"""The port's binary rANS coder (bvsc_tpu_torch.ops.rans) against
``bvsc_tpu.ops.rans``: ``quantize_probs`` equal, ``rans_encode`` byte for
byte the same on its native path (``native/rans.c``, built with ``cc`` into
``bvsc_tpu_torch/_build/``) and on its numpy path, payloads decoded across
the two packages, the streaming decoder's round trip, and truncated or
corrupt payloads raising (the pattern of tests/test_entropy.py)."""

import numpy as np
import pytest
import torch

from bvsc_tpu.ops import rans as JR
from bvsc_tpu_torch.ops import _cc
from bvsc_tpu_torch.ops import rans as TR

torch.set_num_threads(1)


@pytest.fixture(params=["native", "numpy"])
def port_rans(request, monkeypatch):
    """The port's rANS on its native path, or forced onto numpy."""
    if request.param == "native":
        if TR._load_native() is None:
            pytest.skip("no C toolchain")
    else:
        monkeypatch.setattr(TR, "_lib", None)
        monkeypatch.setattr(TR, "_tried", True)
    return TR


def _case(seed: int, n: int, lo: float = 0.001, hi: float = 0.999):
    rng = np.random.default_rng(seed)
    p = rng.uniform(lo, hi, n)
    return (rng.uniform(size=n) < p).astype(np.uint8), TR.quantize_probs(p)


def test_quantize_probs_equal_jax():
    rng = np.random.default_rng(0)
    p = np.concatenate([rng.uniform(0, 1, 4096), [0.0, 1.0, 1e-9, 1 - 1e-9, 0.5,
                                                  0.5 / 65536, 1.5 / 65536]])
    got = TR.quantize_probs(p)
    assert got.dtype == np.uint16
    np.testing.assert_array_equal(got, JR.quantize_probs(p))
    assert got.min() == 16 and got.max() == 65520


@pytest.mark.parametrize("n,lo,hi", [(0, 0.1, 0.9), (1, 0.1, 0.9), (4096, 0.001, 0.999),
                                     (3000, 0.45, 0.55), (2048, 1e-6, 1e-3)])
def test_encode_bytes_equal_jax(port_rans, n, lo, hi):
    bits, q = _case(n + 1, n, lo, hi)
    payload = port_rans.rans_encode(bits, q)
    assert payload == JR.rans_encode(bits, q)
    if n:  # the coded size is near the model's cross-entropy (1 % + the flush)
        h_bytes = -(bits * np.log2(q / 65536.0) + (1 - bits) * np.log2(1 - q / 65536.0)).sum() / 8
        assert len(payload) <= h_bytes * 1.01 + 8


def test_roundtrip_in_chunks(port_rans):
    bits, q = _case(2, 4096)
    payload = port_rans.rans_encode(bits, q)
    dec = port_rans.RansDecoder(payload)
    got = np.concatenate([dec.decode_bits(q[i: i + 37]) for i in range(0, bits.size, 37)])
    dec.finish()
    np.testing.assert_array_equal(got, bits)


def test_payloads_decode_across_packages(port_rans):
    """Each package's decoder unwinds the other's payload exactly."""
    bits, q = _case(3, 1500)
    for payload, decoder in ((JR.rans_encode(bits, q), port_rans.RansDecoder),
                             (port_rans.rans_encode(bits, q), JR.RansDecoder)):
        dec = decoder(payload)
        np.testing.assert_array_equal(dec.decode_bits(q), bits)
        dec.finish()


def test_truncation_and_corruption_detected(port_rans):
    bits, q = _case(4, 256, 0.2, 0.8)
    payload = port_rans.rans_encode(bits, q)
    with pytest.raises(ValueError):
        dec = port_rans.RansDecoder(payload[: len(payload) // 2])
        dec.decode_bits(q)
        dec.finish()
    bad = bytearray(payload)
    bad[len(bad) // 2] ^= 0x5A
    with pytest.raises(ValueError):
        dec = port_rans.RansDecoder(bytes(bad))
        dec.decode_bits(q)
        dec.finish()
    with pytest.raises(ValueError, match="shorter than the 4-byte state"):
        port_rans.RansDecoder(payload[:3])
    with pytest.raises(ValueError, match="did not unwind"):
        dec = port_rans.RansDecoder(payload + b"\0")  # a trailing byte is never consumed
        dec.decode_bits(q)
        dec.finish()


def test_bad_arguments_rejected(port_rans):
    bits, q = _case(5, 10)
    with pytest.raises(ValueError, match="probabilities"):
        port_rans.rans_encode(bits, np.zeros(10, np.uint16))
    with pytest.raises(ValueError, match="bits"):
        port_rans.rans_encode(bits[:9], q)


def test_builds_into_the_port():
    """The native library is built from the port's own C source, a copy of
    bvsc_tpu's, into the port's build directory."""
    if TR._load_native() is None:
        pytest.skip("no C toolchain")
    assert TR._SRC.endswith("bvsc_tpu_torch/native/rans.c")
    assert TR._load_native()._name.startswith(_cc.BUILD_DIR)
    jax_src = open(JR._SRC).read()
    port_src = open(TR._SRC).read()
    # the same code after the header comment
    assert jax_src[jax_src.index("#include"):] == port_src[port_src.index("#include"):]
