"""The port's prior entropy coder (bvsc_tpu_torch.entropy.PriorEntropyCoder).

At a small config (h 48, z 20): round trips at a constant and a variable
bitrate with zero-bit (DTX) frames and a fractional allocation (the ceil),
the native and numpy paths of its fixed-order float64 pass giving the same
bytes, the same bytes at 1, 4 and 8 torch threads, quantised and non-host
weights refused, and the pass against the port's float32 ``prior_apply``
and ``_advance`` (it is their math in float64).  On the trained
``augfull_step1800`` BVRNN and the golden codes
(``chkpts_npz/golden_demo_stim15_3kbps.npz``): the port decodes its own
payload to the exact codes, its size is within 1 % of
``bvsc_tpu.entropy.PriorEntropyCoder``'s on the same codes, and its SHA-256
is the constant that ``chip_smoke.py`` (phase ``entropy``) checks on the
card's host.
"""

import hashlib
import os

import numpy as np
import pytest
import torch

from bvsc_tpu_torch import entropy as E
from bvsc_tpu_torch.convert import load_bvrnn_npz, to_torch
from bvsc_tpu_torch.models import bvrnn as bvrnn_mod
from bvsc_tpu_torch.ops import quant

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NPZ = os.path.join(REPO, "chkpts", "bvsc_bvrnn_demo_augfull_step1800_f16.npz")
GOLDEN = os.path.join(REPO, "chkpts_npz", "golden_demo_stim15_3kbps.npz")
# SHA-256 of the port's payload of the golden codes at 35 bits a frame;
# chip_smoke.py holds the card's host to the same constant
GOLDEN_V3_SHA256 = "c6db926661ba5993ae8c505205097521dc51744bd534bac5fa5bafb4d499a26f"
SIZE_RTOL = 0.01  # the port's payload against bvsc_tpu's on the same codes


@pytest.fixture(scope="module")
def small():
    cfg = bvrnn_mod.BVRNNConfig(x_dim=12, h_dim=48, z_dim=20)
    params = bvrnn_mod.init_bvrnn_params(3, cfg)
    rng = np.random.default_rng(7)
    frames = 33
    ks = rng.integers(0, cfg.z_dim + 1, frames)
    ks[[0, 5, 6, 20]] = 0  # DTX frames, one of them first
    codes = np.full((frames, cfg.z_dim), 0.5, np.float32)
    for t, k in enumerate(ks):
        codes[t, :k] = rng.integers(0, 2, k)
    return cfg, params, codes, ks


@pytest.fixture(params=["native", "numpy"])
def host_path(request, monkeypatch):
    """The coder's dense layers on native/prior.c, or forced onto numpy."""
    if request.param == "native":
        if E._load_native() is None:
            pytest.skip("no C toolchain")
    else:
        monkeypatch.setattr(E, "_lib", None)
        monkeypatch.setattr(E, "_tried", True)
    return request.param


def test_roundtrip_vbr_with_dtx(small, host_path):
    cfg, params, codes, ks = small
    ec = E.PriorEntropyCoder(params, cfg)
    payload = ec.encode(codes, ks)
    got = ec.decode(payload, ks, codes.shape[0])
    np.testing.assert_array_equal(got, codes)
    assert ec.encode(got, ks) == payload  # the decoded codes re-encode to the same bytes


@pytest.mark.parametrize("bits", [9, 8.2])
def test_roundtrip_constant_bitrate(small, bits):
    """A fractional allocation transmits its ceil (8.2 -> 9 bits), as the
    model's bit mask does; the bits past it are 0.5."""
    cfg, params, codes, _ = small
    full = np.where(codes == 0.5, 1.0, codes)  # every bit set or clear
    ec = E.PriorEntropyCoder(params, cfg)
    payload = ec.encode(full, bits)
    got = ec.decode(payload, bits, full.shape[0])
    np.testing.assert_array_equal(got[:, :9], full[:, :9])
    assert (got[:, 9:] == 0.5).all()
    assert payload == ec.encode(full, 9)


def test_native_and_numpy_paths_give_the_same_bytes(small, monkeypatch):
    if E._load_native() is None:
        pytest.skip("no C toolchain")
    cfg, params, codes, ks = small
    ec = E.PriorEntropyCoder(params, cfg)
    h = np.random.default_rng(1).standard_normal(cfg.h_dim)
    native = (ec.encode(codes, ks), ec._prior(h), ec._advance(h, np.full(cfg.z_dim, 0.5)))
    monkeypatch.setattr(E, "_lib", None)
    monkeypatch.setattr(E, "_tried", True)
    numpy_path = (ec.encode(codes, ks), ec._prior(h), ec._advance(h, np.full(cfg.z_dim, 0.5)))
    assert native[0] == numpy_path[0]
    for a, b in zip(native[1:], numpy_path[1:]):
        assert a.dtype == b.dtype == np.float64
        np.testing.assert_array_equal(a, b)


def test_same_bytes_at_any_thread_count(small):
    cfg, params, codes, ks = small
    payloads = []
    try:
        for n in (1, 4, 8):
            torch.set_num_threads(n)
            payloads.append(E.PriorEntropyCoder(to_torch(params, "cpu"), cfg).encode(codes, ks))
    finally:
        torch.set_num_threads(1)
    assert payloads[0] == payloads[1] == payloads[2]


def test_host_pass_is_the_ports_math(small):
    """The prior and the closed-loop advance against the port's float32
    ``prior_apply`` and ``_advance`` (float32 sums in another order)."""
    cfg, params, _, _ = small
    ec = E.PriorEntropyCoder(params, cfg)
    tp = to_torch(params, "cpu")
    rng = np.random.default_rng(2)
    h = rng.standard_normal(cfg.h_dim) * 0.5
    z = np.where(np.arange(cfg.z_dim) < 11, rng.integers(0, 2, cfg.z_dim), 0.5).astype(np.float64)
    with torch.no_grad():
        th = torch.tensor(h, dtype=torch.float32)[None]
        prior = bvrnn_mod.prior_apply(tp, th)[0].numpy()
        _, h_next = bvrnn_mod._advance(tp, torch.tensor(z, dtype=torch.float32)[None], th,
                                       "highest")
    np.testing.assert_allclose(ec._prior(h), prior, atol=1e-6)
    np.testing.assert_allclose(ec._advance(h, z), h_next[0].numpy(), atol=1e-5)


def test_exp_is_exp():
    x = np.linspace(-700.0, 700.0, 200001)
    np.testing.assert_allclose(E._exp(x), np.exp(x), rtol=4e-16)
    tails = E._exp(np.array([-800.0, 800.0]))  # clamped: no inf reaches the sigmoid's division
    assert 0 <= tails[0] < 1e-300 and np.isfinite(tails[1])


def test_refusals(small):
    cfg, params, codes, ks = small
    tp = to_torch(params, "cpu")
    for q in (quant.quantize_bvrnn_params(tp), quant.quantize_bvrnn_params_mixed(tp)):
        with pytest.raises(ValueError, match="quantised"):
            E.PriorEntropyCoder(q, cfg)
    with pytest.raises(ValueError, match="not BVRNN"):
        E.PriorEntropyCoder({"gru": params["gru"]}, cfg)
    meta = to_torch(params, "meta")  # weights off the host: the coder touches no device
    with pytest.raises(ValueError, match="host"):
        E.PriorEntropyCoder(meta, cfg)
    ec = E.PriorEntropyCoder(params, cfg)
    with pytest.raises(ValueError, match="shape"):
        ec.encode(codes, ks[:-1])
    assert ec.encode(codes, 0) == b""
    np.testing.assert_array_equal(ec.decode(b"", 0, 4), np.full((4, cfg.z_dim), 0.5, np.float32))
    with pytest.raises(ValueError, match="nonempty payload"):
        ec.decode(b"\0", 0, 4)


def test_truncated_or_corrupt_payload_raises(small):
    cfg, params, codes, ks = small
    ec = E.PriorEntropyCoder(params, cfg)
    payload = ec.encode(codes, ks)
    with pytest.raises(ValueError):
        ec.decode(payload[: len(payload) // 2], ks, codes.shape[0])
    bad = bytearray(payload)
    bad[len(bad) // 2] ^= 0x5A
    try:
        assert not np.array_equal(ec.decode(bytes(bad), ks, codes.shape[0]), codes)
    except ValueError:
        pass  # the state-unwind check firing is equally right


def test_measure(small):
    cfg, params, codes, ks = small
    m = E.PriorEntropyCoder(params, cfg).measure(codes, ks)
    assert m["frames"] == codes.shape[0] and m["raw_bytes"] == (int(ks.sum()) + 7) // 8
    assert m["coded_bytes"] == len(E.PriorEntropyCoder(params, cfg).encode(codes, ks))
    assert m["saving_pct"] == pytest.approx(100 * (1 - 8 * m["coded_bytes"] / ks.sum()))


# --- the trained BVRNN on the golden codes -----------------------------------------------


@pytest.fixture(scope="module")
def golden():
    with np.load(GOLDEN) as z:
        codes = z["codes"].astype(np.float32) / 2
        bitrate = float(z["bitrate"])
    bits = int(np.round(bitrate * 256 / 22050))
    cfg = bvrnn_mod.BVRNNConfig(h_dim=1024, z_dim=64)
    coder = E.PriorEntropyCoder(load_bvrnn_npz(NPZ), cfg)
    payload = coder.encode(codes, bits)
    return coder, codes, bits, payload


def test_golden_payload_decodes_to_the_codes(golden):
    coder, codes, bits, payload = golden
    np.testing.assert_array_equal(coder.decode(payload, bits, codes.shape[0]), codes)


def test_golden_payload_hash(golden):
    """The bytes are a constant of the checkpoint and the codes: the same on
    any machine (chip_smoke.py checks this constant on the card's host)."""
    _, codes, bits, payload = golden
    assert (codes.shape, bits) == ((227, 64), 35)
    assert hashlib.sha256(payload).hexdigest() == GOLDEN_V3_SHA256


def test_golden_size_near_jax(golden):
    """Within 1 % of bvsc_tpu's payload on the same codes (its float32 prior
    differs from the port's by ~5e-7, so the bytes differ)."""
    import jax.numpy as jnp

    from bvsc_tpu.codec import _unflatten_npz
    from bvsc_tpu.entropy import PriorEntropyCoder as JaxCoder
    from bvsc_tpu.models.bvrnn import BVRNNConfig as JaxConfig

    _, codes, bits, payload = golden
    with np.load(NPZ) as z:
        jparams = _unflatten_npz(z, jnp.float32)
    ref = JaxCoder(jparams, JaxConfig(h_dim=1024, z_dim=64)).encode(codes, bits)
    assert abs(len(payload) - len(ref)) <= SIZE_RTOL * len(ref), (len(payload), len(ref))
    assert len(payload) < (codes.shape[0] * bits + 7) // 8  # smaller than raw packing
