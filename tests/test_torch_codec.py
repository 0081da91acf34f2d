"""Port codec (bvsc_tpu_torch.BVRNNCodecModel, device='cpu') against
bvsc_tpu.BVRNNCodecModel on the same weights (moved across with
bvsc_tpu_torch.convert): a small BVRNN (h 48, z 12, 80 mels) and the
full-width vocoder, on a seeded ~0.3 s input.  Codes must agree bit for bit;
waveforms to SNR > 40 dB and 1e-4 abs."""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from bvsc_tpu.codec import BVRNNCodecModel as JCodec
from bvsc_tpu.codec import _unflatten_npz
from bvsc_tpu.config import CodecConfig as JCodecConfig
from bvsc_tpu.eval.metrics import snr_db
from bvsc_tpu.models import bvrnn as jb
from bvsc_tpu_torch import BVRNNCodecModel, CodecConfig
from bvsc_tpu_torch.convert import bvrnn_params_from_jax, load_bvrnn_npz, vocoder_params_from_jax
from test_torch_amp_resblock import perturbed_generator_params

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NPZ = os.path.join(REPO, "chkpts", "bvsc_bvrnn_demo_augfull_step1800_f16.npz")
SMALL = dict(h_dim=48, z_dim=12)
L, B = 6615, 2  # 0.3 s at 22.05 kHz
BUCKET = 16


@pytest.fixture(scope="module")
def trees():
    """The JAX config and numpy weight trees both codecs are built from."""
    jconf = JCodecConfig(**SMALL)
    bcfg = jb.BVRNNConfig(x_dim=80, h_dim=SMALL["h_dim"], z_dim=SMALL["z_dim"])
    mean_std = (np.random.default_rng(1).standard_normal(80) * 0.5 - 4.0,
                np.abs(np.random.default_rng(2).standard_normal(80)) + 1.0)
    btree = jax.tree.map(np.asarray, jb.init_bvrnn_params(jax.random.key(0), bcfg, mean_std))
    vtree = perturbed_generator_params(jconf.vocoder_config, seed=3)
    return jconf, btree, vtree


def _jax_codec(trees, **kwargs):
    jconf, btree, vtree = trees
    return JCodec(config=jconf, bvrnn_params=jax.tree.map(jax.numpy.asarray, btree),
                  vocoder_params=jax.tree.map(jax.numpy.asarray, vtree), length_bucket=BUCKET,
                  **kwargs)


def _port_codec(trees, **kwargs):
    _, btree, vtree = trees
    return BVRNNCodecModel(config=CodecConfig(**SMALL), bvrnn_params=bvrnn_params_from_jax(btree),
                           vocoder_params=vocoder_params_from_jax(vtree), length_bucket=BUCKET,
                           device="cpu", **kwargs)


@pytest.fixture(scope="module")
def codecs(trees):
    return _jax_codec(trees), _port_codec(trees)


@pytest.fixture(scope="module")
def x():
    return (np.random.default_rng(11).standard_normal((B, L)) * 0.3).astype(np.float32)


@pytest.fixture(scope="module")
def vbr(codecs):
    """A per-frame schedule of bps over the input's frames."""
    n = codecs[1].frontend.num_frames(L)
    return np.random.default_rng(12).choice([1000.0, 2000.0, 3000.0, 5512.5], size=n)


def _close(got, ref):
    got = got.numpy()
    assert got.shape == ref.shape
    assert np.isfinite(got).all()
    assert snr_db(ref, got) > 40.0
    np.testing.assert_allclose(got, ref, atol=1e-4)


@pytest.mark.parametrize("fused", [True, False])
def test_call_matches_jax(codecs, x, fused):
    jc, tc = codecs
    ref = np.asarray(jc(x, 3000, fused=fused))
    _close(tc(x, 3000, fused=fused), ref)


def test_encode_codes_bitexact(codecs, x, vbr):
    jc, tc = codecs
    for bitrate in (3000, vbr):
        ref = np.asarray(jc.encode(x, bitrate))
        got = tc.encode(x, bitrate).numpy()
        np.testing.assert_array_equal(got, ref)
        assert set(np.unique(got)) <= {0.0, 0.5, 1.0}


def test_decode_matches_jax(codecs, x):
    jc, tc = codecs
    codes = np.asarray(jc.encode(x, 3000))
    _close(tc.decode(codes, L), np.asarray(jc.decode(codes, L)))
    np.testing.assert_allclose(tc.decode_to_mel(codes).numpy(),
                               np.asarray(jc.decode_to_mel(codes)), atol=2e-5)


@pytest.mark.parametrize("bps", [0, 43.06640625, 129.19921875, 1000, 3000, 5512.5, 6000])
def test_bitrate_rounding_matches_jax(codecs, bps):
    jc, tc = codecs
    assert tc.bits_per_frame(bps) == jc.bits_per_frame(bps)


def test_1d_input_promotion(codecs, x, vbr):
    jc, tc = codecs
    codes = tc.encode(x[0], vbr)
    assert codes.shape == (tc.frontend.num_frames(L), SMALL["z_dim"])
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jc.encode(x[0], vbr)))
    y1 = tc(x[0], 3000)
    assert y1.shape == (L,)
    np.testing.assert_array_equal(y1.numpy(), tc(x[:1], 3000)[0].numpy())
    np.testing.assert_array_equal(tc.decode(codes, L).numpy(), tc.decode(codes[None], L)[0].numpy())


def test_load_bvrnn_npz_matches_jax_loader():
    with np.load(NPZ) as z:
        ref = jax.tree.map(np.asarray, _unflatten_npz(z, jax.numpy.float32))
    got = jax.tree.map(lambda t: t.numpy(), load_bvrnn_npz(NPZ))
    assert jax.tree.structure(got) == jax.tree.structure(ref)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(ref)):
        assert a.dtype == np.float32 and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kwargs", [
    {"bvrnn_chkpt_path": "orbax"},
    {"vocoder_chkpt_path": "orbax", "precision": "default"}, {"vocoder_chkpt_path": "orbax"},
])
def test_unported_knobs_raise(kwargs, tmp_path):
    """Orbax checkpoints (directories) are not ported: Orbax needs JAX.  The
    codec raises ValueError naming the ROADMAP entry and the exporter."""
    (tmp_path / "orbax").mkdir()
    kwargs = {k: str(tmp_path / v) if k.endswith("_path") else v for k, v in kwargs.items()}
    with pytest.raises(ValueError, match="ROADMAP.*export_"):
        BVRNNCodecModel(config=CodecConfig(**SMALL), device="cpu", **kwargs)


@pytest.mark.parametrize("kwargs,approx,voc_dtype", [
    ({"use_pallas": False}, False, "f32"),
    ({"use_pallas": False, "precision": "default"}, True, "bf16"),
    ({"use_pallas": False, "quantize": "int8"}, False, "f32"),
])
def test_use_pallas_false_builds_the_direct_path(kwargs, approx, voc_dtype):
    """``use_pallas=False`` builds the direct path with the reference's
    knob defaults: no packed blocks, the whole generator in the weights."""
    c = BVRNNCodecModel(config=CodecConfig(**SMALL), device="cpu", **kwargs)
    assert (c.use_pallas, c.approx_snake, c.voc_dtype) == (False, approx, voc_dtype)
    assert c.kernel_blocks is None and c.weights.direct
    assert "resblocks" in c.weights.tree()["vocoder"] and "blocks" not in c.weights.tree()


def test_default_device_is_cuda():
    """No silent CPU fallback: without a card the default device raises."""
    if torch.cuda.is_available():
        pytest.skip("a card is present; the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BVRNNCodecModel(config=CodecConfig(**SMALL))


@pytest.mark.parametrize("dtype", [torch.float32, np.float32, "float32", jnp.float32])
def test_reference_constructor_knobs(trees, codecs, x, dtype):
    """The reference's ``dtype=float32`` and ``scan_unroll=`` (scheduling
    only there): the port takes them and its output does not change."""
    _, tc = codecs
    tc2 = _port_codec(trees, scan_unroll=2, dtype=dtype)
    assert tc2.dtype == torch.float32
    np.testing.assert_array_equal(tc2(x, 3000).numpy(), tc(x, 3000).numpy())


def test_scan_unroll_codes_match_reference_constructor(trees, x):
    """Both constructors called with the same arguments give the same codes."""
    kwargs = {"scan_unroll": 2, "dtype": jnp.float32}
    ref = np.asarray(_jax_codec(trees, **kwargs).encode(x, 3000))
    np.testing.assert_array_equal(_port_codec(trees, **kwargs).encode(x, 3000).numpy(), ref)


@pytest.mark.parametrize("dtype", [torch.bfloat16, jnp.bfloat16, "bfloat16"])
def test_bf16_storage_names(dtype):
    """Each name of bf16 builds a codec whose weights and state are bf16."""
    codec = BVRNNCodecModel(config=CodecConfig(**SMALL), device="cpu", dtype=dtype)
    assert codec.dtype == codec.bvrnn_cfg.dtype == torch.bfloat16
    assert codec.bvrnn_params["gru"]["w_ih"].dtype == torch.bfloat16
    assert codec.vocoder_params["conv_pre"]["w"].dtype == torch.bfloat16
    assert codec._h0(1).dtype == torch.bfloat16


@pytest.mark.parametrize("dtype", [np.float16, torch.float16, "float16", np.float64])
def test_other_storage_dtypes_raise(dtype):
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        BVRNNCodecModel(config=CodecConfig(**SMALL), device="cpu", dtype=dtype)


@pytest.mark.parametrize("scan_unroll", [0, -1, 1.5])
def test_bad_scan_unroll_raises(scan_unroll):
    with pytest.raises(ValueError, match="scan_unroll"):
        BVRNNCodecModel(config=CodecConfig(**SMALL), device="cpu", scan_unroll=scan_unroll)
