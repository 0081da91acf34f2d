"""The trained vocoder as a JAX-free file, and the trained checkpoints
through both packages.

* ``chkpts_npz/bvsc_vocoder_demo_cl_ft_g_step600_f16.npz`` (written by
  ``tools/export_vocoder_npz.py``) holds every leaf of the Orbax checkpoint
  ``chkpts/bvsc_vocoder_demo_cl_ft_g_step600`` as read by ``bvsc_tpu``
  (weight norm folded), rounded once to float16.
* The port loads it with numpy alone (``vocoder_chkpt_path=``); the Orbax
  directory raises ValueError naming the exporter.
* The trained pair (``augfull_step1800`` BVRNN and this vocoder, both
  packages loading the same files) on a crop of the demo utterance at
  3 kbps: codes bit-exact, decoded mel to 2e-5, waveform SNR > 40 dB.
* The fixed-bitrate family (``configs/fixed64.toml``, ``var_bit = false``)
  on its checkpoint: codes bit-exact.
"""

import importlib.util
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from scipy.io import wavfile

from bvsc_tpu.codec import BVRNNCodecModel as JCodec
from bvsc_tpu.codec import _load_vocoder_checkpoint, _unflatten_npz
from bvsc_tpu.config import load_config as jload_config
from bvsc_tpu.eval.metrics import snr_db
from bvsc_tpu_torch import BVRNNCodecModel, CodecConfig, load_config
from bvsc_tpu_torch.convert import load_vocoder_npz, vocoder_params_from_jax

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHKPTS = os.path.join(REPO, "chkpts")
ORBAX = os.path.join(CHKPTS, "bvsc_vocoder_demo_cl_ft_g_step600")
VOC_NPZ = os.path.join(REPO, "chkpts_npz", "bvsc_vocoder_demo_cl_ft_g_step600_f16.npz")
BVRNN_NPZ = os.path.join(CHKPTS, "bvsc_bvrnn_demo_augfull_step1800_f16.npz")
FIXED_NPZ = os.path.join(CHKPTS, "bvsc_bvrnn_demo_fixed64_step250_f16.npz")
VARBIT = os.path.join(REPO, "configs", "varbitrate.toml")
FIXED = os.path.join(REPO, "configs", "fixed64.toml")
WAV = os.path.join(REPO, "docs", "artifacts", "demo_stim15_3kbps.wav")
CROP = 32768  # samples: 128 frames, 1.49 s at 22.05 kHz
N_LEAVES, N_PARAMS = 302, 930_321  # the Orbax tree as bvsc_tpu reads it
MEL_TOL = 2e-5  # the BVRNN gate of the port (ROADMAP.md)
F16_ROUNDING = 6.11e-5  # half a float16 ulp (2 ** -14) at the largest |w|, 0.2129


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: np.asarray(tree, np.float32)}
    out = {}
    for k, v in items:
        out.update(_flat(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


@pytest.fixture(scope="module")
def orbax_leaves():
    conf = jload_config(VARBIT)
    tree = _load_vocoder_checkpoint(ORBAX, conf.vocoder_config, jnp.float32)
    return _flat(jax.tree.map(np.asarray, tree))


def test_npz_is_the_orbax_tree_in_float16(orbax_leaves):
    assert len(orbax_leaves) == N_LEAVES
    assert sum(v.size for v in orbax_leaves.values()) == N_PARAMS
    with np.load(VOC_NPZ) as z:
        assert sorted(z.files) == sorted(orbax_leaves)
        for key, ref in orbax_leaves.items():
            got = z[key]
            assert got.dtype == np.float16 and got.shape == ref.shape, key
            np.testing.assert_array_equal(got, ref.astype(np.float16), err_msg=key)


def test_exporter_writes_the_committed_file(tmp_path):
    """tools/export_vocoder_npz.py run again gives the committed leaves."""
    spec = importlib.util.spec_from_file_location(
        "export_vocoder_npz", os.path.join(REPO, "tools", "export_vocoder_npz.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    out = str(tmp_path / "vocoder_f16.npz")
    stats = tool.export(ORBAX, out)
    assert (stats["leaves"], stats["parameters"]) == (N_LEAVES, N_PARAMS)
    assert stats["max_rounding"] <= F16_ROUNDING
    with np.load(out) as got, np.load(VOC_NPZ) as ref:
        assert sorted(got.files) == sorted(ref.files)
        for key in ref.files:
            np.testing.assert_array_equal(got[key], ref[key], err_msg=key)


def test_load_vocoder_npz_is_the_converted_tree():
    """The port's loader gives the tree vocoder_params_from_jax gives for the
    JAX package's own reading of the same file."""
    with np.load(VOC_NPZ) as z:
        ref = vocoder_params_from_jax(jax.tree.map(np.asarray, _unflatten_npz(z, jnp.float32)))
    got = load_vocoder_npz(VOC_NPZ)
    assert jax.tree.structure(got) == jax.tree.structure(ref)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(ref)):
        assert a.dtype == torch.float32
        assert torch.equal(a, b)


def test_codec_loads_the_npz():
    codec = BVRNNCodecModel(config=CodecConfig(h_dim=48, z_dim=12), vocoder_chkpt_path=VOC_NPZ,
                            device="cpu")
    ref = load_vocoder_npz(VOC_NPZ)
    for a, b in zip(jax.tree.leaves(codec.vocoder_params), jax.tree.leaves(ref)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("path, error, match", [
    (ORBAX, ValueError, "tools/export_vocoder_npz.py"),
    (os.path.join(CHKPTS, "generator.pt"), FileNotFoundError, "generator.pt"),
], ids=["orbax_dir", "torch_file"])
def test_other_vocoder_checkpoints_raise(path, error, match):
    """The Orbax directory is refused naming the exporter; a torch file is
    read (the reference's BigVGAN format), so a missing one is not found."""
    with pytest.raises(error, match=match):
        BVRNNCodecModel(config=CodecConfig(h_dim=48, z_dim=12), vocoder_chkpt_path=path,
                        device="cpu")


@pytest.fixture(scope="module")
def crop():
    fs, data = wavfile.read(WAV)
    assert fs == 22050
    return (data[:CROP].astype(np.float32) / 32768.0)[None]


def test_trained_pair_matches_jax(crop):
    with np.load(VOC_NPZ) as z:
        jvoc = _unflatten_npz(z, jnp.float32)
    jc = JCodec(VARBIT, BVRNN_NPZ, vocoder_params=jvoc)
    tc = BVRNNCodecModel(VARBIT, BVRNN_NPZ, VOC_NPZ, device="cpu")
    codes = np.asarray(jc.encode(crop, 3000))
    np.testing.assert_array_equal(tc.encode(crop, 3000).numpy(), codes)
    np.testing.assert_allclose(tc.decode_to_mel(codes).numpy(), np.asarray(jc.decode_to_mel(codes)),
                               atol=MEL_TOL)
    ref = np.asarray(jc.decode(codes, CROP))
    got = tc.decode(codes, CROP).numpy()
    assert got.shape == ref.shape == (1, CROP) and np.isfinite(got).all()
    assert snr_db(ref, got) > 40.0


def test_fixed_bitrate_codes_match_jax(crop):
    """configs/fixed64.toml: var_bit = false, every frame all 64 bits."""
    assert not load_config(FIXED).var_bit
    jc = JCodec(FIXED, FIXED_NPZ)
    tc = BVRNNCodecModel(FIXED, FIXED_NPZ, device="cpu")
    codes = np.asarray(jc.encode(crop, 5512.5))
    got = tc.encode(crop, 5512.5).numpy()
    np.testing.assert_array_equal(got, codes)
    assert set(np.unique(got)) <= {0.0, 1.0}
