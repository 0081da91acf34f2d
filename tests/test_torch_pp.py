"""The port's two-stage pipeline (bvsc_tpu_torch.parallel.pp) on gloo ranks
on the CPU, against the port's unpipelined per-microbatch composition and
bvsc_tpu.parallel.pp's ``pipeline_resynth`` on the virtual CPU devices, on
the same numpy-seeded weights (``tests/test_pp.py``'s small config).

Gates: codes bitwise, waveform within 1e-6 of the port's unpipelined run
(the same functions on the same rows; ``tests/test_pp.py``'s bound) and
within 1e-4 of the JAX package's pipeline (the cross-package vocoder
bound), on a pipe mesh and a 2 x 2 data x pipe mesh.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bvsc_tpu.models import bvrnn as jb
from bvsc_tpu.models import vocoder as JV
from bvsc_tpu.parallel import pp as JP
from bvsc_tpu_torch.config import VocoderConfig
from bvsc_tpu_torch.convert import bvrnn_params_from_jax, vocoder_params_from_jax
from bvsc_tpu_torch.models import bvrnn as B
from bvsc_tpu_torch.models.vocoder import generator_apply_kernel, prepare_kernel_params
from test_codec import small_conf
from torch_parallel_ranks import spawn

torch.set_num_threads(1)

N_MICRO, M, T = 3, 2, 16
WAV_TOL = 1e-6
CROSS_TOL = 1e-4
MESHES = [(2, "1d"), (4, "2d")]


@pytest.fixture(scope="module")
def setup():
    conf = small_conf()
    jvcfg = conf.vocoder_config
    jbcfg = jb.BVRNNConfig(x_dim=conf.num_mels, h_dim=conf.h_dim, z_dim=conf.z_dim, var_bit=True)
    btree = jax.tree.map(np.asarray, jb.init_bvrnn_params(jax.random.key(0), jbcfg))
    vtree = jax.tree.map(np.asarray, JV.init_generator_params(jax.random.key(1), jvcfg,
                                                              weight_norm=False))
    rng = np.random.default_rng(5)
    mel_mb = rng.standard_normal((N_MICRO, M, T, conf.num_mels)).astype(np.float32)
    bits_mb = rng.integers(1, conf.z_dim + 1, (N_MICRO, M, T)).astype(np.float32)
    bcfg = {"x_dim": conf.num_mels, "h_dim": conf.h_dim, "z_dim": conf.z_dim}
    vcfg = VocoderConfig(**dataclasses.asdict(jvcfg))
    return (jbcfg, jvcfg, btree, vtree, bcfg, vcfg, bvrnn_params_from_jax(btree),
            vocoder_params_from_jax(vtree), mel_mb, bits_mb)


@pytest.fixture(scope="module")
def unpipelined(setup):
    *_, bcfg, vcfg, bparams, vparams, mel_mb, bits_mb = setup
    cfg = B.BVRNNConfig(**bcfg)
    blocks = prepare_kernel_params(vparams, vcfg)
    codes, wavs = [], []
    with torch.no_grad():
        for i in range(N_MICRO):
            z, mel, _ = B.encode_decode(bparams, cfg, torch.from_numpy(mel_mb[i]),
                                        torch.from_numpy(bits_mb[i]), torch.zeros(M, cfg.h_dim))
            wavs.append(generator_apply_kernel(vparams, blocks, vcfg,
                                               mel.transpose(1, 2).contiguous(),
                                               T * vcfg.total_upsample).numpy())
            codes.append(z.numpy())
    return np.stack(codes), np.stack(wavs)


@pytest.fixture(scope="module")
def port_pp(setup, tmp_path_factory):
    *_, bcfg, vcfg, bparams, vparams, mel_mb, bits_mb = setup
    return {(n, kind): spawn(n, tmp_path_factory.mktemp(f"pp{n}{kind}"), "pp", kind, bparams,
                             bcfg, vparams, vcfg, mel_mb, bits_mb) for n, kind in MESHES}


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}{m[1]}")
def test_pp_matches_unpipelined(port_pp, unpipelined, mesh):
    codes, wav = unpipelined
    for out in port_pp[mesh]:
        assert out["codes"].shape == codes.shape == (N_MICRO, M, T, codes.shape[-1])
        np.testing.assert_array_equal(out["codes"], codes)
        assert out["wav"].shape == wav.shape
        assert np.abs(out["wav"] - wav).max() <= WAV_TOL


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}{m[1]}")
def test_pp_matches_bvsc_tpu(setup, port_pp, mesh):
    jbcfg, jvcfg, btree, vtree, *_, mel_mb, bits_mb = setup
    jmesh = JP.make_dp_pp_mesh(2) if mesh[1] == "2d" else JP.make_pp_mesh()
    fn = jax.jit(lambda bp, vp, m, b: JP.pipeline_resynth(
        bp, jbcfg, vp, jvcfg, m, b, jmesh, precision=jax.lax.Precision.HIGHEST))
    codes, wav = fn(jax.tree.map(jnp.asarray, btree), jax.tree.map(jnp.asarray, vtree),
                    jnp.asarray(mel_mb), jnp.asarray(bits_mb))
    np.testing.assert_array_equal(port_pp[mesh][0]["codes"], np.asarray(codes))
    assert np.abs(port_pp[mesh][0]["wav"] - np.asarray(wav)).max() <= CROSS_TOL


def test_pp_input_validation(setup):
    """The reference's errors, raised before any exchange."""
    from bvsc_tpu_torch.parallel.pp import pipeline_resynth

    *_, bcfg, vcfg, bparams, vparams, mel_mb, bits_mb = setup
    cfg = B.BVRNNConfig(**bcfg)
    with pytest.raises(ValueError, match="must have size 2"):
        pipeline_resynth(bparams, cfg, vparams, vcfg, mel_mb, bits_mb, _Rank0(1))
    two = _Rank0(2)
    with pytest.raises(ValueError, match="bits_mb required"):
        pipeline_resynth(bparams, cfg, vparams, vcfg, mel_mb, None, two)
    bad = np.zeros((N_MICRO, M, T, bcfg["x_dim"] + 1), np.float32)
    with pytest.raises(ValueError, match="x_dim"):
        pipeline_resynth(bparams, cfg, vparams, vcfg, bad, bits_mb, two)


class _Rank0:
    """A stand-in for rank 0 of a mesh with a pipe axis of ``n``: the checks
    before the first exchange read only the axes."""

    device = torch.device("cpu")

    def __init__(self, n):
        self.n = n

    def axis(self, name):
        from bvsc_tpu_torch.parallel.mesh import Axis

        n = self.n if name == "pipe" else 1
        return Axis(name, n, 0, tuple(range(n)), None)
