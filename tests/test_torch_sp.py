"""The port's sequence-parallel vocoder (bvsc_tpu_torch.parallel.sp) on gloo
ranks on the CPU, against the port's one-shot generator and
bvsc_tpu.parallel.sp's ``generator_apply_sp`` on the virtual CPU devices,
on the same numpy-seeded weights.

Gates: within 1e-5 of the port's one-shot generator (the overlap adds sum
in another order; ``tests/test_sp.py``'s bound), within 1e-4 of the JAX
package's (the cross-package vocoder bound).  The cases are
``tests/test_sp.py``'s (shards, frames) that fit 4 ranks, a 2 x 2 data x
seq mesh, and the default full-width vocoder at 8 frames a shard, whose
stage-0 context (120 samples) spans two ranks to the left.  The residual
stacks run through ``ops.amp_resblock.amp_stack`` with ``ctx`` / ``start``
(the kernels' plain versions here).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bvsc_tpu.config import CodecConfig as JCodecConfig
from bvsc_tpu.models import vocoder as JV
from bvsc_tpu.parallel import sp as JS
from bvsc_tpu_torch.config import CodecConfig, VocoderConfig
from bvsc_tpu_torch.convert import vocoder_params_from_jax
from bvsc_tpu_torch.models.vocoder import generator_apply_kernel, prepare_kernel_params
from test_codec import small_conf
from test_torch_amp_resblock import perturbed_generator_params
from torch_parallel_ranks import spawn

torch.set_num_threads(1)

ONE_SHOT_TOL = 1e-5
CROSS_TOL = 1e-4
CASES = [(2, "1d", 16), (4, "1d", 32), (4, "2d", 16)]  # ranks, mesh, frames
WIDE = (4, 32)  # the default vocoder: 4 shards of 8 frames


def _port_cfg(jcfg) -> VocoderConfig:
    import dataclasses

    return VocoderConfig(**dataclasses.asdict(jcfg))


@pytest.fixture(scope="module")
def small():
    jcfg = small_conf().vocoder_config
    tree = jax.tree.map(np.asarray, JV.init_generator_params(jax.random.key(0), jcfg,
                                                             weight_norm=False))
    mel = np.random.default_rng(0).standard_normal((2, jcfg.num_mels, 32)).astype(np.float32)
    return jcfg, _port_cfg(jcfg), tree, vocoder_params_from_jax(tree), mel


@pytest.fixture(scope="module")
def wide():
    jcfg = JCodecConfig().vocoder_config
    tree = perturbed_generator_params(jcfg, seed=4)
    mel = (np.random.default_rng(1).standard_normal((1, jcfg.num_mels, WIDE[1])) - 4.0
           ).astype(np.float32)
    return jcfg, CodecConfig().vocoder_config, tree, vocoder_params_from_jax(tree), mel


def _one_shot(params, cfg, mel):
    with torch.no_grad():
        m = torch.from_numpy(mel)
        return generator_apply_kernel(params, prepare_kernel_params(params, cfg), cfg, m,
                                      m.shape[-1] * cfg.total_upsample).numpy()


def _jax_sp(jcfg, tree, mel, n, kind):
    mesh = JS.make_dp_sp_mesh(2, n // 2) if kind == "2d" else JS.make_sp_mesh(n)
    fn = jax.jit(lambda p, m: JS.generator_apply_sp(p, jcfg, m, mesh,
                                                    precision=jax.lax.Precision.HIGHEST))
    return np.asarray(fn(jax.tree.map(jnp.asarray, tree), jnp.asarray(mel)))


@pytest.fixture(scope="module")
def port_sp(small, wide, tmp_path_factory):
    _, cfg, _, params, mel = small
    out = {}
    for n, kind, T in CASES:
        out[(n, kind, T)] = spawn(n, tmp_path_factory.mktemp(f"sp{n}{kind}{T}"), "sp", kind,
                                  params, cfg, mel[..., :T])
    _, wcfg, _, wparams, wmel = wide
    out["wide"] = spawn(WIDE[0], tmp_path_factory.mktemp("spwide"), "sp", "1d", wparams, wcfg,
                        wmel)
    return out


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}{c[1]}_T{c[2]}")
def test_sp_matches_one_shot(small, port_sp, case):
    _, cfg, _, params, mel = small
    ref = _one_shot(params, cfg, mel[..., :case[2]])
    for got in port_sp[case]:
        assert got.shape == ref.shape == (2, 1, case[2] * cfg.total_upsample)
        assert np.abs(got - ref).max() <= ONE_SHOT_TOL


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}{c[1]}_T{c[2]}")
def test_sp_matches_bvsc_tpu(small, port_sp, case):
    jcfg, _, tree, _, mel = small
    ref = _jax_sp(jcfg, tree, mel[..., :case[2]], case[0], case[1])
    assert np.abs(port_sp[case][0] - ref).max() <= CROSS_TOL


def test_sp_context_spans_ranks(wide, port_sp):
    """Full width, 8 frames a shard: stage 0's 64 samples a shard are fewer
    than its 120-sample context, which the shards further left fill."""
    jcfg, cfg, tree, params, mel = wide
    ref = _one_shot(params, cfg, mel)
    for got in port_sp["wide"]:
        assert np.abs(got - ref).max() <= ONE_SHOT_TOL
    assert np.abs(port_sp["wide"][0] - _jax_sp(jcfg, tree, mel, *WIDE[:1], "1d")).max() <= CROSS_TOL


def test_sp_input_validation(small, tmp_path):
    """Frames that do not divide over the shards, and shards too short for
    conv_pre's 6-frame context, raise tests/test_sp.py's errors on every
    rank."""
    _, cfg, _, params, _ = small
    for errs in spawn(2, tmp_path, "sp_errors", params, cfg, (15, 8)):
        assert "divisible" in errs[0] and "halo" in errs[1]


def test_sp_rejects_noncausal(small):
    import dataclasses

    from bvsc_tpu_torch.parallel.mesh import make_mesh
    from bvsc_tpu_torch.parallel.sp import generator_apply_sp

    _, cfg, _, params, mel = small
    mesh = make_mesh(devices=["cpu"], axis_name="seq")
    for bad in (dataclasses.replace(cfg, layers_sym=(True, False)),
                dataclasses.replace(cfg, antialias_post=True)):
        with pytest.raises(ValueError, match="causal|anti-aliased"):
            generator_apply_sp(params, bad, mel, mesh)


def test_sp_default_minimum(wide):
    """The default config's minimum of 7 frames a shard passes the halo
    check, and 6 does not (a stage-0 conv with k = 11, d = 5 needs 50
    samples, 8 a frame)."""
    from bvsc_tpu_torch.parallel.sp import _check_halos

    cfg = wide[1]
    _check_halos(cfg, 7)
    with pytest.raises(ValueError, match="too short for halo"):
        _check_halos(cfg, 6)
