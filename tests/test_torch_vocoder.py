"""Port generator (bvsc_tpu_torch.models.vocoder) against
bvsc_tpu.models.vocoder.generator_apply at Precision.HIGHEST, full-width
causal config, on the same weights."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from bvsc_tpu.config import CodecConfig as JCodecConfig
from bvsc_tpu.models import vocoder as JV
from bvsc_tpu_torch.config import CodecConfig
from bvsc_tpu_torch.convert import to_torch, vocoder_params_from_jax
from bvsc_tpu_torch.models import vocoder as TV
from test_torch_amp_resblock import perturbed_generator_params

torch.set_num_threads(1)

FRAMES = 8


@pytest.fixture(scope="module")
def setup():
    jcfg = JCodecConfig().vocoder_config
    tcfg = CodecConfig().vocoder_config
    tree = perturbed_generator_params(jcfg, seed=2)
    mel = (np.random.default_rng(0).standard_normal((2, 80, FRAMES)) - 5).astype(np.float32)
    L = FRAMES * 256
    ref = np.asarray(jax.jit(
        lambda p, m: JV.generator_apply(p, jcfg, m, L, precision=jax.lax.Precision.HIGHEST)
    )(tree, jnp.asarray(mel)))
    return tree, vocoder_params_from_jax(tree), tcfg, mel, ref


def test_generator_matches_jax(setup):
    _, port, tcfg, mel, ref = setup
    got = TV.generator_apply(port, tcfg, torch.from_numpy(mel), FRAMES * 256).numpy()
    assert got.shape == ref.shape == (2, 1, FRAMES * 256)
    np.testing.assert_allclose(got, ref, atol=1e-4)


def test_kernel_path_on_cpu_equals_plain(setup):
    _, port, tcfg, mel, _ = setup
    kb = TV.prepare_kernel_params(port, tcfg)
    m = torch.from_numpy(mel)
    np.testing.assert_array_equal(
        TV.generator_apply_kernel(port, kb, tcfg, m, FRAMES * 256).numpy(),
        TV.generator_apply(port, tcfg, m, FRAMES * 256).numpy(),
    )


@pytest.mark.parametrize("path", ["kernel", "direct"])
def test_every_stage_runs_through_the_one_stage_function(setup, path, monkeypatch):
    """On either path, one-shot and streaming over the same mel each make 4
    stage calls a call, all through ``Vocoder.stage``, which finds the
    stacks' function (``amp_stack``, or ``amp_block`` once a block) in
    ``models.vocoder`` when it is called.  One-shot stays bitwise the direct
    path (the kernels' plain version on the CPU), streaming within 1e-5 of
    one-shot (the overlap adds' sums)."""
    from bvsc_tpu_torch import streaming as S

    _, port, tcfg, mel, _ = setup
    m = torch.from_numpy(mel)
    kernel = path == "kernel"
    name = "amp_stack" if kernel else "amp_block"
    calls = {"stage": 0, name: 0}

    def counting(key, fn):
        def inner(*args, **kwargs):
            calls[key] += 1
            return fn(*args, **kwargs)
        return inner

    monkeypatch.setattr(TV.Vocoder, "stage", counting("stage", TV.Vocoder.stage))
    monkeypatch.setattr(TV, name, counting(name, getattr(TV, name)))
    per_stage = 1 if kernel else len(tcfg.resblock_kernel_sizes)
    with torch.no_grad():
        if kernel:
            y = TV.generator_apply_kernel(port, TV.prepare_kernel_params(port, tcfg), tcfg, m,
                                          FRAMES * 256)
        else:
            y = TV.generator_apply(port, tcfg, m, FRAMES * 256)
        assert calls == {"stage": 4, name: 4 * per_stage}
        _, streamed = S.generator_stream_step(TV.prepare_vocoder(port, tcfg, kernel),
                                              S.generator_stream_init(tcfg, 2, "cpu"), m)
        assert calls == {"stage": 8, name: 8 * per_stage}
        monkeypatch.undo()
        assert torch.equal(y, TV.generator_apply(port, tcfg, m, FRAMES * 256))
    assert (streamed - y).abs().max().item() <= 1e-5


def test_weight_norm_params_fold_like_jax():
    """Trainer-style (g, v) params fold to the same inference weights."""
    jcfg = JCodecConfig().vocoder_config
    wn = JV.init_generator_params(jax.random.key(3), jcfg, weight_norm=True)
    ref = jax.tree.map(np.asarray, JV.fold_generator_params(wn))
    got = vocoder_params_from_jax(jax.tree.map(np.asarray, wn))
    flat_ref = jax.tree_util.tree_leaves_with_path(ref)
    flat_got = jax.tree_util.tree_leaves_with_path(jax.tree.map(lambda t: t.numpy(), got))
    assert [p for p, _ in flat_got] == [p for p, _ in flat_ref]
    for (_, a), (_, b) in zip(flat_got, flat_ref):
        np.testing.assert_allclose(a, b, atol=1e-7)


def test_init_shapes_match_jax():
    jcfg = JCodecConfig().vocoder_config
    jp = JV.init_generator_params(jax.random.key(0), jcfg, weight_norm=False)
    tp = TV.init_generator_params(0, CodecConfig().vocoder_config)
    assert jax.tree.map(lambda a: tuple(a.shape), tp) == jax.tree.map(lambda a: tuple(a.shape), jp)


@pytest.mark.parametrize("field,value", [
    ("layers_sym", (True, False, False, False)),
    ("layers_antialias", (False, True, False, False)),
    ("activation", "snake"),
])
def test_variant_configs_run_the_direct_path_only(field, value):
    """The variants init and run on the direct path; the kernels cover the
    causal log-scale SnakeBeta family only, so their path refuses them."""
    import dataclasses

    cfg = dataclasses.replace(CodecConfig().vocoder_config, **{field: value})
    params = TV.init_generator_params(0, cfg)
    y = TV.generator_apply(to_torch(params), cfg, torch.zeros(1, 80, 4) - 5, 4 * 256)
    assert y.shape == (1, 1, 4 * 256) and torch.isfinite(y).all()
    with pytest.raises(ValueError, match="use_pallas"):
        TV.prepare_kernel_params(to_torch(params), cfg)
