"""The direct vocoder path's pieces against ``bvsc_tpu``'s, on the CPU:
``ops.snake`` (``sin_sq_approx``, plain Snake, linear scale), ``ops.resample``
(the kaiser-sinc filter, 2x up- and down-sampling, ``Activation1d``), the
full-width generator in each vocoder variant of ``tests/test_vocoder.py``
(symmetric, plain Snake, anti-aliased) and two more (``lrelu``, linear-scale
snake), one GAN trainer step on a variant, and the direct path under
sequence and pipeline parallelism (gloo ranks on the CPU).

Gates: the polynomial sin^2 < 2e-4 from float64 (the reference's) and
1e-6 from ``bvsc_tpu``'s; the filters bitwise, the resamplers 1e-6 (of the
largest |value| where it is above 1); the
generator 1e-4 (the vocoder gate); the GAN step 1e-5 (``tests/test_torch_gan.py``'s);
SP and PP 1e-5 / 1e-6 from the port's one-shot direct path
(``tests/test_torch_sp.py``'s and ``tests/test_torch_pp.py``'s bounds).
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from bvsc_tpu.config import CodecConfig as JCodecConfig
from bvsc_tpu.models import vocoder as JV
from bvsc_tpu.ops import resample as JR
from bvsc_tpu.ops import snake as JS
from bvsc_tpu.train import vocoder_train as JT
from bvsc_tpu_torch.config import CodecConfig
from bvsc_tpu_torch.convert import flatten_tree, to_torch, vocoder_params_from_jax
from bvsc_tpu_torch.models import bvrnn as B
from bvsc_tpu_torch.models import vocoder as TV
from bvsc_tpu_torch.ops import amp_resblock as AR
from bvsc_tpu_torch.ops import resample as TR
from bvsc_tpu_torch.ops import snake as TS
from bvsc_tpu_torch.train import vocoder_train as TT
from test_torch_gan import ONE_EACH, PARAM_TOL, TRAIN, JaxGAN, audio, cfgs
from torch_parallel_ranks import spawn

torch.set_num_threads(1)

VOC_TOL = 1e-4
RESAMPLE_TOL = 1e-6
FRAMES = 6
WEIGHT_SCALE = 3.0  # conv weights x3 over the init's N(0, 0.01)
POST_SCALE = 20.0  # and conv_post's x20 more: an output of ~0.1-0.5, not the init's ~1e-2
VARIANTS = {
    "symmetric": {"layers_sym": (True,) * 4, "pre_sym": True, "post_sym": True},
    "snake": {"activation": "snake"},
    "antialiased": {"layers_antialias": (True,) * 4, "antialias_post": True},
    "lrelu": {"activation": "lrelu"},
    "linear_scale": {"snake_logscale": False},
}


def variant_params(jcfg, seed: int) -> dict:
    """The JAX init of ``jcfg`` with its conv weights scaled and every snake
    parameter drawn per channel from a numpy seed (log scale N(0, 0.3),
    linear scale its exp, so positive)."""
    tree = jax.tree.map(np.asarray, JV.init_generator_params(jax.random.key(seed), jcfg,
                                                             weight_norm=False))
    rng = np.random.default_rng(seed)
    for block in tree["resblocks"] + [{"acts": [tree["act_post"]]}]:
        for act in block["acts"]:
            for k in act:
                v = rng.standard_normal(act[k].shape) * 0.3
                act[k] = (v if jcfg.snake_logscale else np.exp(v)).astype(np.float32)
    tree = jax.tree_util.tree_map_with_path(
        lambda path, a: a * WEIGHT_SCALE if path[-1].key == "w" else a, tree)
    tree["conv_post"]["w"] = tree["conv_post"]["w"] * POST_SCALE
    return tree


# --- ops.snake ------------------------------------------------------------------------------


def test_sin_sq_approx_accuracy(rng):
    """tests/test_vocoder.py's inputs: < 2e-4 from float64 sin^2, and within
    1e-6 of bvsc_tpu's polynomial."""
    u = np.concatenate([
        rng.standard_normal(100000).astype(np.float32) * 3,
        rng.standard_normal(10000).astype(np.float32) * 30,
        np.linspace(-300, 300, 10000, dtype=np.float32),
    ])
    got = TS.sin_sq_approx(torch.from_numpy(u)).numpy()
    assert np.abs(got.astype(np.float64) - np.sin(np.float64(u)) ** 2).max() < 2e-4
    assert np.abs(got - np.asarray(JS.sin_sq_approx(jnp.asarray(u)))).max() <= 1e-6


def test_sin_sq_approx_rounds_half_to_even():
    """u / pi at exactly k + 0.5 rounds to the even k, as jnp.round does."""
    u = torch.tensor([0.5, 1.5, 2.5, -0.5, -2.5], dtype=torch.float64) * np.pi
    r = u - np.pi * torch.round(u / np.pi)
    assert torch.equal(torch.round(u / np.pi), torch.tensor([0.0, 2.0, 2.0, -0.0, -2.0],
                                                             dtype=torch.float64))
    assert (r.abs() <= np.pi / 2 + 1e-12).all()


@pytest.mark.parametrize("kind", ["snake", "snakebeta", "lrelu"])
@pytest.mark.parametrize("logscale", [True, False])
@pytest.mark.parametrize("approx", [False, True])
def test_activation_matches_jax(kind, logscale, approx):
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((2, 16, 64)) * 3).astype(np.float32)
    p = JS.init_snake_params(16, beta=kind == "snakebeta", logscale=logscale)
    p = {k: (rng.standard_normal(16) * 0.3 + (0 if logscale else 1)).astype(np.float32)
         for k in p}
    ref = np.asarray(JS.apply_activation(jnp.asarray(x), jax.tree.map(jnp.asarray, p),
                                         kind=kind, logscale=logscale, approx=approx))
    got = TS.apply_activation(torch.from_numpy(x), to_torch(p), kind=kind, logscale=logscale,
                              approx=approx).numpy()
    assert np.abs(got - ref).max() <= 1e-5 * max(1.0, np.abs(ref).max())
    prep = TS.prepare_act(to_torch(p), kind=kind, logscale=logscale)
    got = TS.apply_activation(torch.from_numpy(x), prep, kind=kind, logscale=logscale,
                              approx=approx).numpy()
    assert np.abs(got - ref).max() <= 1e-5 * max(1.0, np.abs(ref).max())


def test_prepare_act_is_the_kernels_snake_params():
    """The direct path's prepared snake parameters are bitwise the packed
    blocks' (so the causal float32 direct path is the kernels' plain
    version)."""
    rng = np.random.default_rng(6)
    acts = [{"alpha": torch.from_numpy(rng.standard_normal(8).astype(np.float32) * 0.3),
             "beta": torch.from_numpy(rng.standard_normal(8).astype(np.float32) * 0.3)}
            for _ in range(6)]
    alpha, inv_beta = AR.snake_params(acts)
    for j, a in enumerate(acts):
        p = TS.prepare_act(a, kind="snakebeta", logscale=True)
        assert torch.equal(p["alpha"], alpha[j]) and torch.equal(p["inv_beta"], inv_beta[j])


def test_init_snake_params():
    assert {k: v.tolist() for k, v in TS.init_snake_params(2, beta=True, logscale=True).items()} \
        == {"alpha": [0.0, 0.0], "beta": [0.0, 0.0]}
    assert {k: v.tolist() for k, v in TS.init_snake_params(2, beta=False, logscale=False).items()} \
        == {"alpha": [1.0, 1.0]}


# --- ops.resample ---------------------------------------------------------------------------


@pytest.mark.parametrize("args", [(0.25, 0.3, 12), (0.5, 0.6, 12), (0.25, 0.3, 11),
                                  (0.1, 0.05, 32), (0.0, 0.3, 12)])
def test_kaiser_filter_bitwise(args):
    got = TR.kaiser_sinc_filter1d(*args)
    ref = JR.kaiser_sinc_filter1d(*args)
    assert got.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("name", ["UpSample1d", "DownSample1d", "Activation1d", "LowPassFilter1d"])
def test_resample_matches_jax(name):
    x = (np.random.default_rng(7).standard_normal((2, 8, 50)) * 2).astype(np.float32)
    if name == "Activation1d":
        p = {"alpha": np.full(8, 0.2, np.float32), "beta": np.full(8, -0.1, np.float32)}
        jf = JR.Activation1d(lambda v: JS.snake_beta(v, jax.tree.map(jnp.asarray, p),
                                                     logscale=True))
        tf = TR.Activation1d(lambda v: TS.snake_beta(v, to_torch(p), logscale=True))
    elif name == "LowPassFilter1d":
        jf, tf = JR.LowPassFilter1d(0.2, 0.1, 2, kernel_size=11), TR.LowPassFilter1d(
            0.2, 0.1, 2, kernel_size=11)
    else:
        jf, tf = getattr(JR, name)(2), getattr(TR, name)(2)
    ref = np.asarray(jf(jnp.asarray(x)))
    got = tf(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape
    # of the largest |value| where above 1: Activation1d's snake takes sin
    # of values up to ~6, whose float32 results differ by a few ulp
    assert np.abs(got - ref).max() <= RESAMPLE_TOL * max(1.0, np.abs(ref).max())


# --- the generator --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def mel():
    return (np.random.default_rng(0).standard_normal((2, 80, FRAMES)) - 5).astype(np.float32)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_generator_variant_matches_jax(variant, mel):
    """The full-width generator of each variant: the direct path within
    1e-4 of bvsc_tpu's generator_apply at HIGHEST."""
    jcfg = dataclasses.replace(JCodecConfig().vocoder_config, **VARIANTS[variant])
    tcfg = dataclasses.replace(CodecConfig().vocoder_config, **VARIANTS[variant])
    tree = variant_params(jcfg, seed=1)
    ref = np.asarray(jax.jit(lambda p, m: JV.generator_apply(
        p, jcfg, m, None, precision=jax.lax.Precision.HIGHEST))(tree, jnp.asarray(mel)))
    with torch.no_grad():
        got = TV.generator_apply(vocoder_params_from_jax(tree), tcfg, torch.from_numpy(mel)).numpy()
    assert got.shape == ref.shape and np.isfinite(got).all()
    assert np.abs(ref).max() > 0.05  # a signal, not the init's near-silence
    assert np.abs(got - ref).max() <= VOC_TOL


@pytest.mark.parametrize("bf16", [False, True])
def test_generator_approx_snake_matches_jax(mel, bf16):
    """approx_snake on the default config, float32 and with the reference's
    bf16 vocoder segment (params and mel cast, HIGHEST on bf16 operands):
    float32 within the vocoder gate, bf16 within the fast contract (2e-2)."""
    jcfg, tcfg = JCodecConfig().vocoder_config, CodecConfig().vocoder_config
    tree = variant_params(jcfg, seed=2)
    dt = jnp.bfloat16 if bf16 else jnp.float32
    ref = np.asarray(jax.jit(lambda p, m: JV.generator_apply(
        jax.tree.map(lambda a: a.astype(dt), p), jcfg, m.astype(dt), None,
        precision=jax.lax.Precision.HIGHEST, approx_snake=True).astype(jnp.float32))(
        tree, jnp.asarray(mel)))
    tdt = torch.bfloat16 if bf16 else torch.float32
    params = TV.prepare_direct_params(vocoder_params_from_jax(tree), tcfg, tdt)
    with torch.no_grad():
        got = TV.generator_apply(params, tcfg, torch.from_numpy(mel).to(tdt),
                                 approx_snake=True).float().numpy()
    assert np.abs(got - ref).max() <= (2e-2 if bf16 else VOC_TOL)


def test_direct_path_is_the_kernel_paths_plain_version(mel):
    """Causal float32: prepared once or on every call, the direct path is
    bitwise generator_apply_kernel on the CPU (the kernels' plain blocks)."""
    tcfg = CodecConfig().vocoder_config
    params = vocoder_params_from_jax(variant_params(JCodecConfig().vocoder_config, seed=3))
    m = torch.from_numpy(mel)
    with torch.no_grad():
        ref = TV.generator_apply_kernel(params, TV.prepare_kernel_params(params, tcfg), tcfg, m)
        assert torch.equal(TV.generator_apply(params, tcfg, m), ref)
        assert torch.equal(TV.generator_apply(TV.prepare_direct_params(params, tcfg), tcfg, m),
                           ref)


def test_variant_gan_step_matches_jax():
    """One step of the GAN trainer (D frozen: the mel-loss G step) on a
    symmetric, anti-aliased, linear-scale Snake generator: metrics within
    1e-5 relative, every generator parameter within 1e-5 of bvsc_tpu's."""
    variant = dict(layers_sym=(True, True), pre_sym=True, post_sym=True,
                   layers_antialias=(True, False), antialias_post=True, activation="snake",
                   snake_logscale=False)
    jcfg, tcfg = cfgs(**ONE_EACH, **variant)
    jtc = JT.GANTrainConfig(freeze_step=1, **TRAIN)
    rng = np.random.default_rng(3)
    from bvsc_tpu_torch.models import discriminators as TD

    gen = TV.init_generator_params(3, tcfg, weight_norm=True)
    for block in gen["resblocks"] + [{"acts": [gen["act_post"]]}]:
        for act in block["acts"]:
            act["alpha"] = np.exp(rng.standard_normal(act["alpha"].shape) * 0.3).astype(np.float32)
    weights = (gen, TD.init_mpd_params(rng, tcfg), TD.init_mrd_params(rng, tcfg))
    jtr = JaxGAN(jcfg, jtc, *jax.tree.map(jnp.asarray, weights))
    ttr = TT.VocoderGANTrainer(tcfg, TT.GANTrainConfig(**dataclasses.asdict(jtc)),
                               gen_params=weights[0], mpd_params=weights[1],
                               mrd_params=weights[2], device="cpu")
    y = audio(8)[:, 0]
    jm, tm = jtr.step_on_audio(y), ttr.step_on_audio(y)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, atol=1e-6, err_msg=k)
    ref = flatten_tree(jax.tree.map(np.asarray, jtr.state.gen))
    got = flatten_tree(ttr.gen)
    assert sorted(got) == sorted(ref) and any("acts" in k for k in got)
    init = flatten_tree(gen)
    moved = 0
    for k, r in ref.items():
        np.testing.assert_allclose(got[k].detach().numpy(), r, atol=PARAM_TOL, err_msg=k)
        moved += not np.array_equal(r, init[k])
    assert moved > len(ref) // 2  # the step moved the generator


# --- the direct path under SP and PP ---------------------------------------------------------


@pytest.fixture(scope="module")
def wide():
    jcfg = JCodecConfig().vocoder_config
    tree = variant_params(jcfg, seed=4)
    mel = (np.random.default_rng(1).standard_normal((1, jcfg.num_mels, 32)) - 4.0
           ).astype(np.float32)
    return CodecConfig().vocoder_config, vocoder_params_from_jax(tree), mel


@pytest.mark.parametrize("kw", [{"use_pallas": False}, {"approx_snake": True}],
                         ids=["exact", "approx"])
def test_sp_direct_path(wide, kw, tmp_path):
    """Two seq ranks on the direct path (exact snake, and approx_snake,
    which picks it), full width, 16 frames a shard: within 1e-5 of the
    one-shot direct generator, and the kernel path with approx_snake
    refused."""
    from bvsc_tpu_torch.parallel import sp as SP

    cfg, params, mel = wide
    approx = kw.get("approx_snake", False)
    with torch.no_grad():
        ref = TV.generator_apply(params, cfg, torch.from_numpy(mel), mel.shape[-1] * 256,
                                 approx_snake=approx).numpy()
    outs = spawn(2, tmp_path, "sp", "1d", params, cfg, mel, kw)
    for got in outs:
        assert got.shape == ref.shape
        assert np.abs(got - ref).max() <= 1e-5
    with pytest.raises(ValueError, match="approx_snake"):
        SP.direct_path(True, True)


def test_pp_direct_path(wide, tmp_path):
    """pipeline_resynth with approx_snake on two pipe ranks: codes bitwise,
    waveforms within 1e-6 of encode_decode + the one-shot direct generator."""
    cfg, vparams, _ = wide
    bcfg = {"x_dim": 80, "h_dim": 48, "z_dim": 12}
    bparams = B.init_bvrnn_params(0, B.BVRNNConfig(**bcfg))
    rng = np.random.default_rng(5)
    mel_mb = (rng.standard_normal((2, 2, 8, 80)) - 4).astype(np.float32)
    bits_mb = rng.integers(1, 13, (2, 2, 8)).astype(np.float32)
    outs = spawn(2, tmp_path, "pp", "1d", bparams, bcfg, vparams, cfg, mel_mb, bits_mb,
                 {"approx_snake": True})
    model = B.prepare(to_torch(bparams), B.BVRNNConfig(**bcfg))
    with torch.no_grad():
        for i in range(2):
            z, mel, _ = B.encode_decode(model, B.BVRNNConfig(**bcfg), torch.from_numpy(mel_mb[i]),
                                        torch.from_numpy(bits_mb[i]), torch.zeros(2, 48))
            wav = TV.generator_apply(vparams, cfg, mel.transpose(1, 2).contiguous(), 8 * 256,
                                     approx_snake=True).numpy()
            for out in outs:
                np.testing.assert_array_equal(out["codes"][i], z.numpy())
                assert np.abs(out["wav"][i] - wav).max() <= 1e-6
