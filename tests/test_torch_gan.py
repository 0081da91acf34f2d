"""The port's GAN training (``bvsc_tpu_torch.models.discriminators``,
``models.losses``, ``ops.stft_loss``, the weight-normed generator and
``train.vocoder_train``) against ``bvsc_tpu``'s on the same weights, at a
narrow generator and quarter-width discriminators (the shapes of
``tests/test_gan.py``)."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from bvsc_tpu.config import VocoderConfig as JVC
from bvsc_tpu.models import discriminators as JD
from bvsc_tpu.models import losses as JL
from bvsc_tpu.models import vocoder as JV
from bvsc_tpu.ops import conv as JC
from bvsc_tpu.ops.mel import MelFrontend as JMel
from bvsc_tpu.ops.stft_loss import multi_resolution_stft_loss as j_mrstft
from bvsc_tpu.train import vocoder_train as JT
from bvsc_tpu_torch.config import VocoderConfig as TVC
from bvsc_tpu_torch.convert import (discriminator_params_from_jax, flatten_tree,
                                    generator_train_params_from_jax, to_torch)
from bvsc_tpu_torch.models import discriminators as TD
from bvsc_tpu_torch.models import losses as TL
from bvsc_tpu_torch.models import vocoder as TV
from bvsc_tpu_torch.ops import conv as TC
from bvsc_tpu_torch.ops.stft_loss import multi_resolution_stft_loss as t_mrstft
from bvsc_tpu_torch.train import vocoder_train as TT

torch.set_num_threads(1)

NARROW = dict(
    mpd_reshapes=(2, 3), resolutions=((128, 32, 64), (256, 64, 128), (512, 128, 256)),
    discriminator_channel_mult=0.25, num_mels=8, upsample_initial_channel=8,
    upsample_rates=(4, 2), upsample_kernel_sizes=(8, 4), resblock_kernel_sizes=(3,),
    resblock_dilation_sizes=((1, 2),), layers_sym=(False, False),
    layers_antialias=(False, False))
TRAIN = dict(segment_size=1024, batch_size=2, hop_size=8, n_fft=64, win_size=64,
             mel_pad_left=16, fmax=4000.0)
DISC_TOL = 1e-5  # of the largest |value| of the tensor compared
GRAD_RTOL = 1e-4
PARAM_TOL = 1e-5
# the trainer runs take one period and one resolution: the JAX step's
# compile time grows with every sub-discriminator
ONE_EACH = dict(mpd_reshapes=(3,), resolutions=((128, 32, 64),))
NORMS = {"weight_norm": {}, "spectral_norm": {"use_spectral_norm": True},
         "mrd_spectral_override": {"mrd_use_spectral_norm": True, "mrd_channel_mult": 0.5}}


def cfgs(**kw):
    return JVC(**{**NARROW, **kw}), TVC(**{**NARROW, **kw})


def close(got, ref, tol=DISC_TOL, what=""):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    assert np.abs(got - ref).max() <= tol * max(1.0, np.abs(ref).max()), what


def audio(seed, batch=2, length=1024):
    return (np.random.default_rng(seed).standard_normal((batch, 1, length)) * 0.3).astype(np.float32)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_disc(kind, norm):
    """Jitted ``bvsc_tpu`` (init, apply) of one discriminator kind and norm."""
    jcfg, _ = cfgs(**NORMS[norm])
    init = JD.init_mpd_params if kind == "mpd" else JD.init_mrd_params
    apply = JD.mpd_apply if kind == "mpd" else JD.mrd_apply
    return (jax.jit(lambda k: init(k, jcfg)),
            jax.jit(lambda p, y, yh: apply(p, jcfg, y, yh)))


@pytest.fixture(scope="module")
def jax_fns():
    """``bvsc_tpu``'s jitted functions, each built once for the module per
    configuration: ``jax_fns(make, *config)``."""
    cache = {}

    def get(make, *key):
        if (make, *key) not in cache:
            cache[(make, *key)] = make(*key)
        return cache[(make, *key)]

    return get


def test_losses_match_jax():
    rng = np.random.default_rng(0)
    r = [rng.standard_normal((2, n)).astype(np.float32) for n in (5, 9)]
    g = [rng.standard_normal((2, n)).astype(np.float32) for n in (5, 9)]
    fr = [[rng.standard_normal((2, 3, 4)).astype(np.float32)] * 2 for _ in range(2)]
    fg = [[rng.standard_normal((2, 3, 4)).astype(np.float32)] * 2 for _ in range(2)]
    t = lambda xs: [torch.from_numpy(x) for x in xs]  # noqa: E731
    j = lambda xs: [jnp.asarray(x) for x in xs]  # noqa: E731
    np.testing.assert_allclose(float(TL.discriminator_loss(t(r), t(g))[0]),
                               float(JL.discriminator_loss(j(r), j(g))[0]), rtol=1e-6)
    np.testing.assert_allclose(float(TL.generator_loss(t(g))[0]),
                               float(JL.generator_loss(j(g))[0]), rtol=1e-6)
    np.testing.assert_allclose(float(TL.feature_loss([t(x) for x in fr], [t(x) for x in fg])),
                               float(JL.feature_loss([j(x) for x in fr], [j(x) for x in fg])),
                               rtol=1e-6)


def test_mrstft_matches_jax():
    y = np.random.default_rng(1).standard_normal((2, 4096)).astype(np.float32)
    yh = np.random.default_rng(2).standard_normal((2, 4096)).astype(np.float32)
    np.testing.assert_allclose(float(t_mrstft(torch.from_numpy(yh), torch.from_numpy(y))),
                               float(j_mrstft(jnp.asarray(yh), jnp.asarray(y))), rtol=1e-5)
    assert float(t_mrstft(torch.from_numpy(y), torch.from_numpy(y))) < 1e-3


@pytest.mark.parametrize("resolution", NARROW["resolutions"] + ((1024, 120, 600),))
def test_mrd_spectrogram_matches_highest(resolution):
    """The framed DFT against bvsc_tpu's at Precision.HIGHEST."""
    x = audio(3, length=4000)
    ref = JD._resolution_spectrogram(jnp.asarray(x), resolution)
    close(TD.resolution_spectrogram(torch.from_numpy(x), resolution).numpy(), ref, 1e-5)


@pytest.mark.parametrize("norm", list(NORMS))
def test_init_shapes_match_jax(norm):
    jcfg, tcfg = cfgs(**NORMS[norm])
    for jinit, tinit in ((JD.init_mpd_params, TD.init_mpd_params),
                         (JD.init_mrd_params, TD.init_mrd_params)):
        ref = {k: v.shape for k, v in flatten_tree(
            jax.eval_shape(lambda: jinit(jax.random.key(0), jcfg))).items()}
        got = {k: v.shape for k, v in flatten_tree(tinit(np.random.default_rng(0), tcfg)).items()}
        assert got == ref
    gen_ref = flatten_tree(jax.eval_shape(
        lambda: JV.init_generator_params(jax.random.key(0), jcfg, weight_norm=True)))
    gen = flatten_tree(TV.init_generator_params(0, tcfg, weight_norm=True))
    assert {k: v.shape for k, v in gen.items()} == {k: v.shape for k, v in gen_ref.items()}


@pytest.mark.parametrize("norm", list(NORMS))
@pytest.mark.parametrize("kind", ["mpd", "mrd"])
def test_discriminators_match_jax(jax_fns, kind, norm):
    """Logits and every feature map, real and generated."""
    _, tcfg = cfgs(**NORMS[norm])
    tapply = TD.mpd_apply if kind == "mpd" else TD.mrd_apply
    jinit, japply = jax_fns(_jax_disc, kind, norm)
    jp = jinit(jax.random.key(1))
    y, yh = audio(4, length=1000), audio(5, length=1000)
    ref = japply(jp, jnp.asarray(y), jnp.asarray(yh))
    got = tapply(discriminator_params_from_jax(_np(jp)), tcfg, torch.from_numpy(y),
                 torch.from_numpy(yh))
    for i in (0, 1):
        for a, b in zip(got[i], ref[i]):
            close(a.numpy(), b, what=f"logits {i}")
    for i in (2, 3):
        for fa, fb in zip(got[i], ref[i]):
            for a, b in zip(fa, fb):
                close(a.numpy(), b, what=f"fmap {i}")


def test_power_iteration_matches_jax():
    jcfg, _ = cfgs(use_spectral_norm=True)
    jp = JD.init_mrd_params(jax.random.key(2), jcfg)
    ref = _np(JC.spectral_norm_power_iteration(JC.spectral_norm_power_iteration(jp)))
    got = TC.spectral_norm_power_iteration(TC.spectral_norm_power_iteration(
        discriminator_params_from_jax(_np(jp))))
    ref_flat, got_flat = flatten_tree(ref), flatten_tree(got)
    assert set(got_flat) == set(ref_flat)
    for name, r in ref_flat.items():
        np.testing.assert_allclose(got_flat[name].numpy(), r, atol=1e-6, err_msg=name)
    conv = got[0]["convs"][1]
    ref_conv = ref[0]["convs"][1]
    close(TC.spectral_norm_weight(conv).numpy(),
          np.asarray(JC.spectral_norm_weight(jax.tree.map(jnp.asarray, ref_conv))), 1e-6)
    mask = flatten_tree(TC.spectral_norm_trainable_mask(got))
    assert all(mask[k] == (k.split("/")[-1] not in ("sn_u", "sn_v")) for k in mask)
    assert not all(mask.values())


def _g_loss_jax(jcfg, tcfg_j, gen, d, mel, y, y_mel):
    loss_fe = JMel(sampling_rate=tcfg_j.sampling_rate, n_fft=tcfg_j.n_fft,
                   hop_size=tcfg_j.hop_size, win_size=tcfg_j.win_size, fmin=tcfg_j.fmin,
                   fmax=tcfg_j.sampling_rate / 2, padding_left=tcfg_j.mel_pad_left,
                   num_mels=jcfg.num_mels)
    y_hat = JV.generator_apply(gen, jcfg, mel, y.shape[-1])
    loss = jnp.mean(jnp.abs(y_mel - loss_fe(y_hat[:, 0]))) * 45.0
    _, g_f, fr_f, fg_f = JD.mpd_apply(d["mpd"], jcfg, y, y_hat)
    _, g_s, fr_s, fg_s = JD.mrd_apply(d["mrd"], jcfg, y, y_hat)
    return (loss + JL.generator_loss(g_s)[0] + JL.generator_loss(g_f)[0]
            + JL.feature_loss(fr_s, fg_s) + JL.feature_loss(fr_f, fg_f))


def _jax_g_grad():
    """Jitted gradient of ``bvsc_tpu``'s G loss in the generator's leaves."""
    jcfg, _ = cfgs(**ONE_EACH)
    jtc = JT.GANTrainConfig(**TRAIN)
    return jax.jit(jax.grad(lambda g, d, mel, y, y_mel: _g_loss_jax(jcfg, jtc, g, d, mel, y, y_mel)))


def test_generator_grads_match_jax(jax_fns):
    """The G loss's gradient in every weight-normed generator leaf (g, v, the
    biases, the snake parameters) against jax.grad."""
    _, tcfg = cfgs(**ONE_EACH)
    tc = TT.GANTrainConfig(**TRAIN)
    rng = np.random.default_rng(9)
    gen = jax.tree.map(lambda a: jnp.asarray(a + 0.05 * rng.standard_normal(a.shape), jnp.float32),
                       TV.init_generator_params(3, tcfg, weight_norm=True))
    d = jax.tree.map(jnp.asarray, {"mpd": TD.init_mpd_params(rng, tcfg),
                                   "mrd": TD.init_mrd_params(rng, tcfg)})
    y = audio(6)
    mel = (np.random.default_rng(7).standard_normal((2, 8, 128)) - 3).astype(np.float32)
    trainer = TT.VocoderGANTrainer(
        tcfg, tc, gen_params=generator_train_params_from_jax(_np(gen)),
        mpd_params=discriminator_params_from_jax(_np(d["mpd"])),
        mrd_params=discriminator_params_from_jax(_np(d["mrd"])), device="cpu")
    y_mel = trainer.loss_frontend(torch.from_numpy(y[:, 0]))[..., :128]
    ref = jax_fns(_jax_g_grad)(gen, d, jnp.asarray(mel), jnp.asarray(y), jnp.asarray(y_mel.numpy()))
    y_hat = TV.generator_apply(trainer.gen, tcfg, torch.from_numpy(mel), 1024)
    loss = torch.mean(torch.abs(y_mel - trainer.loss_frontend(y_hat[:, 0]))) * 45.0
    _, g_f, fr_f, fg_f = TD.mpd_apply(trainer.mpd, tcfg, torch.from_numpy(y), y_hat)
    _, g_s, fr_s, fg_s = TD.mrd_apply(trainer.mrd, tcfg, torch.from_numpy(y), y_hat)
    loss = (loss + TL.generator_loss(g_s)[0] + TL.generator_loss(g_f)[0]
            + TL.feature_loss(fr_s, fg_s) + TL.feature_loss(fr_f, fg_f))
    names, leaves = list(flatten_tree(trainer.gen)), list(flatten_tree(trainer.gen).values())
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    ref_flat = flatten_tree(_np(ref))
    for name, g in zip(names, grads):
        r = ref_flat[name]
        g = np.zeros_like(r) if g is None else g.numpy()
        err = np.abs(g - r).max() / max(np.abs(r).max(), 1e-12) if np.abs(r).max() else np.abs(g).max()
        assert err <= GRAD_RTOL, (name, err)
    assert any(n.endswith("/g") for n in names) and any("acts" in n for n in names)


class JaxGAN:
    """``bvsc_tpu``'s GAN step (``make_gan_train_step``, jitted) on a state
    built from the given weights as its ``VocoderGANTrainer`` builds it,
    with that trainer's ``step_on_audio`` and ``set_epoch``."""

    def __init__(self, vcfg, tcfg, gen, mpd, mrd):
        opt_g, opt_d = JT._make_optimizer(tcfg), JT._make_optimizer(tcfg)

        def init(gen, mpd, mrd):
            return JT.GANTrainState(gen, mpd, mrd, opt_g.init(gen),
                                    opt_d.init({"mpd": mpd, "mrd": mrd}),
                                    jnp.zeros((), jnp.int32))

        self.tcfg = tcfg
        self.state = jax.jit(init)(gen, mpd, mrd)
        d_step, g_step = JT.make_gan_train_step(tcfg, vcfg, opt_g, opt_d)
        self.d_step, self.g_step = jax.jit(d_step), jax.jit(g_step)

        def fe(fmax):
            return JMel(sampling_rate=tcfg.sampling_rate, n_fft=tcfg.n_fft,
                        hop_size=tcfg.hop_size, win_size=tcfg.win_size, fmin=tcfg.fmin,
                        fmax=fmax, padding_left=tcfg.mel_pad_left, num_mels=vcfg.num_mels)

        self.mels = jax.jit(lambda y: (fe(tcfg.fmax)(y), fe(tcfg.sampling_rate / 2)(y)))

    def set_epoch(self, epoch):
        lr = jnp.asarray(self.tcfg.learning_rate * self.tcfg.lr_decay ** epoch)
        self.state.opt_g.hyperparams["learning_rate"] = lr
        self.state.opt_d.hyperparams["learning_rate"] = lr

    def step_on_audio(self, y, mel_in=None):
        y = jnp.asarray(y)
        mel, mel_loss = self.mels(y)
        T = y.shape[-1] // self.tcfg.hop_size
        mel = mel[..., :T] if mel_in is None else jnp.asarray(mel_in)[..., :T]
        self.state, d_metrics = self.d_step(self.state, mel, y[:, None, :])
        self.state, g_metrics = self.g_step(self.state, mel, y[:, None, :], mel_loss[..., :T])
        return {**d_metrics, **g_metrics}


@pytest.fixture(scope="module", params=["weight_norm", "spectral_norm"])
def gan_runs(request):
    """bvsc_tpu's GAN step and the port's trainer from the same weights,
    freeze_step 1: step 0 on y (D frozen), then set_epoch(3) and step 1 on y
    with a fine-tuning mel_in; the parameters of both after each step."""
    jcfg, tcfg = cfgs(**ONE_EACH, **NORMS[request.param])
    jtc = JT.GANTrainConfig(freeze_step=1, **TRAIN)
    rng = np.random.default_rng(3)
    weights = (TV.init_generator_params(3, tcfg, weight_norm=True),
               TD.init_mpd_params(rng, tcfg), TD.init_mrd_params(rng, tcfg))
    jtr = JaxGAN(jcfg, jtc, *jax.tree.map(jnp.asarray, weights))
    ttr = TT.VocoderGANTrainer(tcfg, TT.GANTrainConfig(**dataclasses.asdict(jtc)),
                               gen_params=weights[0], mpd_params=weights[1],
                               mrd_params=weights[2], device="cpu")
    y = audio(8)[:, 0]
    mel_in = (np.random.default_rng(9).standard_normal((2, 8, 130)) - 4).astype(np.float32)

    def snap():
        """(reference, port) parameters by flat name, and the reference's D
        first moments (mu = (1 - b1) g after the first D update)."""
        ref = flatten_tree(_np({"gen": jtr.state.gen, "mpd": jtr.state.mpd,
                                "mrd": jtr.state.mrd}))
        got = {k: v.detach().numpy().copy() for k, v in flatten_tree(
            {"gen": ttr.gen, "mpd": ttr.mpd, "mrd": ttr.mrd}).items()}
        ref["mu_d"] = flatten_tree(_np(jtr.state.opt_d.inner_state[1][0].mu))
        got["mu_d"] = {n: m.numpy().copy() for n, m in zip(ttr._d.names, ttr.opt_d.mu)}
        return ref, got

    start = snap()
    steps = [(jtr.step_on_audio(y), ttr.step_on_audio(y), snap())]
    jtr.set_epoch(3)
    ttr.set_epoch(3)
    steps.append((jtr.step_on_audio(y, mel_in), ttr.step_on_audio(y, mel_in), snap()))
    return start, steps, ttr


# Adam moves a weight by lr * g / (|g| + eps): where |g| is within a few eps
# (1e-8) of 0, float32 noise in g (~2e-9 in sums of terms ~0.1) moves the
# weight by up to lr / 2 = 5e-5.  Such weights are held by their gradient.
ILL_CONDITIONED_G = 1e-7


def test_gan_steps_match_jax(gan_runs):
    """make_gan_train_step's D and G step (D frozen), then one of each with
    D training on a fine-tuning mel: the metrics within 1e-5 relative, every
    parameter and buffer within 1e-5, the D gradients (from Adam's first
    moment) within 1e-4 of each leaf's largest, and a D weight whose
    gradient is below ILL_CONDITIONED_G held by that gradient alone."""
    _, steps, _ = gan_runs
    b1 = TT.GANTrainConfig().adam_b1
    for i, (jm, tm, (ref, got)) in enumerate(steps):
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, atol=1e-6,
                                       err_msg=f"step {i} {k}")
        ill = {}
        for name, mu in got["mu_d"].items():  # the spectral-norm buffers take no update
            g_ref, g = ref["mu_d"][name] / (1 - b1), mu / (1 - b1)
            assert np.abs(g - g_ref).max() <= GRAD_RTOL * max(np.abs(g_ref).max(), 1e-12), name
            ill[name] = np.abs(g_ref) < ILL_CONDITIONED_G
        for name, r in ref.items():
            if name == "mu_d":
                continue
            keep = ~ill.get(name, np.zeros(r.shape, bool)) if i else np.ones(r.shape, bool)
            np.testing.assert_allclose(got[name][keep], r[keep], atol=PARAM_TOL,
                                       err_msg=f"step {i} {name}")


def test_freeze_step(gan_runs):
    """D unchanged while frozen (spectral-norm buffers aside), changed after;
    the generator changes at both steps."""
    start, steps, trainer = gan_runs
    (_, _, (_, s0)), (_, _, (_, s1)) = steps
    disc = [k for k in start[1] if k.startswith(("mpd/", "mrd/"))
            and not k.endswith(("sn_u", "sn_v"))]
    assert all(np.array_equal(start[1][k], s0[k]) for k in disc)
    assert any(not np.array_equal(s0[k], s1[k]) for k in disc)
    gen = [k for k in start[1] if k.startswith("gen/")]
    assert any(not np.array_equal(start[1][k], s0[k]) for k in gen)
    assert trainer.step_count == 2 and trainer.opt_d.count == 1 and trainer.opt_g.count == 2


def test_set_epoch_learning_rate(gan_runs):
    *_, trainer = gan_runs
    assert trainer.epoch == 3
    assert trainer.opt_g.lr == trainer.opt_d.lr == pytest.approx(1e-4 * 0.999 ** 3, rel=1e-12)
    assert trainer.opt_g.lr_at(0) == float(np.float32(1e-4 * 0.999 ** 3))


def test_remat_gives_equal_gradients():
    _, tcfg = cfgs()
    gen = to_torch(TV.init_generator_params(2, tcfg, weight_norm=True))
    leaves = list(flatten_tree(gen).values())
    for p in leaves:
        p.requires_grad_(True)
    mel = torch.randn(2, 8, 16, generator=torch.Generator().manual_seed(0)) - 3
    target = torch.randn(2, 1, 128, generator=torch.Generator().manual_seed(1))
    grads = []
    for remat in (False, True):
        y = TV.generator_apply(gen, tcfg, mel, 128, remat=remat)
        grads.append(torch.autograd.grad(((y - target) ** 2).mean(), leaves, allow_unused=True))
    for a, b in zip(*grads):
        assert (a is None and b is None) or torch.equal(a, b)
    assert sum(a is not None for a in grads[0]) > len(leaves) // 2


def test_weight_norm_round_trip():
    """unfold then fold gives the folded weights back; the training and the
    inference generator agree on folded weights."""
    _, tcfg = cfgs()
    folded = to_torch(TV.init_generator_params(4, tcfg))
    wn = TV.unfold_generator_params(folded)
    assert TV.is_weight_normed(wn) and not TV.is_weight_normed(folded)
    back = flatten_tree(TV.fold_generator_params(wn))
    for k, v in flatten_tree(folded).items():
        np.testing.assert_allclose(back[k].numpy(), v.numpy(), rtol=1e-6, atol=1e-9)
    mel = torch.randn(1, 8, 8) - 3
    np.testing.assert_allclose(TV.generator_apply(wn, tcfg, mel).numpy(),
                               TV.generator_apply(folded, tcfg, mel).numpy(), atol=1e-6)


def test_gan_trainer_needs_a_card_by_default():
    _, tcfg = cfgs()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TT.VocoderGANTrainer(tcfg, TT.GANTrainConfig(**TRAIN))
