"""The port's BVRNN training (``bvsc_tpu_torch.models.bvrnn.forward_train``,
``bvsc_tpu_torch.train.bvrnn_train``) against ``bvsc_tpu``'s at the small
config (h 48, z 12), on the same weights and the same random draws: the
draws ``jax.random`` makes from the reference's keys are passed to the port
as tensors.  The port's own draws are checked by their distributions."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from bvsc_tpu.config import CodecConfig as JConf
from bvsc_tpu.models import bvrnn as jb
from bvsc_tpu.train import bvrnn_train as jt
from bvsc_tpu_torch.config import CodecConfig as TConf
from bvsc_tpu_torch.convert import bvrnn_params_from_jax, flatten_tree
from bvsc_tpu_torch.models import bvrnn as tb
from bvsc_tpu_torch.train import bvrnn_train as tt
from bvsc_tpu_torch.train import checkpoint as ckpt

torch.set_num_threads(1)

X, H, Z = 12, 48, 12
B, T = 3, 10
MEL_TOL, KLD_TOL = 2e-5, 1e-5
GRAD_RTOL = 1e-4
PARAM_TOL = 1e-5
# the reference's own bound between two numerics of one objective
# (tests/test_bvrnn_train.py, fused against standard first loss)
LOSS_RTOL_LOOSE = 0.05
SMALL = dict(num_mels=X, h_dim=H, z_dim=Z, batch_size=B, learning_rate=1e-3,
             teacher_force_step_1perc=2)


def _tree_np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def jparams():
    mean_std = (np.random.default_rng(1).standard_normal(X) * 0.1,
                np.abs(np.random.default_rng(2).standard_normal(X)) + 0.5)
    return jb.init_bvrnn_params(jax.random.key(0), jb.BVRNNConfig(x_dim=X, h_dim=H, z_dim=Z),
                                mean_std)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(7)
    mel = rng.standard_normal((B, T, X)).astype(np.float32)
    bits = rng.integers(1, Z + 1, size=(B, T)).astype(np.float32)
    return mel, bits


def jax_noise(key, p_use_gen, dtype=jnp.float32):
    """The draws ``bvsc_tpu``'s forward_train makes from ``key``."""
    k_sched, k_bin = jax.random.split(key)
    use_gen = jax.random.uniform(k_sched, (T,)) < p_use_gen
    noise = jax.random.uniform(k_bin, (T, B, Z), dtype)
    return torch.from_numpy(np.asarray(use_gen)), torch.from_numpy(
        np.asarray(noise.astype(jnp.float32))).to(
        torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)


def jax_step_draws(conf, key, step, mel_mask):
    """:class:`StepDraws` of ``bvsc_tpu``'s train step ``step`` from ``key``
    (``fold_in(key, step)`` split three ways)."""
    k_bits, k_model, k_mask = jax.random.split(jax.random.fold_in(key, step), 3)
    bits = np.asarray(jt.draw_bitrates(k_bits, conf, B, T))
    use_gen, noise = jax_noise(k_model, float(jt.p_use_gen_schedule(jnp.asarray(step), conf)))
    mask = None
    if mel_mask is not None:
        kt, kf = jax.random.split(k_mask)
        mask = torch.from_numpy(np.asarray(
            jt.stripe_mask(kt, B, T, 2, 24)[:, :, None] | jt.stripe_mask(kf, B, X, 2, 10)[:, None, :]))
    return tt.StepDraws(torch.from_numpy(bits), use_gen, noise, mask)


def _jax_forward(fused, greedy, var_bit):
    cfg = jb.BVRNNConfig(x_dim=X, h_dim=H, z_dim=Z, var_bit=var_bit, fused_cell=fused)
    return jax.jit(lambda p, y, pg, vb, key: jb.forward_train(
        p, cfg, y, pg, greedy, vb if var_bit else None, key))


def _jax_loss_grad(fused):
    cfg = jb.BVRNNConfig(x_dim=X, h_dim=H, z_dim=Z, fused_cell=fused)
    return jax.jit(jax.value_and_grad(
        lambda p, mel, pg, bits, key, mel_in: jt.loss_fn(p, cfg, mel, pg, bits, key, mel_in),
        has_aux=True))


def _jax_train_step(clip, mel_mask):
    conf = JConf(grad_clip=clip, **SMALL)
    opt = jt.make_optimizer(conf)
    step = jt.make_train_step(conf, jb.BVRNNConfig(x_dim=X, h_dim=H, z_dim=Z), opt,
                              mel_mask=None if mel_mask is None else dict(mel_mask))
    return opt, jax.jit(step)


def _jax_bf16_loss(fused):
    cfg = jb.BVRNNConfig(x_dim=X, h_dim=H, z_dim=Z, dtype=jnp.bfloat16,
                         precision=jax.lax.Precision.DEFAULT, fused_cell=fused)
    return jax.jit(lambda p, mel, bits, key: jt.loss_fn(p, cfg, mel, 0.5, bits, key))


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


@pytest.mark.parametrize("var_bit", [True, False], ids=["var_bit", "all_bits"])
@pytest.mark.parametrize("greedy", [False, True], ids=["sampled", "greedy"])
@pytest.mark.parametrize("fused", [False, True], ids=["standard", "fused"])
def test_forward_train_matches_jax(jax_fns, jparams, data, fused, greedy, var_bit):
    mel, bits = data
    tcfg = tb.BVRNNConfig(x_dim=X, h_dim=H, z_dim=Z, var_bit=var_bit, fused_cell=fused)
    tparams = bvrnn_params_from_jax(_tree_np(jparams))
    for i, p in enumerate((0.0, 0.5, 1.0)):
        key = jax.random.key(10 + i)
        ref_mel, ref_kld = jax_fns(_jax_forward, fused, greedy, var_bit)(
            jparams, jnp.asarray(mel), jnp.float32(p), jnp.asarray(bits), key)
        use_gen, noise = jax_noise(key, p)
        got_mel, got_kld = tb.forward_train(tparams, tcfg, torch.from_numpy(mel), use_gen,
                                            greedy, torch.from_numpy(bits) if var_bit else None,
                                            noise)
        np.testing.assert_allclose(got_mel.detach().numpy(), np.asarray(ref_mel), atol=MEL_TOL)
        assert abs(float(got_kld) - float(ref_kld)) <= KLD_TOL, (p, float(got_kld), float(ref_kld))


@pytest.mark.parametrize("mel_mask", [None, {}], ids=["plain", "mel_mask"])
@pytest.mark.parametrize("fused", [False, True], ids=["standard", "fused"])
def test_loss_and_grads_match_jax(jax_fns, jparams, data, fused, mel_mask):
    """loss_fn's value and its gradient in every leaf, log_sigma and the mel
    statistics included, against jax.value_and_grad of bvsc_tpu's."""
    mel, _ = data
    conf = JConf(**SMALL)
    key = jax.random.key(3)
    draws = jax_step_draws(conf, key, 1, mel_mask)
    k_bits, k_model, k_mask = jax.random.split(jax.random.fold_in(key, 1), 3)
    mel_in = (jt.apply_spec_mask(k_mask, jnp.asarray(mel)) if mel_mask is not None else None)
    (ref, _), ref_g = jax_fns(_jax_loss_grad, fused)(
        jparams, jnp.asarray(mel), jt.p_use_gen_schedule(jnp.asarray(1), conf),
        jnp.asarray(draws.bits.numpy()), k_model, mel_in)
    tparams = bvrnn_params_from_jax(_tree_np(jparams))
    leaves = flatten_tree(tparams)
    for p in leaves.values():
        p.requires_grad_(True)
    tcfg = tb.BVRNNConfig(x_dim=X, h_dim=H, z_dim=Z, fused_cell=fused)
    loss, _ = tt.loss_fn(tparams, tcfg, torch.from_numpy(mel), draws)
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    assert abs(float(loss) - float(ref)) <= GRAD_RTOL * abs(float(ref))
    ref_flat = flatten_tree(_tree_np(ref_g))
    assert set(ref_flat) == set(grads)
    for name, g in grads.items():
        r = ref_flat[name]
        err = np.abs(g.numpy() - r).max() / max(np.abs(r).max(), 1e-12)
        assert err <= GRAD_RTOL, (name, err)


@pytest.mark.parametrize("clip,mel_mask", [(130.0, None), (0.05, {})],
                         ids=["no_clip", "clip_fires+mel_mask"])
def test_three_steps_match_jax(jax_fns, jparams, data, clip, mel_mask):
    """Three optimizer steps against bvsc_tpu's make_train_step with the
    same draws; at grad_clip 0.05 every step clips (grad norm ~7)."""
    mel, _ = data
    jconf, tconf = JConf(grad_clip=clip, **SMALL), TConf(grad_clip=clip, **SMALL)
    opt, step = jax_fns(_jax_train_step, clip, None if mel_mask is None else ())
    state = jt.TrainState(jparams, opt.init(jparams), jnp.zeros((), jnp.int32))
    trainer = tt.BVRNNTrainer(tconf, params=bvrnn_params_from_jax(_tree_np(jparams)),
                              mel_mask=mel_mask, device="cpu")
    key = jax.random.key(1)
    for i in range(3):
        state, m = step(state, jnp.asarray(mel), key)
        got = trainer.step(torch.from_numpy(mel), jax_step_draws(jconf, key, i, mel_mask))
        if clip < 1:
            assert float(got["grad_norm"]) > clip
        np.testing.assert_allclose(float(got["grad_norm"]), float(m["grad_norm"]), rtol=1e-5)
        np.testing.assert_allclose(float(got["loss"]), float(m["loss"]), rtol=1e-5)
    ref = flatten_tree(_tree_np(state.params))
    got = flatten_tree(trainer.host_params())
    for name, r in ref.items():
        np.testing.assert_allclose(got[name], r, atol=PARAM_TOL, err_msg=name)
    assert trainer.step_count == int(state.step) == 3


@pytest.mark.parametrize("fused", [False, True], ids=["standard", "fused"])
def test_bf16_loss_matches_jax_bf16(jax_fns, jparams, data, fused):
    """compute_dtype='bf16': the loss on a bf16 cast of the float32 masters
    against bvsc_tpu's bf16 mode, within the reference's own tolerance; the
    gradients reach the float32 masters in float32."""
    mel, bits = data
    key = jax.random.key(4)
    ref, _ = jax_fns(_jax_bf16_loss, fused)(jparams, jnp.asarray(mel), jnp.asarray(bits), key)
    use_gen, noise = jax_noise(key, 0.5, jnp.bfloat16)
    assert noise.dtype == torch.bfloat16
    tparams = bvrnn_params_from_jax(_tree_np(jparams))
    leaves = list(flatten_tree(tparams).values())
    for p in leaves:
        p.requires_grad_(True)
    tcfg = tb.BVRNNConfig(x_dim=X, h_dim=H, z_dim=Z, fused_cell=fused)
    loss, m = tt.loss_fn(tparams, tcfg, torch.from_numpy(mel),
                         tt.StepDraws(torch.from_numpy(bits), use_gen, noise),
                         dtype=torch.bfloat16)
    assert loss.dtype == m["kld"].dtype == torch.float32
    assert abs(float(loss) - float(ref)) < LOSS_RTOL_LOOSE * max(1.0, abs(float(ref)))
    grads = torch.autograd.grad(loss, leaves)
    assert all(g.dtype == torch.float32 and torch.isfinite(g).all() for g in grads)


def test_p_use_gen_ramp():
    conf = TConf(**{**SMALL, "teacher_force_step_1perc": 100})
    assert tt.p_use_gen_schedule(0, conf) == 0.0
    assert tt.p_use_gen_schedule(50, conf) == pytest.approx(0.5)
    assert tt.p_use_gen_schedule(100, conf) == 1.0
    assert tt.p_use_gen_schedule(10_000, conf) == 1.0


def test_draw_bitrates_properties():
    conf = TConf(**{**SMALL, "p_bitratechange": 1.0})
    n, frames = 64, 20
    bits = tt.draw_bitrates(torch.Generator().manual_seed(0), conf, n, frames).numpy()
    assert bits.shape == (n, frames) and bits.dtype == np.float32
    assert bits.min() >= 1 and bits.max() <= conf.z_dim
    assert (bits == np.round(bits)).all()
    switched = 0
    for row in bits:
        changes = np.flatnonzero(np.diff(row))
        assert len(changes) <= 1, row
        switched += len(changes)
    assert switched > n // 4
    conf0 = TConf(**{**SMALL, "p_bitratechange": 0.0})
    bits0 = tt.draw_bitrates(torch.Generator().manual_seed(1), conf0, n, frames).numpy()
    assert (np.diff(bits0, axis=1) == 0).all()


def test_spec_mask_properties():
    mel = torch.from_numpy(np.random.default_rng(2).standard_normal((4, 40, 8)).astype(np.float32))
    kw = dict(n_time=2, time_width=10, n_freq=1, freq_width=3)
    mask = tt.draw_spec_mask(torch.Generator().manual_seed(3), 4, 40, 8, **kw)
    again = tt.draw_spec_mask(torch.Generator().manual_seed(3), 4, 40, 8, **kw)
    assert mask.shape == (4, 40, 8) and mask.dtype == torch.bool and mask.any()
    assert torch.equal(mask, again)
    out = tt.apply_spec_mask(mel, mask).numpy()
    changed = ~np.isclose(out, mel.numpy())
    assert changed.any()
    target = np.broadcast_to(mel.numpy().mean(axis=1, keepdims=True), mel.shape)
    np.testing.assert_allclose(out[changed], target[changed], rtol=1e-6)
    np.testing.assert_array_equal(out[~mask.numpy()], mel.numpy()[~mask.numpy()])
    assert not tt.stripe_mask(torch.Generator().manual_seed(0), 4, 40, 3, 0).any()


def test_step_draws_distribution():
    """The port's own per-step draws: seeded by (seed, step) alone, the
    scheduled-sampling share following p_use_gen, noise uniform."""
    conf = TConf(**{**SMALL, "teacher_force_step_1perc": 4})
    a = tt.draw_step(5, 2, conf, 64, 400)
    b = tt.draw_step(5, 2, conf, 64, 400)
    c = tt.draw_step(5, 3, conf, 64, 400)
    assert torch.equal(a.bin_noise, b.bin_noise) and torch.equal(a.bits, b.bits)
    assert not torch.equal(a.bin_noise, c.bin_noise)
    assert abs(a.use_gen.float().mean().item() - 0.5) < 0.1
    assert tt.draw_step(5, 4, conf, 2, 50).use_gen.all()
    assert not tt.draw_step(5, 0, conf, 2, 50).use_gen.any()
    assert 0.0 <= a.bin_noise.min() and a.bin_noise.max() < 1.0
    assert abs(a.bin_noise.mean().item() - 0.5) < 0.01
    bf = tt.draw_step(5, 2, conf, 4, 10, dtype=torch.bfloat16)
    assert bf.bin_noise.dtype == torch.bfloat16


def _signal(n=B, frames=12):
    rng = np.random.default_rng(0)
    t = np.linspace(0, 1, frames)[None, :, None]
    return torch.from_numpy((np.sin(2 * np.pi * 3 * t) * np.linspace(1, 2, X)[None, None, :]
                             + 0.05 * rng.standard_normal((n, frames, X))).astype(np.float32))


@pytest.mark.parametrize("kw", [{}, {"fused_cell": True}, {"compute_dtype": "bf16"}],
                         ids=["standard", "fused", "bf16"])
def test_loss_falls(kw):
    """30 steps on a learnable signal: finite metrics, the loss falls, the
    masters stay float32."""
    trainer = tt.BVRNNTrainer(TConf(**SMALL), seed=0, device="cpu", **kw)
    mel = _signal()
    losses = []
    for _ in range(30):
        m = trainer.step(mel)
        losses.append(float(m["loss"]))
        assert all(np.isfinite(float(v)) for v in m.values()), m
    assert np.mean(losses[-5:]) < np.mean(losses[:5]), losses
    assert all(p.dtype == torch.float32 for p in trainer.leaves)
    assert trainer.step_count == 30


def test_resume_is_bitwise(tmp_path):
    """2 steps, save, restore into a new trainer, 2 more: bitwise the
    params and optimizer state of 4 unbroken steps."""
    conf = TConf(**SMALL)
    mel = _signal()
    whole = tt.BVRNNTrainer(conf, seed=3, device="cpu", mel_mask={})
    for _ in range(4):
        whole.step(mel)
    first = tt.BVRNNTrainer(conf, seed=3, device="cpu", mel_mask={})
    for _ in range(2):
        first.step(mel)
    path = ckpt.save_step(str(tmp_path), "bvrnn_", first.step_count, first.state_dict())
    second = tt.BVRNNTrainer(conf, seed=99, device="cpu", mel_mask={})
    state, step = ckpt.restore_latest(str(tmp_path), "bvrnn_")
    assert step == 2 and path.endswith("bvrnn_00000002")
    second.load_state_dict(state)
    for _ in range(2):
        second.step(mel)
    for a, b in zip(whole.leaves + whole.opt.mu + whole.opt.nu,
                    second.leaves + second.opt.mu + second.opt.nu):
        assert torch.equal(a, b)
    assert second.step_count == 4 and second.opt.count == 4


def test_exported_npz_serves(tmp_path):
    """The trained params, exported to the flat float16 .npz, load into the
    port's BVRNNCodecModel and encode."""
    from bvsc_tpu_torch import BVRNNCodecModel
    from bvsc_tpu_torch.cli import export_bvrnn_npz

    conf = TConf(h_dim=H, z_dim=Z, batch_size=2, learning_rate=1e-3)
    trainer = tt.BVRNNTrainer(conf, seed=1, device="cpu")
    trainer.step(torch.from_numpy(
        np.random.default_rng(0).standard_normal((2, 8, 80)).astype(np.float32)))
    src = ckpt.save_step(str(tmp_path), "bvrnn_", 1, trainer.state_dict())
    dst = str(tmp_path / "trained.npz")
    flat = export_bvrnn_npz.export(src, dst)
    assert all(v.dtype == np.float16 for v in flat.values())
    assert "log_sigma" in flat and "gru/w_ih" in flat
    codec = BVRNNCodecModel(config=conf, bvrnn_chkpt_path=dst, device="cpu")
    want = flatten_tree(trainer.host_params())
    for name, t in flatten_tree(codec.bvrnn_params).items():
        np.testing.assert_array_equal(t.numpy(), want[name].astype(np.float16).astype(np.float32))
    x = np.random.default_rng(1).standard_normal(4096).astype(np.float32) * 0.1
    codes = codec.encode(x, 3000)
    assert codes.shape[-1] == Z and set(np.unique(codes.numpy())) <= {0.0, 0.5, 1.0}


def test_forward_train_casts_float32_masters_under_bf16():
    """Float32 masters given with dtype=bf16 are cast inside (both cells)."""
    params = bvrnn_params_from_jax(tb.init_bvrnn_params(0, tb.BVRNNConfig(x_dim=X, h_dim=H, z_dim=Z)))
    for fused in (False, True):
        cfg = tb.BVRNNConfig(x_dim=X, h_dim=H, z_dim=Z, fused_cell=fused)
        use_gen, noise = tb.draw_train_noise(torch.Generator().manual_seed(0), 1.0, 6, 1, Z,
                                             torch.bfloat16)
        mel, kld = tb.forward_train(params, cfg, torch.randn(1, 6, X), use_gen, True,
                                    torch.full((1, 6), 5.0), noise, dtype=torch.bfloat16)
        assert mel.dtype == torch.bfloat16 and torch.isfinite(mel.float()).all()
        assert torch.isfinite(kld.float())


def test_trainer_rejects_bad_compute_dtype_and_needs_a_card():
    with pytest.raises(ValueError, match="compute_dtype"):
        tt.BVRNNTrainer(TConf(**SMALL), compute_dtype="fp8", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tt.BVRNNTrainer(TConf(**SMALL))


def test_straight_through_rounds_half_to_even():
    """round(0.5) is 0 and round(1.5) is 2, as jnp.round; the gradient
    passes straight through."""
    enc = torch.tensor([0.5, 1.5, 0.49, 2.5], requires_grad=True)
    z = tb._straight_through(enc, None, greedy=True)
    assert z.tolist() == [0.0, 2.0, 0.0, 2.0]
    (g,) = torch.autograd.grad(z.sum(), enc)
    assert g.tolist() == [1.0, 1.0, 1.0, 1.0]
    assert np.asarray(jnp.round(jnp.asarray([0.5, 1.5, 0.49, 2.5]))).tolist() == z.tolist()
