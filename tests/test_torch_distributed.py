"""The port's data-parallel trainers and trainer CLI on gloo ranks on the
CPU.

* ``BVRNNTrainer(mesh=)`` on 2 ranks against ``bvsc_tpu``'s mesh trainer on
  2 virtual devices, with the reference's ``jax.random`` draws of the
  global batch passed in (each rank keeps its rows), and against the port's
  one-rank step on the global batch: metrics within 1e-5 relative,
  parameters within 1e-5, after 2 steps.
* ``VocoderGANTrainer(mesh=)`` on 2 ranks against ``bvsc_tpu``'s mesh
  trainer from the same weights (its own init, converted): a D-frozen step
  and a training one, held as ``tests/test_torch_gan.py`` holds one rank
  (a D weight whose gradient lies within float noise of 0 held by that
  gradient, ``ILL_CONDITIONED_G``).
* ``cli.train_bvrnn`` in two processes (``--coordinator_address file://``):
  both ranks print the same losses, and rank 0's checkpoint loads.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from bvsc_tpu.config import CodecConfig as JConf
from bvsc_tpu.config import VocoderConfig as JVC
from bvsc_tpu.models import bvrnn as jb
from bvsc_tpu.parallel.mesh import make_mesh as jax_mesh
from bvsc_tpu.parallel.mesh import shard_batch
from bvsc_tpu.train import bvrnn_train as jt
from bvsc_tpu.train import vocoder_train as JT
from bvsc_tpu_torch.config import CodecConfig as TConf
from bvsc_tpu_torch.config import VocoderConfig as TVC
from bvsc_tpu_torch.convert import (bvrnn_params_from_jax, discriminator_params_from_jax,
                                    flatten_tree, generator_train_params_from_jax)
from bvsc_tpu_torch.train import bvrnn_train as tt
from bvsc_tpu_torch.train import checkpoint as ckpt
from bvsc_tpu_torch.train import vocoder_train as TT
from test_torch_gan import ILL_CONDITIONED_G, NARROW, ONE_EACH, TRAIN, audio
from test_torch_train_cli import TINY_TOML
from torch_parallel_ranks import spawn

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANKS = 2
X, H, Z, B, T, STEPS = 12, 48, 12, 4, 10, 2
SMALL = dict(num_mels=X, h_dim=H, z_dim=Z, batch_size=B, learning_rate=1e-3,
             teacher_force_step_1perc=2)
RTOL = 1e-5
PARAM_TOL = 1e-5
GRAD_RTOL = 1e-4
CLI_TIMEOUT = 240


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def global_draws(conf, key, step) -> tt.StepDraws:
    """The draws of ``bvsc_tpu``'s train step ``step`` over the global batch
    (``fold_in(key, step)`` split three ways, as its ``make_train_step``)."""
    k_bits, k_model, _ = jax.random.split(jax.random.fold_in(key, step), 3)
    bits = np.array(jt.draw_bitrates(k_bits, conf, B, T))
    k_sched, k_bin = jax.random.split(k_model)
    use_gen = jax.random.uniform(k_sched, (T,)) < jt.p_use_gen_schedule(jnp.asarray(step), conf)
    noise = jax.random.uniform(k_bin, (T, B, Z))
    return tt.StepDraws(torch.from_numpy(bits), torch.from_numpy(np.array(use_gen)),
                        torch.from_numpy(np.array(noise)))


@pytest.fixture(scope="module")
def bvrnn_runs(tmp_path_factory):
    """bvsc_tpu's mesh trainer on 2 virtual devices, the port on 2 gloo
    ranks and on one rank, from the same weights and draws."""
    jconf = JConf(**SMALL)
    mean_std = (np.random.default_rng(1).standard_normal(X) * 0.1,
                np.abs(np.random.default_rng(2).standard_normal(X)) + 0.5)
    tree = _np(jb.init_bvrnn_params(jax.random.key(0), jb.BVRNNConfig(x_dim=X, h_dim=H, z_dim=Z),
                                    mean_std))
    mel = np.random.default_rng(7).standard_normal((B, T, X)).astype(np.float32)
    key = jax.random.key(1)
    mesh = jax_mesh(RANKS)
    jtr = jt.BVRNNTrainer(jconf, mesh=mesh, params=jax.tree.map(jnp.array, tree))
    ref = [_np(jtr.step(shard_batch(mesh, jnp.asarray(mel)), key)) for _ in range(STEPS)]
    draws = [global_draws(jconf, key, i) for i in range(STEPS)]
    params = bvrnn_params_from_jax(tree)
    one = tt.BVRNNTrainer(TConf(**SMALL), params=params, device="cpu")
    one_rank = [{k: v.numpy() for k, v in one.step(torch.from_numpy(mel), d).items()}
                for d in draws]
    ranks = spawn(RANKS, tmp_path_factory.mktemp("bvrnn_dp"), "bvrnn_dp", SMALL, params, mel,
                  draws)
    return {"jax": (ref, flatten_tree(_np(jtr.state.params))),
            "one": (one_rank, flatten_tree(one.host_params())), "ranks": ranks}


def _hold(got, ref):
    metrics, params = got
    ref_metrics, ref_params = ref
    for m, r in zip(metrics, ref_metrics):
        for k in ("loss", "nll", "kld", "mse", "grad_norm"):
            np.testing.assert_allclose(float(m[k]), float(r[k]), rtol=RTOL, err_msg=k)
    for name, r in ref_params.items():
        np.testing.assert_allclose(params[name], r, atol=PARAM_TOL, err_msg=name)


@pytest.mark.parametrize("ref", ["jax", "one"], ids=["bvsc_tpu_mesh", "port_one_rank"])
def test_bvrnn_dp_step(bvrnn_runs, ref):
    for rank in bvrnn_runs["ranks"]:
        _hold((rank["metrics"], flatten_tree(rank["params"])), bvrnn_runs[ref])


def test_bvrnn_ranks_agree(bvrnn_runs):
    """Every rank reports the same global metrics and holds the same
    parameters, bitwise."""
    a, b = bvrnn_runs["ranks"]
    for ma, mb in zip(a["metrics"], b["metrics"]):
        assert ma == mb
    fa, fb = flatten_tree(a["params"]), flatten_tree(b["params"])
    for name in fa:
        np.testing.assert_array_equal(fa[name], fb[name])


def test_mesh_helpers(bvrnn_runs):
    """On an SPMD data mesh: ``shard_batch`` assembles the ranks' rows into
    the global batch, ``batch_sharded`` cuts a rank's block out of it, and
    ``replicated`` leaves a tensor whole on the rank's device; on a
    single-controller mesh the last two give one entry a device."""
    from bvsc_tpu_torch.parallel.mesh import batch_sharded, make_mesh, replicated

    mel = np.random.default_rng(7).standard_normal((B, T, X)).astype(np.float32)
    for rank in bvrnn_runs["ranks"]:
        lo, hi = rank["rows"]
        h = rank["helpers"]
        np.testing.assert_array_equal(h["shard_batch"], mel)
        np.testing.assert_array_equal(h["batch_sharded"], mel[lo:hi])
        np.testing.assert_array_equal(h["replicated"], mel[lo:hi])
    mesh = make_mesh(devices=["cpu", "cpu"])
    blocks = batch_sharded(mesh, torch.from_numpy(mel))
    assert [b.shape[0] for b in blocks] == [B // 2] * 2
    np.testing.assert_array_equal(torch.cat(blocks).numpy(), mel)
    assert len(replicated(mesh, {"x": torch.ones(1)})) == 2
    with pytest.raises(ValueError, match="CUDA devices"):
        make_mesh(torch.cuda.device_count() + 1)


@pytest.fixture(scope="module")
def gan_runs(tmp_path_factory):
    """bvsc_tpu's mesh GAN trainer on 2 virtual devices and the port on 2
    ranks from its initial weights: a D-frozen step, then one training D."""
    jcfg = JVC(**{**NARROW, **ONE_EACH})
    tcfg = TVC(**{**NARROW, **ONE_EACH})
    jtc = JT.GANTrainConfig(freeze_step=1, **{**TRAIN, "batch_size": 4})
    jtr = JT.VocoderGANTrainer(jcfg, jtc, mesh=jax_mesh(RANKS), seed=2)
    weights = (generator_train_params_from_jax(_np(jtr.state.gen)),
               discriminator_params_from_jax(_np(jtr.state.mpd)),
               discriminator_params_from_jax(_np(jtr.state.mrd)))
    ys = [audio(8, batch=4)[:, 0], audio(9, batch=4)[:, 0]]
    ref = [_np(jtr.step_on_audio(y)) for y in ys]
    ref_params = flatten_tree(_np({"gen": jtr.state.gen, "mpd": jtr.state.mpd,
                                   "mrd": jtr.state.mrd}))
    ref_mu = flatten_tree(_np(jtr.state.opt_d.inner_state[1][0].mu))
    ranks = spawn(RANKS, tmp_path_factory.mktemp("gan_dp"), "gan_dp", tcfg,
                  TT.GANTrainConfig(**dataclasses.asdict(jtc)), *weights, ys)
    return ref, ref_params, ref_mu, ranks


def test_gan_dp_steps_match_bvsc_tpu(gan_runs):
    ref, ref_params, ref_mu, ranks = gan_runs
    b1 = TT.GANTrainConfig().adam_b1
    for rank in ranks:
        for m, r in zip(rank["metrics"], ref):
            for k in r:
                np.testing.assert_allclose(float(m[k]), float(r[k]), rtol=RTOL, atol=1e-6,
                                           err_msg=k)
        ill = {}
        for name, mu in rank["mu_d"].items():  # one D update: mu = (1 - b1) g
            g_ref, g = ref_mu[name] / (1 - b1), mu / (1 - b1)
            assert np.abs(g - g_ref).max() <= GRAD_RTOL * max(np.abs(g_ref).max(), 1e-12), name
            ill[name] = np.abs(g_ref) < ILL_CONDITIONED_G
        for name, r in ref_params.items():
            keep = ~ill.get(name, np.zeros(r.shape, bool))
            np.testing.assert_allclose(rank["params"][name][keep], r[keep], atol=PARAM_TOL,
                                       err_msg=name)


def test_gan_ranks_agree(gan_runs):
    a, b = gan_runs[3]
    for name, v in a["params"].items():
        np.testing.assert_array_equal(b["params"][name], v)


def test_two_process_bvrnn_cli(tmp_path):
    """``cli.train_bvrnn`` as two processes of one run: both ranks train 2
    steps on their filelist shards and print the same (global) losses; rank
    0's checkpoint loads."""
    wavs = tmp_path / "wavs"
    wavs.mkdir()
    rng = np.random.default_rng(0)
    names = [f"utt_{i}" for i in range(4)]  # 2 files a rank
    t = np.arange(int(0.8 * 8000)) / 8000.0
    for i, name in enumerate(names):
        x = 0.5 * np.sin(2 * np.pi * (150 + 60 * i) * t) + 0.05 * rng.standard_normal(t.shape)
        wavfile.write(str(wavs / f"{name}.wav"), 8000, (x * 32767 * 0.5).astype(np.int16))
    (tmp_path / "train.txt").write_text("\n".join(names) + "\n")
    (tmp_path / "tiny.toml").write_text(TINY_TOML)
    run = tmp_path / "run"
    env = {**os.environ, "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
           "OMP_NUM_THREADS": "1"}

    def launch(rank):
        return subprocess.Popen(
            [sys.executable, "-m", "bvsc_tpu_torch.cli.train_bvrnn",
             "--config", str(tmp_path / "tiny.toml"), "--input_wavs_dir", str(wavs),
             "--input_training_file", str(tmp_path / "train.txt"),
             "--checkpoint_path", str(run), "--max_steps", "2", "--batch_size", "8",
             "--stdout_interval", "1", "--stats_batches", "1", "--device", "cpu",
             "--coordinator_address", f"file://{tmp_path / 'store'}",
             "--num_processes", "2", "--process_id", str(rank)],
            env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    procs = [launch(0), launch(1)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=CLI_TIMEOUT)
            assert p.returncode == 0, f"rc={p.returncode}\n{out[-2000:]}\n{err[-4000:]}"
            outs.append(out)
    finally:
        for p in procs:
            p.kill()
            p.wait()
    losses = []
    for out in outs:
        lines = [ln for ln in out.splitlines() if ln.startswith("Steps : 2,")]
        assert lines and "done at step 2" in out, out[-2000:]
        losses.append(lines[-1].split(", s/b")[0])
    assert losses[0] == losses[1], losses
    state, step = ckpt.restore_latest(str(run), "bvrnn_")
    assert step == 2 and state["step"] == 2
    trainer = tt.BVRNNTrainer(TConf.from_toml(str(tmp_path / "tiny.toml")), device="cpu")
    trainer.load_state_dict(state)
    assert trainer.step_count == 2
