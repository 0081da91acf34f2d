"""Rank bodies of the port's parallel tests, and the spawner that runs them.

This module imports torch and the port only, never JAX: the ranks are
spawned processes (``parallel.dryrun.run_ranks``: ``multiprocessing``'s
spawn context) that import it fresh, joined over gloo through a
``file://`` store in a temporary directory (no ports, so parallel test
workers cannot collide), each running one body of this module on CPU
devices.  A rank that fails, or outlives the timeout, fails the test with
its traceback.
"""

from __future__ import annotations

import numpy as np
import torch

from bvsc_tpu_torch.parallel.dryrun import run_ranks

TIMEOUT_S = 120.0


def spawn(n: int, tmp, body: str, *args, timeout: float = TIMEOUT_S) -> list:
    """Run ``body(n, *args)`` on n gloo ranks on the CPU; the ranks' results
    in rank order."""
    tmp.mkdir(parents=True, exist_ok=True)
    return run_ranks(n, globals()[body], *args, device="cpu", timeout_s=timeout, tmp=str(tmp))


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_np(v) for v in tree)
    if isinstance(tree, torch.Tensor):  # bf16 (the bf16 storage dtype) widens exactly
        return tree.detach().cpu().to(torch.float32 if tree.dtype == torch.bfloat16
                                      else tree.dtype).numpy()
    return tree


def _mesh(kind: str, n: int, make_1d, make_2d):
    devices = ["cpu"] * n
    return make_2d(2, n // 2, devices=devices) if kind == "2d" else make_1d(devices=devices)


# ---------------------------------------------------------------------------
# Bodies
# ---------------------------------------------------------------------------


def tp(n, kind, params, cfg_kwargs, z, y, bits, h0):
    """decode_tp and encode_tp on a model mesh (``kind='1d'``) or a 2 x n/2
    data x model mesh (``'2d'``)."""
    from bvsc_tpu_torch.models.bvrnn import BVRNNConfig
    from bvsc_tpu_torch.parallel import tp as T

    mesh = _mesh(kind, n, T.make_tp_mesh, T.make_dp_tp_mesh)
    cfg = BVRNNConfig(**cfg_kwargs)
    tpp = T.shard_tp_params(T.prepare_tp_params(params), mesh, dtype=cfg.dtype)
    mel, h = T.decode_tp(tpp, cfg, z, h0, mesh)
    codes, h_enc = T.encode_tp(tpp, cfg, y, bits, h0, mesh)
    return _np({"mel": mel, "h": h, "codes": codes, "h_enc": h_enc})


def sp(n, kind, params, cfg, mel, kw=None):
    """generator_apply_sp on a seq mesh or a 2 x n/2 data x seq mesh, with
    the keyword arguments ``kw``."""
    from bvsc_tpu_torch.parallel import sp as S

    mesh = _mesh(kind, n, S.make_sp_mesh, S.make_dp_sp_mesh)
    return _np(S.generator_apply_sp(params, cfg, mel, mesh, **(kw or {})))


def sp_errors(n, params, cfg, lengths):
    """The ValueError generator_apply_sp raises on an input of each of
    ``lengths`` frames (None where it runs)."""
    from bvsc_tpu_torch.parallel import sp as S

    mesh = S.make_sp_mesh(devices=["cpu"] * n)
    out = []
    for frames in lengths:
        try:
            S.generator_apply_sp(params, cfg, np.zeros((1, cfg.num_mels, frames), np.float32),
                                 mesh)
            out.append(None)
        except ValueError as e:
            out.append(str(e))
    return out


def pp(n, kind, bparams, bcfg_kwargs, vparams, vcfg, mel_mb, bits_mb, kw=None):
    """pipeline_resynth on a pipe mesh or a 2 x 2 data x pipe mesh, with the
    keyword arguments ``kw``."""
    from bvsc_tpu_torch.models.bvrnn import BVRNNConfig
    from bvsc_tpu_torch.parallel import pp as P

    devices = ["cpu"] * n
    mesh = P.make_dp_pp_mesh(2, devices=devices) if kind == "2d" else P.make_pp_mesh(devices)
    codes, wav = P.pipeline_resynth(bparams, BVRNNConfig(**bcfg_kwargs), vparams, vcfg,
                                    mel_mb, bits_mb, mesh, **(kw or {}))
    return _np({"codes": codes, "wav": wav})


def bvrnn_dp(n, conf_kwargs, params, mel, draws):
    """BVRNNTrainer over a data mesh: one step a draw, each rank on its rows
    of ``mel``; the metrics and the final parameters."""
    from bvsc_tpu_torch.config import CodecConfig
    from bvsc_tpu_torch.parallel.mesh import make_mesh
    from bvsc_tpu_torch.train.bvrnn_train import BVRNNTrainer

    from bvsc_tpu_torch.parallel.mesh import batch_sharded, replicated, shard_batch

    mesh = make_mesh(devices=["cpu"] * n)
    trainer = BVRNNTrainer(CodecConfig(**conf_kwargs), params=params, mesh=mesh)
    ax = mesh.axis("data")
    rows = mel.shape[0] // n
    local = torch.from_numpy(mel[ax.index * rows:(ax.index + 1) * rows])
    metrics = [_np(trainer.step(local, d)) for d in draws]
    helpers = {"shard_batch": _np(shard_batch(mesh, {"mel": local})["mel"]),
               "batch_sharded": _np(batch_sharded(mesh, [torch.from_numpy(mel)])[0]),
               "replicated": _np(replicated(mesh, local))}
    return {"metrics": metrics, "params": trainer.host_params(), "helpers": helpers,
            "rows": (ax.index * rows, (ax.index + 1) * rows)}


def gan_dp(n, vcfg, tcfg, gen, mpd, mrd, ys):
    """VocoderGANTrainer over a data mesh: one step on each of ``ys``, each
    rank on its rows; the metrics, the parameters and D's first moments."""
    from bvsc_tpu_torch.convert import flatten_tree
    from bvsc_tpu_torch.parallel.mesh import make_mesh
    from bvsc_tpu_torch.train.vocoder_train import VocoderGANTrainer

    mesh = make_mesh(devices=["cpu"] * n)
    trainer = VocoderGANTrainer(vcfg, tcfg, gen_params=gen, mpd_params=mpd, mrd_params=mrd,
                                mesh=mesh)
    ax = mesh.axis("data")
    metrics = []
    for y in ys:
        rows = y.shape[0] // n
        metrics.append(_np(trainer.step_on_audio(y[ax.index * rows:(ax.index + 1) * rows])))
    params = _np(flatten_tree({"gen": trainer.gen, "mpd": trainer.mpd, "mrd": trainer.mrd}))
    mu_d = _np(dict(zip(trainer._d.names, trainer.opt_d.mu)))
    return {"metrics": metrics, "params": params, "mu_d": mu_d}
