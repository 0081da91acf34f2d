"""Multi-rank dry run of every parallel path, and the spawner of ranks.

:func:`run_ranks` starts n processes (``multiprocessing``'s spawn context),
joins them into one process group through a ``file://`` store in a fresh
temporary directory, runs one module-level function on each and returns
each rank's result.  A rank that raises, or that outlives the timeout (a
collective that waits on a dead rank times out first), fails the call.

:func:`dryrun_multichip` is the counterpart of the JAX package's
``__graft_entry__.dryrun_multichip``: on n ranks, at small shapes, one
data-parallel BVRNN step and one GAN step (each against the same step on
one rank over the global batch), tensor-parallel encode and decode against
one device, the sequence-parallel vocoder against one-shot, the pipeline
against the unpipelined composition (with an even n); then, in this
process, the sharded ``DecodeEngine`` (with a concealed frame),
``ServingEngine`` and bundle engine against unsharded ones on a mesh of the
same n devices.

    python -m bvsc_tpu_torch.parallel.dryrun 4 --device cpu

``device`` is every rank's device: ``'cpu'``, one card for all ranks (say
``'cuda:0'``: gloo, since NCCL refuses two ranks on one card), or None for
card r on rank r (NCCL).
"""

from __future__ import annotations

import argparse
import multiprocessing
import os
import pickle
import tempfile
import traceback

import numpy as np
import torch

TIMEOUT_S = 600.0
GATES = {"dp": 1e-5, "tp": 1e-4, "sp": 1e-4, "pp": 1e-6, "serve": 1e-5, "bundle": 1e-4}


def _rank_main(n: int, rank: int, tmp: str, fn, args: tuple, backend: str, device,
               timeout_s: float) -> None:
    out = os.path.join(tmp, f"rank{rank}.pkl")
    try:
        if torch.device(device or "cpu").type == "cpu":
            torch.set_num_threads(1)
        import torch.distributed as dist

        from bvsc_tpu_torch.parallel.mesh import init_distributed

        init_distributed(f"file://{os.path.join(tmp, 'store')}", n, rank, backend=backend,
                         device=device, timeout_s=timeout_s)
        result = fn(n, *args)
        dist.destroy_process_group()
        status = ("ok", result)
    except BaseException:
        status = ("error", traceback.format_exc())
    with open(out, "wb") as f:
        pickle.dump(status, f)
    if status[0] != "ok":
        raise SystemExit(1)


def default_backend(n: int, device) -> str:
    """gloo on the CPU or where the ranks share one card, else NCCL."""
    if device is None:
        return "nccl"
    return "gloo" if torch.device(device).type == "cpu" or n > 1 else "nccl"


def run_ranks(n: int, fn, *args, device=None, backend: str | None = None,
              timeout_s: float = TIMEOUT_S, tmp: str | None = None) -> list:
    """``fn(n, *args)`` on n spawned ranks of one process group; the ranks'
    results in rank order.  ``fn`` is a module-level function (the children
    import it by name) and its arguments and result pickle."""
    backend = backend or default_backend(n, device)
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="bvsc-ranks-", dir=tmp) as d:
        procs = [ctx.Process(target=_rank_main,
                             args=(n, r, d, fn, args, backend, device, timeout_s / 2))
                 for r in range(n)]
        for p in procs:
            p.start()
        try:
            for p in procs:
                p.join(timeout_s)
        finally:
            alive = [p for p in procs if p.is_alive()]
            for p in alive:
                p.kill()
                p.join()
        results = []
        for r, p in enumerate(procs):
            path = os.path.join(d, f"rank{r}.pkl")
            if not os.path.exists(path):
                raise RuntimeError(f"rank {r} of {fn.__name__} left no result "
                                   f"(exit code {p.exitcode})")
            with open(path, "rb") as f:
                status, value = pickle.load(f)
            if status != "ok":
                raise RuntimeError(f"rank {r} of {fn.__name__} failed:\n{value}")
            results.append(value)
    if alive:
        raise RuntimeError(f"{len(alive)} ranks of {fn.__name__} outlived {timeout_s} s")
    return results


# ---------------------------------------------------------------------------
# The dry run's configurations: small, and shapes the card's kernels take
# ---------------------------------------------------------------------------


def dry_vocoder():
    from bvsc_tpu_torch.config import VocoderConfig

    return VocoderConfig(num_mels=16, upsample_rates=(4, 2), upsample_kernel_sizes=(8, 4),
                         upsample_initial_channel=32, resblock_kernel_sizes=(3, 7),
                         resblock_dilation_sizes=((1, 3, 5), (1, 3, 5)),
                         layers_sym=(False, False), layers_antialias=(False, False),
                         mpd_reshapes=(2, 3),
                         resolutions=((128, 32, 64), (256, 64, 128), (512, 128, 256)),
                         discriminator_channel_mult=0.25)


def dry_codec_config():
    from bvsc_tpu_torch.config import CodecConfig

    return CodecConfig(num_mels=16, h_dim=64, z_dim=16, hopsize=8, winsize=64, mel_pad_left=16,
                       var_bit=True, vocoder_config=dry_vocoder())


def _err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def _gate(name: str, err: float, tol: float) -> float:
    if not err <= tol:
        raise AssertionError(f"{name}: {err:.3e} above {tol:.0e}")
    return err


def _spmd_checks(n: int, device) -> dict:
    """One rank's part of the dry run (module docstring)."""
    from bvsc_tpu_torch.config import CodecConfig
    from bvsc_tpu_torch.convert import to_torch
    from bvsc_tpu_torch.models import bvrnn as B
    from bvsc_tpu_torch.models import vocoder as V
    from bvsc_tpu_torch.parallel import pp as PP
    from bvsc_tpu_torch.parallel import sp as SP
    from bvsc_tpu_torch.parallel import tp as TP
    from bvsc_tpu_torch.parallel.mesh import make_mesh
    from bvsc_tpu_torch.train.bvrnn_train import BVRNNTrainer
    from bvsc_tpu_torch.train.vocoder_train import GANTrainConfig, VocoderGANTrainer

    devices = None if device is None else [device] * n
    mesh = make_mesh(devices=devices)
    dev, ax = mesh.device, mesh.axis("data")
    rng = np.random.default_rng(0)
    out = {}

    # data-parallel BVRNN step against one rank's step on the global batch
    conf = CodecConfig(h_dim=64, z_dim=16, num_mels=16, batch_size=2 * n)
    mel = torch.from_numpy(rng.standard_normal((2 * n, 12, conf.num_mels)).astype(np.float32))
    dp = BVRNNTrainer(conf, mesh=mesh).step(mel[2 * ax.index: 2 * ax.index + 2])
    one = BVRNNTrainer(conf, device=dev)
    ref = one.step(mel)
    out["loss"] = float(dp["loss"])
    out["dp_err"] = _gate("DP BVRNN loss", abs(out["loss"] - float(ref["loss"]))
                          / abs(float(ref["loss"])), GATES["dp"])

    # tensor-parallel decode and encode against one device
    cfg = one.cfg
    params = to_torch(one.host_params(), dev)
    tmesh = TP.make_tp_mesh(devices=devices)
    tpp = TP.shard_tp_params(TP.prepare_tp_params(params), tmesh)
    z = torch.from_numpy(rng.integers(0, 2, (2, 10, conf.z_dim)).astype(np.float32)).to(dev)
    h0 = torch.zeros(2, conf.h_dim, device=dev, dtype=cfg.dtype)
    with torch.no_grad():
        ref_mel, _ = B.decode(params, cfg, z, h0)
        ref_z, _ = B.encode_with_state(params, cfg, mel[:2].to(dev), torch.full(
            (2, 12), 8.0, device=dev), h0)
    tp_mel, _ = TP.decode_tp(tpp, cfg, z, h0, tmesh)
    tp_z, _ = TP.encode_tp(tpp, cfg, mel[:2], torch.full((2, 12), 8.0), h0, tmesh)
    out["tp_err"] = _gate("TP decode", _err(tp_mel, ref_mel), GATES["tp"])
    out["tp_codes_equal"] = bool(torch.equal(tp_z, ref_z))
    if not out["tp_codes_equal"]:
        raise AssertionError("TP encode codes differ from one device's")

    # data-parallel GAN step against one rank's step on the global batch
    vcfg = dry_vocoder()
    tcfg = GANTrainConfig(segment_size=512, batch_size=n, hop_size=8, n_fft=64, win_size=64,
                          mel_pad_left=16, fmax=4000.0, freeze_step=0)
    y = rng.standard_normal((n, tcfg.segment_size)).astype(np.float32) * 0.3
    gm = VocoderGANTrainer(vcfg, tcfg, mesh=mesh).step_on_audio(y[ax.index: ax.index + 1])
    gref = VocoderGANTrainer(vcfg, tcfg, device=dev).step_on_audio(y)
    out["gan_loss"] = float(gm["gen_loss_total"])
    out["gan_err"] = _gate("DP GAN loss", abs(out["gan_loss"] - float(gref["gen_loss_total"]))
                           / abs(float(gref["gen_loss_total"])), GATES["dp"])

    # sequence-parallel vocoder against one-shot, 8 frames a shard
    voc = to_torch(V.init_generator_params(2, vcfg), dev)
    blocks = V.prepare_kernel_params(voc, vcfg)
    T = 8 * n
    mel_sp = torch.from_numpy(rng.standard_normal((2, vcfg.num_mels, T)).astype(np.float32))
    with torch.no_grad():
        ref_wav = V.generator_apply_kernel(voc, blocks, vcfg, mel_sp.to(dev),
                                           T * vcfg.total_upsample)
    sp_wav = SP.generator_apply_sp(voc, vcfg, mel_sp, SP.make_sp_mesh(devices=devices),
                                   kernel_blocks=blocks)
    out["sp_err"] = _gate("SP vocoder", _err(sp_wav, ref_wav), GATES["sp"])

    # the two-stage pipeline against the unpipelined composition
    if n % 2 == 0:
        bcfg = B.BVRNNConfig(x_dim=vcfg.num_mels, h_dim=32, z_dim=8)
        bp = B.init_bvrnn_params(3, bcfg)
        n_micro, msz, frames = 3, 2, 10
        mel_mb = rng.standard_normal((n_micro, msz, frames, bcfg.x_dim)).astype(np.float32)
        bits_mb = rng.integers(1, bcfg.z_dim + 1, (n_micro, msz, frames)).astype(np.float32)
        pmesh = (PP.make_pp_mesh(devices) if n == 2
                 else PP.make_dp_pp_mesh(n // 2, devices=devices))
        codes, wav = PP.pipeline_resynth(bp, bcfg, voc, vcfg, mel_mb, bits_mb, pmesh)
        bpt = to_torch(bp, dev)
        with torch.no_grad():
            z0, mel0, _ = B.encode_decode(bpt, bcfg, torch.from_numpy(mel_mb[0]).to(dev),
                                          torch.from_numpy(bits_mb[0]).to(dev),
                                          torch.zeros(msz, bcfg.h_dim, device=dev,
                                                      dtype=bcfg.dtype))
            wav0 = V.generator_apply_kernel(voc, blocks, vcfg, mel0.transpose(1, 2).contiguous(),
                                            frames * vcfg.total_upsample)
        if not torch.equal(codes[0], z0):
            raise AssertionError("PP codes differ from the unpipelined run's")
        out["pp_err"] = _gate("PP resynthesis", _err(wav[0], wav0), GATES["pp"])
    return out


def _engine_checks(n: int, device) -> dict:
    """The sharded engines against unsharded ones, in this process."""
    from bvsc_tpu_torch import BVRNNCodecModel
    from bvsc_tpu_torch.parallel.mesh import make_mesh
    from bvsc_tpu_torch.serve.engine import DecodeEngine, ServingEngine
    from bvsc_tpu_torch.serve.export import (BundleServingEngine, ServingBundle,
                                             export_serving_bundle)

    dev = torch.device("cuda" if device is None else device)
    mesh = make_mesh(n, devices=None if device is None else [device] * n)
    conf = dry_codec_config()
    codec = BVRNNCodecModel(config=conf, seed=5, length_bucket=4, device=dev)
    rng = np.random.default_rng(1)
    codes = rng.integers(0, 2, (4, conf.z_dim)).astype(np.float32)
    lost = np.array([0, 1, 0, 0], np.float32)

    def run_decode(engine):
        sid = engine.open_stream(conceal_bitrate=500)
        engine.push(sid, codes, lost=lost)
        return np.concatenate([engine.tick()[sid] for _ in range(4)])

    out = {"decode_serve_err": _gate(
        "sharded DecodeEngine", float(np.abs(run_decode(DecodeEngine(codec, n, mesh=mesh))
                                             - run_decode(DecodeEngine(codec, n))).max()),
        GATES["serve"])}
    audio = (rng.standard_normal(conf.winsize - conf.mel_pad_left + 3 * conf.hopsize)
             * 0.3).astype(np.float32)

    def run_encode(engine):
        sid = engine.open_stream(bitrate=8000)
        engine.push(sid, audio)
        outs = []
        while engine.has_frame(sid):
            outs.append(engine.tick()[sid])
        return np.stack([c for c, _ in outs]), np.concatenate([w for _, w in outs])

    def held(name, engine, tol):
        got_codes, got_wav = run_encode(engine)
        if not np.array_equal(got_codes, ref_codes):
            raise AssertionError(f"{name}: codes differ from the unsharded engine's")
        out[name] = _gate(name, float(np.abs(got_wav - ref_wav).max()), tol)

    ref_codes, ref_wav = run_encode(ServingEngine(codec, n))
    held("serve_encode_err", ServingEngine(codec, n, mesh=mesh), GATES["serve"])
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "dryrun.bvscx")
        export_serving_bundle(codec, path, batch=1, lengths=(), packet=False, engine_batch=n)
        held("bundle_serve_err", BundleServingEngine(ServingBundle(path, dev), mesh=mesh),
             GATES["bundle"])
    return out


def dryrun_multichip(n_devices: int, device=None, timeout_s: float = TIMEOUT_S) -> dict:
    """The dry run (module docstring); returns its numbers and prints one
    line.  Raises on the first check that fails."""
    ranks = run_ranks(n_devices, _spmd_checks, device, device=device, timeout_s=timeout_s)
    result = {**ranks[0], **_engine_checks(n_devices, device)}
    print(f"dryrun_multichip({n_devices}): ok, " + ", ".join(
        f"{k}={v:.3e}" if isinstance(v, float) else f"{k}={v}" for k, v in result.items()),
        flush=True)
    return result


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="the multi-rank dry run of the parallel paths")
    p.add_argument("n_devices", type=int)
    p.add_argument("--device", default=None,
                   help="every rank's device (cpu, or one card shared); default card r on rank r")
    args = p.parse_args(argv)
    dryrun_multichip(args.n_devices, args.device)


if __name__ == "__main__":
    main()
