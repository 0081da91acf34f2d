"""BVRNN VAE training CLI (the port's ``scripts/train_bvrnn.py``).

    python -m bvsc_tpu_torch.cli.train_bvrnn --config configs/varbitrate.toml \
        --input_wavs_dir WAVS --input_training_file train.txt \
        --checkpoint_path exp/bvrnn [--device cpu]

A step: ``train_seq_duration``-second audio segments -> log-mel on the
device -> scheduled-sampling BVRNN forward -> NLL(log_sigma) + KLD ->
optax's clip and Adam (``train.bvrnn_train``).  The mel mean and std are
estimated from the first ``--stats_batches`` batches and frozen into the
fresh params.  Checkpoints are ``<checkpoint_path>/bvrnn_NNNNNNNN`` (the
port's format, ``train.checkpoint``), the run resumes from the latest, and
validation (closed loop, every bit) keeps the best one under ``best/``;
``cli.export_bvrnn_npz`` turns one into the ``.npz`` that
``BVRNNCodecModel(bvrnn_chkpt_path=)`` serves.  The run directory gets a
copy of the config.  Training runs on the card unless ``--device cpu``.

Data parallelism: one process per rank, each given ``--coordinator_address``
(``host:port`` of process 0, or a ``file://`` path all share),
``--num_processes`` and its ``--process_id``.  Each rank trains on its
shard of the filelist at the global batch divided by the world size (the
reference's error where it does not divide) and averages the gradients
with the others (``train.bvrnn_train``); the mel statistics are rank 0's.
Rank 0 alone copies the config, logs, validates and writes checkpoints;
every rank resumes from them and prints its steps (the losses are the
global batch's, equal on every rank).  Each rank runs on ``--device`` if
given, else on card ``process_id``; the backend follows the device (NCCL
on cards, gloo on the CPU) unless ``--dist_backend`` names one, as two
ranks sharing one card must (NCCL refuses that).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import shutil
import time

import numpy as np
import torch

from bvsc_tpu_torch.config import CodecConfig
from bvsc_tpu_torch.data.dataset import AudioSegmentDataset
from bvsc_tpu_torch.device import resolve_device
from bvsc_tpu_torch.models import bvrnn as bvrnn_mod
from bvsc_tpu_torch.ops.mel import MelFrontend
from bvsc_tpu_torch.parallel.collectives import broadcast
from bvsc_tpu_torch.parallel.mesh import DATA_AXIS, init_distributed, make_mesh
from bvsc_tpu_torch.train import checkpoint as ckpt
from bvsc_tpu_torch.train.bvrnn_train import BVRNNTrainer, StepDraws, loss_fn
from bvsc_tpu_torch.utils.logging import TrainLogger

PREFIX = "bvrnn_"
AUGMENT = {"speed": (0.85, 1.15), "gain_db": (-10.0, 0.0)}
AUGMENT_FULL = {"noise_snr_db": (8.0, 30.0), "noise_p": 0.5, "reverb_rt60": (0.1, 0.4),
                "reverb_p": 0.3, "pitch_semitones": (-2.0, 2.0), "pitch_p": 0.3}


def add_common_args(p: argparse.ArgumentParser) -> None:
    """``--device`` and the distributed flags, shared with ``train_vocoder``."""
    p.add_argument("--device", default=None,
                   help="torch device of every rank; default the CUDA card (raises without "
                        "one), card process_id under --coordinator_address")
    p.add_argument("--coordinator_address", default=None,
                   help="host:port of process 0 (or a file:// path all processes share); "
                        "presence enables data-parallel training over the processes")
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)
    p.add_argument("--dist_backend", choices=["nccl", "gloo"], default=None,
                   help="default by device: nccl on cards, gloo on the CPU (two ranks on one "
                        "card need gloo)")


class Distributed:
    """This process's place in a data-parallel run (module docstring): the
    mesh (None alone), its device, rank and world size."""

    def __init__(self, args):
        if not args.coordinator_address:
            if args.num_processes not in (None, 1) or args.process_id not in (None, 0):
                raise ValueError("--num_processes and --process_id need --coordinator_address")
            self.mesh, self.device, self.rank, self.world = None, resolve_device(args.device), 0, 1
            return
        init_distributed(args.coordinator_address, args.num_processes, args.process_id,
                         backend=args.dist_backend, device=args.device)
        devices = None if args.device is None else [args.device] * args.num_processes
        self.mesh = make_mesh(devices=devices)
        self.device, self.rank, self.world = self.mesh.device, args.process_id, args.num_processes

    @property
    def main(self) -> bool:
        """Rank 0: logs, validates and writes."""
        return self.rank == 0

    def local_batch(self, global_batch: int) -> int:
        """The per-rank batch (the reference divides by the world size)."""
        if global_batch % self.world:
            raise ValueError(f"batch_size {global_batch} not divisible by {self.world} processes")
        return global_batch // self.world

    def from_rank0(self, x: np.ndarray) -> np.ndarray:
        """Rank 0's ``x`` on every rank."""
        if self.mesh is None:
            return x
        t = torch.as_tensor(np.asarray(x, np.float32), device=self.device)
        return broadcast(t, self.mesh.axis(DATA_AXIS), 0).cpu().numpy()

    def close(self) -> None:
        if self.mesh is not None:
            torch.distributed.destroy_process_group()


def build_env(config_path: str, checkpoint_path: str) -> None:
    """Copy the config beside the checkpoints as ``config.<ext>``."""
    ext = os.path.splitext(config_path)[1] or ".toml"
    target = os.path.join(checkpoint_path, "config" + ext)
    if os.path.abspath(config_path) != os.path.abspath(target):
        os.makedirs(checkpoint_path, exist_ok=True)
        shutil.copyfile(config_path, target)


def read_filelist(path: str, wavs_dir: str) -> list[str]:
    """Pipe-separated filelist -> wav paths (``.wav`` added where missing)."""
    with open(path) as f:
        files = [os.path.join(wavs_dir, line.split("|")[0]) for line in f.read().splitlines()
                 if line]
    return [f if f.endswith(".wav") else f + ".wav" for f in files]


def augment_dict(args) -> dict | None:
    if not (args.augment or args.augment_full):
        return None
    return {**AUGMENT, **(AUGMENT_FULL if args.augment_full else {})}


def scalars(metrics: dict) -> dict:
    return {k: float(v) for k, v in metrics.items()}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--config", default="configs/varbitrate.toml")
    p.add_argument("--checkpoint_path", default="exp/bvrnn")
    p.add_argument("--input_wavs_dir", default="")
    p.add_argument("--input_training_file", required=True)
    p.add_argument("--input_validation_file", default=None)
    p.add_argument("--val_interval", type=int, default=None,
                   help="defaults to the config's val_interval")
    p.add_argument("--max_steps", type=int, default=None)
    p.add_argument("--stdout_interval", type=int, default=5)
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--stats_batches", type=int, default=8,
                   help="batches used to estimate the mel mean and std")
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--teacher_force_step_1perc", type=int, default=None,
                   help="override the config's scheduled-sampling ramp length")
    p.add_argument("--augment", action="store_true",
                   help="speed perturbation (0.85-1.15) and random gain (-10..0 dB) per crop")
    p.add_argument("--augment_full", action="store_true",
                   help="speed and gain plus additive noise (SNR 8-30 dB, p=0.5), "
                        "synthetic-RIR reverb (RT60 0.1-0.4 s, p=0.3) and WSOLA pitch "
                        "shift (+-2 semitones, p=0.3)")
    p.add_argument("--mel_mask", action="store_true",
                   help="SpecAugment-style denoising: time/frequency stripes of the "
                        "encoder's input mel replaced by the sequence mean")
    p.add_argument("--fused_cell", action="store_true",
                   help="the fused step (weight-concatenated products; same objective)")
    p.add_argument("--compute_dtype", choices=["f32", "bf16"], default=None,
                   help="bf16: forward and backward on a bf16 cast of the float32 masters")
    add_common_args(p)
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    dist = Distributed(args)
    try:
        train(args, dist)
    finally:
        dist.close()


def train(args, dist: Distributed) -> None:
    device = dist.device
    conf = CodecConfig.from_toml(args.config)
    if args.teacher_force_step_1perc is not None:
        conf = dataclasses.replace(conf, teacher_force_step_1perc=args.teacher_force_step_1perc)
    if dist.main:
        build_env(args.config, args.checkpoint_path)
    batch_size = dist.local_batch(args.batch_size or conf.batch_size)
    max_steps = args.max_steps or conf.max_steps
    segment = int(conf.train_seq_duration * conf.fs)
    segment -= segment % conf.hopsize

    trainset = AudioSegmentDataset(
        read_filelist(args.input_training_file, args.input_wavs_dir), segment, conf.fs,
        conf.hopsize, seed=args.seed, augment=augment_dict(args))
    frontend = MelFrontend(sampling_rate=conf.fs, n_fft=conf.winsize, num_mels=conf.num_mels,
                           hop_size=conf.hopsize, fmin=conf.fmin, fmax=conf.fmax,
                           padding_left=conf.mel_pad_left, device=device)

    def mel_fn(audio) -> torch.Tensor:
        with torch.no_grad():
            return frontend(torch.as_tensor(audio, device=device)).transpose(1, 2)

    # mel statistics over the first batches (rank 0's), frozen into the
    # fresh params
    batches = trainset.batches(batch_size, host_id=dist.rank, num_hosts=dist.world)
    stats = [mel_fn(next(batches)[0]).cpu().numpy() for _ in range(args.stats_batches)]
    cat = np.concatenate(stats).reshape(-1, conf.num_mels)
    mean_std = tuple(dist.from_rank0(np.stack([cat.mean(0), cat.std(0) + 1e-5])))
    print(f"mel stats from {len(stats)} batches: "
          f"mean[0]={mean_std[0][0]:.3f} std[0]={mean_std[1][0]:.3f}")

    trainer = BVRNNTrainer(conf, seed=args.seed, mean_std_mel=mean_std,
                           mel_mask={} if args.mel_mask else None, fused_cell=args.fused_cell,
                           compute_dtype=args.compute_dtype,
                           device=None if dist.mesh else device, mesh=dist.mesh)
    if conf.resume or ckpt.scan_checkpoint(args.checkpoint_path, PREFIX) is not None:
        state, start = ckpt.restore_latest(args.checkpoint_path, PREFIX)
        if state is not None:
            trainer.load_state_dict(state)
            print(f"resumed from step {start}")

    logger = TrainLogger(os.path.join(args.checkpoint_path, "logs") if dist.main else None)
    val_mels = None
    if args.input_validation_file and dist.main:
        valset = AudioSegmentDataset(
            read_filelist(args.input_validation_file, args.input_wavs_dir), segment, conf.fs,
            conf.hopsize, shuffle=False, seed=0)
        val_mels = mel_fn(np.stack([valset[i][0] for i in range(len(valset))]))
    val_interval = args.val_interval or conf.val_interval
    best_val = [np.inf]

    def val_draws(B: int, T: int) -> StepDraws:
        """Closed loop (every frame from the generated state), every bit, the
        binarisation noise from a fixed seed."""
        g = torch.Generator().manual_seed(0)
        _, noise = bvrnn_mod.draw_train_noise(g, 1.0, T, B, conf.z_dim, trainer.dtype)
        return StepDraws(torch.full((B, T), float(conf.z_dim), device=device),
                         torch.ones(T, dtype=torch.bool), noise.to(device))

    def validate(step: int) -> None:
        if val_mels is None:
            return
        B, T, _ = val_mels.shape
        with torch.no_grad():
            _, m = loss_fn(trainer.params, trainer.cfg, val_mels, val_draws(B, T),
                           trainer.dtype)
            m = scalars(m)
            logger.scalars(m, step, prefix="validation/")
            if logger._sw is not None:  # figures only when TensorBoard is live
                d = val_draws(1, T)
                dec, _ = bvrnn_mod.forward_train(trainer.params, trainer.cfg, val_mels[:1],
                                                 d.use_gen, True, d.bits, d.bin_noise,
                                                 dtype=trainer.dtype)
                gt, dec = val_mels[0].T.cpu().numpy(), dec[0].float().T.cpu().numpy()
                logger.spectrogram_figure("validation/gt_mel", gt, step)
                logger.spectrogram_figure("validation/decoded_mel", dec, step)
                logger.spectrogram_figure("validation/delta_dclip1",
                                          np.clip(np.abs(gt - dec), 1e-6, 1.0), step)
        print(f"validation @ {step}: mse={m['mse']:.4f} kld={m['kld']:.4f}")
        if m["mse"] < best_val[0]:
            best_val[0] = m["mse"]
            ckpt.save_step(os.path.join(args.checkpoint_path, "best"), PREFIX, step,
                           trainer.state_dict())
            print(f"  new best validation ({m['mse']:.4f}) -> best/{PREFIX}{step:08d}")

    if conf.validate_only:
        validate(trainer.step_count)
        return

    t0 = time.time()
    steps = trainer.step_count
    while steps < max_steps:
        audio, _ = next(batches)
        metrics = scalars(trainer.step(mel_fn(audio)))
        steps = trainer.step_count
        if steps % args.stdout_interval == 0:
            print(f"Steps : {steps}, loss : {metrics['loss']:.4f}, "
                  f"nll : {metrics['nll']:.4f}, kld : {metrics['kld']:.4f}, s/b : "
                  f"{(time.time() - t0) / args.stdout_interval:.3f}", flush=True)
            t0 = time.time()
        if steps % 100 == 0:
            logger.scalars(metrics, steps)
        if steps % conf.distinct_chkpt_interval == 0 and dist.main:
            ckpt.save_step(args.checkpoint_path, PREFIX, steps, trainer.state_dict())
            print(f"saved checkpoint at step {steps}")
        if steps % val_interval == 0:
            validate(steps)

    if dist.main:
        ckpt.save_step(args.checkpoint_path, PREFIX, steps, trainer.state_dict())
    logger.flush()
    print(f"done at step {steps}")


if __name__ == "__main__":
    main()
