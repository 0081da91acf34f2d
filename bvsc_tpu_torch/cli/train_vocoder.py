"""Vocoder GAN training CLI (the port's ``scripts/train_vocoder.py``; the
reference's ``third_party/BigVGAN/train.py`` flags where they apply).

    python -m bvsc_tpu_torch.cli.train_vocoder --config configs/varbitrate.toml \
        --input_wavs_dir WAVS --input_training_file train.txt \
        --input_validation_file val.txt --checkpoint_path exp/voc [--device cpu]

The config is a codec TOML (its ``vocoder_config`` table and DSP keys) or a
BigVGAN-style JSON.  Checkpoints are ``g_NNNNNNNN`` (the folded generator)
and ``do_NNNNNNNN`` (generator, discriminators, optimizers) in the port's
format (``train.checkpoint``); a run resumes from the latest ``do_``.
``--init_generator`` warm-starts the generator from a port ``g_``
checkpoint or a vocoder ``.npz`` (``tools/export_vocoder_npz.py``), folded
weights re-parametrised as weight norm.  ``--fine_tuning`` trains on
precomputed ``.npy`` mels (``--input_mels_dir``) with the target audio at
the codec's -10 dB unless ``--audio_scale`` says otherwise.  Validation
reports the loss-band mel L1 and the multi-resolution STFT loss per set
(seen, and each ``unseen_<name>``); STOI and PESQ come with the eval
metrics (ROADMAP item 12).  Training runs on the card unless ``--device
cpu``; ``--coordinator_address`` / ``--num_processes`` / ``--process_id``
train data-parallel as ``cli.train_bvrnn`` does (each rank its shard at the
global batch over the world size; rank 0 logs, validates, saves audio and
writes checkpoints).
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from bvsc_tpu_torch.cli.train_bvrnn import (Distributed, add_common_args, augment_dict,
                                            build_env, read_filelist, scalars)
from bvsc_tpu_torch.codec import SCALING
from bvsc_tpu_torch.config import CodecConfig, VocoderConfig
from bvsc_tpu_torch.convert import load_vocoder_npz
from bvsc_tpu_torch.data.audio import save_wav
from bvsc_tpu_torch.data.dataset import AudioSegmentDataset
from bvsc_tpu_torch.models import vocoder as voc_mod
from bvsc_tpu_torch.ops.stft_loss import multi_resolution_stft_loss
from bvsc_tpu_torch.train import checkpoint as ckpt
from bvsc_tpu_torch.train.vocoder_train import (GANTrainConfig, VocoderGANTrainer,
                                                generator_from_checkpoint)
from bvsc_tpu_torch.utils.logging import TrainLogger


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--config", required=True)
    p.add_argument("--checkpoint_path", default="exp/vocoder")
    p.add_argument("--input_wavs_dir", default="")
    p.add_argument("--input_training_file", required=True)
    p.add_argument("--input_validation_file", default=None)
    p.add_argument("--input_mels_dir", default=None, help="precomputed .npy mels for --fine_tuning")
    p.add_argument("--list_input_unseen_wavs_dir", nargs="+", default=[],
                   help="wav dirs of extra (unseen-speaker) validation sets")
    p.add_argument("--list_input_unseen_validation_file", nargs="+", default=[],
                   help="filelists of extra validation sets, validated as unseen_<name>")
    p.add_argument("--training_epochs", type=int, default=100000)
    p.add_argument("--max_steps", type=int, default=None)
    p.add_argument("--stdout_interval", type=int, default=5)
    p.add_argument("--checkpoint_interval", type=int, default=50000)
    p.add_argument("--summary_interval", type=int, default=100)
    p.add_argument("--validation_interval", type=int, default=50000)
    p.add_argument("--freeze_step", type=int, default=0)
    p.add_argument("--fine_tuning", action="store_true")
    p.add_argument("--augment", action="store_true",
                   help="speed perturbation (0.85-1.15) and random gain (-10..0 dB) per crop "
                        "(not with --fine_tuning)")
    p.add_argument("--augment_full", action="store_true",
                   help="speed and gain plus additive noise, synthetic-RIR reverb and WSOLA "
                        "pitch shift (see train_bvrnn)")
    p.add_argument("--init_generator", default=None,
                   help="warm-start the generator from a port g_ checkpoint or a vocoder "
                        ".npz (fresh discriminators and optimizers); ignored on resume")
    p.add_argument("--audio_scale", type=float, default=None,
                   help="multiply the target audio by this; default the codec's -10 dB "
                        "scaling with --fine_tuning, else 1")
    p.add_argument("--debug", action="store_true", help="skip validation")
    p.add_argument("--evaluate", action="store_true", help="validate and exit")
    p.add_argument("--eval_subsample", type=int, default=5,
                   help="log audio and spectrogram figures for every nth validation item")
    p.add_argument("--skip_seen", action="store_true",
                   help="skip the seen-speaker validation set")
    p.add_argument("--save_audio", action="store_true",
                   help="also write validation wavs under <checkpoint_path>/samples/")
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--segment_size", type=int, default=8192)
    p.add_argument("--seed", type=int, default=1234)
    add_common_args(p)
    return p.parse_args(argv)


def load_configs(args) -> tuple[VocoderConfig, GANTrainConfig]:
    if args.config.endswith(".json"):
        with open(args.config) as f:
            raw = json.load(f)
        vcfg = VocoderConfig.from_dict(raw)
        tcfg = GANTrainConfig(
            learning_rate=raw.get("learning_rate", 1e-4), adam_b1=raw.get("adam_b1", 0.8),
            adam_b2=raw.get("adam_b2", 0.99), lr_decay=raw.get("lr_decay", 0.999),
            freeze_step=args.freeze_step,
            segment_size=raw.get("segment_size", args.segment_size),
            batch_size=args.batch_size or raw.get("batch_size", 32),
            sampling_rate=raw.get("sampling_rate", 22050), n_fft=raw.get("n_fft", 1024),
            hop_size=raw.get("hop_size", 256), win_size=raw.get("win_size", 1024),
            fmin=raw.get("fmin", 0), fmax=raw.get("fmax", 8000),
            fmax_for_loss=raw.get("fmax_for_loss"), mel_pad_left=raw.get("mel_pad_left", 256))
    else:
        conf = CodecConfig.from_toml(args.config)
        vcfg = conf.vocoder_config
        tcfg = GANTrainConfig(
            freeze_step=args.freeze_step, segment_size=args.segment_size,
            batch_size=args.batch_size or conf.batch_size, sampling_rate=conf.fs,
            n_fft=conf.winsize, hop_size=conf.hopsize, win_size=conf.winsize, fmin=conf.fmin,
            fmax=conf.fmax, mel_pad_left=conf.mel_pad_left)
    return vcfg, tcfg


def load_generator(path: str) -> dict:
    """A generator tree from a port ``g_`` / ``do_`` checkpoint or a vocoder
    ``.npz``."""
    if path.endswith(".npz"):
        return load_vocoder_npz(path)
    return generator_from_checkpoint(ckpt.load(path))


def main(argv=None):
    args = parse_args(argv)
    dist = Distributed(args)
    try:
        train(args, dist)
    finally:
        dist.close()


def train(args, dist: Distributed) -> None:
    device = dist.device
    vcfg, tcfg = load_configs(args)
    if dist.main:
        build_env(args.config, args.checkpoint_path)
    local_batch = dist.local_batch(tcfg.batch_size)
    state, start_step = ckpt.restore_latest(args.checkpoint_path, "do_")
    warm = state is None and args.init_generator
    trainer = VocoderGANTrainer(vcfg, tcfg, seed=args.seed, device=None if dist.mesh else device,
                                mesh=dist.mesh,
                                gen_params=load_generator(args.init_generator) if warm else None)
    if state is not None:
        trainer.load_state_dict(state)
        print(f"resumed from step {start_step}")
    elif warm:
        print(f"generator warm-started from {args.init_generator}")

    if (args.augment or args.augment_full) and args.fine_tuning:
        raise SystemExit("--augment is incompatible with --fine_tuning (precomputed mels "
                         "would desync from the augmented waveform)")
    trainset = AudioSegmentDataset(
        read_filelist(args.input_training_file, args.input_wavs_dir), tcfg.segment_size,
        tcfg.sampling_rate, tcfg.hop_size, fine_tuning=args.fine_tuning,
        base_mels_path=args.input_mels_dir, seed=args.seed, augment=augment_dict(args))

    def set_name(filelist):
        return os.path.splitext(os.path.basename(filelist))[0]

    val_files = (read_filelist(args.input_validation_file, args.input_wavs_dir)
                 if args.input_validation_file else [])
    if len(args.list_input_unseen_wavs_dir) != len(args.list_input_unseen_validation_file):
        raise SystemExit("--list_input_unseen_wavs_dir and --list_input_unseen_validation_file "
                         "must pair up")
    unseen_sets = [(f"unseen_{set_name(fl)}", read_filelist(fl, wd))
                   for wd, fl in zip(args.list_input_unseen_wavs_dir,
                                     args.list_input_unseen_validation_file)]
    logger = TrainLogger(os.path.join(args.checkpoint_path, "logs") if dist.main else None)

    @torch.no_grad()
    def validate(step: int, files: list[str], mode: str) -> None:
        """One validation set: loss-band mel L1 and MRSTFT, figures and
        audio of every ``--eval_subsample``-th item (rank 0 only)."""
        if not files or not dist.main:
            return
        valset = AudioSegmentDataset(files, tcfg.segment_size, tcfg.sampling_rate,
                                     tcfg.hop_size, split=False, shuffle=False, seed=args.seed)
        samples = os.path.join(args.checkpoint_path, "samples")
        if args.save_audio:
            os.makedirs(os.path.join(samples, f"gt_{mode}"), exist_ok=True)
            os.makedirs(os.path.join(samples, f"{mode}_{step:08d}"), exist_ok=True)
        errs, stfts = [], []
        for i in range(len(valset)):
            audio = valset[i][0]
            y = torch.as_tensor(audio[None, :], device=device)
            mel = trainer.input_frontend(y)
            y_hat = voc_mod.generator_apply(trainer.gen, vcfg, mel, audio.shape[0])[:, 0]
            errs.append(float(torch.mean(torch.abs(trainer.loss_frontend(y)
                                                   - trainer.loss_frontend(y_hat)))))
            stfts.append(float(multi_resolution_stft_loss(y_hat, y)))
            if i % args.eval_subsample == 0:
                y_np = y_hat[0].cpu().numpy()
                logger.audio(f"gt_{mode}/y_{i}", audio, step, tcfg.sampling_rate)
                logger.audio(f"generated_{mode}/y_hat_{i}", y_np, step, tcfg.sampling_rate)
                mel_hat = trainer.input_frontend(y_hat)
                t = min(mel.shape[-1], mel_hat.shape[-1])
                m, mh = mel[0].cpu().numpy(), mel_hat[0].cpu().numpy()
                logger.spectrogram_figure(f"gt_{mode}/y_spec_{i}", m, step)
                logger.spectrogram_figure(f"generated_{mode}/y_hat_spec_{i}", mh, step)
                logger.spectrogram_figure(f"delta_dclip1_{mode}/spec_{i}",
                                          np.clip(np.abs(m[:, :t] - mh[:, :t]), 1e-6, 1.0), step)
                if args.save_audio:
                    save_wav(audio, os.path.join(samples, f"gt_{mode}", f"{i:04d}.wav"),
                             tcfg.sampling_rate)
                    save_wav(y_np, os.path.join(samples, f"{mode}_{step:08d}", f"{i:04d}.wav"),
                             tcfg.sampling_rate)
        logger.scalar(f"validation_{mode}/mel_spec_error", np.mean(errs), step)
        logger.scalar(f"validation_{mode}/mrstft", np.mean(stfts), step)
        print(f"validation @ {step} [{mode}]: mel_l1={np.mean(errs):.4f} "
              f"mrstft={np.mean(stfts):.4f}", flush=True)

    def validate_all(step: int) -> None:
        if not args.skip_seen:
            validate(step, val_files, f"seen_{set_name(args.input_validation_file)}"
                     if args.input_validation_file else "seen")
        for mode, files in unseen_sets:
            validate(step, files, mode)

    if args.evaluate:
        validate_all(trainer.step_count)
        return

    def save(steps: int) -> None:
        if dist.main:
            ckpt.save_step(args.checkpoint_path, "g_", steps, trainer.generator_state_dict())
            ckpt.save_step(args.checkpoint_path, "do_", steps, trainer.state_dict())

    audio_scale = args.audio_scale
    if audio_scale is None:
        audio_scale = SCALING if args.fine_tuning else 1.0
    steps = trainer.step_count
    if steps != 0 and not args.debug:
        validate_all(steps)  # a resumed run starts with a validation pass
    steps_per_epoch = max(1, len(trainset) // tcfg.batch_size)
    t0 = time.time()
    for audio, mel_ft in trainset.batches(local_batch, host_id=dist.rank, num_hosts=dist.world):
        trainer.set_epoch(steps // steps_per_epoch)
        metrics = scalars(trainer.step_on_audio(audio * audio_scale, mel_ft))
        steps += 1
        if steps % args.stdout_interval == 0:
            print(f"Steps : {steps}, Gen Loss Total : {metrics['gen_loss_total']:.3f}, "
                  f"Mel-Spec. Error : {metrics['mel_spec_error']:.3f}, s/b : "
                  f"{(time.time() - t0) / args.stdout_interval:.3f}", flush=True)
            t0 = time.time()
        if steps % args.summary_interval == 0:
            logger.scalars(metrics, steps)
        if steps % args.checkpoint_interval == 0:
            save(steps)
            print(f"saved checkpoints at step {steps}")
        if steps % args.validation_interval == 0 and not args.debug:
            validate_all(steps)
        if args.max_steps is not None and steps >= args.max_steps:
            break
    save(steps)
    logger.flush()
    print(f"done at step {steps}")


if __name__ == "__main__":
    main()
