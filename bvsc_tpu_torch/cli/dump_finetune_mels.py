"""Dump BVRNN-decoded mels to ``.npy`` for vocoder fine-tuning (port of
``scripts/dump_finetune_mels.py``).

The reference fine-tunes its vocoder on BVRNN-decoded mel spectrograms
(``meldataset.py:197-214`` reads precomputed ``<stem>.npy`` mels); the tool
that writes them was never published.  This one does: wav -> (x * SCALING)
-> mel -> BVRNN encode at the bitrate -> BVRNN decode -> the decoded log-mel
as a ``(num_mels, frames)`` float32 array, the tensor the codec's vocoder
consumes at decode time::

    python -m bvsc_tpu_torch.cli.dump_finetune_mels --config configs/varbitrate.toml \\
        --bvrnn_checkpoint CKPT --input_training_file train.txt \\
        --input_wavs_dir WAVS --output_dir mels/ --bitrate 3000 [--device cpu]

The mels are in the -10 dB SCALING domain (the codec divides the vocoder's
output by SCALING afterwards), so fine-tuning pairs them with SCALING-scaled
target audio: ``python -m bvsc_tpu_torch.cli.train_vocoder --fine_tuning
--input_mels_dir mels/`` applies that scale by default (``--audio_scale``).
The BVRNN runs on the first CUDA card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from bvsc_tpu_torch.cli import BVRNN_HELP
from bvsc_tpu_torch.cli.train_bvrnn import read_filelist
from bvsc_tpu_torch.codec import DEFAULT_CONFIG, BVRNNCodecModel
from bvsc_tpu_torch.data.audio import load_wav


def dump_mels(codec: BVRNNCodecModel, files: list[str], output_dir: str, bitrate: float, *,
              random_bitrate: tuple[float, float] | None = None, seed: int = 0,
              verbose: bool = True) -> list[str]:
    """Encode and mel-decode each wav through ``codec`` and write
    ``output_dir/<stem>.npy`` of shape (num_mels, frames).

    ``random_bitrate=(lo, hi)`` draws one bitrate per utterance uniformly,
    to fine-tune across the codec's operating range (the reference trains
    the variable-bitrate model with per-sequence bitrate redraws,
    ``configs/config_varBitRate.toml:29`` p_bitratechange)."""
    os.makedirs(output_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    written = []
    for path in files:
        wav, _ = load_wav(path, codec.conf.fs)
        if wav.ndim > 1:
            wav = wav[:, 0]
        # no peak normalisation: the fine-tuning dataset mode loads raw audio
        # (reference meldataset.py:160-163 normalises only when not
        # fine-tuning), so the mels must match the raw waveform
        br = rng.uniform(*random_bitrate) if random_bitrate is not None else bitrate
        codes = codec.encode(wav.astype(np.float32), br)
        mel = codec.decode_to_mel(codes).cpu().numpy().astype(np.float32)
        out = os.path.join(output_dir, os.path.splitext(os.path.basename(path))[0] + ".npy")
        np.save(out, mel)
        written.append(out)
        if verbose:
            print(f"{out}: {mel.shape} @ {br:.0f} bps")
    return written


def main(argv=None) -> list[str]:
    p = argparse.ArgumentParser(prog="python -m bvsc_tpu_torch.cli.dump_finetune_mels",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--config", default=None)
    p.add_argument("--bvrnn_checkpoint", default=None, help=BVRNN_HELP)
    p.add_argument("--input_wavs_dir", default="")
    p.add_argument("--input_training_file", default=None,
                   help="pipe-separated filelist (reference format); if omitted, every .wav "
                        "under --input_wavs_dir")
    p.add_argument("--output_dir", required=True)
    p.add_argument("--bitrate", type=float, default=3000.0)
    p.add_argument("--random_bitrate", type=float, nargs=2, default=None, metavar=("LO", "HI"),
                   help="draw one bitrate per utterance uniformly in [LO, HI]")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="'cuda' (the default: the first card) or 'cpu'")
    args = p.parse_args(argv)

    codec = BVRNNCodecModel(args.config or DEFAULT_CONFIG,
                            bvrnn_chkpt_path=args.bvrnn_checkpoint, device=args.device)
    if args.input_training_file:
        files = read_filelist(args.input_training_file, args.input_wavs_dir)
    else:
        files = sorted(os.path.join(args.input_wavs_dir, f)
                       for f in os.listdir(args.input_wavs_dir) if f.endswith(".wav"))
    written = dump_mels(codec, files, args.output_dir, args.bitrate,
                        random_bitrate=tuple(args.random_bitrate) if args.random_bitrate else None,
                        seed=args.seed)
    print(f"wrote {len(written)} mel files to {args.output_dir}")
    return written


if __name__ == "__main__":
    main()
