"""Rebuild the demo-training corpus (``data_local/``) from the reference's
MUSHRA stimuli (port of ``scripts/prepare_demo_data.py``).

The training evidence in ``docs/TRAINING.md`` used the 16 clean reference
signals of the MUSHRA listening-test dataset (``stim_*/ref.wav``),
resampled from 24 kHz to 22 050 Hz and split 14 train / 2 held out
(stim_15 and stim_16).  This recreates that corpus and its filelists (one
basename a line; the trainers' loaders add ``.wav``)::

    python -m bvsc_tpu_torch.cli.prepare_demo_data --src DATASET/audio [--out data_local]
    python -m bvsc_tpu_torch.cli.train_bvrnn --config configs/varbitrate.toml \\
        --input_wavs_dir data_local/wavs --input_training_file data_local/train.txt \\
        --input_validation_file data_local/val.txt ...

It runs on the host (numpy and scipy).
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np
import scipy.signal

from bvsc_tpu_torch.data.audio import load_wav, save_wav

DEFAULT_VAL = ["stim_15", "stim_16"]


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m bvsc_tpu_torch.cli.prepare_demo_data",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--src", required=True,
                   help="directory of stim_*/ref.wav clean reference signals (the MUSHRA "
                        "dataset's audio/)")
    p.add_argument("--out", default="data_local",
                   help="output corpus directory (wavs/ + filelists)")
    p.add_argument("--val", nargs="*", default=DEFAULT_VAL,
                   help="stimulus names held out for validation")
    p.add_argument("--fs", type=int, default=22050)
    return p.parse_args(argv)


def main(argv=None) -> tuple[list[str], list[str]]:
    args = parse_args(argv)
    refs = sorted(glob.glob(os.path.join(args.src, "stim_*", "ref.wav")))
    if not refs:
        raise SystemExit(f"no stim_*/ref.wav under {args.src}")
    wav_dir = os.path.join(args.out, "wavs")
    os.makedirs(wav_dir, exist_ok=True)
    train, val = [], []
    for path in refs:
        name = os.path.basename(os.path.dirname(path))  # stim_NN
        x, fs = load_wav(path)
        if x.ndim > 1:
            x = x[:, 0]
        if fs != args.fs:
            x = scipy.signal.resample_poly(x, args.fs, fs)
        save_wav(np.asarray(x, np.float32), os.path.join(wav_dir, name + ".wav"), args.fs)
        (val if name in set(args.val) else train).append(name)
    unknown = set(args.val) - {os.path.basename(os.path.dirname(p)) for p in refs}
    if unknown:
        raise SystemExit(f"--val names not found in corpus: {sorted(unknown)}")
    for fname, names in (("train.txt", train), ("val.txt", val)):
        with open(os.path.join(args.out, fname), "w") as f:
            f.write("\n".join(names) + "\n")
    print(f"wrote {len(train)} train / {len(val)} val wavs at {args.fs} Hz under {args.out}/")
    return train, val


if __name__ == "__main__":
    main()
