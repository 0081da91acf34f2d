"""Objective evaluation of the codec over a set of wavs (port of
``scripts/evaluate_codec.py``).

Runs the reference's validation metrics (``third_party/BigVGAN/train.py:
150-227``: mel-L1, MRSTFT, PESQ) plus STOI and MCD over any wav set at any
bitrates, optionally under seeded packet loss with prior-based concealment
and with the effective bitrate after prior-adaptive entropy coding::

    python -m bvsc_tpu_torch.cli.evaluate_codec --stimuli_dir DIR \\
        --bvrnn_checkpoint chkpts/bvsc_bvrnn_demo_augfull_step1800_f16.npz \\
        --vocoder_checkpoint chkpts_npz/bvsc_vocoder_demo_cl_ft_g_step600_f16.npz \\
        --bitrates 1378 5512 [--loss_rate 0.1] [--entropy] [--device cpu]

The codec runs on the first CUDA card (its vocoder through the K1 kernels)
unless ``--device cpu``; mel-L1 and MRSTFT on the same device, STOI, MCD's
DCT and PESQ on the host.  With no checkpoints the weights are random (a
pipeline smoke test only).  Prints one row per (stimulus, bitrate) and a
summary JSON line; ``main`` returns the report.

Each row's loss pattern is seeded by ``(--loss_seed, crc32(stimulus name),
bitrate)``, so it is the same in every run (the JAX script seeds with
Python's ``hash``, which is salted per process).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import zlib

import numpy as np
import scipy.signal

from bvsc_tpu_torch.cli import BVRNN_HELP, VOCODER_HELP
from bvsc_tpu_torch.codec import DEFAULT_CONFIG, BVRNNCodecModel, host_bvrnn_params
from bvsc_tpu_torch.config import load_config
from bvsc_tpu_torch.data.audio import load_wav, peak_normalize
from bvsc_tpu_torch.entropy import PriorEntropyCoder
from bvsc_tpu_torch.eval.metrics import mcd, mel_l1, mrstft, pesq_wb_16k, stoi

def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m bvsc_tpu_torch.cli.evaluate_codec",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--config", default=DEFAULT_CONFIG)
    p.add_argument("--stimuli_dir", required=True,
                   help="directory of stim_*/ref.wav (or a flat dir of wavs)")
    p.add_argument("--bvrnn_checkpoint", default=None, help=BVRNN_HELP)
    p.add_argument("--vocoder_checkpoint", default=None,
                   help=VOCODER_HELP)
    p.add_argument("--bitrates", type=float, nargs="+", default=[1378.0, 5512.0],
                   help="bits/s; paper points: 1378 (16 b/frame), 5512 (64)")
    p.add_argument("--precision", default="highest", choices=["highest", "default"])
    p.add_argument("--entropy", action="store_true",
                   help="also report the effective bitrate after prior-adaptive entropy "
                        "coding (bvsc_tpu_torch.entropy.PriorEntropyCoder)")
    p.add_argument("--loss_rate", type=float, default=None,
                   help="also evaluate under this random packet-loss probability with "
                        "prior-based concealment (metrics reported with a _plc suffix)")
    p.add_argument("--loss_seed", type=int, default=0)
    p.add_argument("--loss_burst", type=float, default=None,
                   help="mean burst length in frames: draw losses from a two-state "
                        "Gilbert-Elliott channel at the same average --loss_rate instead of "
                        "i.i.d. frames")
    p.add_argument("--limit", type=int, default=None, help="max stimuli")
    p.add_argument("--out_json", default=None)
    p.add_argument("--device", default=None,
                   help="'cuda' (the default: the first card) or 'cpu'")
    return p.parse_args(argv)


def draw_losses(rng, n: int, rate: float, mean_burst=None) -> np.ndarray:
    """(n,) 0/1 loss flags: i.i.d. at `rate`, or a two-state Gilbert-Elliott
    chain with the given mean burst length at the same average rate
    (bursty losses are the realistic packet-network case and stress PLC
    state re-convergence much harder than isolated drops)."""
    if not mean_burst or mean_burst <= 1.0:
        return (rng.uniform(size=n) < rate).astype(np.float32)
    # stationary loss prob = p_gb / (p_gb + p_bg); mean burst = 1 / p_bg
    p_bg = 1.0 / mean_burst
    p_gb = rate * p_bg / max(1.0 - rate, 1e-9)
    lost = np.zeros(n, np.float32)
    bad = rng.uniform() < rate
    for t in range(n):
        lost[t] = float(bad)
        bad = rng.uniform() < (1.0 - p_bg if bad else p_gb)
    return lost


def loss_rng(seed: int, name: str, bps: float) -> np.random.Generator:
    """A row's loss-pattern generator: independent per stimulus and bitrate
    (one fixed pattern would bias the means), the same in every run."""
    return np.random.default_rng([seed, zlib.crc32(name.encode()) & 0x7FFFFFFF, int(bps)])


def find_wavs(root: str) -> list[str]:
    nested = sorted(glob.glob(os.path.join(root, "stim_*", "ref.wav")))
    return nested if nested else sorted(glob.glob(os.path.join(root, "*.wav")))


def load_22k(path: str) -> np.ndarray:
    """First channel, resampled to 22 050 Hz, peak-normalised, float32."""
    x, fs = load_wav(path)  # dtype-aware [-1, 1] float (int16/int32/float)
    if x.ndim > 1:
        x = x[:, 0]
    if fs != 22050:
        x = scipy.signal.resample_poly(x, 22050, fs)
    return peak_normalize(x).astype(np.float32)


def score(frontend, x: np.ndarray, y) -> dict:
    """The metrics of one output ``y`` (a tensor on the codec's device) of
    input ``x``: mel-L1 and MRSTFT on the device, the waveform brought to
    the host once for STOI, MCD and PESQ."""
    y_host = y.cpu().numpy()
    xd = y.new_tensor(x)[None]
    return {"mel_l1": mel_l1(frontend, xd, y[None]), "mrstft": mrstft(y[None], xd),
            "stoi": stoi(x, y_host), "mcd_db": mcd(frontend, x, y_host),
            "pesq_wb": pesq_wb_16k(x, y_host)}


def main(argv=None) -> dict:
    args = parse_args(argv)
    conf = load_config(args.config)
    bvrnn_params = host_bvrnn_params(conf, args.bvrnn_checkpoint)
    codec = BVRNNCodecModel(config=conf, bvrnn_params=bvrnn_params,
                            vocoder_chkpt_path=args.vocoder_checkpoint,
                            precision=args.precision, device=args.device)
    frontend = codec.frontend

    wavs = find_wavs(args.stimuli_dir)
    if args.limit:
        wavs = wavs[: args.limit]
    if not wavs:
        raise SystemExit(f"no wavs under {args.stimuli_dir}")
    ecoder = PriorEntropyCoder(bvrnn_params, codec.bvrnn_cfg) if args.entropy else None

    rows = []
    for path in wavs:
        x = load_22k(path)
        name = os.path.basename(os.path.dirname(path)) or os.path.basename(path)
        for bps in args.bitrates:
            y = codec(x[None, :], bps)[0][: x.shape[0]]
            row = {"stim": name, "bps": bps, "bits_per_frame": codec.bits_per_frame(bps)}
            row.update(score(frontend, x, y))
            codes = None
            if args.loss_rate is not None or ecoder is not None:
                codes = codec.encode(x[None, :], bps)[0]
            if args.loss_rate is not None:
                lost = draw_losses(loss_rng(args.loss_seed, name, bps), codes.shape[0],
                                   args.loss_rate, args.loss_burst)
                y_plc = codec.decode(codes[None], x.shape[0], lost=lost[None],
                                     conceal_bitrate=bps)[0]
                row["loss_pct"] = round(100.0 * float(lost.mean()), 2)
                row["mel_l1_plc"] = mel_l1(frontend, y_plc.new_tensor(x)[None], y_plc[None])
                row["stoi_plc"] = stoi(x, y_plc.cpu().numpy())
            if ecoder is not None:
                m = ecoder.measure(codes.cpu().numpy(), int(round(codec.bits_per_frame(bps))))
                # coded payload bits per second of audio
                row["entropy_bps"] = 8.0 * m["coded_bytes"] / (x.shape[0] / conf.fs)
                row["entropy_saving_pct"] = m["saving_pct"]
            rows.append(row)
            print(" ".join(f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
                           for k, v in row.items()), flush=True)

    summary = {}
    for bps in args.bitrates:
        sel = [r for r in rows if r["bps"] == bps]
        keys = ["mel_l1", "mrstft", "stoi", "mcd_db", "pesq_wb"]
        for extra in (("entropy_bps", "entropy_saving_pct"), ("mel_l1_plc", "stoi_plc")):
            if all(extra[0] in r for r in sel):
                keys += extra
        summary[str(bps)] = {k: round(float(np.mean([r[k] for r in sel])), 4) for k in keys}
    out = {"n_stimuli": len(wavs), "summary": summary}
    print(json.dumps(out))
    if args.out_json:
        with open(args.out_json, "w") as f:
            json.dump({"rows": rows, **out}, f, indent=2)
    return {"rows": rows, **out}


if __name__ == "__main__":
    main()
