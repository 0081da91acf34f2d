"""Validate the self-contained PESQ-WB model (``eval/pesq.py``) on the
evidence at hand: no ITU vectors and no ``pesq`` wheel (port of
``scripts/validate_pesq.py``).

Three layers, strongest first:

1. **Signal-level behaviour**: identical signals reach the 4.64 MOS-LQO
   ceiling; additive noise degrades the score strictly monotonically across
   40..0 dB SNR; lowpassing degrades it monotonically; a gain change is
   invisible (level alignment).
2. **Within-family orderings on the human-rated MUSHRA conditions**: for each
   codec family at two operating points (the paper's codec at 1.38 and 5.51
   kbps, Lyra at its two rates), the mean PESQ must order the conditions as
   the human means do.
3. **Cross-family correlation, reported and not asserted**: every rated
   condition is a generative codec, which loudness-difference models (ITU
   PESQ included) misrank across families.

::

    python -m bvsc_tpu_torch.cli.validate_pesq --dataset DIR [--out pesq_validation.json]

Runs on the host (numpy).  Exits 1 when a within-family ordering
disagrees, and raises when a signal-level check fails.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
from collections import defaultdict

import numpy as np
import scipy.signal
from scipy.io import wavfile
from scipy.stats import spearmanr

from bvsc_tpu_torch.eval.mushra import load_ratings
from bvsc_tpu_torch.eval.pesq import pesq_wb



def load_22k(path: str) -> np.ndarray:
    """First channel of an int16 wav, float64, resampled to 22 050 Hz (no
    normalisation)."""
    fs, data = wavfile.read(path)
    if data.ndim > 1:
        data = data[:, 0]
    x = data.astype(np.float64) / 32768.0
    if fs != 22050:
        x = scipy.signal.resample_poly(x, 22050, fs)
    return x


def human_means_per_file(dataset: str) -> dict[str, float]:
    rows = load_ratings(os.path.join(dataset, "ratings_formated_filtered.csv"))
    acc: dict[str, list[float]] = defaultdict(list)
    for r in rows:
        parts = r["file"].replace("\\", "/").split("/")
        acc["/".join(parts[-2:])].extend(float(v) for v in r["ratings"])
    return {k: float(np.mean(v)) for k, v in acc.items()}


def signal_level_checks(x: np.ndarray) -> dict:
    rng = np.random.default_rng(0)
    out = {"identical": pesq_wb(x, x, 22050),
           "gain_minus10db": pesq_wb(x, x * 10 ** (-0.5), 22050)}
    awgn = {}
    for snr in (40, 30, 20, 10, 0):
        noise = rng.standard_normal(x.size)
        noise *= np.sqrt((x ** 2).mean() / (noise ** 2).mean()) * 10 ** (-snr / 20)
        awgn[snr] = pesq_wb(x, x + noise, 22050)
    out["awgn_by_snr"] = awgn
    lp = {}
    for fc in (7000, 5000, 3000, 1500):
        sos = scipy.signal.butter(8, fc, fs=22050, output="sos")
        lp[fc] = pesq_wb(x, scipy.signal.sosfilt(sos, x), 22050)
    out["lowpass_by_fc"] = lp
    return out


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(prog="python -m bvsc_tpu_torch.cli.validate_pesq",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--dataset", required=True,
                   help="the MUSHRA dataset: ratings_formated_filtered.csv and audio/stim_*/")
    p.add_argument("--out", default="pesq_validation.json", help="the report's JSON path")
    args = p.parse_args(argv)

    human = human_means_per_file(args.dataset)
    x = load_22k(os.path.join(args.dataset, "audio", "stim_01", "ref.wav"))
    report = {"signal_level": signal_level_checks(x)}
    sl = report["signal_level"]
    assert sl["identical"] > 4.6
    assert abs(sl["gain_minus10db"] - sl["identical"]) < 0.05
    snrs = sorted(sl["awgn_by_snr"])  # ascending SNR
    assert all(sl["awgn_by_snr"][a] < sl["awgn_by_snr"][b]
               for a, b in zip(snrs, snrs[1:])), sl["awgn_by_snr"]
    fcs = sorted(sl["lowpass_by_fc"])
    assert all(sl["lowpass_by_fc"][a] < sl["lowpass_by_fc"][b] + 1e-9
               for a, b in zip(fcs, fcs[1:])), sl["lowpass_by_fc"]
    print("signal-level checks passed:", json.dumps(sl, default=lambda v: round(float(v), 3)))

    scores: dict[str, list[float]] = defaultdict(list)
    hums: dict[str, list[float]] = defaultdict(list)
    for sd in sorted(glob.glob(os.path.join(args.dataset, "audio", "stim_*"))):
        stim = os.path.basename(sd)
        ref = load_22k(os.path.join(sd, "ref.wav"))
        for wav in sorted(glob.glob(os.path.join(sd, "*.wav"))):
            base = os.path.basename(wav)
            key = f"{stim}/{base}"
            if base == "ref.wav" or key not in human:
                continue
            s = pesq_wb(ref, load_22k(wav), 22050)
            scores[base].append(s)
            hums[base].append(human[key])
            print(f"{key:32s} pesq={s:5.3f} human={human[key]:5.1f}", flush=True)

    cond = {b: {"pesq_mean": float(np.mean(v)), "human_mean": float(np.mean(hums[b])),
                "n": len(v)} for b, v in scores.items()}
    report["conditions"] = cond

    families = {"proposed": ("prop_13.wav", "prop_55.wav"), "lyra": ("lyra_32.wav", "lyra_6.wav")}
    ok = True
    within = {}
    for fam, (lo, hi) in families.items():
        human_order = cond[lo]["human_mean"] < cond[hi]["human_mean"]
        pesq_order = cond[lo]["pesq_mean"] < cond[hi]["pesq_mean"]
        within[fam] = {"human_prefers": hi if human_order else lo,
                       "pesq_prefers": hi if pesq_order else lo,
                       "agrees": human_order == pesq_order}
        ok &= human_order == pesq_order
        print(f"within-family {fam}: human prefers {within[fam]['human_prefers']}, pesq "
              f"{'agrees' if within[fam]['agrees'] else 'DISAGREES'}")
    report["within_family"] = within

    bases = sorted(cond)
    rho = float(spearmanr([cond[b]["pesq_mean"] for b in bases],
                          [cond[b]["human_mean"] for b in bases]).statistic)
    report["cross_family_spearman"] = round(rho, 3)
    report["cross_family_note"] = (
        "negative/weak by construction: all rated conditions are generative codecs, which "
        "PESQ-style models misrank across families (GAN spectral texture reads as additive "
        "disturbance); within-family orderings above are the valid comparisons")
    print(f"cross-family Spearman vs human means: {rho:+.3f} (reported, not asserted)")

    if os.path.dirname(args.out):
        os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1, sort_keys=True, default=lambda v: round(float(v), 4))
    print("->", args.out)
    if not ok:
        sys.exit(1)
    return report


if __name__ == "__main__":
    main()
