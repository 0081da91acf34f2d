"""Compare codec output against the reference's published condition audio
(port of ``scripts/compare_reference_conditions.py``).

The reference's MUSHRA dataset ships the decoded audio of every
listening-test condition (``mushra_results_dataset/audio/stim_*/``: prop_13
and prop_55 are the paper's codec at 1.38 / 5.51 kbps, beside lyra, audiodec,
encodec and 16 kHz variants) with the raw human ratings.  This harness

1. scores every published condition wav against ``ref.wav`` with the
   objective metrics (mel-L1, MRSTFT, STOI, MCD),
2. scores the port's codec (any checkpoints) at the chosen bitrates on the
   same stimuli with the same metrics,
3. prints the per-condition table beside the published MUSHRA means
   (``eval.mushra``), and the Spearman rank correlation of each metric with
   the human scores over the rated conditions::

    python -m bvsc_tpu_torch.cli.compare_reference_conditions --dataset DIR \\
        --bvrnn_checkpoint chkpts/bvsc_bvrnn_demo_augfull_step1800_f16.npz \\
        --vocoder_checkpoint chkpts_npz/bvsc_vocoder_demo_cl_ft_g_step600_f16.npz \\
        --bitrates 1378 5512 [--skip_ours] [--device cpu]

``--skip_ours`` scores only the published conditions (no model run).  The
codec and the mel metrics run on the first CUDA card unless ``--device
cpu``.  ``main`` returns the report.
"""

from __future__ import annotations

import argparse
import glob
import json
import os

import numpy as np
import torch

from bvsc_tpu_torch.cli.evaluate_codec import load_22k
from bvsc_tpu_torch.codec import DEFAULT_CONFIG, BVRNNCodecModel
from bvsc_tpu_torch.config import load_config
from bvsc_tpu_torch.device import resolve_device
from bvsc_tpu_torch.eval.metrics import frontend_for, mcd, mel_l1, mrstft, stoi
from bvsc_tpu_torch.eval.mushra import condition_stats, load_ratings

METRICS = ("mel_l1", "mrstft", "stoi", "mcd_db")


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m bvsc_tpu_torch.cli.compare_reference_conditions",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--config", default=DEFAULT_CONFIG)
    p.add_argument("--dataset", required=True,
                   help="the MUSHRA dataset: ratings_formated_filtered.csv and audio/stim_*/")
    p.add_argument("--bvrnn_checkpoint", default=None, help="flat BVRNN .npz")
    p.add_argument("--vocoder_checkpoint", default=None,
                   help="flat vocoder .npz (tools/export_vocoder_npz.py)")
    p.add_argument("--bitrates", type=float, nargs="+", default=[1378.0, 5512.0],
                   help="paper operating points: 1378 / 5512 bps")
    p.add_argument("--skip_ours", action="store_true",
                   help="score only the published condition wavs")
    p.add_argument("--limit", type=int, default=None, help="max stimuli")
    p.add_argument("--out_json", default=None)
    p.add_argument("--device", default=None,
                   help="'cuda' (the default: the first card) or 'cpu'")
    return p.parse_args(argv)


def spearman(a, b) -> float:
    """Spearman rank correlation."""
    from scipy.stats import spearmanr

    return float(spearmanr(a, b).statistic)


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = resolve_device(args.device)
    conf = load_config(args.config)
    frontend = frontend_for(conf, device)

    # condition name <-> wav basename, from the ratings CSV itself
    rows = load_ratings(os.path.join(args.dataset, "ratings_formated_filtered.csv"))
    base_to_cond = {}
    for r in rows:
        base_to_cond.setdefault(os.path.basename(r["file"]), r["condition"])
    mushra = condition_stats(rows)

    stim_dirs = sorted(glob.glob(os.path.join(args.dataset, "audio", "stim_*")))
    if args.limit:
        stim_dirs = stim_dirs[: args.limit]
    if not stim_dirs:
        raise SystemExit(f"no stimuli under {args.dataset}")

    codec = None
    if not args.skip_ours:
        codec = BVRNNCodecModel(config=conf, bvrnn_chkpt_path=args.bvrnn_checkpoint,
                                vocoder_chkpt_path=args.vocoder_checkpoint, device=device)

    def score(ref: np.ndarray, deg: np.ndarray) -> dict:
        n = min(ref.shape[0], deg.shape[0])
        r, d = ref[:n], deg[:n]
        rt, dt = (torch.as_tensor(v[None, :], device=device) for v in (r, d))
        return {"mel_l1": mel_l1(frontend, rt, dt), "mrstft": mrstft(dt, rt),
                "stoi": stoi(r, d), "mcd_db": mcd(frontend, r, d)}

    def show(stim: str, cond: str, s: dict) -> None:
        print(f"{stim} {cond:18s} " + " ".join(f"{k}={v:.4f}" for k, v in s.items()), flush=True)

    per_cond: dict[str, list[dict]] = {}
    for sd in stim_dirs:
        stim = os.path.basename(sd)
        ref = load_22k(os.path.join(sd, "ref.wav"))
        for wav in sorted(glob.glob(os.path.join(sd, "*.wav"))):
            base = os.path.basename(wav)
            if base == "ref.wav":
                continue
            s = score(ref, load_22k(wav))
            per_cond.setdefault(base, []).append(s)
            show(stim, base, s)
        if codec is not None:
            for bps in args.bitrates:
                y = codec(ref[None, :], bps)[0][: ref.shape[0]].cpu().numpy()
                s = score(ref, y)
                per_cond.setdefault(f"ours_{int(bps)}", []).append(s)
                show(stim, f"ours_{int(bps)}", s)

    table = {}
    for cond, ss in sorted(per_cond.items()):
        table[cond] = {m: round(float(np.mean([s[m] for s in ss])), 4) for m in METRICS}
        table[cond]["n"] = len(ss)
        mcond = base_to_cond.get(cond)
        if mcond and mcond in mushra:
            table[cond]["mushra_mean"] = round(mushra[mcond]["mean"], 1)
            table[cond]["mushra_condition"] = mcond

    hdr = f"{'condition':20s} " + " ".join(f"{m:>8s}" for m in METRICS) + "   MUSHRA"
    print("\n" + hdr)
    print("-" * len(hdr))
    for cond, t in table.items():
        mu = f"{t['mushra_mean']:8.1f}" if "mushra_mean" in t else "       -"
        print(f"{cond:20s} " + " ".join(f"{t[m]:8.4f}" for m in METRICS) + mu)

    # objective-vs-human rank correlation over the rated conditions
    rated = [c for c in table if "mushra_mean" in table[c]]
    corr = {}
    if len(rated) >= 3:
        hums = [table[c]["mushra_mean"] for c in rated]
        for m in METRICS:
            corr[m] = round(spearman([table[c][m] for c in rated], hums), 3)
        print(f"\nSpearman rank corr with MUSHRA means (over {len(rated)} rated conditions): "
              + " ".join(f"{m}={corr[m]:+.3f}" for m in METRICS))

    out = {"n_stimuli": len(stim_dirs), "conditions": table, "spearman_vs_mushra": corr}
    print(json.dumps({"spearman_vs_mushra": corr}))
    if args.out_json:
        with open(args.out_json, "w") as f:
            json.dump(out, f, indent=2)
    return out


if __name__ == "__main__":
    main()
