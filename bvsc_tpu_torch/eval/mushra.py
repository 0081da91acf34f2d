"""MUSHRA listening-test statistics tool (a copy of ``bvsc_tpu/eval/mushra.py``).

Parses the reference's published ratings CSVs
(``mushra_results_dataset/ratings_formated*.csv``: columns signal, condition,
ratings (list), participant_ids (list), file) and computes per-condition
statistics, re-deriving the paper's numbers (BASELINE.md: Reference 99.1,
Proposed 5.51 kbps 60.4, Proposed 1.38 kbps 54.3, ...).

Also implements the post-screening rule from the dataset README: drop
participants who rated the hidden reference below 90 in more than one of
their trials.

Run: ``python -m bvsc_tpu_torch.eval.mushra [--screen] path/to/ratings.csv``
(the dataset's screened file is ``ratings_formated_filtered.csv``).
"""

from __future__ import annotations

import ast
import csv
import sys
from collections import defaultdict

import numpy as np


def load_ratings(path: str) -> list[dict]:
    """Rows of {signal, condition, ratings: [float], participant_ids: [int],
    file}."""
    rows = []
    with open(path, newline="", encoding="utf-8") as f:
        for row in csv.DictReader(f):
            rows.append(
                {
                    "signal": row["signal"],
                    "condition": row["condition"],
                    "ratings": [float(x) for x in ast.literal_eval(row["ratings"])],
                    "participant_ids": list(ast.literal_eval(row["participant_ids"])),
                    "file": row["file"],
                }
            )
    return rows


def filter_participants(
    rows: list[dict], ref_condition: str = "Reference",
    threshold: float = 90.0, max_violations: int = 1,
) -> list[dict]:
    """Post-screening: drop raters scoring the hidden reference < threshold
    in more than ``max_violations`` trials (dataset README rule)."""
    violations: dict[int, int] = defaultdict(int)
    for row in rows:
        if row["condition"] == ref_condition:
            for pid, r in zip(row["participant_ids"], row["ratings"]):
                if r < threshold:
                    violations[pid] += 1
    bad = {pid for pid, n in violations.items() if n > max_violations}
    out = []
    for row in rows:
        keep = [
            (pid, r)
            for pid, r in zip(row["participant_ids"], row["ratings"])
            if pid not in bad
        ]
        out.append(
            {
                **row,
                "participant_ids": [p for p, _ in keep],
                "ratings": [r for _, r in keep],
            }
        )
    return out


def condition_stats(rows: list[dict]) -> dict[str, dict]:
    """Per-condition mean / std / 95% CI / n over all pooled ratings."""
    pooled: dict[str, list[float]] = defaultdict(list)
    for row in rows:
        pooled[row["condition"]].extend(row["ratings"])
    stats = {}
    for cond, vals in pooled.items():
        v = np.asarray(vals)
        sem = v.std(ddof=1) / np.sqrt(len(v)) if len(v) > 1 else 0.0
        stats[cond] = {
            "mean": float(v.mean()),
            "std": float(v.std(ddof=1)) if len(v) > 1 else 0.0,
            "ci95": float(1.96 * sem),
            "n": int(len(v)),
        }
    return stats


def per_stimulus_means(rows: list[dict]) -> dict[tuple[str, str], float]:
    return {
        (r["signal"], r["condition"]): float(np.mean(r["ratings"]))
        for r in rows if r["ratings"]
    }


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    screen = "--screen" in argv
    argv = [a for a in argv if a != "--screen"]
    if len(argv) != 1:
        raise SystemExit("usage: python -m bvsc_tpu_torch.eval.mushra [--screen] RATINGS_CSV")
    path = argv[0]
    rows = load_ratings(path)
    if screen:
        # the paper's participant screening rule (README.md:5 of the
        # dataset) — pass --screen when analysing the RAW ratings CSV (the
        # default _filtered.csv ships pre-screened)
        rows = filter_participants(rows)
        print("(participant screening applied)")
    stats = condition_stats(rows)
    width = max(len(c) for c in stats)
    print(f"{'condition':<{width}}  {'mean':>6}  {'±95%CI':>6}  {'n':>5}")
    for cond, s in sorted(stats.items(), key=lambda kv: -kv[1]["mean"]):
        print(f"{cond:<{width}}  {s['mean']:6.1f}  {s['ci95']:6.1f}  {s['n']:5d}")


if __name__ == "__main__":
    main()
