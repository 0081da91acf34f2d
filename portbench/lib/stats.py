"""The benchmark's arithmetic on timings: percentiles, rates, busy unions.

Frozen here, so that later changes to the program cannot move the
yardstick.
"""

from __future__ import annotations

import math


def percentile(values, q: float) -> float:
    """The ``q``-th percentile (0-100) by linear interpolation between
    closest ranks (numpy's default); a single value is its own."""
    v = sorted(float(x) for x in values)
    if not v:
        raise ValueError("percentile of no values")
    pos = (len(v) - 1) * q / 100
    lo = math.floor(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def median(values) -> float:
    return percentile(values, 50)


def rate(work: float, seconds: float) -> float:
    """Work over the seconds it took."""
    if seconds <= 0:
        raise ValueError(f"a rate over {seconds} s")
    return work / seconds


def union_length(intervals) -> float:
    """Total length covered by (start, end) intervals, overlaps counted once."""
    total, end = 0.0, -math.inf
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total
