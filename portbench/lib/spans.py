"""The program's own spans and counters (``bvsc_tpu_torch.utils.tracing``),
read in the benchmark's process after a run.

Each reader gives None where there is nothing to read: a program without the
registry, or one whose span or counter has another name.  The registry
holds every call of the process, set-up, profiled stretches and drain
included; the readers that take a median over it say so.
"""

from __future__ import annotations

from portbench.lib.stats import median


def _registry():
    try:
        from bvsc_tpu_torch.utils import tracing
    except ImportError:
        return None
    return tracing


def span_median_ms(name: str):
    """The median of the span's recorded durations, in ms, or None."""
    tracing = _registry()
    times = tracing.durations(name) if tracing is not None else []
    return median(times) * 1e3 if times else None


def _snapshot() -> dict:
    tracing = _registry()
    return tracing.snapshot() if tracing is not None else {"spans": {}, "counters": {}}


def span_count(name: str):
    """How many times the span was recorded, or None where it never was."""
    return _snapshot()["spans"].get(name, {}).get("count")


def counter(name: str):
    """The counter's value, or None where it was never counted."""
    return _snapshot()["counters"].get(name)
