"""Ranges around the program's layers, and the reduction of a profiler trace.

The benchmark marks the calls into each layer from its own files: it wraps a
module attribute of the program (a function the layer above calls by name)
in a ``torch.profiler.record_function`` range ``portbench.<label>``, or in
CUDA events (:class:`PhaseEvents`).  A traced run profiles two stretches of
the same work: one tracing the device alone (the busy time, the idle share,
the operations by time: recording every host operation as well would slow
a host-paced loop about twofold and overstate its idle share), and one that
also records the host's operations and the ranges (what each range launched,
the idle gaps by range).  A profiled stretch is exported as a Chrome trace
under ``TMPDIR`` and reduced here:

* busy: the union of the device's kernel, copy and set intervals;
* per label: the device time of the operations whose launch lies inside a
  range of that label (the innermost one), found through the launch's
  correlation id, not by kernel name;
* idle gaps: the device's idle intervals, each charged to the innermost
  range that encloses the launch of the operation that ends it (what the
  host was doing while the device waited).
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import tempfile
import time

import torch

from portbench.lib.stats import union_length

PREFIX = "portbench."
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
OUTSIDE = "outside any range"


@contextlib.contextmanager
def wrapped(module, attr: str, wrapper_of):
    """``module.attr`` replaced by ``wrapper_of(original)`` inside the block."""
    original = getattr(module, attr)
    setattr(module, attr, wrapper_of(original))
    try:
        yield original
    finally:
        setattr(module, attr, original)


def ranged(label: str):
    """A wrapper maker: the function called inside ``record_function``."""
    def wrap(fn):
        def inner(*args, **kwargs):
            with torch.profiler.record_function(PREFIX + label):
                return fn(*args, **kwargs)
        return inner
    return wrap


class PhaseEvents:
    """Device time of labelled phases over many calls, from CUDA events
    recorded around them (host clocks on a CPU run); read after a sync."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.marks: dict[str, list] = {}

    def _mark(self):
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            return e
        return time.perf_counter()

    def wrap(self, label: str):
        def make(fn):
            def inner(*args, **kwargs):
                a = self._mark()
                out = fn(*args, **kwargs)
                self.marks.setdefault(label, []).append((a, self._mark()))
                return out
            return inner
        return make

    def seconds(self) -> dict[str, list[float]]:
        """Each label's phase durations, in seconds."""
        if self.cuda:
            torch.cuda.synchronize()
            return {k: [a.elapsed_time(b) / 1e3 for a, b in v] for k, v in self.marks.items()}
        return {k: [b - a for a, b in v] for k, v in self.marks.items()}


def profile(fn, device, ranges: bool = False) -> dict:
    """Run ``fn`` under ``torch.profiler`` and reduce its trace (module
    docstring): {'window_s', 'busy_s', 'label_device_s', 'device_ops',
    'idle_gaps', 'n_device_ops'}, or without device events only
    'window_s' and 'n_device_ops' 0.  The host's operations and the ranges
    are recorded with ``ranges`` only."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    cuda = torch.device(device).type == "cuda"
    acts = ([ProfilerActivity.CPU] if ranges or not cuda else []) + (
        [ProfilerActivity.CUDA] if cuda else [])
    with torch_profile(activities=acts) as prof:
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        if cuda:
            torch.cuda.synchronize()
        window = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".json", prefix="portbench-trace-")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return {"window_s": window, **reduce_events(events)}


def reduce_events(events: list) -> dict:
    """The reduction of Chrome-trace events (module docstring); times in s."""
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    dev = sorted((e for e in xs if e.get("cat") in DEVICE_CATS), key=lambda e: float(e["ts"]))
    if not dev:
        return {"n_device_ops": 0}
    launch_ts = {}
    for e in xs:
        if e.get("cat") in ("cuda_runtime", "cuda_driver"):
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launch_ts[corr] = float(e["ts"])
    ranges = sorted(((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"][len(PREFIX):])
                     for e in xs if e.get("cat") == "user_annotation"
                     and str(e.get("name", "")).startswith(PREFIX)), key=lambda r: r[0])
    starts = [r[0] for r in ranges]

    def label_at(ts):
        """The innermost range that holds ``ts`` (the latest start before it
        whose end is after it)."""
        if ts is None:
            return OUTSIDE
        i = bisect.bisect_right(starts, ts) - 1
        while i >= 0:
            a, b, name = ranges[i]
            if b >= ts:
                return name
            i -= 1
        return OUTSIDE

    spans, per_label, per_op, gaps = [], {}, {}, {}
    end = None
    for e in dev:
        a = float(e["ts"])
        b = a + float(e["dur"])
        spans.append((a, b))
        label = label_at(launch_ts.get((e.get("args") or {}).get("correlation")))
        per_label[label] = per_label.get(label, 0.0) + (b - a) / 1e6
        name = str(e.get("name", "?"))[:96]
        per_op[name] = per_op.get(name, 0.0) + (b - a) / 1e6
        if end is not None and a > end:
            gaps[label] = gaps.get(label, 0.0) + (a - end) / 1e6
        end = b if end is None else max(end, b)

    def top(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]

    return {"busy_s": union_length(spans) / 1e6, "label_device_s": per_label,
            "device_ops": top(per_op), "idle_gaps": top(gaps), "n_device_ops": len(dev)}
