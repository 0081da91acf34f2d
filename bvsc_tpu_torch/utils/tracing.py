"""Spans and counters of the port's layers, read from the running process.

* :class:`span` (``with tracing.span("serve.tick"):``) adds the block's
  duration on the host clock (``time.perf_counter_ns``) to a record of its
  name: the count, the total and a ring of the last :data:`RING` durations.
  While a ``torch.profiler`` profile is recording, the block also runs
  inside a ``bvsc.<name>`` user annotation, so the span lies on the
  profiler's clock beside the device's work.  A ``numbered`` span (an
  engine's tick, a codec's public call) names its range
  ``bvsc.<name>#<n>``, n its own record's count once it ends, failed calls
  included: what joins a stretch of trace to the counters, since a trace
  keeps no range args.  With no profile no range is entered.  A range is
  entered through torch's direct binding (``torch.autograd.
  _record_function_with_args_enter``), a few microseconds, not
  ``torch.profiler.record_function``'s operator call; torch does not say
  whether a profile records host activity, so a device-only profile enters
  the ranges too, though it records none of them.
* :func:`count` adds to a monotonic integer counter.
* :func:`snapshot` is everything at once, for an operator: each span's
  count and total, and each counter.  :func:`reset` zeroes everything;
  :func:`durations` is one span's ring, for a reader that wants its
  quantiles.

Recording is always on.  Under ``torch.compile`` or ``torch.export``
(``torch.compiler.is_compiling()`` / ``is_exporting()``) spans and counters
record nothing: a traced program keeps none, and exporting moves no count.

Spans, each in the one function every path runs:

* ``serve.tick`` / ``decode.tick``: ``serve.engine``'s ``ServingEngine.tick``
  / ``DecodeEngine.tick``, a tick that advances a stream or fails (one
  that advances none records nothing), with its children ``.gather`` (the
  host slot loop), ``.copy`` (every host-to-device copy), ``.issue`` (launching the
  device step, and any host read inside it) and ``.wait`` (the read-back);
* ``codec.call``, ``codec.encode``, ``codec.decode``: ``BVRNNCodecModel``'s
  ``__call__``, ``encode`` and ``decode``;
* ``mel``: ``ops.mel.MelFrontend.log_mel``, one-shot and streaming;
* ``bvrnn.scan``: ``models.bvrnn._frames``, one BVRNN scan (T frames; on
  the card's chunk graphs, the host's time to enqueue their replays);
  ``bvrnn.lost_read``: ``decode_plc``'s host read of the loss flags;
* ``vocoder``: the generator, one-shot (``models.vocoder._apply``) or
  streaming (``streaming.generator_stream_step``); ``vocoder.stage``: one
  stage's residual stack inside it; ``vocoder.aa``: one anti-aliased
  activation (``models.vocoder.antialiased``, direct path).

Counters: ``<engine>.frames`` (streams advanced), ``.slots_open`` (open
slots, summed over ticks), ``.h2d_copies`` and ``.h2d_bytes`` (the tick's
explicit host-to-device copies), ``serve.starts`` (streams started),
``decode.concealed`` (frames concealed); ``codec.frames`` (rows x real
frames of each public codec call); ``bvrnn.graph_captures`` (chunk graphs
captured, ``models.bvrnn._ChunkGraph``) and ``bvrnn.graph_frames`` (rows x
frames of every chunk replayed, counted outside the graph);
``vocoder.aa_elements`` (rows x channels x samples each anti-aliased
activation filtered).  Every hand-written kernel counts its launches, after
each, in its wrapper: ``amp_resblock.launches``, ``.launches_bf16``,
``.launches_io_bf16`` and ``.launches_bf16_io_bf16`` (K1 and K1-bf16 with
float32 and bf16 activations, ``ops.amp_resblock.launch``),
``persistent_gru.launches`` (K2), ``dot_chain.launches`` and
``gridded_dot.launches`` (K3, K4, ``ops.dot_probe``) and
``vocoder.aa_kernel`` (``ops.resample``'s anti-aliased activation).  A
counter never counted is absent from :func:`snapshot`.  How many ticks or
calls ran is their span's count.  Under a CUDA graph the counters count at
capture.

Threads: there is no lock.  Under the GIL each dictionary and deque
operation is atomic, so records are never corrupted and a snapshot taken
from another thread copies each one whole; but an increment is a
read-modify-write, so two threads recording the same name at the same
moment may lose one of the two.  The daemon ticks both engines from its
one ticker thread.
"""

from __future__ import annotations

import collections
import time

import torch
import torch.autograd.profiler as _profiler

RING = 16384  # durations kept a span: every tick of a 30-s stream run
PREFIX = "bvsc."  # of the profiler ranges


class _Record:
    __slots__ = ("count", "total_ns", "ring")

    def __init__(self):
        self.count = 0
        self.total_ns = 0
        self.ring: collections.deque[int] = collections.deque(maxlen=RING)


_spans: dict[str, _Record] = {}
_counters: dict[str, int] = {}


_clock = time.perf_counter_ns


def _tracing() -> bool:
    """Whether this Python runs inside a ``torch.compile`` or
    ``torch.export`` trace."""
    return torch.compiler.is_compiling() or torch.compiler.is_exporting()


def _record(name: str) -> _Record:
    return _spans.get(name) or _spans.setdefault(name, _Record())


class span:
    """Context manager: the block's host time into the span ``name`` (module
    docstring); a ``numbered`` span's profiler range carries its number."""

    __slots__ = ("name", "numbered", "_t0", "_range")

    def __init__(self, name: str, numbered: bool = False):
        self.name = name
        self.numbered = numbered

    def __enter__(self) -> "span":
        self._range = None
        if _tracing():
            self._t0 = None
            return self
        if _profiler._is_profiler_enabled:
            label = PREFIX + self.name
            if self.numbered:
                label += f"#{_record(self.name).count + 1}"
            self._range = torch.autograd._record_function_with_args_enter(label)
        self._t0 = _clock()
        return self

    def __exit__(self, *exc) -> None:
        t0 = self._t0
        if t0 is None:
            return
        dt = _clock() - t0
        rec = _record(self.name)
        rec.count += 1
        rec.total_ns += dt
        rec.ring.append(dt)
        if self._range is not None:
            torch.autograd._record_function_with_args_exit(self._range)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` (nothing inside a trace)."""
    if not _tracing():
        _counters[name] = _counters.get(name, 0) + n


def durations(name: str) -> list[float]:
    """The span's last :data:`RING` durations, oldest first, in seconds
    (empty for a span never recorded)."""
    rec = _spans.get(name)
    return [] if rec is None else [d / 1e9 for d in list(rec.ring)]


def snapshot() -> dict:
    """{'spans': {name: {count, total_s}}, 'counters': {name: value}}."""
    spans = {name: {"count": rec.count, "total_s": rec.total_ns / 1e9}
             for name, rec in list(_spans.items())}
    return {"spans": spans, "counters": dict(_counters)}


def reset() -> None:
    """Every span and counter to nothing."""
    _spans.clear()
    _counters.clear()
