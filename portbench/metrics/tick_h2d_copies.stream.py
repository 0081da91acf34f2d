"""tick_h2d_copies.stream: host-to-device copies a tick, the program's
``<engine>.h2d_copies`` counter over the count of its ``<engine>.tick`` span
(``serve`` or ``decode``, the record's kind): every tick of the run's process
that advanced a stream, as ``tick_gather_ms.stream`` says."""

from portbench.lib.spans import counter, span_count


def read(rec):
    if rec["family"] != "stream":
        return None
    copies, ticks = counter(f"{rec['kind']}.h2d_copies"), span_count(f"{rec['kind']}.tick")
    return copies / ticks if copies is not None and ticks else None
