"""tick_gather_ms.stream: median ms of a tick's host slot loop (queue pops,
the input chunk or codes, the start windows), the program's
``<engine>.gather`` span (``serve`` or ``decode``, the record's kind).

The median is over every tick of the run's process that advanced a stream:
the window's are about 94 % of them; the rest are the warm-up's, the traced
run's split and profiled ticks (whose synchronised step reads ``issue``
high and ``wait`` near 0, in the tails) and the drain's."""

from portbench.lib.spans import span_median_ms


def read(rec):
    if rec["family"] != "stream":
        return None
    return span_median_ms(f"{rec['kind']}.gather")
