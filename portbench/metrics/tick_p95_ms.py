"""tick_p95_ms: the 95th percentile of the wall time of every tick of the
window, in ms."""

from portbench.lib.stats import percentile


def read(rec):
    if rec["family"] != "stream" or not rec["ticks_s"]:
        return None
    return percentile(rec["ticks_s"], 95) * 1e3
