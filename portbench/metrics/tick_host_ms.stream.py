"""tick_host_ms.stream: median over the traced run's split ticks of a
tick's wall time less its device step, synchronised on both sides (the slot
loop, the queues, the copies in and the read-back), in ms."""

from portbench.lib.stats import median


def read(rec):
    host = rec.get("tick_host_s")
    if rec["family"] != "stream" or not host:
        return None
    return median(host) * 1e3
