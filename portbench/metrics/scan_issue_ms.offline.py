"""scan_issue_ms.offline: median host ms of a codec call's BVRNN scan, the
program's ``bvrnn.scan`` span, over every scan of the run's process (the
warm call, the window's and the profiled stretches'): the host's time to
issue the scan, against ``scan_ms.offline``'s device time."""

from portbench.lib.spans import span_median_ms


def read(rec):
    if rec["family"] != "offline":
        return None
    return span_median_ms("bvrnn.scan")
