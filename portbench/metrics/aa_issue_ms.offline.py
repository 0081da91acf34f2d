"""aa_issue_ms.offline: median host ms of one anti-aliased activation, the
program's ``vocoder.aa`` span, over every one of the run's process (the
warm call, the window's and the profiled stretches'): the host's time to
issue it."""

from portbench.lib.spans import span_median_ms


def read(rec):
    if rec["family"] != "offline":
        return None
    return span_median_ms("vocoder.aa")
