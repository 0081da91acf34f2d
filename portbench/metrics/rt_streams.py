"""rt_streams: frames every tick of the window advanced, over the window's
seconds, over the frames a second of one real-time stream (fs / hop)."""

from portbench.lib.stats import rate


def read(rec):
    if rec["family"] != "stream":
        return None
    return rate(rec["frames"], rec["window_s"]) / (rec["fs"] / rec["hop"])
