"""idle_share.stream: the share of the profiled stretch in which no kernel or
copy ran on the device, in %, from the stretch traced on the device alone."""

FAMILY = "stream"


def read(rec):
    prof = rec.get("profile") or {}
    if rec["family"] != FAMILY or not prof.get("n_device_ops"):
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
