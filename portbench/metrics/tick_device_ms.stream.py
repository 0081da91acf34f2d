"""tick_device_ms.stream: device-busy ms a tick (the union of the device's
operations over the profiled ticks, over their count)."""


def read(rec):
    prof = rec.get("profile") or {}
    if rec["family"] != "stream" or not prof.get("n_device_ops"):
        return None
    return prof["busy_s"] / rec["profile_ticks"] * 1e3
