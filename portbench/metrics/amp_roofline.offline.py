"""amp_roofline.offline: the vocoder stages' least time (``counts.stage_bound_s``
at each stage call's shape) over the device time of the operations launched
inside the stage calls of the profiled stretch that records the ranges, in %."""

FAMILY = "offline"


def read(rec):
    prof = rec.get("ranges") or {}
    device_s = prof.get("label_device_s", {}).get("stage", 0.0)
    if rec["family"] != FAMILY or device_s <= 0:
        return None
    return 100.0 * rec["stage_bound_s"] / device_s
