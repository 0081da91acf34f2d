"""aa_ms.offline: device ms a codec call spends in its anti-aliased
activations: the device time of the operations launched inside the
``portbench.aa`` ranges (``models.vocoder.antialiased``) of the profiled
stretch that records the ranges, over the stretch's calls."""


def read(rec):
    prof = rec.get("ranges") or {}
    device_s = prof.get("label_device_s", {}).get("aa", 0.0)
    if rec["family"] != "offline" or device_s <= 0:
        return None
    return device_s / rec["profile_calls"] * 1e3
