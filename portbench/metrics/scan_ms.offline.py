"""scan_ms.offline: mean ms a codec call spends in its scan step, from CUDA
events around the step over the traced run's window."""


def read(rec):
    times = rec.get("phase_s", {}).get("scan")
    if rec["family"] != "offline" or not times:
        return None
    return sum(times) / len(times) * 1e3
