"""mel_ms.offline: mean ms a codec call spends in its mel step, from CUDA
events around the step over the traced run's window."""


def read(rec):
    times = rec.get("phase_s", {}).get("mel")
    if rec["family"] != "offline" or not times:
        return None
    return sum(times) / len(times) * 1e3
