"""vocoder_ms.offline: mean ms a codec call spends in its vocoder step, from CUDA
events around the step over the traced run's window."""


def read(rec):
    times = rec.get("phase_s", {}).get("vocoder")
    if rec["family"] != "offline" or not times:
        return None
    return sum(times) / len(times) * 1e3
