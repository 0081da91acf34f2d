"""mfu.stream: the model's operations for the window's work (the BVRNN's
products a frame and the generator's convolutions, ``counts``) over the
window's seconds and the configuration's peak (``mfu_peak``), in %."""

from portbench.counts import PEAK_FLOPS

FAMILY = "stream"


def read(rec):
    if rec["family"] != FAMILY:
        return None
    return 100.0 * rec["model_flops"] / rec["window_s"] / PEAK_FLOPS[rec["conf"]["mfu_peak"]]
