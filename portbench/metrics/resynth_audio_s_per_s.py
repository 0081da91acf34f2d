"""resynth_audio_s_per_s: seconds of input audio of every codec call of the
window, over the window's seconds to the last call's end."""

from portbench.lib.stats import rate


def read(rec):
    if rec["family"] != "offline":
        return None
    return rate(rec["audio_s"], rec["window_s"])
