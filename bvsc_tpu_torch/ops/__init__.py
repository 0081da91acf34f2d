"""Ops of the port: the mel frontend, convolutions, snakes, the
kernels' wrappers and the host coders."""

from bvsc_tpu_torch.ops.mel import (MelFrontend, hann_window_periodic, mel_spectrogram,
                                    slaney_mel_filterbank)

__all__ = ["MelFrontend", "mel_spectrogram", "slaney_mel_filterbank", "hann_window_periodic"]
