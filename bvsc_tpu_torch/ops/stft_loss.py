"""Multi-resolution STFT loss (port of ``bvsc_tpu/ops/stft_loss.py``): the
``auraloss.freq.MultiResolutionSTFTLoss`` defaults of the reference's
validation, resolutions (n_fft, hop, win) = (1024, 120, 600),
(2048, 240, 1200), (512, 50, 240); per resolution spectral convergence plus
log-magnitude L1, on centred (reflect-padded) frames with a Hann window
zero-padded to n_fft; the mean over resolutions."""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

DEFAULT_RESOLUTIONS = ((1024, 120, 600), (2048, 240, 1200), (512, 50, 240))


@functools.lru_cache(maxsize=16)
def _window(n_fft: int, win: int) -> np.ndarray:
    n = np.arange(win, dtype=np.float64)
    hann = (0.5 - 0.5 * np.cos(2 * np.pi * n / win)).astype(np.float32)
    window = np.zeros(n_fft, np.float32)
    wpad = (n_fft - win) // 2
    window[wpad : wpad + win] = hann
    return window


def _stft_mag(x: torch.Tensor, n_fft: int, hop: int, win: int) -> torch.Tensor:
    """(B, T) -> (B, bins, frames) magnitude, clamped at 1e-12 before the
    square root."""
    pad = n_fft // 2
    x = F.pad(x[:, None, :], (pad, pad), mode="reflect")[:, 0]
    frames = x.unfold(-1, n_fft, hop)
    window = torch.from_numpy(_window(n_fft, win)).to(x.device)
    spec = torch.fft.rfft(frames * window, dim=-1)
    mag = torch.sqrt(torch.clamp(spec.real ** 2 + spec.imag ** 2, min=1e-12))
    return mag.transpose(-1, -2)


def stft_loss(x: torch.Tensor, y: torch.Tensor, n_fft: int, hop: int, win: int) -> torch.Tensor:
    """Single resolution: spectral convergence + log-magnitude L1."""
    X = _stft_mag(x, n_fft, hop, win)
    Y = _stft_mag(y, n_fft, hop, win)
    sc = torch.linalg.vector_norm(Y - X) / torch.clamp(torch.linalg.vector_norm(Y), min=1e-8)
    return sc + torch.mean(torch.abs(torch.log(Y) - torch.log(X)))


def multi_resolution_stft_loss(x: torch.Tensor, y: torch.Tensor,
                               resolutions=DEFAULT_RESOLUTIONS) -> torch.Tensor:
    """x: generated (B, T), y: target (B, T)."""
    return sum(stft_loss(x, y, *r) for r in resolutions) / len(resolutions)
