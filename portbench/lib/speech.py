"""Speech-like waveforms from a seed, made on the device.

A source-filter voice: a glottal harmonic series on an intonation contour
(base pitch 90-240 Hz), shaped by three formants that glide with the
syllables, gated by a syllable envelope (3-5 syllables a second) with phrase
pauses, plus breath noise; each row normalised to a peak of 0.35-0.7.  It
has speech's spectral envelope, pitch, rhythm and silences, which is what
the codec's mel frontend and bit allocation see; it is not intelligible.
"""

from __future__ import annotations

import math

import torch

HARMONICS = 48
TOP_HZ = 7000.0  # no harmonic above this
ROWS_A_BLOCK = 64  # rows made at once (bounds the temporaries)


def _u(gen, n, lo, hi, device):
    return lo + (hi - lo) * torch.rand(n, 1, generator=gen, device=device, dtype=torch.float64)


def _block(gen, n: int, length: int, fs: int, device) -> torch.Tensor:
    t = torch.arange(length, device=device, dtype=torch.float64)[None] / fs
    two_pi = 2 * math.pi

    def phase():
        return two_pi * torch.rand(n, 1, generator=gen, device=device, dtype=torch.float64)

    f0 = _u(gen, n, 90.0, 240.0, device) * (1 + 0.12 * torch.sin(two_pi * 0.3 * t + phase())
                                            + 0.06 * torch.sin(two_pi * 1.1 * t + phase()))
    theta = torch.cumsum(two_pi * f0 / fs, dim=1) % two_pi
    rate = _u(gen, n, 3.0, 5.0, device)
    syl = torch.clamp(torch.sin(two_pi * rate * t + phase()), min=0) ** 0.7
    pause = (torch.sin(two_pi * _u(gen, n, 0.15, 0.3, device) * t + phase()) > -0.6).double()
    env = (syl * pause).float()
    formants = []
    for lo, hi, bw in ((300, 800, 90), (900, 2300, 120), (2400, 3200, 160)):
        centre = _u(gen, n, lo, hi, device)
        swing = 0.25 * centre * torch.sin(two_pi * rate / 2 * t + phase())
        formants.append(((centre + swing).float(), bw))
    f0 = f0.float()
    theta = theta.float()
    voiced = torch.zeros(n, length, device=device)
    for k in range(1, HARMONICS + 1):
        fk = k * f0
        amp = sum(torch.exp(-0.5 * ((fk - fc) / bw) ** 2) for fc, bw in formants)
        amp = amp * (fk < TOP_HZ) / math.sqrt(k)
        voiced += amp * torch.sin(k * theta)
    noise = torch.randn(n, length, generator=gen, device=device)
    x = env * (voiced + 0.05 * noise) + 0.003 * noise
    peak = x.abs().amax(1, keepdim=True)
    return x / peak * _u(gen, n, 0.35, 0.7, device).float()


def speech(gen: torch.Generator, rows: int, length: int, fs: int, device) -> torch.Tensor:
    """(rows, length) float32 speech-like waveforms on ``device``."""
    return torch.cat([_block(gen, min(ROWS_A_BLOCK, rows - r), length, fs, device)
                      for r in range(0, rows, ROWS_A_BLOCK)])
