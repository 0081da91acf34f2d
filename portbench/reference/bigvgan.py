"""Plain reference of the published BigVGAN generator, in PyTorch.

Written from Lee et al., "BigVGAN: A Universal Neural Vocoder with
Large-Scale Training" (arXiv:2206.04658) and the upstream code's structure
(github.com/NVIDIA/BigVGAN: ``models.py``' ``BigVGAN`` and ``AMPBlock1``,
``activations.py``' ``SnakeBeta``, ``alias_free_torch``' ``Activation1d``),
for the ``correct`` decision of a cell whose codec vocodes with it.  It
imports nothing of the program under test: the weights are the benchmark's
own seeded tree (``lib.weights``, weight norm already folded), and it
derives the kaiser-sinc taps and the replicate pads itself.

The generator: conv_pre (k 7, 'same' padding) -> per stage a
ConvTranspose1d (kernel k, stride u, padding (k - u) / 2) and the average
of its AMPBlock1s (per dilation d: Activation1d(SnakeBeta) -> conv (k, d)
-> Activation1d(SnakeBeta) -> conv (k, 1) -> residual add, 'same' padding)
-> Activation1d(SnakeBeta) -> conv_post (k 7) -> tanh.  Activation1d is 2x
upsampling (zero-stuffing and a 12-tap kaiser-sinc low-pass, cutoff 0.25,
half-width 0.3, replicate padding), the snake, then the same low-pass and
2x decimation.

Every convolution's operands, and the filters', are rounded to ``kind``
(:func:`bvrnn_codec.round_to`; ``'f32'`` or ``'tf32'`` here) through
``bvrnn_codec``'s ``conv`` / ``conv_transpose``; call it under
:func:`bvrnn_codec.exact_float32` (TF32 off).

Departures from upstream: the taps are computed in float64 and rounded once
to float32 (upstream computes them in float32: at most an ulp a tap); the
snake's exp and 1 / (beta + eps) are taken in float32 on the device, as
upstream does.  The waveform's -10 dB input scaling is undone after tanh,
as the codec does.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from portbench.reference import bvrnn_codec as R

RATIO = 2  # Activation1d's up- and down-sampling ratio
TAPS = 12  # its filters' length


def kaiser_sinc(cutoff: float, half_width: float, taps: int) -> torch.Tensor:
    """A kaiser-windowed sinc low-pass of unity DC gain, (taps,) float32
    (``alias_free_torch.filter.kaiser_sinc_filter1d`` for an even length)."""
    half = taps // 2
    a = 2.285 * (half - 1) * math.pi * 4 * half_width + 7.95
    if a > 50.0:
        beta = 0.1102 * (a - 8.7)
    elif a >= 21.0:
        beta = 0.5842 * (a - 21) ** 0.4 + 0.07886 * (a - 21.0)
    else:
        beta = 0.0
    window = torch.kaiser_window(taps, periodic=False, beta=beta, dtype=torch.float64)
    t = torch.arange(-half, half, dtype=torch.float64) + 0.5
    filt = 2 * cutoff * window * torch.sinc(2 * cutoff * t)
    return (filt / filt.sum()).to(torch.float32)


def _replicate(x: torch.Tensor, left: int, right: int) -> torch.Tensor:
    """``x`` with its first sample repeated ``left`` times before it and its
    last ``right`` times after it."""
    return torch.cat([x[..., :1].expand(*x.shape[:-1], left), x,
                      x[..., -1:].expand(*x.shape[:-1], right)], -1)


def _depthwise(filt: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return filt.to(x.device).expand(x.shape[1], 1, filt.shape[0])


class AntiAliased:
    """Activation1d: (B, C, T) -> 2x up -> ``act`` -> 2x down -> (B, C, T)."""

    def __init__(self, kind: str):
        self.kind = kind
        self.filt = kaiser_sinc(0.5 / RATIO, 0.6 / RATIO, TAPS)  # up and down alike
        self.pad = TAPS // RATIO - 1
        self.trim_left = self.pad * RATIO + (TAPS - RATIO) // 2
        self.trim_right = self.pad * RATIO + (TAPS - RATIO + 1) // 2

    def up(self, x: torch.Tensor) -> torch.Tensor:
        x = R.round_to(_replicate(x, self.pad, self.pad), self.kind)
        w = R.round_to(_depthwise(self.filt, x), self.kind)
        y = RATIO * F.conv_transpose1d(x, w, stride=RATIO, groups=x.shape[1])
        return y[..., self.trim_left: y.shape[-1] - self.trim_right]

    def down(self, x: torch.Tensor) -> torch.Tensor:
        x = R.round_to(_replicate(x, TAPS // 2 - 1, TAPS // 2), self.kind)
        w = R.round_to(_depthwise(self.filt, x), self.kind)
        return F.conv1d(x, w, stride=RATIO, groups=x.shape[1])

    def __call__(self, x: torch.Tensor, act) -> torch.Tensor:
        return self.down(act(self.up(x)))


def same_conv(x: torch.Tensor, p: dict, kind: str, dilation: int = 1) -> torch.Tensor:
    """Conv1d with 'same' zero padding, (k - 1) d / 2 on each side."""
    pad = (p["w"].shape[-1] - 1) * dilation // 2
    return R.conv(F.pad(x, (pad, pad)), p, kind, dilation)


def amp_block(x: torch.Tensor, p: dict, dilations, aa: AntiAliased, kind: str) -> torch.Tensor:
    """AMPBlock1 (its kernel size k the weights'): per dilation d,
    anti-aliased snake -> conv (k, d) -> anti-aliased snake -> conv (k, 1),
    added to the input."""
    for j, d in enumerate(dilations):
        t = same_conv(aa(x, lambda v: R.snake_beta(v, p["acts"][2 * j])), p["convs1"][j], kind, d)
        t = same_conv(aa(t, lambda v: R.snake_beta(v, p["acts"][2 * j + 1])), p["convs2"][j],
                      kind)
        x = x + t
    return x


def vocoder(p: dict, vcfg: dict, mel: torch.Tensor, length: int, kind: str = "f32") -> torch.Tensor:
    """(B, M, T) mel -> (B, length) waveform (``length`` at most T x hop),
    the -10 dB undone."""
    dils = vcfg["resblock_dilation_sizes"]
    aa = AntiAliased(kind)
    x = same_conv(mel, p["conv_pre"], kind)
    for i, (u, k) in enumerate(zip(vcfg["upsample_rates"], vcfg["upsample_kernel_sizes"])):
        x = R.conv_transpose(x, p["ups"][i], kind, u)
        trim = (k - u) // 2
        x = x[..., trim: x.shape[-1] - trim]
        outs = [amp_block(x, p["resblocks"][i * len(dils) + j], d, aa, kind)
                for j, d in enumerate(dils)]
        x = sum(outs[1:], outs[0]) / len(outs)
    x = same_conv(aa(x, lambda v: R.snake_beta(v, p["act_post"])), p["conv_post"], kind)
    return torch.tanh(x[:, 0, :length]) / R.SCALING


def frames_vocoded(length: int, hop: int) -> int:
    """The decoded frames a ``length``-sample clip is vocoded from: those
    that cover it, ceil(length / hop)."""
    return -(-length // hop)
