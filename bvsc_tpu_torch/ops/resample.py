"""Alias-free resampling: a kaiser-windowed sinc low-pass and 2x up- and
down-sampling around an activation (port of ``bvsc_tpu/ops/resample.py``,
the reference's vendored alias-free-torch).

The anti-aliased vocoder variants (``layers_antialias``, ``antialias_post``)
wrap each snake in :class:`Activation1d`: up 2x -> activation -> down 2x.
The filters look ahead, so the causal configs (``configs/varbitrate.toml``,
``fixed64.toml``) leave them off; the full BigVGAN
(``configs/varbitrate_bigvgan.toml``) turns every one on.  They run on the
direct vocoder path only.

Each filter is a depthwise ``conv1d`` / ``conv_transpose1d`` (groups = C)
with replicate padding, in the input's dtype and on its device, with the
JAX package's pads and trims.  The filter taps are numpy float32, as the
JAX package computes them (:func:`kaiser_sinc_filter1d` is a copy); their
copy on each (device, dtype) a filter meets is made once and kept
(:func:`_depthwise`), so a call makes no host-to-device copy and no stream
synchronisation.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def kaiser_sinc_filter1d(cutoff: float, half_width: float, kernel_size: int) -> np.ndarray:
    """Kaiser-windowed sinc low-pass of unity DC gain, (1, 1, kernel_size)
    float32."""
    even = kernel_size % 2 == 0
    half_size = kernel_size // 2
    delta_f = 4 * half_width
    A = 2.285 * (half_size - 1) * math.pi * delta_f + 7.95
    if A > 50.0:
        beta = 0.1102 * (A - 8.7)
    elif A >= 21.0:
        beta = 0.5842 * (A - 21) ** 0.4 + 0.07886 * (A - 21.0)
    else:
        beta = 0.0
    window = np.kaiser(kernel_size, beta)
    if even:
        time = np.arange(-half_size, half_size) + 0.5
    else:
        time = np.arange(kernel_size) - half_size
    if cutoff == 0:
        return np.zeros((1, 1, kernel_size), np.float32)
    filt = 2 * cutoff * window * np.sinc(2 * cutoff * time)
    filt /= filt.sum()
    return filt.reshape(1, 1, kernel_size).astype(np.float32)


# (taps' bytes, device, dtype) -> the (1, 1, K) taps there
_device_taps: dict = {}


def _depthwise(filt: np.ndarray, x: torch.Tensor) -> torch.Tensor:
    """The (1, 1, K) taps as a (C, 1, K) depthwise weight for ``x``: their
    copy on ``x``'s device in its dtype, made on first use and kept (a
    ``torch.compile`` or ``torch.export`` trace takes a fresh one, so no
    traced tensor is kept)."""
    key = (filt.tobytes(), x.device, x.dtype)
    w = _device_taps.get(key)
    if w is None:
        w = torch.as_tensor(filt, device=x.device).to(x.dtype)
        if not (torch.compiler.is_compiling() or torch.compiler.is_exporting()):
            _device_taps[key] = w
    return w.expand(x.shape[1], 1, filt.shape[-1])


def _replicate(x: torch.Tensor, left: int, right: int) -> torch.Tensor:
    return F.pad(x, (left, right), mode="replicate") if left or right else x


class LowPassFilter1d:
    def __init__(self, cutoff=0.5, half_width=0.6, stride=1, padding=True, kernel_size=12):
        if not 0.0 <= cutoff <= 0.5:
            raise ValueError("cutoff must be in [0, 0.5]")
        self.kernel_size = kernel_size
        even = kernel_size % 2 == 0
        self.pad_left = kernel_size // 2 - int(even)
        self.pad_right = kernel_size // 2
        self.stride = stride
        self.padding = padding
        self.filter = kaiser_sinc_filter1d(cutoff, half_width, kernel_size)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.padding:
            x = _replicate(x, self.pad_left, self.pad_right)
        return F.conv1d(x, _depthwise(self.filter, x), stride=self.stride, groups=x.shape[1])


class UpSample1d:
    """Zero-stuffing and sinc interpolation: (B, C, T) -> (B, C, ratio * T)."""

    def __init__(self, ratio=2, kernel_size=None):
        self.ratio = ratio
        self.kernel_size = int(6 * ratio // 2) * 2 if kernel_size is None else kernel_size
        self.stride = ratio
        self.pad = self.kernel_size // ratio - 1
        self.pad_left = self.pad * self.stride + (self.kernel_size - self.stride) // 2
        self.pad_right = self.pad * self.stride + (self.kernel_size - self.stride + 1) // 2
        self.filter = kaiser_sinc_filter1d(0.5 / ratio, 0.6 / ratio, self.kernel_size)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        x = _replicate(x, self.pad, self.pad)
        y = self.ratio * F.conv_transpose1d(x, _depthwise(self.filter, x), stride=self.stride,
                                            groups=x.shape[1])
        return y[..., self.pad_left: y.shape[-1] - self.pad_right]


class DownSample1d:
    """Low-pass and decimate: (B, C, T) -> (B, C, T / ratio)."""

    def __init__(self, ratio=2, kernel_size=None):
        kernel_size = int(6 * ratio // 2) * 2 if kernel_size is None else kernel_size
        self.lowpass = LowPassFilter1d(cutoff=0.5 / ratio, half_width=0.6 / ratio,
                                       stride=ratio, kernel_size=kernel_size)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return self.lowpass(x)


class Activation1d:
    """up 2x -> ``activation`` -> down 2x."""

    def __init__(self, activation, up_ratio=2, down_ratio=2, up_kernel_size=12,
                 down_kernel_size=12):
        self.act = activation
        self.upsample = UpSample1d(up_ratio, up_kernel_size)
        self.downsample = DownSample1d(down_ratio, down_kernel_size)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return self.downsample(self.act(self.upsample(x)))
