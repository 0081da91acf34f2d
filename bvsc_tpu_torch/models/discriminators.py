"""GAN discriminators, multi-period (MPD) and multi-resolution (MRD), in
PyTorch (port of ``bvsc_tpu/models/discriminators.py``; reference BigVGAN
``models.py:251-408``).

* ``DiscriminatorP``: the waveform reflect-padded to a multiple of the
  period, reshaped to (T / p, p), then (5, 1) 2-D convs of stride (3, 1);
  one per period of ``mpd_reshapes`` = [2, 3, 5, 7, 11].
* ``DiscriminatorR``: |STFT| at one (n_fft, hop, win) resolution, then
  (3, 9) 2-D convs; one per entry of ``resolutions``.

Convs are weight-normed ``{g, v, b}`` by default, spectral-normed
``{w_orig, b, sn_u, sn_v}`` with ``use_spectral_norm``; the MRD honours the
``mrd_use_spectral_norm`` / ``mrd_channel_mult`` overrides.  Parameters
are nested dicts with the JAX package's keys and layouts, so
``convert.discriminator_params_from_jax`` carries them across unchanged.
:func:`mpd_apply` / :func:`mrd_apply` return (real logits, generated
logits, real feature maps, generated feature maps), one entry each per
sub-discriminator.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from bvsc_tpu_torch.config import VocoderConfig
from bvsc_tpu_torch.ops.conv import conv2d, init_conv2d_params
from bvsc_tpu_torch.ops.mel import dft_real_bases

LRELU_SLOPE = 0.1


# ---------------------------------------------------------------------------
# Multi-period discriminator
# ---------------------------------------------------------------------------


def init_discriminator_p_params(rng: np.random.Generator, cfg: VocoderConfig) -> dict:
    d = cfg.discriminator_channel_mult
    sn = cfg.use_spectral_norm
    chans = [1, int(32 * d), int(128 * d), int(512 * d), int(1024 * d), int(1024 * d)]
    kw = dict(weight_norm=not sn, spectral_norm=sn)
    return {
        "convs": [init_conv2d_params(rng, chans[i + 1], chans[i], (5, 1), **kw)
                  for i in range(5)],
        "conv_post": init_conv2d_params(rng, 1, chans[5], (3, 1), **kw),
    }


def discriminator_p_apply(params: dict, x: torch.Tensor, period: int):
    """x: (B, 1, T) -> (logits (B, n), feature maps)."""
    B, C, T = x.shape
    if T % period:
        x = F.pad(x, (0, period - T % period), mode="reflect")
    x = x.reshape(B, C, -1, period)
    fmap = []
    for i, p in enumerate(params["convs"]):
        x = F.leaky_relu(conv2d(x, p, stride=(3, 1) if i < 4 else (1, 1), padding=(2, 0)),
                         LRELU_SLOPE)
        fmap.append(x)
    x = conv2d(x, params["conv_post"], padding=(1, 0))
    fmap.append(x)
    return x.reshape(B, -1), fmap


def init_mpd_params(rng: np.random.Generator, cfg: VocoderConfig) -> list:
    return [init_discriminator_p_params(rng, cfg) for _ in cfg.mpd_reshapes]


def _pairs(apply, params, settings, y, y_hat):
    y_d_rs, y_d_gs, fmap_rs, fmap_gs = [], [], [], []
    for p, s in zip(params, settings):
        dr, fr = apply(p, y, s)
        dg, fg = apply(p, y_hat, s)
        y_d_rs.append(dr)
        y_d_gs.append(dg)
        fmap_rs.append(fr)
        fmap_gs.append(fg)
    return y_d_rs, y_d_gs, fmap_rs, fmap_gs


def mpd_apply(params: list, cfg: VocoderConfig, y: torch.Tensor, y_hat: torch.Tensor):
    """(y, y_hat): (B, 1, T) real and generated."""
    return _pairs(discriminator_p_apply, params, cfg.mpd_reshapes, y, y_hat)


# ---------------------------------------------------------------------------
# Multi-resolution discriminator
# ---------------------------------------------------------------------------


def _mrd_spectral_norm(cfg: VocoderConfig) -> bool:
    if cfg.mrd_use_spectral_norm is not None:
        return cfg.mrd_use_spectral_norm
    return cfg.use_spectral_norm


def init_discriminator_r_params(rng: np.random.Generator, cfg: VocoderConfig) -> dict:
    d = cfg.mrd_channel_mult if cfg.mrd_channel_mult is not None else cfg.discriminator_channel_mult
    sn = _mrd_spectral_norm(cfg)
    c = int(32 * d)
    kw = dict(weight_norm=not sn, spectral_norm=sn)
    return {
        "convs": [init_conv2d_params(rng, c, 1, (3, 9), **kw),
                  init_conv2d_params(rng, c, c, (3, 9), **kw),
                  init_conv2d_params(rng, c, c, (3, 9), **kw),
                  init_conv2d_params(rng, c, c, (3, 9), **kw),
                  init_conv2d_params(rng, c, c, (3, 3), **kw)],
        "conv_post": init_conv2d_params(rng, 1, c, (3, 3), **kw),
    }


@functools.lru_cache(maxsize=16)
def _masked_bases(n_fft: int, win: int) -> tuple[np.ndarray, np.ndarray]:
    """The DFT bases with the rectangular window (``win`` ones centred in
    n_fft) folded into their rows."""
    cos_b, sin_b = dft_real_bases(n_fft)
    mask = np.zeros((n_fft, 1), np.float32)
    wpad = (n_fft - win) // 2
    mask[wpad : wpad + win] = 1.0
    return cos_b * mask, sin_b * mask


def resolution_spectrogram(x: torch.Tensor, resolution) -> torch.Tensor:
    """|STFT| at (n_fft, hop, win): reflect pre-pad (n_fft - hop) / 2 on both
    sides, frames without centring, a rectangular window of ``win`` samples
    zero-padded to n_fft, the DFT as two float32 products (the reference's
    ``Precision.HIGHEST``; TF32 must be off on the card), magnitude
    sqrt(re^2 + im^2 + 1e-12).  (B, 1, T) -> (B, bins, frames)."""
    n_fft, hop, win = resolution
    pad = (n_fft - hop) // 2
    x = F.pad(x, (pad, pad), mode="reflect")[:, 0]
    frames = x.unfold(-1, n_fft, hop)
    cos_b, sin_b = (torch.from_numpy(b).to(x.device) for b in _masked_bases(n_fft, win))
    re = torch.matmul(frames, cos_b)
    im = torch.matmul(frames, sin_b)
    return torch.sqrt(re * re + im * im + 1e-12).transpose(-1, -2)


def discriminator_r_apply(params: dict, x: torch.Tensor, resolution):
    """x: (B, 1, T) -> (logits, feature maps)."""
    return discriminator_r_apply_mag(params, resolution_spectrogram(x, resolution))


def discriminator_r_apply_mag(params: dict, mag: torch.Tensor):
    """The conv stack on a precomputed |STFT| magnitude (B, bins, frames)
    (:func:`resolution_spectrogram`) -> (logits, feature maps)."""
    x = mag[:, None]  # (B, 1, bins, frames)
    fmap = []
    strides = [(1, 1), (1, 2), (1, 2), (1, 2), (1, 1)]
    pads = [(1, 4), (1, 4), (1, 4), (1, 4), (1, 1)]
    for p, s, pad in zip(params["convs"], strides, pads):
        x = F.leaky_relu(conv2d(x, p, stride=s, padding=pad), LRELU_SLOPE)
        fmap.append(x)
    x = conv2d(x, params["conv_post"], padding=(1, 1))
    fmap.append(x)
    return x.reshape(x.shape[0], -1), fmap


def init_mrd_params(rng: np.random.Generator, cfg: VocoderConfig) -> list:
    return [init_discriminator_r_params(rng, cfg) for _ in cfg.resolutions]


def mrd_apply(params: list, cfg: VocoderConfig, y: torch.Tensor, y_hat: torch.Tensor):
    return _pairs(discriminator_r_apply, params, cfg.resolutions, y, y_hat)
