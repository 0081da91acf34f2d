"""Causal BigVGAN-tiny generator in PyTorch (port of
``bvsc_tpu/models/vocoder.py``, causal config).

mel (B, 80, T) -> waveform (B, 1, T * 256): left-pad 6 -> conv_pre k7 ->
4 x [ConvTranspose1d (strides 8, 8, 2, 2) -> 3 AMP resblocks (k = 3, 7, 11;
dilations 1, 3, 5) averaged] -> SnakeBeta -> left-pad 6 -> conv_post k7 ->
tanh -> trim to ``length``.  Channels 128 -> 64 -> 32 -> 16 -> 8.

Parameters are a nested dict of tensors with the JAX package's keys and
torch conv layouts.  :func:`generator_apply` is the plain path;
:func:`generator_apply_kernel` runs the residual stacks through the CUDA
kernels of ``ops.amp_resblock`` (its counterpart is
``generator_apply_pallas``).  ``precision`` sets conv_pre, the upsamplers
and conv_post (``ops.conv``); ``compute_dtype`` sets the residual stacks'
mode (float32, or bf16 operands with float32 sums).  The symmetric and
anti-aliased variants are not ported.
"""

from __future__ import annotations

import numpy as np
import torch

from bvsc_tpu_torch.config import VocoderConfig
from bvsc_tpu_torch.ops.amp_resblock import (
    ResblockParams,
    amp_block_plain,
    amp_stack,
    average,
    prepare_resblock,
    supported,
)
from bvsc_tpu_torch.ops.conv import conv1d, conv_transpose1d, pad1d
from bvsc_tpu_torch.ops.snake import snake_beta

Params = dict


def _check_supported(cfg: VocoderConfig) -> None:
    if not supported(cfg):
        raise NotImplementedError(
            "only the causal snakebeta(logscale) vocoder config is ported; the "
            "symmetric and anti-aliased variants are still to come (ROADMAP.md, "
            "'Modules still to port')"
        )


def _conv_init(rng, out_ch, in_ch, kernel, *, transpose=False, init_std=0.01):
    """N(0, 0.01) weights and torch's U(-1/sqrt(fan_in), .) bias."""
    shape = (in_ch, out_ch, kernel) if transpose else (out_ch, in_ch, kernel)
    w = (init_std * rng.standard_normal(shape)).astype(np.float32)
    bound = 1.0 / np.sqrt((out_ch if transpose else in_ch) * kernel)
    return {"w": w, "b": rng.uniform(-bound, bound, (out_ch,)).astype(np.float32)}


def _snake_init(channels):
    """Log-scale snakebeta parameters start at 0 (exp() = 1)."""
    return {"alpha": np.zeros(channels, np.float32), "beta": np.zeros(channels, np.float32)}


def init_generator_params(seed: int, cfg: VocoderConfig) -> Params:
    """Fresh inference params (weight norm folded) from a numpy seed, as a
    tree of numpy arrays with the shapes of the JAX package's init."""
    _check_supported(cfg)
    rng = np.random.default_rng(seed)
    C0 = cfg.upsample_initial_channel
    params: Params = {
        "conv_pre": _conv_init(rng, C0, cfg.num_mels, 7),
        "ups": [],
        "resblocks": [],
    }
    ch = C0
    for i, k in enumerate(cfg.upsample_kernel_sizes):
        out_ch = C0 // (2 ** (i + 1))
        params["ups"].append(_conv_init(rng, out_ch, ch, k, transpose=True))
        for ksz in cfg.resblock_kernel_sizes:
            params["resblocks"].append({
                "convs1": [_conv_init(rng, out_ch, out_ch, ksz) for _ in range(3)],
                "convs2": [_conv_init(rng, out_ch, out_ch, ksz) for _ in range(3)],
                "acts": [_snake_init(out_ch) for _ in range(6)],
            })
        ch = out_ch
    params["act_post"] = _snake_init(ch)
    params["conv_post"] = _conv_init(rng, 1, ch, 7)
    return params


def prepare_kernel_params(params: Params, cfg: VocoderConfig) -> list[list[ResblockParams]]:
    """Per stage, the packed params of its resblocks (stage-major, as
    ``params['resblocks']``)."""
    _check_supported(cfg)
    num_k = len(cfg.resblock_kernel_sizes)
    return [
        [
            prepare_resblock(params["resblocks"][i * num_k + j], ksz, dils)
            for j, (ksz, dils) in enumerate(
                zip(cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes)
            )
        ]
        for i in range(len(cfg.upsample_rates))
    ]


def _apply(params, cfg, x, length, stage_fn, precision):
    x = conv1d(pad1d(x, 6), params["conv_pre"], precision=precision)
    for i, u in enumerate(cfg.upsample_rates):
        x = conv_transpose1d(x, params["ups"][i], stride=u, precision=precision)
        x = stage_fn(i, x)
    x = snake_beta(x, params["act_post"], logscale=cfg.snake_logscale)
    x = torch.tanh(conv1d(pad1d(x, 6), params["conv_post"], precision=precision))
    return x if length is None else x[..., :length]


def generator_apply(params: Params, cfg: VocoderConfig, x: torch.Tensor,
                    length: int | None = None, precision: str = "highest",
                    compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Mel (B, num_mels, T) -> waveform (B, 1, length), plain path."""
    _check_supported(cfg)
    num_k = len(cfg.resblock_kernel_sizes)

    def stage(i, x):
        kernels = zip(cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes)
        return average([amp_block_plain(x, params["resblocks"][i * num_k + j], ksz, dils,
                                        compute_dtype)
                        for j, (ksz, dils) in enumerate(kernels)])

    return _apply(params, cfg, x, length, stage, precision)


def generator_apply_kernel(params: Params, kernel_blocks: list[list[ResblockParams]],
                           cfg: VocoderConfig, x: torch.Tensor,
                           length: int | None = None, precision: str = "highest",
                           compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """:func:`generator_apply` with the residual stacks through
    ``ops.amp_resblock.amp_stack`` (the CUDA kernel of ``compute_dtype``'s
    mode on a CUDA tensor); ``kernel_blocks`` from
    :func:`prepare_kernel_params`."""
    return _apply(params, cfg, x, length,
                  lambda i, x: amp_stack(x, kernel_blocks[i], compute_dtype), precision)
