"""Causal BigVGAN-tiny generator in PyTorch (port of
``bvsc_tpu/models/vocoder.py``, causal config).

mel (B, 80, T) -> waveform (B, 1, T * 256): left-pad 6 -> conv_pre k7 ->
4 x [ConvTranspose1d (strides 8, 8, 2, 2) -> 3 AMP resblocks (k = 3, 7, 11;
dilations 1, 3, 5) averaged] -> SnakeBeta -> left-pad 6 -> conv_post k7 ->
tanh -> trim to ``length``.  Channels 128 -> 64 -> 32 -> 16 -> 8.

Parameters are a nested dict of tensors with the JAX package's keys and
torch conv layouts: folded ``{w, b}`` convs for inference, weight-normed
``{g, v, b}`` for training (:func:`init_generator_params` makes either,
:func:`fold_generator_params` / :func:`unfold_generator_params` turn one
into the other).  :func:`generator_apply` is the plain path;
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
from torch.utils.checkpoint import checkpoint

from bvsc_tpu_torch.config import VocoderConfig
from bvsc_tpu_torch.ops.amp_resblock import (
    ResblockParams,
    amp_block_plain,
    amp_stack,
    average,
    causal_family,
    prepare_resblock,
    supported,
)
from bvsc_tpu_torch.ops.conv import (conv1d, conv_transpose1d, conv_weight, init_conv_params,
                                     pad1d)
from bvsc_tpu_torch.ops.snake import snake_beta

Params = dict


def _check_supported(cfg: VocoderConfig, kernel: bool = True) -> None:
    """The causal snakebeta (log-scale) family; the kernel path also needs
    three dilations a block, the plain path any number."""
    if not (supported(cfg) if kernel else causal_family(cfg)):
        raise NotImplementedError(
            "only the causal snakebeta(logscale) vocoder config is ported; the "
            "symmetric and anti-aliased variants are still to come (ROADMAP.md, "
            "'Modules still to port')"
        )


def _snake_init(channels):
    """Log-scale snakebeta parameters start at 0 (exp() = 1)."""
    return {"alpha": np.zeros(channels, np.float32), "beta": np.zeros(channels, np.float32)}


def init_generator_params(seed: int, cfg: VocoderConfig, *, weight_norm: bool = False) -> Params:
    """Fresh params from a numpy seed, as a tree of numpy arrays with the
    shapes of the JAX package's init: inference convs ``{w, b}`` (weight
    norm folded), or with ``weight_norm`` the trainers' ``{g, v, b}``, from
    the same draws (folding them gives the inference init back)."""
    _check_supported(cfg, kernel=False)
    rng = np.random.default_rng(seed)
    C0 = cfg.upsample_initial_channel

    def conv(out_ch, in_ch, k, transpose=False):
        return init_conv_params(rng, out_ch, in_ch, k, transpose=transpose,
                                weight_norm=weight_norm)

    params: Params = {"conv_pre": conv(C0, cfg.num_mels, 7), "ups": [], "resblocks": []}
    ch = C0
    for i, k in enumerate(cfg.upsample_kernel_sizes):
        out_ch = C0 // (2 ** (i + 1))
        params["ups"].append(conv(out_ch, ch, k, transpose=True))
        for ksz in cfg.resblock_kernel_sizes:
            params["resblocks"].append({
                "convs1": [conv(out_ch, out_ch, ksz) for _ in range(3)],
                "convs2": [conv(out_ch, out_ch, ksz) for _ in range(3)],
                "acts": [_snake_init(out_ch) for _ in range(6)],
            })
        ch = out_ch
    params["act_post"] = _snake_init(ch)
    params["conv_post"] = conv(1, ch, 7)
    return params


def _map_convs(tree, fn):
    """``tree`` with ``fn`` applied to every conv's parameter dict."""
    if isinstance(tree, dict):
        if "b" in tree and ("w" in tree or "g" in tree):
            return fn(tree)
        return {k: _map_convs(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_convs(v, fn) for v in tree]
    return tree


def fold_generator_params(params: Params) -> Params:
    """Weight-normed ``{g, v, b}`` convs folded to inference ``{w, b}``
    (the reference's ``remove_weight_norm``)."""
    return _map_convs(params, lambda p: {"w": conv_weight(p), "b": p["b"]})


def unfold_generator_params(params: Params) -> Params:
    """Inverse of :func:`fold_generator_params` for trainer warm starts:
    folded ``w`` re-parametrised as g = ||w|| (per output channel), v = w,
    torch's ``weight_norm`` from existing weights."""
    def unfold(p):
        if "g" in p:
            return p
        w = p["w"]
        g = torch.sqrt(torch.sum(w * w, dim=tuple(range(1, w.ndim)), keepdim=True))
        return {"g": g, "v": w, "b": p["b"]}

    return _map_convs(params, unfold)


def is_weight_normed(params: Params) -> bool:
    """Whether the tree holds the trainers' weight-normed convs."""
    return "g" in params["conv_pre"]


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


def amp_block_train(x: torch.Tensor, block: dict, kernel_size: int, dilations) -> torch.Tensor:
    """The causal AMP residual block in float32, differentiable in every
    leaf: convs in any form ``ops.conv.conv_weight`` resolves, and the
    log-scale snake parameters exponentiated on the tensors' device (the
    inference block takes them from the host, ``amp_resblock.snake_params``)."""
    for j, d in enumerate(dilations):
        xt = snake_beta(x, block["acts"][2 * j], logscale=True)
        xt = conv1d(pad1d(xt, (kernel_size - 1) * d), block["convs1"][j], dilation=d)
        xt = snake_beta(xt, block["acts"][2 * j + 1], logscale=True)
        xt = conv1d(pad1d(xt, kernel_size - 1), block["convs2"][j])
        x = xt + x
    return x


def generator_apply(params: Params, cfg: VocoderConfig, x: torch.Tensor,
                    length: int | None = None, precision: str = "highest",
                    compute_dtype: torch.dtype = torch.float32, *,
                    remat: bool = False) -> torch.Tensor:
    """Mel (B, num_mels, T) -> waveform (B, 1, length), plain path.

    A weight-normed tree (the trainers', :func:`is_weight_normed`) runs
    :func:`amp_block_train` in float32, so gradients reach ``g``, ``v``,
    the biases and the snake parameters; a folded tree runs the inference
    block, bitwise the kernel path's plain version.  ``remat`` recomputes
    each AMP block in the backward pass (``torch.utils.checkpoint``, as the
    reference's ``jax.checkpoint``): the same values and gradients, less
    memory held between the passes."""
    _check_supported(cfg, kernel=False)
    num_k = len(cfg.resblock_kernel_sizes)
    train = is_weight_normed(params)
    if train and compute_dtype != torch.float32:
        raise ValueError("weight-normed (training) params run in float32 only")

    def block(x, p, ksz, dils):
        if train:
            return amp_block_train(x, p, ksz, dils)
        return amp_block_plain(x, p, ksz, dils, compute_dtype)

    def stage(i, x):
        outs = []
        for j, (ksz, dils) in enumerate(zip(cfg.resblock_kernel_sizes,
                                            cfg.resblock_dilation_sizes)):
            p = params["resblocks"][i * num_k + j]
            if remat:
                outs.append(checkpoint(block, x, p, ksz, dils, use_reentrant=False))
            else:
                outs.append(block(x, p, ksz, dils))
        return average(outs)

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
