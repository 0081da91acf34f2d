"""BigVGAN-tiny generator in PyTorch (port of ``bvsc_tpu/models/vocoder.py``).

mel (B, 80, T) -> waveform (B, 1, T * 256): pad -> conv_pre k7 -> 4 x
[ConvTranspose1d (strides 8, 8, 2, 2) -> 3 AMP resblocks (k = 3, 7, 11;
dilations 1, 3, 5) averaged] -> activation -> pad -> conv_post k7 -> tanh
-> trim to ``length``.  Channels 128 -> 64 -> 32 -> 16 -> 8.  Two shipped
configs are this causal generator (left padding only) with log-scale
SnakeBeta; the third (``configs/varbitrate_bigvgan.toml``) is the published
BigVGAN (six stages, 1536 -> 24 channels, every padding symmetric, every
activation anti-aliased).  The config's variants run on the direct path:
symmetric padding (``pre_sym``, ``post_sym``, ``layers_sym``), anti-aliased
activations (``layers_antialias``, ``antialias_post``:
``ops.resample.Activation1d``, through :func:`antialiased`), ``activation``
``'snake'`` / ``'snakebeta'`` / ``'lrelu'`` (a leaky ReLU also before each
upsampler) and linear-scale snake parameters.

Parameters are a nested dict of tensors with the JAX package's keys and
torch conv layouts: folded ``{w, b}`` convs for inference, weight-normed
``{g, v, b}`` for training (:func:`init_generator_params` makes either,
:func:`fold_generator_params` / :func:`unfold_generator_params` turn one
into the other).

* :func:`generator_apply` is the direct path, the reference's
  ``generator_apply``: every conv through ``ops.conv`` (cuDNN on a card),
  every activation elementwise torch (an anti-aliased one on a card in
  one kernel launch, :func:`antialiased`), in the input's dtype
  (float32, or bf16 on the codec's bf16 vocoder segment), with
  ``approx_snake`` the polynomial sin^2.  A weight-normed tree takes its
  activations from the stored parameters on the device, so gradients
  reach every leaf; a folded tree's resblock snakes read host-prepared
  parameters (:func:`prepare_direct_params`, ``ops.snake.prepare_act``),
  which makes the causal float32 direct path bitwise the kernel path's
  plain version.
* :func:`generator_apply_kernel` runs the residual stacks through the CUDA
  kernels of ``ops.amp_resblock`` (its counterpart is
  ``generator_apply_pallas``): the causal log-scale SnakeBeta family with
  three dilations a block (``ops.amp_resblock.supported``) only.

``precision`` sets conv_pre, the upsamplers and conv_post (``ops.conv``);
``compute_dtype`` sets the residual stacks' convs (float32, or bf16
operands with float32 sums).
"""

from __future__ import annotations

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from bvsc_tpu_torch.config import VocoderConfig
from bvsc_tpu_torch.convert import tree_size
from bvsc_tpu_torch.ops.amp_resblock import (
    ResblockParams,
    amp_stack,
    average,
    conv_precision,
    prepare_resblock,
    stream_times,
    supported,
)
from bvsc_tpu_torch.ops.conv import (conv1d, conv_transpose1d, conv_weight, init_conv_params,
                                     pad1d)
from bvsc_tpu_torch.ops.resample import activation1d
from bvsc_tpu_torch.ops.snake import (ACTIVATIONS, apply_activation, init_snake_params,
                                      leaky_relu, linear_params, prepare_act)
from bvsc_tpu_torch.utils import tracing

Params = dict

KERNEL_CONFIGS = ("the kernel path (use_pallas) requires a causal, non-antialiased "
                  "snakebeta(logscale) vocoder config with three dilations a resblock")


def _check_activation(cfg: VocoderConfig) -> None:
    if cfg.activation not in ACTIVATIONS:
        raise NotImplementedError(f"activation {cfg.activation!r}")


def get_padding(kernel_size: int, dilation: int = 1) -> int:
    """Symmetric 'same' padding of one side."""
    return (kernel_size * dilation - dilation) // 2


def get_padding_causal(kernel_size: int, dilation: int = 1) -> int:
    """Full left-only padding."""
    return kernel_size * dilation - dilation


def init_generator_params(seed: int, cfg: VocoderConfig, *, weight_norm: bool = False) -> Params:
    """Fresh params from a numpy seed, as a tree of numpy arrays with the
    shapes of the JAX package's init: inference convs ``{w, b}`` (weight
    norm folded), or with ``weight_norm`` the trainers' ``{g, v, b}``, from
    the same draws (folding them gives the inference init back).  Snake
    parameters hold ``alpha`` (and ``beta`` for SnakeBeta), zeros in log
    scale, ones in linear scale."""
    _check_activation(cfg)
    rng = np.random.default_rng(seed)
    C0 = cfg.upsample_initial_channel
    beta = cfg.activation == "snakebeta"

    def conv(out_ch, in_ch, k, transpose=False):
        return init_conv_params(rng, out_ch, in_ch, k, transpose=transpose,
                                weight_norm=weight_norm)

    def act(ch):
        return init_snake_params(ch, beta=beta, logscale=cfg.snake_logscale)

    params: Params = {"conv_pre": conv(C0, cfg.num_mels, 7), "ups": [], "resblocks": []}
    ch = C0
    for i, k in enumerate(cfg.upsample_kernel_sizes):
        out_ch = C0 // (2 ** (i + 1))
        params["ups"].append(conv(out_ch, ch, k, transpose=True))
        for ksz in cfg.resblock_kernel_sizes:
            params["resblocks"].append({
                "convs1": [conv(out_ch, out_ch, ksz) for _ in range(3)],
                "convs2": [conv(out_ch, out_ch, ksz) for _ in range(3)],
                "acts": [act(out_ch) for _ in range(6)],
            })
        ch = out_ch
    params["act_post"] = act(ch)
    params["conv_post"] = conv(1, ch, 7)
    return params


def generator_param_count(params: Params) -> int:
    """The generator's parameter count (every leaf's elements)."""
    return tree_size(params)


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


def prepare_direct_params(params: Params, cfg: VocoderConfig,
                          dtype: torch.dtype | None = None) -> Params:
    """A folded tree as the direct path reads it: every resblock snake's
    parameters prepared on the host (``ops.snake.prepare_act``: linear
    alpha and 1 / (beta + eps), float64 rounded once), everything in
    ``dtype`` (default: as stored).  ``act_post`` stays as stored, as the
    kernel path reads it.  Prepared trees come back unchanged.  bf16-stored
    snake parameters (the bf16 storage dtype) stay as stored: the snakes
    take ``exp`` of them in bf16 on the device, as the reference does."""
    def cast(t):
        return t if dtype is None else t.to(dtype)

    def act(a):
        if "alpha" in a and a["alpha"].dtype == torch.bfloat16:
            return {k: cast(v) for k, v in a.items()}
        return prepare_act(a, kind=cfg.activation, logscale=cfg.snake_logscale, dtype=dtype)

    def block(b):
        return {"convs1": [{k: cast(v) for k, v in c.items()} for c in b["convs1"]],
                "convs2": [{k: cast(v) for k, v in c.items()} for c in b["convs2"]],
                "acts": [act(a) for a in b["acts"]]}

    def tree(t):
        if isinstance(t, dict):
            return {k: tree(v) for k, v in t.items()}
        if isinstance(t, list):
            return [tree(v) for v in t]
        return cast(t)

    return {k: ([block(b) for b in v] if k == "resblocks" else tree(v))
            for k, v in params.items()}


def prepare_kernel_params(params: Params, cfg: VocoderConfig) -> list[list[ResblockParams]]:
    """Per stage, the packed params of its resblocks (stage-major, as
    ``params['resblocks']``) for the kernels; raises ValueError outside
    the family they cover (:data:`KERNEL_CONFIGS`)."""
    if not supported(cfg):
        raise ValueError(KERNEL_CONFIGS)
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


def activation(x: torch.Tensor, p: dict, cfg: VocoderConfig, approx: bool = False,
               antialias: bool = False) -> torch.Tensor:
    """The config's activation on ``p`` (stored or prepared parameters);
    snakes anti-aliased (:func:`antialiased`) when ``antialias``."""
    if antialias and cfg.activation != "lrelu":
        return antialiased(x, p, cfg, approx)
    return apply_activation(x, p, kind=cfg.activation, logscale=cfg.snake_logscale,
                            approx=approx)


def antialiased(x: torch.Tensor, p: dict, cfg: VocoderConfig,
                approx: bool = False) -> torch.Tensor:
    """The config's snake anti-aliased (``ops.resample.Activation1d``: 2x
    up, the snake, 2x down) on (B, C, T) ``x``: the span ``vocoder.aa``;
    the counter ``vocoder.aa_elements`` adds the B x C x T elements
    filtered.  It is ``ops.resample.activation1d`` on the linear
    parameters (``ops.snake.linear_params``): on a card one launch of the
    anti-aliased kernel (float32 or bf16), each counted in
    ``vocoder.aa_kernel``; on the CPU the plain chain.  :func:`activation`
    looks it up by name, so a caller can wrap it."""
    with tracing.span("vocoder.aa"):
        tracing.count("vocoder.aa_elements", x.numel())
        alpha, inv_beta = linear_params(p, kind=cfg.activation, logscale=cfg.snake_logscale)
        return activation1d(x, alpha, inv_beta, approx)


def amp_block(x: torch.Tensor, block: dict, cfg: VocoderConfig, kernel_size: int, dilations, *,
              symmetric: bool = False, antialias: bool = False, precision: str = "highest",
              approx: bool = False, ctx: int = 0,
              start: torch.Tensor | None = None) -> torch.Tensor:
    """AMP residual block (the reference's ``_amp_block``): per dilation d,
    activation -> conv (k, d) -> activation -> conv (k, 1) -> residual add,
    with causal or symmetric padding; ``precision`` sets its convs.  With
    ``ctx`` or ``start`` (a causal streaming stage, ``ops.amp_resblock``'s
    arguments) the positions before each row's stream began are zeroed on
    load and after every conv's bias, and the last T columns returned."""
    keep = None if ctx == 0 and start is None else stream_times(x, ctx, start) >= 0

    def mask(v):
        return v if keep is None else torch.where(keep, v, 0.0)

    pad = get_padding if symmetric else get_padding_causal
    p2 = pad(kernel_size, 1)
    x = mask(x)
    for j, d in enumerate(dilations):
        p1 = pad(kernel_size, d)
        xt = activation(x, block["acts"][2 * j], cfg, approx, antialias)
        xt = mask(conv1d(pad1d(xt, p1, p1 if symmetric else 0), block["convs1"][j],
                         dilation=d, precision=precision))
        xt = activation(xt, block["acts"][2 * j + 1], cfg, approx, antialias)
        xt = mask(conv1d(pad1d(xt, p2, p2 if symmetric else 0), block["convs2"][j],
                         precision=precision))
        x = xt + x
    return x[..., ctx:]


def _apply(params, cfg, x, length, stage_fn, precision, approx=False):
    """The generator around its stages (``stage_fn(i, x)``), on either path:
    the spans ``vocoder`` and ``vocoder.stage``."""
    with tracing.span("vocoder"):
        x = pad1d(x, 3, 3) if cfg.pre_sym else pad1d(x, 6)
        x = conv1d(x, params["conv_pre"], precision=precision)
        for i, (u, k) in enumerate(zip(cfg.upsample_rates, cfg.upsample_kernel_sizes)):
            if cfg.activation == "lrelu":
                x = leaky_relu(x)
            x = conv_transpose1d(x, params["ups"][i], stride=u, precision=precision)
            # torch's ConvTranspose1d(padding=p): p trimmed from both ends
            p = (k - u) // 2 if cfg.layers_sym[i] else 0
            if p:
                x = x[..., p:-p]
            with tracing.span("vocoder.stage"):
                x = stage_fn(i, x)
        x = activation(x, params["act_post"], cfg, approx, cfg.antialias_post)
        x = pad1d(x, 3, 3) if cfg.post_sym else pad1d(x, 6)
        x = torch.tanh(conv1d(x, params["conv_post"], precision=precision))
        return x if length is None else x[..., :length]


def generator_apply(params: Params, cfg: VocoderConfig, x: torch.Tensor,
                    length: int | None = None, precision: str = "highest",
                    compute_dtype: torch.dtype = torch.float32, *,
                    remat: bool = False, approx_snake: bool = False) -> torch.Tensor:
    """Mel (B, num_mels, T) -> waveform (B, 1, length), the direct path, in
    the dtype of ``x`` and the params (module docstring).

    A weight-normed tree (the trainers', :func:`is_weight_normed`) runs in
    float32 with every activation from its stored parameters, so gradients
    reach ``g``, ``v``, the biases and the snake parameters; a folded tree
    runs on :func:`prepare_direct_params`'s (prepared here unless they
    already are).  ``approx_snake`` takes the polynomial sin^2.  ``remat``
    recomputes each AMP block in the backward pass
    (``torch.utils.checkpoint``, as the reference's ``jax.checkpoint``):
    the same values and gradients, less memory held between the passes."""
    _check_activation(cfg)
    num_k = len(cfg.resblock_kernel_sizes)
    if is_weight_normed(params):
        if compute_dtype != torch.float32:
            raise ValueError("weight-normed (training) params run in float32 only")
    else:
        params = prepare_direct_params(params, cfg)
    prec = conv_precision(compute_dtype)

    def stage(i, x):
        outs = []
        for j, (ksz, dils) in enumerate(zip(cfg.resblock_kernel_sizes,
                                            cfg.resblock_dilation_sizes)):
            p = params["resblocks"][i * num_k + j]
            kw = dict(symmetric=cfg.layers_sym[i], antialias=cfg.layers_antialias[i],
                      precision=prec, approx=approx_snake)
            if remat:
                outs.append(checkpoint(amp_block, x, p, cfg, ksz, dils, use_reentrant=False,
                                       **kw))
            else:
                outs.append(amp_block(x, p, cfg, ksz, dils, **kw))
        return average(outs)

    return _apply(params, cfg, x, length, stage, precision, approx_snake)


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
