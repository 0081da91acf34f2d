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

Which path runs is decided once, by :func:`resolve_vocoder_path`, and a
:class:`Vocoder` (:func:`prepare_vocoder`) holds the params prepared for it;
its :meth:`Vocoder.stage` is the one function that runs a stage's residual
stack, one-shot (:func:`_apply`), streaming (``streaming``) and sequence-
or pipeline-parallel (``parallel.sp``, ``parallel.pp``):

* the direct path, the reference's
  ``generator_apply``: every conv through ``ops.conv`` (cuDNN on a card),
  every activation elementwise torch (an anti-aliased one on a card in
  one kernel launch, :func:`antialiased`), in the input's dtype
  (float32, or bf16 on the codec's bf16 vocoder segment), with
  ``approx_snake`` the polynomial sin^2.  A weight-normed tree takes its
  activations from the stored parameters on the device, so gradients
  reach every leaf; a folded tree's resblock snakes read host-prepared
  parameters (:func:`prepare_direct_params`, ``ops.snake.prepare_act``),
  which makes the causal float32 direct path bitwise the kernel path's
  plain version;
* the kernel path runs the residual stacks through the CUDA kernels of
  ``ops.amp_resblock``: the causal log-scale SnakeBeta family with three
  dilations a block, at the shapes the kernels were built for
  (``ops.amp_resblock.supported``) only.

:func:`generator_apply` (the direct path, the reference's name) and
:func:`generator_apply_kernel` (the kernel path, the counterpart of
``generator_apply_pallas``) build a :class:`Vocoder` and run it.

``precision`` sets conv_pre, the upsamplers and conv_post (``ops.conv``);
``compute_dtype`` sets the residual stacks' convs (float32, or bf16
operands with float32 sums).
"""

from __future__ import annotations

import dataclasses

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
    missing_shapes,
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


def _require_kernels(cfg: VocoderConfig) -> None:
    """ValueError unless the kernels cover ``cfg`` (``ops.amp_resblock.
    supported``): :data:`KERNEL_CONFIGS`, naming the stages' (C, k, d) the
    kernels were not built for."""
    if supported(cfg):
        return
    missing = missing_shapes(cfg)
    raise ValueError(KERNEL_CONFIGS + (f", at (C, k, d) in ops.amp_resblock.F32_SHAPES, which "
                                       f"lacks this config's {missing}" if missing else ""))


def resolve_vocoder_path(vcfg: VocoderConfig, fast: bool, use_pallas, approx_snake,
                         voc_dtype) -> tuple[bool, bool, str]:
    """(use_pallas, approx_snake, voc_dtype) as they run, from the codec's
    constructor arguments (``BVRNNCodecModel``; ``parallel.sp`` and
    ``parallel.pp`` pass theirs with ``fast=False`` and no ``voc_dtype``);
    ``fast`` is ``precision='default'``.  ``use_pallas=None`` is the kernel
    path where the kernels cover ``vcfg`` and neither ``approx_snake=True``
    nor a ``voc_dtype`` was asked for.  Raises the reference's ValueErrors,
    and :data:`KERNEL_CONFIGS` for ``use_pallas=True`` outside the kernels'
    configs."""
    if voc_dtype not in (None, "f32", "bf16"):
        raise ValueError(f"voc_dtype must be 'f32' or 'bf16', got {voc_dtype!r}")
    if use_pallas is None:
        use_pallas = supported(vcfg) and not approx_snake and voc_dtype is None
    if not use_pallas:
        return (False, fast if approx_snake is None else bool(approx_snake),
                voc_dtype or ("bf16" if fast else "f32"))
    if approx_snake:
        raise ValueError("approx_snake=True is not supported with use_pallas (the kernels "
                         "compute exact snake); drop one")
    if voc_dtype is not None:
        raise ValueError("voc_dtype is not supported with use_pallas (the kernel path's "
                         "compute dtype follows `precision`); drop one")
    _require_kernels(vcfg)
    return True, False, "f32"


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
    the configs they cover (:data:`KERNEL_CONFIGS`)."""
    _require_kernels(cfg)
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


@dataclasses.dataclass(frozen=True)
class Vocoder:
    """A generator's params prepared for one path (:func:`prepare_vocoder`)
    and the one function that runs a stage's residual stack on it.

    ``blocks``: each stage's packed ``ResblockParams`` on the kernel path
    (``params`` then needs only conv_pre, the upsamplers, act_post and
    conv_post), None on the direct path.  ``compute_dtype`` sets the
    stacks' convs; ``approx`` (the polynomial sin^2) and ``remat`` (each
    AMP block recomputed in the backward pass) are the direct path's."""

    params: Params
    cfg: VocoderConfig
    blocks: list[list[ResblockParams]] | None = None
    compute_dtype: torch.dtype = torch.float32
    approx: bool = False
    remat: bool = False

    @property
    def direct(self) -> bool:
        return self.blocks is None

    def stage(self, i: int, x: torch.Tensor, ctx: int = 0,
              start: torch.Tensor | None = None) -> torch.Tensor:
        """Stage ``i``'s residual stack, (B, C, ctx + T) -> (B, C, T): the
        kernels' ``amp_stack``, or the average of the stage's
        :func:`amp_block`s; ``ctx`` / ``start`` are a streaming stage's
        context and per-row stream start (``ops.amp_resblock``).  Both
        names are looked up in this module when called, so a caller (the
        benchmark) can wrap them here."""
        if not self.direct:
            return amp_stack(x, self.blocks[i], self.compute_dtype, ctx=ctx, start=start)
        cfg = self.cfg
        num_k = len(cfg.resblock_kernel_sizes)
        kw = dict(symmetric=cfg.layers_sym[i], antialias=cfg.layers_antialias[i],
                  precision=conv_precision(self.compute_dtype), approx=self.approx, ctx=ctx,
                  start=start)
        outs = []
        for j, (ksz, dils) in enumerate(zip(cfg.resblock_kernel_sizes,
                                            cfg.resblock_dilation_sizes)):
            p = self.params["resblocks"][i * num_k + j]
            if self.remat:
                outs.append(checkpoint(amp_block, x, p, cfg, ksz, dils, use_reentrant=False,
                                       **kw))
            else:
                outs.append(amp_block(x, p, cfg, ksz, dils, **kw))
        return average(outs)


def prepare_vocoder(params: Params, cfg: VocoderConfig, use_pallas: bool,
                    compute_dtype: torch.dtype = torch.float32, approx_snake: bool = False, *,
                    dtype: torch.dtype | None = None, remat: bool = False,
                    blocks: list[list[ResblockParams]] | None = None) -> Vocoder:
    """A :class:`Vocoder` of folded (or, on the direct path, the trainers'
    weight-normed) ``params`` on the path ``use_pallas`` picks
    (:func:`resolve_vocoder_path`): the kernel path packs the stacks
    (:func:`prepare_kernel_params`, unless ``blocks`` holds them already);
    the direct path prepares a folded tree (:func:`prepare_direct_params`,
    in ``dtype``) and runs a weight-normed one as it is, in float32 only."""
    _check_activation(cfg)
    if use_pallas:
        if blocks is None:
            blocks = prepare_kernel_params(params, cfg)
        return Vocoder(params, cfg, blocks, compute_dtype)
    if not is_weight_normed(params):
        params = prepare_direct_params(params, cfg, dtype)
    elif compute_dtype != torch.float32:
        raise ValueError("weight-normed (training) params run in float32 only")
    return Vocoder(params, cfg, None, compute_dtype, approx_snake, remat)


def _apply(voc: Vocoder, x: torch.Tensor, length: int | None, precision: str) -> torch.Tensor:
    """The generator around its stages (:meth:`Vocoder.stage`), on either
    path: the spans ``vocoder`` and ``vocoder.stage``."""
    params, cfg = voc.params, voc.cfg
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
                x = voc.stage(i, x)
        x = activation(x, params["act_post"], cfg, voc.approx, cfg.antialias_post)
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
    voc = prepare_vocoder(params, cfg, False, compute_dtype, approx_snake, remat=remat)
    return _apply(voc, x, length, precision)


def generator_apply_kernel(params: Params, kernel_blocks: list[list[ResblockParams]],
                           cfg: VocoderConfig, x: torch.Tensor,
                           length: int | None = None, precision: str = "highest",
                           compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """:func:`generator_apply` with the residual stacks through
    ``ops.amp_resblock.amp_stack`` (the CUDA kernel of ``compute_dtype``'s
    mode on a CUDA tensor); ``kernel_blocks`` from
    :func:`prepare_kernel_params`."""
    return _apply(Vocoder(params, cfg, kernel_blocks, compute_dtype), x, length, precision)
