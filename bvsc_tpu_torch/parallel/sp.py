"""Sequence-parallel vocoder: the causal generator with its time axis split
over a ``seq`` axis (port of ``bvsc_tpu/parallel/sp.py``).

The causal generator decomposes over time as the streaming vocoder does
(``streaming.py``), with each carried state taken from the ranks to the
left instead of from the previous packet (``parallel.collectives``):

* conv_pre and conv_post take their left context, (k - 1) * dilation
  samples, from the left neighbour; shard 0 takes zeros, the one-shot
  generator's causal padding;
* each transposed conv sends the ``k - stride`` samples it has not
  finished to the right neighbour, which adds them into its first samples;
  the bias goes in after that add (``streaming._stream_conv_transpose``);
* each stage's residual stack runs through K1 (``ops.amp_resblock.amp_stack``,
  or K1-bf16), or on the direct path (``use_pallas=False``, or
  ``approx_snake=True``) through the plain blocks
  (``models.vocoder.amp_block``), once, as a streaming stage does: the
  stage input's last
  ``streaming.stage_context(cfg)`` samples before this shard (120 at
  k = 11) come from the shards to the left, as ``ctx``, and ``start`` is
  this shard's true stream time.  Shard 0's start of 0 lets K1 zero the
  history before the input after every conv's bias, as the one-shot zero
  padding does; a shard shorter than the context takes it from more than
  one rank.

Each rank's output is the one-shot generator's to the reordered sums of the
overlap adds.  The shard minimum is the JAX package's: every conv needs its
left context inside one neighbour (at the default config conv_pre needs 6
frames and the stage-0 conv with k = 11, d = 5 needs 50 samples, 7 frames);
a shorter shard raises the same ``ValueError``.

SPMD: every rank passes the same global mel and gets the global waveform
back.  A 2-D (data x seq) mesh also splits the batch's rows over ``data``.
"""

from __future__ import annotations

import torch

from bvsc_tpu_torch.config import VocoderConfig
from bvsc_tpu_torch.convert import to_torch
from bvsc_tpu_torch.models.vocoder import (activation, amp_block, prepare_direct_params,
                                           prepare_kernel_params)
from bvsc_tpu_torch.ops.amp_resblock import amp_stack, average, conv_precision
from bvsc_tpu_torch.ops.conv import conv1d, conv_transpose1d, conv_weight
from bvsc_tpu_torch.ops.snake import leaky_relu
from bvsc_tpu_torch.parallel.collectives import all_gather, from_left, left_context
from bvsc_tpu_torch.parallel.mesh import DATA_AXIS, Mesh, make_2d_mesh, make_mesh, row_blocks
from bvsc_tpu_torch.streaming import stage_context

SEQ_AXIS = "seq"
PRE_POST_K = 7  # conv_pre's and conv_post's kernel


def make_sp_mesh(n_devices: int | None = None, devices=None, axis_name: str = SEQ_AXIS) -> Mesh:
    return make_mesh(n_devices, devices, axis_name)


def make_dp_sp_mesh(n_data: int, n_seq: int, devices=None, data_axis: str = DATA_AXIS,
                    seq_axis: str = SEQ_AXIS) -> Mesh:
    """2-D mesh: streams over ``data`` x frames over ``seq`` (the composed
    offline-synthesis layout)."""
    return make_2d_mesh(n_data, n_seq, (data_axis, seq_axis), devices)


def _check_halos(cfg: VocoderConfig, frames: int) -> None:
    """The JAX package's condition, conv by conv in the order it meets
    them: each conv's left context lies inside one neighbour."""
    convs = [(frames, PRE_POST_K, 1)]
    T = frames
    for u in cfg.upsample_rates:
        T *= u
        for k, dils in zip(cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes):
            for d in dils:
                convs += [(T, k, d), (T, k, 1)]
    convs.append((T, PRE_POST_K, 1))
    for T, k, d in convs:
        if T < (k - 1) * d:
            raise ValueError(
                f"sequence shard too short for halo: local T={T} < left context "
                f"{(k - 1) * d} (kernel {k}, dilation {d}); use fewer shards or more frames")


def _sp_conv(x, p, ax, precision):
    """Causal conv with its left context from the neighbour."""
    klen = conv_weight(p).shape[-1] - 1
    return conv1d(torch.cat([left_context(x, klen, ax), x], -1), p, precision=precision)


def _sp_conv_transpose(x, p, stride, ax, precision):
    """Causal transposed conv: the ``k - stride`` unfinished tail samples
    go right and are added into the neighbour's first ones; the bias after
    that add."""
    y = conv_transpose1d(x, {"w": p["w"]}, stride=stride, precision=precision)
    overlap = p["w"].shape[-1] - stride
    emit = stride * x.shape[-1]
    out = y[..., :emit]
    if overlap:
        head = out[..., :overlap] + from_left(y[..., emit: emit + overlap], ax)
        out = torch.cat([head, out[..., overlap:]], -1)
    return out + p["b"][None, :, None]


def direct_path(use_pallas: bool | None, approx_snake: bool) -> bool:
    """Whether a parallel vocoder runs the direct path: ``use_pallas=False``,
    or None with ``approx_snake`` (the kernels compute exact snake, so
    ``use_pallas=True`` with it raises, as the codec does)."""
    if use_pallas and approx_snake:
        raise ValueError("approx_snake=True is not supported with use_pallas (the kernels "
                         "compute exact snake); drop one")
    return bool(approx_snake) if use_pallas is None else not use_pallas


@torch.no_grad()
def generator_apply_sp(params: dict, cfg: VocoderConfig, mel, mesh: Mesh, *,
                       axis_name: str = SEQ_AXIS, precision: str = "highest",
                       compute_dtype: torch.dtype = torch.float32,
                       kernel_blocks: list | None = None, approx_snake: bool = False,
                       use_pallas: bool | None = None,
                       dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Sequence-parallel causal generator: mel (B, num_mels, T), T divisible
    by the ``seq`` axis, the same on every rank -> waveform (B, 1,
    T * prod(upsample_rates)) on every rank.  ``params`` are folded
    inference convs (numpy or tensors); ``precision`` sets conv_pre, the
    upsamplers and conv_post, ``compute_dtype`` the residual stacks' convs,
    as in ``models.vocoder.generator_apply_kernel``; ``kernel_blocks`` from
    ``prepare_kernel_params`` (prepared here when None).  The residual
    stacks run K1 unless ``use_pallas=False`` or ``approx_snake``
    (:func:`direct_path`), which run the direct path's blocks,
    ``approx_snake`` the polynomial sin^2.  ``dtype`` is the storage type:
    under bf16 the params and the mel are cast to bf16 and the whole
    generator runs in bf16 (the kernels with bf16 activations), as one
    device's does; the waveform comes back in ``dtype``."""
    if any(cfg.layers_sym) or cfg.pre_sym or cfg.post_sym:
        raise ValueError("sequence parallelism requires a fully causal config")
    if any(cfg.layers_antialias) or cfg.antialias_post:
        raise ValueError("sequence parallelism is incompatible with anti-aliased activations")
    direct = direct_path(use_pallas, approx_snake)
    ax, dax = mesh.axis(axis_name), mesh.axis(DATA_AXIS)
    mel = torch.as_tensor(mel).to(mesh.device, torch.float32).to(dtype)
    T = mel.shape[-1]
    if T % ax.size:
        raise ValueError(f"frames {T} not divisible by seq shards {ax.size}")
    Tl = T // ax.size
    _check_halos(cfg, Tl)
    params = to_torch(params, mesh.device, dtype=dtype)
    num_k = len(cfg.resblock_kernel_sizes)
    if direct:
        params = prepare_direct_params(params, cfg)
        block_prec = conv_precision(compute_dtype)

        def stack(i, window, ctx, start):
            return average([
                amp_block(window, params["resblocks"][i * num_k + j], cfg, ksz, dils,
                          precision=block_prec, approx=approx_snake, ctx=ctx, start=start)
                for j, (ksz, dils) in enumerate(zip(cfg.resblock_kernel_sizes,
                                                    cfg.resblock_dilation_sizes))])
    else:
        blocks = kernel_blocks if kernel_blocks is not None else prepare_kernel_params(params,
                                                                                         cfg)

        def stack(i, window, ctx, start):
            return amp_stack(window, blocks[i], compute_dtype, ctx=ctx, start=start)

    x = mel[row_blocks(mel.shape[0], dax.size)[dax.index], :, ax.index * Tl:(ax.index + 1) * Tl]
    x = _sp_conv(x.contiguous(), params["conv_pre"], ax, precision)
    ctx = stage_context(cfg)
    for i, u in enumerate(cfg.upsample_rates):
        if cfg.activation == "lrelu":
            x = leaky_relu(x)
        x = _sp_conv_transpose(x, params["ups"][i], u, ax, precision)
        start = torch.full((x.shape[0],), ax.index * x.shape[-1], dtype=torch.int32,
                           device=x.device)
        window = torch.cat([left_context(x, ctx, ax), x], -1)
        x = stack(i, window, ctx, start)
    x = activation(x, params["act_post"], cfg, approx_snake)
    wav = torch.tanh(_sp_conv(x, params["conv_post"], ax, precision))
    return all_gather(all_gather(wav, ax, -1), dax, 0)
