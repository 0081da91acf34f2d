"""The vocoder's AMP residual blocks: CUDA kernel, plain and tiled versions.

Replaces the Pallas TPU kernel ``bvsc_tpu/ops/pallas_voc.py:_amp_kernel``
(launched by ``amp_resblock_folded``, driven per stage by
``resblock_stack_folded``).  One AMP residual block is 3 units of
SnakeBeta -> causal dilated conv (k, d in {1, 3, 5}) -> SnakeBeta ->
causal conv (k, 1) -> residual add; a vocoder stage averages 3 blocks with
k = 3, 7, 11.

* :func:`amp_resblock` is the kernel's wrapper.  For a CUDA tensor it
  launches ``csrc/amp_resblock.cu`` (one launch per block, the stage
  average in torch) or raises; only a CPU tensor takes the plain version.
  ``amp_resblock.launches`` counts the launches.
* :func:`amp_block_plain` is the plain version, the reference
  ``_amp_block`` written with the port's ``conv1d`` and ``snake_beta``.
* :func:`amp_block_tiled` reproduces the kernel's tiling in torch (per-tile
  halo recompute, shrinking windows, zeros re-imposed at t < 0 after every
  conv's bias), so the CPU tests prove the kernel's indexing.

What bounds the kernel on an H100: float32 FLOPs on the CUDA cores, since
parity mode forbids TF32.  The design keeps every intermediate of a block
in shared memory, so device memory sees one read and one write of the
activations per block; see the source for what it does not do yet.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch
import torch.nn.functional as F

from bvsc_tpu_torch.ops import _build
from bvsc_tpu_torch.ops.conv import conv1d, pad1d
from bvsc_tpu_torch.ops.snake import EPS, snake_beta

SMEM_LIMIT = 232_448  # bytes of shared memory one block may use on Hopper
N_UNITS = 3


@dataclasses.dataclass(frozen=True)
class ResblockParams:
    """One resblock: its raw params (for the plain version) and the packed
    tensors the kernel reads."""

    block: dict
    kernel_size: int
    dilations: tuple[int, ...]
    w1: torch.Tensor  # (3, C, C, k)
    b1: torch.Tensor  # (3, C)
    w2: torch.Tensor  # (3, C, C, k)
    b2: torch.Tensor  # (3, C)
    alpha: torch.Tensor  # (6, C), exp(log alpha)
    inv_beta: torch.Tensor  # (6, C), 1 / (exp(log beta) + eps)

    @property
    def channels(self) -> int:
        return self.w1.shape[1]


def prepare_resblock(block: dict, kernel_size: int, dilations) -> ResblockParams:
    """Pack one resblock's params (snakebeta, log scale) for the kernel."""
    dilations = tuple(int(d) for d in dilations)
    if len(dilations) != N_UNITS:
        raise ValueError(f"the kernel runs {N_UNITS} units, got dilations {dilations}")

    def stack(tensors):
        return torch.stack(list(tensors)).contiguous()

    acts = block["acts"]
    return ResblockParams(
        block=block,
        kernel_size=int(kernel_size),
        dilations=dilations,
        w1=stack(c["w"] for c in block["convs1"]),
        b1=stack(c["b"] for c in block["convs1"]),
        w2=stack(c["w"] for c in block["convs2"]),
        b2=stack(c["b"] for c in block["convs2"]),
        alpha=stack(torch.exp(a["alpha"]) for a in acts),
        inv_beta=stack(1.0 / (torch.exp(a["beta"]) + EPS) for a in acts),
    )


def halo(kernel_size: int, dilations) -> int:
    """Left context of the unit chain: (k - 1) * (sum(d) + units)."""
    return (kernel_size - 1) * (sum(dilations) + len(dilations))


def tile_for(channels: int) -> int:
    """Output samples per thread block: wide tiles where channels are few."""
    return max(32, 8192 // channels)


def smem_bytes(rb: ResblockParams) -> int:
    """Shared memory of one thread block: 3 buffers of C x (halo + tile)."""
    C = rb.channels
    return 3 * 4 * C * (halo(rb.kernel_size, rb.dilations) + tile_for(C))


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def amp_block_plain(x: torch.Tensor, block: dict, kernel_size: int, dilations) -> torch.Tensor:
    """Causal AMP residual block (reference ``_amp_block``, causal branch)."""
    p2 = kernel_size - 1
    for j, d in enumerate(dilations):
        xt = snake_beta(x, block["acts"][2 * j], logscale=True)
        xt = conv1d(pad1d(xt, (kernel_size - 1) * d), block["convs1"][j], dilation=d)
        xt = snake_beta(xt, block["acts"][2 * j + 1], logscale=True)
        xt = conv1d(pad1d(xt, p2), block["convs2"][j])
        x = xt + x
    return x


def amp_block_tiled(x: torch.Tensor, rb: ResblockParams) -> torch.Tensor:
    """The kernel's algorithm in torch: tiles of ``tile_for(C)`` outputs,
    each recomputing its left halo from a zero-filled window."""
    B, C, T = x.shape
    k, dils = rb.kernel_size, rb.dilations
    H, tile = halo(k, dils), tile_for(C)
    xpad = F.pad(x, (H, tile))  # column i holds global time i - H
    acts = rb.block["acts"]
    out = torch.empty_like(x)
    for t0 in range(0, T, tile):
        xw = xpad[..., t0 : t0 + H + tile]
        g = torch.arange(t0 - H, t0 + tile, device=x.device)  # global times
        for j, d in enumerate(dils):
            xt = snake_beta(xw, acts[2 * j], logscale=True)
            xt = F.conv1d(xt, rb.w1[j], rb.b1[j], dilation=d)
            g = g[(k - 1) * d :]
            xt = xt * (g >= 0).to(xt.dtype)
            xt = snake_beta(xt, acts[2 * j + 1], logscale=True)
            xt = F.conv1d(xt, rb.w2[j], rb.b2[j])
            g = g[k - 1 :]
            xt = xt * (g >= 0).to(xt.dtype)
            xw = xt + xw[..., -xt.shape[-1] :]
        n = min(tile, T - t0)
        out[..., t0 : t0 + n] = xw[..., :n]
    return out


def average(outs: list[torch.Tensor]) -> torch.Tensor:
    """The stage average of its resblocks' outputs, summed in order."""
    xs = outs[0]
    for o in outs[1:]:
        xs = xs + o
    return xs / len(outs)


def amp_stack_plain(x: torch.Tensor, stage: list[ResblockParams]) -> torch.Tensor:
    """A vocoder stage: the plain blocks, averaged."""
    return average([amp_block_plain(x, rb.block, rb.kernel_size, rb.dilations) for rb in stage])


def amp_stack_tiled(x: torch.Tensor, stage: list[ResblockParams]) -> torch.Tensor:
    return average([amp_block_tiled(x, rb) for rb in stage])


# ---------------------------------------------------------------------------
# The kernel
# ---------------------------------------------------------------------------


@functools.cache
def _kernel():
    fn = _build.load("amp_resblock").amp_resblock_f32
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(x: torch.Tensor, rb: ResblockParams) -> None:
    if x.dtype != torch.float32 or x.dim() != 3 or not x.is_contiguous():
        raise ValueError(f"expected contiguous float32 (B, C, T), got {x.dtype} {tuple(x.shape)}")
    if not 0 < x.shape[0] <= 65535 or x.shape[2] == 0:
        raise ValueError(f"batch must be 1..65535 (a grid dimension) and T > 0, got {tuple(x.shape)}")
    if x.shape[1] != rb.channels:
        raise ValueError(f"{x.shape[1]} channels, resblock has {rb.channels}")
    for t in (rb.w1, rb.b1, rb.w2, rb.b2, rb.alpha, rb.inv_beta):
        if t.device != x.device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError("resblock params must be contiguous float32 on the input's device")
    if smem_bytes(rb) > SMEM_LIMIT:
        raise ValueError(f"{smem_bytes(rb)} B of shared memory exceeds {SMEM_LIMIT}")


def amp_resblock(x: torch.Tensor, rb: ResblockParams) -> torch.Tensor:
    """One AMP residual block.  CUDA tensors launch the kernel; CPU tensors
    take :func:`amp_block_plain`; anything else raises."""
    if x.device.type == "cpu":
        return amp_block_plain(x, rb.block, rb.kernel_size, rb.dilations)
    if x.device.type != "cuda":
        raise ValueError(f"amp_resblock runs on cuda or cpu, not {x.device}")
    _check(x, rb)
    B, C, T = x.shape
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = _kernel()(
            x.data_ptr(), y.data_ptr(), rb.w1.data_ptr(), rb.b1.data_ptr(),
            rb.w2.data_ptr(), rb.b2.data_ptr(), rb.alpha.data_ptr(), rb.inv_beta.data_ptr(),
            B, C, T, rb.kernel_size, *rb.dilations, tile_for(C),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"amp_resblock kernel launch failed: CUDA error {err}")
    amp_resblock.launches += 1
    return y


amp_resblock.launches = 0


def amp_stack(x: torch.Tensor, stage: list[ResblockParams]) -> torch.Tensor:
    """A vocoder stage through :func:`amp_resblock`: blocks averaged."""
    return average([amp_resblock(x, rb) for rb in stage])


def supported(cfg) -> bool:
    """The kernel covers the shipped config family: causal, no anti-alias,
    snakebeta with log-scale parameters, 3 dilations per block
    (counterpart of ``pallas_stack_supported``)."""
    return (
        not any(cfg.layers_sym)
        and not any(cfg.layers_antialias)
        and not cfg.antialias_post
        and cfg.activation == "snakebeta"
        and cfg.snake_logscale
        and all(len(d) == N_UNITS for d in cfg.resblock_dilation_sizes)
    )
