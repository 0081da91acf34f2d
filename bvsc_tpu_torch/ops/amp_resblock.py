"""The vocoder's AMP residual blocks: CUDA kernels, plain and tiled versions.

Replaces the Pallas TPU kernel ``bvsc_tpu/ops/pallas_voc.py:_amp_kernel``
(launched by ``amp_resblock_folded``, driven per stage by
``resblock_stack_folded``) in both of its modes.  One AMP residual block is
3 units of SnakeBeta -> causal dilated conv (k, d in {1, 3, 5}) ->
SnakeBeta -> causal conv (k, 1) -> residual add; a vocoder stage averages 3
blocks with k = 3, 7, 11.  ``compute_dtype`` picks the mode:

* float32 (parity): ``csrc/amp_resblock.cu``, register-blocked float32
  FMAs on the CUDA cores, since parity mode forbids TF32, compiled for the
  shipped shapes only (:data:`F32_SHAPES`), its weights packed by
  :func:`pack_f32`;
* bf16 (fast serving, the TPU kernel's default): ``csrc/amp_resblock_bf16.cu``
  on the tensor cores, for the same shapes.  Each conv's operands are
  rounded to bf16 and the products summed in float32; snake, bias, start
  mask and residual stay float32.

Each mode takes its activations in and out as float32, or, under the bf16
storage dtype, as bf16 (the TPU kernel's ``out_dtype=x.dtype``): the kernel
reads the bf16 input and widens it as it loads its window, computes as
above, and rounds its float32 result once to nearest-even bf16 as it
stores it.  The plain and tiled versions do the same (widen, compute, round
once), and :func:`average` then sums the three bf16 outputs in bf16, in
order, as the reference's stage does.  The weights and snake parameters
are float32 in every form (bf16 ones widen exactly).

* :func:`amp_resblock` is the kernels' wrapper.  Each mode is a
  ``torch.library`` custom op (:data:`OPS`: ``bvsc_torch::amp_resblock_f32``
  and ``bvsc_torch::amp_resblock_bf16``, flat tensors and ints in, (B, C,
  T) out), which a ``torch.export`` trace records; its fake function gives
  the shape, so a symbolic batch traces.  An eager call runs the op's
  implementation for its device without the dispatcher, and a traced
  program calls the op, so both reach the same launch: for a CUDA tensor
  :func:`launch` (one launch per block, the stage average in torch), which
  launches the mode's kernel or raises; only a CPU tensor takes the plain
  version, from the same packed weights.  ``amp_resblock.launches`` and
  ``amp_resblock.launches_bf16`` count the launches of each mode with
  float32 activations, ``amp_resblock.launches_io_bf16`` and
  ``amp_resblock.launches_bf16_io_bf16`` those with bf16 activations
  (:data:`COUNTERS`), in Python, on either route.
* :func:`amp_block_plain` is the plain version, the reference
  ``_amp_block`` written with the port's ``conv1d`` and SnakeBeta from the
  parameters :func:`snake_params` prepares.
* :func:`amp_block_tiled` reproduces a kernel's tiling in torch (per-tile
  halo recompute, shrinking windows, zeros re-imposed at t < 0 after every
  conv's bias; each conv reads the mode's packed weights as its kernel
  does), so the CPU tests prove the kernels' indexing and packing.

All of them take a streaming stage's two arguments: ``ctx``, samples of
left context before the T outputs asked for (the input is (B, C, ctx + T),
the output (B, C, T)), and ``start``, a (B,) int32 tensor (or None for all
0) of the samples each row's stream fed the stage before output column 0.
Time t < 0 is then a row's stream time: zero on load and after every conv.
``ctx=0, start=None`` is the offline call, bit for bit.

Both kernels keep every intermediate of a block in shared memory, so device
memory sees one read and one write of the activations per block; see the
sources for what they do not do yet.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch
import torch.nn.functional as F

from bvsc_tpu_torch.ops import _build
from bvsc_tpu_torch.ops.conv import conv1d, pad1d
from bvsc_tpu_torch.ops.precision import round_bf16
from bvsc_tpu_torch.ops.snake import EPS

SMEM_LIMIT = 232_448  # bytes of shared memory one block may use on Hopper
N_UNITS = 3
COMPUTE_DTYPES = (torch.float32, torch.bfloat16)
# The kernels' (C, k, d): templates on (C, k), a unit's dilation d by
# switch (float32) or as a row shift (bf16); the shipped configs use no other.
F32_SHAPES = tuple((C, k, d) for C in (8, 16, 32, 64) for k in (3, 7, 11) for d in (1, 3, 5))
BF16_SHAPES = F32_SHAPES
MIN_TILE = 32  # shortest tile tile_for picks in bf16 mode (two m16 tiles)
# Blocks of the bf16 kernel an SM runs at once, per C, at every k: 256
# threads at C <= 16 with room for two, 512 above (its build's occupancy,
# ``bf16_plan(...)["blocks_per_sm"]``, is at least this; chip_smoke.py
# checks it).  A wave of the grid is this many blocks per SM.
BF16_BLOCKS_PER_SM = {8: 2, 16: 2, 32: 1, 64: 1}


@dataclasses.dataclass(frozen=True)
class ResblockParams:
    """One resblock: its raw params (for the plain version) and the packed
    tensors the kernels read.  :meth:`for_mode` keeps only what one mode's
    op reads (a serving bundle's programs take nothing else); the fields it
    drops are None."""

    block: dict | None
    kernel_size: int
    dilations: tuple[int, ...]
    w1: torch.Tensor | None  # (3, C_out, C_in, k)
    b1: torch.Tensor  # (3, C)
    w2: torch.Tensor | None  # (3, C_out, C_in, k)
    b2: torch.Tensor  # (3, C)
    alpha: torch.Tensor  # (6, C), exp(log alpha)
    inv_beta: torch.Tensor  # (6, C), 1 / (exp(log beta) + eps)
    wf1: torch.Tensor | None  # (3, C_in, k, C_out) float32, w1 packed for the float32 kernel
    wf2: torch.Tensor | None  # (3, C_in, k, C_out) float32
    wk1: torch.Tensor | None  # (3, C, Kp) bf16, w1 packed for the bf16 kernel
    wk2: torch.Tensor | None  # (3, C, Kp) bf16

    @property
    def channels(self) -> int:
        return self.b1.shape[1]

    def op_tensors(self, compute_dtype: torch.dtype) -> dict:
        """The tensors the mode's op takes: the mode's packed conv weights
        as ``w1``/``w2``, then the biases and snake parameters."""
        bf16 = conv_precision(compute_dtype) == "default"
        return {"w1": self.wk1 if bf16 else self.wf1, "b1": self.b1,
                "w2": self.wk2 if bf16 else self.wf2, "b2": self.b2,
                "alpha": self.alpha, "inv_beta": self.inv_beta}

    def for_mode(self, compute_dtype: torch.dtype, t: dict) -> "ResblockParams":
        """This block holding only ``t``, tensors of the mode's
        :meth:`op_tensors` layout."""
        bf16 = conv_precision(compute_dtype) == "default"
        w1, w2 = t["w1"], t["w2"]
        return ResblockParams(
            block=None, kernel_size=self.kernel_size, dilations=self.dilations, w1=None,
            b1=t["b1"], w2=None, b2=t["b2"], alpha=t["alpha"], inv_beta=t["inv_beta"],
            wf1=None if bf16 else w1, wf2=None if bf16 else w2,
            wk1=w1 if bf16 else None, wk2=w2 if bf16 else None)


def pack_f32(w: torch.Tensor) -> torch.Tensor:
    """(3, C_out, C_in, k) float32 conv weights -> (3, C_in, k, C_out): the
    float32 kernel reads the C_out weights of one (c_in, tap) as float4s."""
    return w.permute(0, 2, 3, 1).contiguous()


def pack_bf16(w: torch.Tensor) -> torch.Tensor:
    """(3, C_out, C_in, k) float32 conv weights -> (3, C_out, Kp) bf16 GEMM
    rows, column ``tap * C_in + c_in``, zero-padded to Kp, the least
    multiple of 16 >= C_in * k (the bf16 kernel's K)."""
    n, co, ci, k = w.shape
    rows = w.permute(0, 1, 3, 2).reshape(n, co, k * ci)
    return F.pad(rows, (0, -(k * ci) % 16)).to(torch.bfloat16).contiguous()


def snake_params(acts: list) -> tuple[torch.Tensor, torch.Tensor]:
    """A block's (6, C) linear-scale alpha and 1 / (beta + eps) from its
    log-scale snake params, on their device.  Computed on the host in
    float64 and rounded once to float32, so the same on every device: a
    card's ``exp`` and the CPU's can differ in the last bit, and a serving
    bundle stores these as they were prepared."""
    def host64(key):
        return torch.stack([a[key] for a in acts]).detach().to("cpu", torch.float64)

    dev = acts[0]["alpha"].device
    return (torch.exp(host64("alpha")).float().to(dev),
            (1.0 / (torch.exp(host64("beta")) + EPS)).float().to(dev))


def prepare_resblock(block: dict, kernel_size: int, dilations) -> ResblockParams:
    """Pack one resblock's params (snakebeta, log scale) for the kernel;
    bf16-stored params widen to float32, exactly."""
    dilations = tuple(int(d) for d in dilations)
    if len(dilations) != N_UNITS:
        raise ValueError(f"the kernel runs {N_UNITS} units, got dilations {dilations}")

    def stack(tensors):
        return torch.stack([t.to(torch.float32) for t in tensors]).contiguous()

    alpha, inv_beta = snake_params(block["acts"])
    w1 = stack(c["w"] for c in block["convs1"])
    w2 = stack(c["w"] for c in block["convs2"])
    return ResblockParams(
        block=block,
        kernel_size=int(kernel_size),
        dilations=dilations,
        w1=w1,
        b1=stack(c["b"] for c in block["convs1"]),
        w2=w2,
        b2=stack(c["b"] for c in block["convs2"]),
        alpha=alpha,
        inv_beta=inv_beta,
        wf1=pack_f32(w1),
        wf2=pack_f32(w2),
        wk1=pack_bf16(w1),
        wk2=pack_bf16(w2),
    )


def halo(kernel_size: int, dilations) -> int:
    """Left context of the unit chain: (k - 1) * (sum(d) + units)."""
    return (kernel_size - 1) * (sum(dilations) + len(dilations))


def tile_for(channels: int, compute_dtype: torch.dtype = torch.float32, batch: int = 0,
             length: int = 0, sms: int = 0) -> int:
    """Output samples per thread block: 8192 / C, wide where channels are
    few; the defaults give that full tile.  Where ``batch`` rows of
    ``length`` samples would leave some of the card's ``sms`` SMs without a
    block, float32 halves it once (a B = 4 call's stage 0, 2 056 samples at
    C = 64: 68 blocks of 128 for 132 SMs, 132 of 64); bf16 halves it while
    the halved grid still fits in one wave, ``sms`` times
    :data:`BF16_BLOCKS_PER_SM` blocks, down to :data:`MIN_TILE` (the same
    B = 4 stage 0 gets 64; a B = 1 call halves every stage, stage 0 to 32)."""
    tile = 8192 // channels
    if compute_dtype == torch.bfloat16:
        wave = sms * BF16_BLOCKS_PER_SM.get(channels, 1)
        while (wave and tile // 2 >= MIN_TILE
               and batch * -(-length // tile) < wave
               and batch * -(-length // (tile // 2)) <= wave):
            tile //= 2
        return tile
    tile = max(32, tile)
    return tile // 2 if batch * -(-length // tile) < sms else tile


def smem_bytes(rb: ResblockParams, compute_dtype: torch.dtype = torch.float32,
               tile: int | None = None) -> int:
    """Shared memory of one thread block for the window L = halo + tile
    (``tile_for``'s by default), as the mode's kernel build reports it
    (:func:`f32_plan`, :func:`bf16_plan`; so it needs the built kernel)."""
    tile = tile or tile_for(rb.channels, compute_dtype)
    plan = bf16_plan if compute_dtype == torch.bfloat16 else f32_plan
    return plan(rb, tile)["smem_bytes"]


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def conv_precision(compute_dtype: torch.dtype) -> str:
    """The ``ops.conv`` precision of a residual stack's mode: ``'highest'``
    for float32, ``'default'`` (bf16 operands, float32 sums) for bf16."""
    if compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype must be float32 or bfloat16, got {compute_dtype}")
    return "highest" if compute_dtype == torch.float32 else "default"


def stream_times(x: torch.Tensor, ctx: int, start: torch.Tensor | None, lo: int = 0,
                  n: int | None = None) -> torch.Tensor:
    """(B, 1, n) stream times of input columns ``lo`` to ``lo + n``
    (default: all of them): column ``ctx`` is row b's time ``start[b]``."""
    n = x.shape[-1] - lo if n is None else n
    cols = torch.arange(lo - ctx, lo - ctx + n, device=x.device)
    if start is None:
        return cols.expand(x.shape[0], 1, n)
    return start.to(torch.int64)[:, None, None] + cols


def _snake(x: torch.Tensor, alpha: torch.Tensor, inv_beta: torch.Tensor) -> torch.Tensor:
    """SnakeBeta from the linear-scale (C,) alpha and 1 / (beta + eps)
    (:func:`snake_params`)."""
    return x + inv_beta[None, :, None] * torch.square(torch.sin(x * alpha[None, :, None]))


def _block_plain(x, w1, b1, w2, b2, alpha, inv_beta, kernel_size: int, dilations,
                 compute_dtype: torch.dtype, ctx: int, start) -> torch.Tensor:
    """The plain block on (3, C_out, C_in, k) conv weights, (3, C) biases
    and (6, C) linear-scale snake parameters."""
    prec = conv_precision(compute_dtype)
    p2 = kernel_size - 1
    keep = None if ctx == 0 and start is None else stream_times(x, ctx, start) >= 0

    def mask(v):
        return v if keep is None else torch.where(keep, v, 0.0)

    x = mask(x)
    for j, d in enumerate(dilations):
        xt = _snake(x, alpha[2 * j], inv_beta[2 * j])
        xt = mask(conv1d(pad1d(xt, (kernel_size - 1) * d), {"w": w1[j], "b": b1[j]},
                         dilation=d, precision=prec))
        xt = _snake(xt, alpha[2 * j + 1], inv_beta[2 * j + 1])
        xt = mask(conv1d(pad1d(xt, p2), {"w": w2[j], "b": b2[j]}, precision=prec))
        x = xt + x
    return x[..., ctx:]


def amp_block_plain(x: torch.Tensor, block: dict, kernel_size: int, dilations,
                    compute_dtype: torch.dtype = torch.float32, ctx: int = 0,
                    start: torch.Tensor | None = None) -> torch.Tensor:
    """Causal AMP residual block (reference ``_amp_block``, causal branch);
    in bf16 mode each conv takes bf16-rounded operands (``conv1d`` at
    precision ``'default'``).  With ``ctx`` or ``start`` (module docstring)
    the positions before each row's stream began are zeroed on load and
    after every conv's bias, and the last T columns returned.  A bf16 ``x``
    is widened, and the float32 result rounded once to bf16."""
    def stack(tensors):
        return torch.stack([t.to(torch.float32) for t in tensors])

    y = _block_plain(
        x.to(torch.float32), stack(c["w"] for c in block["convs1"]),
        stack(c["b"] for c in block["convs1"]), stack(c["w"] for c in block["convs2"]),
        stack(c["b"] for c in block["convs2"]), *snake_params(block["acts"]), kernel_size,
        dilations, compute_dtype, ctx, start)
    return y.to(x.dtype)


def unpack_f32(wf: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_f32`: (3, C_in, k, C_out) -> (3, C_out, C_in, k)."""
    return wf.permute(0, 3, 1, 2).contiguous()


def unpack_bf16(wk: torch.Tensor, kernel_size: int) -> torch.Tensor:
    """Inverse of :func:`pack_bf16` to the bf16-rounded weights, in float32:
    (3, C_out, Kp) -> (3, C_out, C_in, k)."""
    n, co, _ = wk.shape
    ci = co  # a resblock's convs are square
    rows = wk[..., : kernel_size * ci].to(torch.float32)
    return rows.reshape(n, co, kernel_size, ci).permute(0, 1, 3, 2).contiguous()


def amp_block_packed_plain(x, w1, b1, w2, b2, alpha, inv_beta, start, kernel_size: int,
                           dilations, ctx: int, compute_dtype: torch.dtype) -> torch.Tensor:
    """:func:`amp_block_plain` from the op's arguments (the mode's packed
    weights): the ops' CPU implementation, bitwise the plain block of the
    raw params (unpacking is exact, and bf16 mode rounds the weights to
    bf16 either way)."""
    bf16 = conv_precision(compute_dtype) == "default"
    unpack = (lambda w: unpack_bf16(w, kernel_size)) if bf16 else unpack_f32
    return _block_plain(x.to(torch.float32), unpack(w1), b1, unpack(w2), b2, alpha, inv_beta,
                        kernel_size, dilations, compute_dtype, ctx, start).to(x.dtype)


def _conv_gemm(xt: torch.Tensor, wk: torch.Tensor, b: torch.Tensor, k: int, d: int) -> torch.Tensor:
    """The bf16 kernel's conv: rows (t, tap * C + c) of the bf16-rounded
    operand, zero-padded to Kp, times the packed weights ``wk`` (C, Kp);
    float32 sums, then the bias."""
    n = xt.shape[-1] - (k - 1) * d
    taps = torch.stack([xt[..., tap * d : tap * d + n] for tap in range(k)], 1)  # (B, k, C, n)
    rows = taps.permute(0, 3, 1, 2).reshape(xt.shape[0], n, -1)  # (B, n, k C)
    rows = F.pad(round_bf16(rows), (0, wk.shape[-1] - rows.shape[-1]))
    return (rows @ wk.to(torch.float32).T).transpose(1, 2) + b[:, None]


def _conv_packed(xt: torch.Tensor, wf: torch.Tensor, b: torch.Tensor, k: int, d: int) -> torch.Tensor:
    """The float32 kernel's conv: sum over (c_in, tap) of the packed weights
    ``wf`` (C_in, k, C_out) times the input at t - (k - 1 - tap) d, then the
    bias."""
    n = xt.shape[-1] - (k - 1) * d
    taps = torch.stack([xt[..., tap * d : tap * d + n] for tap in range(k)], 2)  # (B, C, k, n)
    return torch.einsum("bikn,iko->bon", taps, wf) + b[:, None]


def amp_block_tiled(x: torch.Tensor, rb: ResblockParams,
                    compute_dtype: torch.dtype = torch.float32,
                    tile: int | None = None, ctx: int = 0,
                    start: torch.Tensor | None = None) -> torch.Tensor:
    """A kernel's algorithm in torch: tiles of ``tile`` outputs
    (``tile_for(C, compute_dtype)``'s by default), each recomputing its left
    halo from a window read from the input where it lies at or after input
    column 0, zeros elsewhere and before each row's stream began; each conv
    reads the mode's packed weights (:func:`_conv_packed`, or the bf16 GEMM
    :func:`_conv_gemm`) and each snake its prepared parameters.  A bf16
    ``x`` is widened as a window loads it, and each output rounded once to
    bf16 as it is stored."""
    bf16 = conv_precision(compute_dtype) == "default"
    B, C, T = x.shape[0], x.shape[1], x.shape[2] - ctx
    k, dils = rb.kernel_size, rb.dilations
    H, tile = halo(k, dils), tile or tile_for(C, compute_dtype)
    xpad = F.pad(x.to(torch.float32), (H, tile))  # column i holds input column i - H
    out = x.new_empty(B, C, T)

    def conv(xt, n, j, d):
        wf, b, wk = (rb.wf1, rb.b1, rb.wk1) if n == 1 else (rb.wf2, rb.b2, rb.wk2)
        if bf16:
            return _conv_gemm(xt, wk[j], b[j], k, d)
        return _conv_packed(xt, wf[j], b[j], k, d)

    for t0 in range(0, T, tile):
        g = stream_times(x, ctx, start, ctx + t0 - H, H + tile)
        xw = xpad[..., ctx + t0 : ctx + t0 + H + tile] * (g >= 0).to(xpad.dtype)
        for j, d in enumerate(dils):
            xt = _snake(xw, rb.alpha[2 * j], rb.inv_beta[2 * j])
            xt = conv(xt, 1, j, d)
            g = g[..., (k - 1) * d :]
            xt = xt * (g >= 0).to(xt.dtype)
            xt = _snake(xt, rb.alpha[2 * j + 1], rb.inv_beta[2 * j + 1])
            xt = conv(xt, 2, j, 1)
            g = g[..., k - 1 :]
            xt = xt * (g >= 0).to(xt.dtype)
            xw = xt + xw[..., -xt.shape[-1] :]
        n = min(tile, T - t0)
        out[..., t0 : t0 + n] = xw[..., :n]
    return out


def average(outs: list[torch.Tensor]) -> torch.Tensor:
    """The stage average of its resblocks' outputs, summed in order in their
    dtype (bf16 outputs: ``(o0 + o1) + o2``, then ``/ 3``, each rounded to
    bf16, as the reference's stage)."""
    xs = outs[0]
    for o in outs[1:]:
        xs = xs + o
    return xs / len(outs)


def amp_stack_plain(x: torch.Tensor, stage: list[ResblockParams],
                    compute_dtype: torch.dtype = torch.float32, ctx: int = 0,
                    start: torch.Tensor | None = None) -> torch.Tensor:
    """A vocoder stage: the plain blocks, averaged."""
    return average([amp_block_plain(x, rb.block, rb.kernel_size, rb.dilations, compute_dtype,
                                    ctx, start) for rb in stage])


def amp_stack_tiled(x: torch.Tensor, stage: list[ResblockParams],
                    compute_dtype: torch.dtype = torch.float32,
                    tile: int | None = None, ctx: int = 0,
                    start: torch.Tensor | None = None) -> torch.Tensor:
    return average([amp_block_tiled(x, rb, compute_dtype, tile, ctx, start) for rb in stage])


# ---------------------------------------------------------------------------
# The kernel
# ---------------------------------------------------------------------------


# The C entry point and the launch counter (an attribute of amp_resblock)
# of each (mode, activation type).
_ENTRIES = {(torch.float32, torch.float32): ("amp_resblock", "amp_resblock_f32", "launches"),
            (torch.bfloat16, torch.float32): ("amp_resblock_bf16", "amp_resblock_bf16",
                                              "launches_bf16"),
            (torch.float32, torch.bfloat16): ("amp_resblock_io_bf16",
                                              "amp_resblock_f32_io_bf16", "launches_io_bf16"),
            (torch.bfloat16, torch.bfloat16): ("amp_resblock_bf16_io_bf16",
                                               "amp_resblock_bf16_io_bf16",
                                               "launches_bf16_io_bf16")}
COUNTERS = tuple(entry[2] for entry in _ENTRIES.values())
IO_DTYPES = (torch.float32, torch.bfloat16)


@functools.cache
def _kernel(compute_dtype: torch.dtype, io_dtype: torch.dtype = torch.float32):
    source, entry, _ = _ENTRIES[(compute_dtype, io_dtype)]
    fn = getattr(_build.load(source), entry)
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def launch_tile(x: torch.Tensor, compute_dtype: torch.dtype = torch.float32, ctx: int = 0) -> int:
    """The tile :func:`amp_resblock` launches with for a CUDA tensor ``x``
    of ``ctx`` context columns: ``tile_for`` at its (B, C) and its T outputs
    on its card's SMs."""
    B, C, T = x.shape
    return tile_for(C, compute_dtype, B, T - ctx, _sm_count(x.device))


@functools.cache
def _plan(compute_dtype: torch.dtype):
    if compute_dtype == torch.bfloat16:
        fn = _build.load("amp_resblock_bf16").amp_resblock_bf16_plan
    else:
        fn = _build.load("amp_resblock").amp_resblock_f32_plan
    fn.argtypes = [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _ask_plan(compute_dtype: torch.dtype, C: int, k: int, dilations: tuple, tile: int,
              n: int) -> tuple:
    """The ``n`` ints the mode's build reports for one launch shape (asked
    once per shape: the wrapper checks every launch against it)."""
    out = (ctypes.c_int * n)()
    err = _plan(compute_dtype)(C, k, *dilations, tile, ctypes.addressof(out))
    if err != 0:
        raise ValueError(f"the {compute_dtype} kernel does not take C={C}, k={k}, "
                         f"d={dilations}, tile={tile} (CUDA error {err})")
    return tuple(out)


def f32_plan(rb: ResblockParams, tile: int | None = None) -> dict:
    """The float32 kernel's launch for one resblock and ``tile`` (default
    ``tile_for``'s), as its build reports it: threads per block, bytes of
    shared memory and the micro-tile (R_co, R_t).  The kernel source owns
    that layout; this builds the kernel if needed."""
    out = _ask_plan(torch.float32, rb.channels, rb.kernel_size, rb.dilations,
                    tile or tile_for(rb.channels), 4)
    return {"threads": out[0], "smem_bytes": out[1], "rco": out[2], "rt": out[3]}


def bf16_plan(rb: ResblockParams, tile: int | None = None) -> dict:
    """The bf16 kernel's launch for one resblock and ``tile`` (default
    ``tile_for``'s), as its build reports it: threads per block, bytes of
    shared memory, the warp tile (``rm`` m16 tiles x ``channels`` output
    channels), how many convs' weights it stages at once
    (``weight_buffers``) and how many blocks an SM holds at once
    (``blocks_per_sm``, CUDA's occupancy calculator).  The kernel source
    owns that layout; this builds the kernel if needed."""
    out = _ask_plan(torch.bfloat16, rb.channels, rb.kernel_size, rb.dilations,
                    tile or tile_for(rb.channels, torch.bfloat16), 6)
    return {"threads": out[0], "smem_bytes": out[1], "rm": out[2], "channels": out[3],
            "weight_buffers": out[4], "blocks_per_sm": out[5]}


def _check_op(x: torch.Tensor, w1, b1, w2, b2, alpha, inv_beta, start, kernel_size: int,
              dilations: tuple, compute_dtype: torch.dtype, tile: int | None = None,
              ctx: int = 0) -> None:
    """Refuses what the mode's kernel cannot take; with a ``tile``, also a
    window whose shared memory, as the kernel's build reports it, exceeds
    :data:`SMEM_LIMIT`."""
    if x.dtype not in IO_DTYPES or x.dim() != 3 or not x.is_contiguous():
        raise ValueError(f"expected contiguous float32 or bf16 (B, C, T), got {x.dtype} "
                         f"{tuple(x.shape)}")
    if not 0 < x.shape[0] <= 65535 or not 0 <= ctx < x.shape[2]:
        raise ValueError(f"batch must be 1..65535 (a grid dimension) and 0 <= ctx < ctx + T, "
                         f"got {tuple(x.shape)}, ctx={ctx}")
    if start is not None and (start.dtype != torch.int32 or start.shape != x.shape[:1]
                              or start.device != x.device or not start.is_contiguous()):
        raise ValueError(f"start must be a contiguous int32 ({x.shape[0]},) tensor on the "
                         f"input's device, got {start.dtype} {tuple(start.shape)} on {start.device}")
    C = b1.shape[-1]
    if x.shape[1] != C:
        raise ValueError(f"{x.shape[1]} channels, resblock has {C}")
    bf16 = compute_dtype == torch.bfloat16
    wshape = (3, C, C * kernel_size + -(C * kernel_size) % 16) if bf16 else (3, C, kernel_size, C)
    wdtype = torch.bfloat16 if bf16 else torch.float32
    for t, dtype, shape in [(w1, wdtype, wshape), (w2, wdtype, wshape), (b1, torch.float32, (3, C)),
                            (b2, torch.float32, (3, C)), (alpha, torch.float32, (6, C)),
                            (inv_beta, torch.float32, (6, C))]:
        if (t.device != x.device or t.dtype != dtype or not t.is_contiguous()
                or tuple(t.shape) != shape):
            raise ValueError(f"resblock params must be contiguous {dtype} {shape} on the "
                             f"input's device, got {t.dtype} {tuple(t.shape)} on {t.device}")
    if bf16 and any(t.data_ptr() % 16 for t in (w1, w2)):
        raise ValueError("the bf16 kernel copies its weights in 16-byte pieces: align them")
    shapes = [(C, kernel_size, d) for d in dilations]
    if not set(shapes) <= set(BF16_SHAPES if bf16 else F32_SHAPES):
        name = "BF16_SHAPES" if bf16 else "F32_SHAPES"
        raise ValueError(f"the {compute_dtype} kernel takes (C, k, d) in {name}, got {shapes}")
    if tile is not None and (tile <= 0 or bf16 and tile % 16):
        raise ValueError(f"the tile must be positive (a multiple of 16 in bf16), got {tile}")
    if tile is not None:
        plan = _ask_plan(compute_dtype, C, kernel_size, tuple(dilations), tile, 6 if bf16 else 4)
        if plan[1] > SMEM_LIMIT:
            raise ValueError(f"{plan[1]} B of shared memory exceeds {SMEM_LIMIT}")


def _check(x: torch.Tensor, rb: ResblockParams, compute_dtype: torch.dtype,
           tile: int | None = None, ctx: int = 0, start: torch.Tensor | None = None) -> None:
    """:func:`_check_op` on one resblock's tensors for the mode."""
    t = rb.op_tensors(compute_dtype)
    _check_op(x, t["w1"], t["b1"], t["w2"], t["b2"], t["alpha"], t["inv_beta"], start,
              rb.kernel_size, rb.dilations, compute_dtype, tile, ctx)


def launch(x: torch.Tensor, w1, b1, w2, b2, alpha, inv_beta, start, kernel_size: int,
           dilations, ctx: int, tile: int, compute_dtype: torch.dtype) -> torch.Tensor:
    """The ops' CUDA implementation: checks the arguments, then launches the
    kernel of the mode and of ``x``'s type (float32 or bf16 activations in
    and out) on the current stream with ``tile`` outputs per thread block
    (0: :func:`launch_tile`'s, from the real B) and counts the launch."""
    tile = tile or launch_tile(x, compute_dtype, ctx)
    dilations = tuple(dilations)
    _check_op(x, w1, b1, w2, b2, alpha, inv_beta, start, kernel_size, dilations,
              compute_dtype, tile, ctx)
    B, C, T = x.shape[0], x.shape[1], x.shape[2] - ctx
    y = x.new_empty(B, C, T)
    with torch.cuda.device(x.device):
        err = _kernel(compute_dtype, x.dtype)(
            x.data_ptr(), y.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
            b2.data_ptr(), alpha.data_ptr(), inv_beta.data_ptr(),
            None if start is None else start.data_ptr(),
            B, C, T, ctx, kernel_size, *dilations, tile,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"amp_resblock ({compute_dtype}, {x.dtype} activations) kernel launch "
                           f"failed: CUDA error {err}")
    counter = _ENTRIES[(compute_dtype, x.dtype)][2]
    setattr(amp_resblock, counter, getattr(amp_resblock, counter) + 1)
    return y


_OP_SCHEMA = ("(Tensor x, Tensor w1, Tensor b1, Tensor w2, Tensor b2, Tensor alpha, "
              "Tensor inv_beta, Tensor? start, int kernel_size, int[] dilations, int ctx, "
              "int tile) -> Tensor")


def _plain_op(x, w1, b1, w2, b2, alpha, inv_beta, start, kernel_size: int, dilations, ctx: int,
              tile: int, compute_dtype: torch.dtype) -> torch.Tensor:
    """The ops' CPU implementation: the plain block, contiguous as the
    kernel's output and the fake function's are (``tile`` is the kernel's
    only)."""
    return amp_block_packed_plain(x, w1, b1, w2, b2, alpha, inv_beta, start, kernel_size,
                                  dilations, ctx, compute_dtype).contiguous()


def _define_op(name: str, compute_dtype: torch.dtype):
    """The mode's custom op: CPU implementation :func:`_plain_op`, CUDA
    implementation :func:`launch`, fake function (B, C, T - ctx)."""

    def plain(x, w1, b1, w2, b2, alpha, inv_beta, start, kernel_size, dilations, ctx, tile):
        return _plain_op(x, w1, b1, w2, b2, alpha, inv_beta, start, kernel_size, dilations, ctx,
                         tile, compute_dtype)

    op = torch.library.custom_op(f"bvsc_torch::{name}", plain, mutates_args=(),
                                 device_types="cpu", schema=_OP_SCHEMA)

    @op.register_kernel("cuda")
    def _cuda(x, w1, b1, w2, b2, alpha, inv_beta, start, kernel_size, dilations, ctx, tile):
        return launch(x, w1, b1, w2, b2, alpha, inv_beta, start, kernel_size, dilations, ctx,
                      tile, compute_dtype)

    @op.register_fake
    def _fake(x, w1, b1, w2, b2, alpha, inv_beta, start, kernel_size, dilations, ctx, tile):
        return x.new_empty(x.shape[0], x.shape[1], x.shape[2] - ctx)

    return op


# One op per mode; a traced program calls them as torch.ops.bvsc_torch.<name>.
OPS = {torch.float32: _define_op("amp_resblock_f32", torch.float32),
       torch.bfloat16: _define_op("amp_resblock_bf16", torch.bfloat16)}


def amp_resblock(x: torch.Tensor, rb: ResblockParams,
                 compute_dtype: torch.dtype = torch.float32,
                 tile: int | None = None, ctx: int = 0,
                 start: torch.Tensor | None = None) -> torch.Tensor:
    """One AMP residual block in ``compute_dtype``'s mode, on (B, C, ctx +
    T) with ``start`` (module docstring) to (B, C, T), through the mode's
    op (:data:`OPS`).  CUDA tensors launch that mode's kernel with ``tile``
    outputs per thread block (:func:`launch_tile`'s by default); CPU
    tensors take the plain block; anything else raises."""
    conv_precision(compute_dtype)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"amp_resblock runs on cuda or cpu, not {x.device}")
    t = rb.op_tensors(compute_dtype)
    args = (x, t["w1"], t["b1"], t["w2"], t["b2"], t["alpha"], t["inv_beta"], start,
            rb.kernel_size, list(rb.dilations), ctx, tile or 0)
    if torch.compiler.is_compiling() or type(x) is not torch.Tensor:
        return OPS[compute_dtype](*args)  # a trace records the op
    # Eager calls skip the dispatcher, which adds tens of microseconds to a
    # launch on the card's host (PERF.md, section 6), and run the op's
    # implementation itself.
    return (launch if x.device.type == "cuda" else _plain_op)(*args, compute_dtype)


amp_resblock.launches = 0  # float32 kernel, float32 activations
amp_resblock.launches_bf16 = 0  # bf16 kernel, float32 activations
amp_resblock.launches_io_bf16 = 0  # float32 kernel, bf16 activations
amp_resblock.launches_bf16_io_bf16 = 0  # bf16 kernel, bf16 activations


def reset_launches() -> None:
    """Every launch counter of :data:`COUNTERS` to 0."""
    for name in COUNTERS:
        setattr(amp_resblock, name, 0)


def read_launches() -> dict:
    """The launch counters of :data:`COUNTERS`, by name."""
    return {name: getattr(amp_resblock, name) for name in COUNTERS}


def amp_stack(x: torch.Tensor, stage: list[ResblockParams],
              compute_dtype: torch.dtype = torch.float32, ctx: int = 0,
              start: torch.Tensor | None = None) -> torch.Tensor:
    """A vocoder stage through :func:`amp_resblock`: blocks averaged."""
    return average([amp_resblock(x, rb, compute_dtype, ctx=ctx, start=start) for rb in stage])


def causal_family(cfg) -> bool:
    """The shipped config family: causal, no anti-alias, snakebeta with
    log-scale parameters (the direct path runs the config's other
    variants)."""
    return (
        not any(cfg.layers_sym)
        and not any(cfg.layers_antialias)
        and not cfg.antialias_post
        and cfg.activation == "snakebeta"
        and cfg.snake_logscale
    )


def supported(cfg) -> bool:
    """The kernel covers the shipped config family with 3 dilations per
    block (counterpart of ``pallas_stack_supported``)."""
    return causal_family(cfg) and all(len(d) == N_UNITS for d in cfg.resblock_dilation_sizes)
