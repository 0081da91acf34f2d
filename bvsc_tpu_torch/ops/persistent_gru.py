"""A persistent GRU recurrence: CUDA kernel, plain and tiled versions,
and the torch scans it is measured against.

Replaces the Pallas TPU kernel ``persistent_kernel`` of
``benchmarks/probe_persistent_gru.py`` (launched by ``pallas_persistent``):
``steps`` GRU steps over 8 rows of h in one launch, with the weights kept
on chip.  Each step ``x = [bf16(h) | bf16(xconst)]``,
``gi = x @ W_ih + b_ih``, ``gh = bf16(h) @ W_hh + b_hh`` with float32 sums,
then the GRU update in float32 (gates packed [r | z | n]).

* :func:`persistent_gru` is the kernel's wrapper.  For CUDA tensors it
  launches ``csrc/persistent_gru.cu`` (one cooperative launch) or raises;
  only CPU tensors take the plain version.  ``persistent_gru.launches``
  counts the launches.
* :func:`persistent_gru_plain` is the TPU kernel's arithmetic step by step.
* :func:`persistent_gru_tiled` walks the kernel's schedule (:func:`plan`):
  the units split over blocks, each block's row tiles ``[r | z]`` and
  ``[n | 0]`` over the stacked contraction ``[h | xc | h]``, its k-steps
  split over the warps of W_ih's part and of W_hh's, each 16-deep slab
  formed from zero and the sums added in the kernel's order, int8 widened
  once; the CPU tests prove it.
* :func:`scan`, :func:`quantize` and :func:`scan_int8` are the probe's
  variants A-C (``scan_fn``, ``quantize``, ``scan_int8``): plain PyTorch
  products, as the JAX probe leaves them to XLA.

``dequant=True`` takes int8 weights and widens them with no scale, as the
Pallas kernel does: the JAX probe's variant E leaves the scale out.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from bvsc_tpu_torch.ops import _build

LANES = 8  # rows of h the kernel runs (the probe's LANES): the mma's N
MAX_UNITS = 8  # hidden units per block: [r | z] is one m16 tile
KSTEPS = 8  # 16-deep k-steps a warp holds in registers
IH_WARPS, HH_WARPS = 16, 8  # warps over W_ih's 2H and W_hh's H: H <= 1024
WARPS = IH_WARPS + HH_WARPS
RED_ROWS = 3 * MAX_UNITS  # a warp's sums: r, z and n of 8 units
MAX_H = 16 * KSTEPS * HH_WARPS


def gru_math(gi: torch.Tensor, gh: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """The GRU update from the packed [r | z | n] gate sums, in float32."""
    i_r, i_z, i_n = gi.split(h.shape[-1], dim=-1)
    h_r, h_z, h_n = gh.split(h.shape[-1], dim=-1)
    r = torch.sigmoid(i_r + h_r)
    z = torch.sigmoid(i_z + h_z)
    n = torch.tanh(i_n + r * h_n)
    return (1.0 - z) * n + z * h


def _bf16(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bf16 and held in float32."""
    return t.to(torch.bfloat16).float()


def _check(wi, wh, bi, bh, xc, h0, steps, dequant) -> None:
    H = h0.shape[-1]
    wdtype = torch.int8 if dequant else torch.bfloat16
    shapes = {"wi": (wi, (2 * H, 3 * H), wdtype), "wh": (wh, (H, 3 * H), wdtype),
              "bi": (bi, (1, 3 * H), torch.float32), "bh": (bh, (1, 3 * H), torch.float32),
              "xc": (xc, (LANES, H), torch.float32), "h0": (h0, (LANES, H), torch.float32)}
    for name, (t, shape, dtype) in shapes.items():
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name}: expected {dtype} {shape}, got {t.dtype} {tuple(t.shape)}")
        if t.device != h0.device:
            raise ValueError(f"{name} is on {t.device}, h0 on {h0.device}")
    if steps < 1:
        raise ValueError(f"steps must be >= 1, got {steps}")


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def persistent_gru_plain(wi, wh, bi, bh, xc, h0, steps: int, dequant: bool = False):
    """The Pallas kernel's arithmetic, one step at a time.  The bf16 (or
    int8) operands are widened to float32 and multiplied in float32, which
    keeps the gate sums unrounded as ``preferred_element_type=f32`` does
    (a bf16 ``torch.matmul`` would round them to bf16); products of bf16
    values are exact in float32.  Needs TF32 off on CUDA."""
    _check(wi, wh, bi, bh, xc, h0, steps, dequant)
    wif, whf = wi.float(), wh.float()
    xcb = _bf16(xc)
    h = h0
    for _ in range(steps):
        hb = _bf16(h)
        gi = torch.cat([hb, xcb], dim=-1) @ wif + bi
        gh = hb @ whf + bh
        h = gru_math(gi, gh, h)
    return h


class Plan(NamedTuple):
    """The kernel's launch plan (``csrc/persistent_gru.cu``), the same for
    both weight types."""

    units: int  # hidden units per block, ceil(H / SMs)
    blocks: int
    smem: int  # shared-memory bytes per block: x and the warps' partial sums
    threads: int
    ksteps: int  # k-steps per warp
    scratch: int  # bytes: the published bf16 h (two copies) and the step counter


def plan(H: int, n_sm: int, dequant: bool = False) -> Plan:
    """The kernel's launch plan for a card with ``n_sm`` SMs.  ``dequant``
    changes nothing: int8 weights are widened to bf16 as they are staged."""
    del dequant
    units = -(-H // n_sm)
    return Plan(units=units, blocks=-(-H // units),
                smem=2 * LANES * (2 * H + 8) + 4 * WARPS * RED_ROWS * LANES,
                threads=32 * WARPS, ksteps=KSTEPS, scratch=2 * 2 * LANES * H + 128)


def check_shape(H: int, units: int) -> None:
    """Raises unless the kernel takes hidden size ``H`` at ``units`` units
    a block: its warps hold whole runs of 8 k-steps of at most 1024."""
    if H % 64 or H > MAX_H or units > MAX_UNITS:
        raise ValueError(f"the kernel takes H % 64 == 0, H <= {MAX_H} and at most {MAX_UNITS} "
                         f"units a block; got H = {H}, {units} units")


def block_units(H: int, units: int) -> list[range]:
    """The hidden units each block owns: ``units`` consecutive ones, the
    last block ragged where ``units`` does not divide H."""
    return [range(u0, min(H, u0 + units)) for u0 in range(0, H, units)]


def _row_tiles(w: torch.Tensor, H: int, j: torch.Tensor) -> torch.Tensor:
    """One block's A (32, 3H) over the stacked contraction [h | xc | h]:
    rows 0-7 the r columns of units ``j``, 8-15 the z columns, 16-23 the
    n columns (tiles [r | z] and [n | 0]); rows past ``len(j)`` and rows
    24-31 zero.  ``w`` is [W_ih; W_hh] (3H, 3H)."""
    a = torch.zeros(4 * MAX_UNITS, 3 * H)
    n = len(j)
    for gate in range(3):
        a[gate * MAX_UNITS:gate * MAX_UNITS + n] = w[:, gate * H + j].T
    return a


def persistent_gru_tiled(wi, wh, bi, bh, xc, h0, steps: int, units: int, dequant: bool = False):
    """The kernel's schedule in torch: block b owns the units
    ``block_units(H, units)[b]`` and holds their row tiles (int8 widened
    once); each step every block forms ``A . [bf16(h) | bf16(xc) | bf16(h)]^T``
    as the kernel's warps do: 16 warps over W_ih's 2H and 8 over W_hh's H,
    8 k-steps each, each adding its 16-deep slabs' products (each from
    zero) in k order; then gi's warps' sums in warp order, and gh's; then
    the biases and the GRU as the plain version applies them.  Every unit
    of the next h is written by exactly one block."""
    _check(wi, wh, bi, bh, xc, h0, steps, dequant)
    H = h0.shape[-1]
    check_shape(H, units)
    owned = block_units(H, units)
    w = torch.cat([wi.float(), wh.float()])  # bf16 and int8 values are exact in float32
    a = torch.stack([_row_tiles(w, H, torch.tensor(list(r))) for r in owned])
    ks = 3 * H // 16
    slabs = a.view(len(owned), 4 * MAX_UNITS, ks, 16)
    ih = 2 * H // 16  # W_ih's k-steps, then W_hh's; W_hh's last warp may hold 4
    warps = [range(k0, min(k0 + KSTEPS, end)) for start, end in ((0, ih), (ih, ks))
             for k0 in range(start, end, KSTEPS)]
    xcb = _bf16(xc)
    h = h0
    for _ in range(steps):
        hb = _bf16(h)
        x = torch.cat([hb, xcb, hb], dim=-1).view(LANES, ks, 16)
        prods = torch.einsum("bmsk,lsk->sbml", slabs, x)  # each slab from zero
        total = torch.zeros(2, len(owned), 4 * MAX_UNITS, LANES)  # gi's sums, gh's
        for kr in warps:
            acc = torch.zeros_like(total[0])
            for s in kr:
                acc = acc + prods[s]
            part = 0 if kr[0] < ih else 1
            total[part] = total[part] + acc
        nxt = torch.full_like(h, float("nan"))
        for blk, r in enumerate(owned):
            j = torch.tensor(list(r))
            rows = torch.cat([torch.arange(len(j)) + gate * MAX_UNITS for gate in range(3)])
            cols = torch.cat([j, H + j, 2 * H + j])
            gi = total[0, blk, rows].T + bi[:, cols]
            gh = total[1, blk, rows].T + bh[:, cols]
            nxt[:, j] = gru_math(gi, gh, h[:, j])
        h = nxt
    return h


# ---------------------------------------------------------------------------
# The probe's scans (variants A-C)
# ---------------------------------------------------------------------------


def _dot_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with float32 sums for float32 or bf16 operands (JAX's
    ``preferred_element_type=float32``): on the card a bf16 GEMM with a
    float32 output, on the CPU the same products widened to float32."""
    if a.dtype == torch.float32:
        return a @ b
    if a.device.type == "cuda":
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def scan(wi, wh, bi, bh, xconst, h0, steps: int, dot_dtype=torch.float32):
    """Variants A (``dot_dtype`` float32) and B (bf16): the probe's
    ``scan_fn``, with the weights cast once outside the loop as XLA hoists
    the cast."""
    wid, whd = wi.to(dot_dtype), wh.to(dot_dtype)
    h = h0
    for _ in range(steps):
        x = torch.cat([h, xconst], dim=-1)
        gi = _dot_f32(x.to(dot_dtype), wid) + bi
        gh = _dot_f32(h.to(dot_dtype), whd) + bh
        h = gru_math(gi, gh, h)
    return h


def quantize(w: np.ndarray) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-column symmetric int8: ``q = clip(round(w / s), -127, 127)`` with
    ``s = max|w| / 127`` over each column (the probe's ``quantize``)."""
    s = np.abs(w).max(axis=0, keepdims=True) / 127.0
    q = np.clip(np.round(w / s), -127, 127).astype(np.int8)
    return torch.from_numpy(q), torch.from_numpy(s.astype(np.float32))


def scan_int8(wi_q, wi_s, wh_q, wh_s, bi, bh, xconst, h0, steps: int):
    """Variant C: int8 weights widened to bf16, bf16 products with float32
    sums, then the column scale (the probe's ``scan_int8``)."""
    wib, whb = wi_q.to(torch.bfloat16), wh_q.to(torch.bfloat16)
    h = h0
    for _ in range(steps):
        x = torch.cat([h, xconst], dim=-1)
        gi = _dot_f32(x.to(torch.bfloat16), wib) * wi_s + bi
        gh = _dot_f32(h.to(torch.bfloat16), whb) * wh_s + bh
        h = gru_math(gi, gh, h)
    return h


# ---------------------------------------------------------------------------
# The kernel
# ---------------------------------------------------------------------------


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declares the C interface of a build of ``csrc/persistent_gru.cu``."""
    lib.persistent_gru.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.persistent_gru.restype = ctypes.c_int
    lib.persistent_gru_plan.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.persistent_gru_plan.restype = ctypes.c_int
    return lib


@functools.cache
def _lib():
    return bind(_build.load("persistent_gru"))


def kernel_plan(device: torch.device, H: int, dequant: bool = False) -> Plan:
    """The plan the kernel computes on ``device``'s card (see :func:`plan`)."""
    out = (ctypes.c_int * len(Plan._fields))()
    with torch.cuda.device(device):
        err = _lib().persistent_gru_plan(H, int(dequant), ctypes.addressof(out))
    if err != 0:
        raise RuntimeError(f"persistent_gru_plan failed: CUDA error {err}")
    return Plan(*out)


def launch(lib: ctypes.CDLL, wi, wh, bi, bh, xc, h0, steps: int, dequant: bool,
           scratch: torch.Tensor) -> torch.Tensor:
    """One launch of the build ``lib`` (see :func:`bind`) on checked CUDA
    tensors, with ``scratch`` as its scratch buffer; returns the output."""
    out = torch.empty_like(h0)
    with torch.cuda.device(h0.device):
        err = lib.persistent_gru(
            wi.data_ptr(), wh.data_ptr(), bi.data_ptr(), bh.data_ptr(), xc.data_ptr(),
            h0.data_ptr(), scratch.data_ptr(), out.data_ptr(), h0.shape[-1], steps, int(dequant),
            torch.cuda.current_stream(h0.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"persistent_gru kernel launch failed: CUDA error {err}")
    return out


def persistent_gru(wi, wh, bi, bh, xc, h0, steps: int, dequant: bool = False) -> torch.Tensor:
    """``steps`` GRU steps of the 8 rows of ``h0``.  CUDA tensors launch the
    kernel; CPU tensors take :func:`persistent_gru_plain`; anything else
    raises.  Weights are bf16, or int8 with ``dequant``."""
    if h0.device.type == "cpu":
        return persistent_gru_plain(wi, wh, bi, bh, xc, h0, steps, dequant)
    if h0.device.type != "cuda":
        raise ValueError(f"persistent_gru runs on cuda or cpu, not {h0.device}")
    _check(wi, wh, bi, bh, xc, h0, steps, dequant)
    H = h0.shape[-1]
    for t in (wi, wh, bi, bh, xc, h0):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("persistent_gru needs contiguous, 16-byte aligned tensors")
    kp = kernel_plan(h0.device, H, dequant)
    check_shape(H, kp.units)
    scratch = torch.empty(kp.scratch, dtype=torch.uint8, device=h0.device)
    out = launch(_lib(), wi, wh, bi, bh, xc, h0, steps, dequant, scratch)
    persistent_gru.launches += 1
    return out


persistent_gru.launches = 0
