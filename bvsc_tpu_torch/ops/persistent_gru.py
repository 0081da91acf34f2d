"""A persistent GRU recurrence: CUDA kernel, plain and partitioned versions,
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
* :func:`persistent_gru_partitioned` splits the hidden units over blocks as
  the kernel does (:func:`plan`), so the CPU tests prove its column gather.
* :func:`scan`, :func:`quantize` and :func:`scan_int8` are the probe's
  variants A-C (``scan_fn``, ``quantize``, ``scan_int8``): plain PyTorch
  products, as the JAX probe leaves them to XLA.

``dequant=True`` takes int8 weights and widens them with no scale, as the
Pallas kernel does: the JAX probe's variant E leaves the scale out.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from bvsc_tpu_torch.ops import _build

LANES = 8  # rows of h the kernel runs (the probe's LANES)
SMEM_LIMIT = 232_448  # bytes of shared memory one block may use on Hopper
MAX_UNITS = 12  # hidden units per block: at most 384 threads


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


def plan(H: int, n_sm: int, dequant: bool = False) -> tuple[int, int, int]:
    """The kernel's launch plan for a card with ``n_sm`` SMs: units per
    block (ceil(H / n_sm)), blocks, and shared-memory bytes per block (3U
    weight columns of W_ih and W_hh, and the bf16 x)."""
    units = -(-H // n_sm)
    blocks = -(-H // units)
    smem = (1 if dequant else 2) * 3 * units * 3 * H + 2 * LANES * 2 * H
    return units, blocks, smem


def persistent_gru_partitioned(wi, wh, bi, bh, xc, h0, steps: int, units: int,
                               dequant: bool = False):
    """The kernel's partition in torch: block b owns hidden units
    [b U, (b + 1) U) and gathers their 3U gate columns [r | z | n] out of the
    packed 3H, computes its gate sums from the whole of x and writes its
    units of the next h."""
    _check(wi, wh, bi, bh, xc, h0, steps, dequant)
    H = h0.shape[-1]
    wif, whf = wi.float(), wh.float()
    xcb = _bf16(xc)
    h = h0
    for _ in range(steps):
        hb = _bf16(h)
        x = torch.cat([hb, xcb], dim=-1)
        nxt = torch.empty_like(h)
        for u0 in range(0, H, units):
            j = torch.arange(u0, min(H, u0 + units), device=h.device)
            cols = torch.cat([j, H + j, 2 * H + j])
            gi = x @ wif[:, cols] + bi[:, cols]
            gh = hb @ whf[:, cols] + bh[:, cols]
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


@functools.cache
def _lib():
    lib = _build.load("persistent_gru")
    lib.persistent_gru.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.persistent_gru.restype = ctypes.c_int
    lib.persistent_gru_plan.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.persistent_gru_plan.restype = ctypes.c_int
    return lib


def kernel_plan(device: torch.device, H: int, dequant: bool = False) -> tuple[int, int, int]:
    """The plan the kernel computes on ``device``'s card (see :func:`plan`)."""
    out = (ctypes.c_int * 3)()
    with torch.cuda.device(device):
        err = _lib().persistent_gru_plan(H, int(dequant), ctypes.addressof(out))
    if err != 0:
        raise RuntimeError(f"persistent_gru_plan failed: CUDA error {err}")
    return tuple(out)


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
    if H % 16:
        raise ValueError(f"the kernel needs H % 16 == 0, got H = {H}")
    for t in (wi, wh, bi, bh, xc, h0):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("persistent_gru needs contiguous, 16-byte aligned tensors")
    units, _, smem = kernel_plan(h0.device, H, dequant)
    if units > MAX_UNITS or smem > SMEM_LIMIT:
        raise ValueError(f"H = {H} needs {units} units and {smem} B of shared memory per "
                         f"block; the kernel takes at most {MAX_UNITS} and {SMEM_LIMIT}")
    hbuf = torch.empty(2, LANES, H, device=h0.device)
    out = torch.empty_like(h0)
    with torch.cuda.device(h0.device):
        err = _lib().persistent_gru(
            wi.data_ptr(), wh.data_ptr(), bi.data_ptr(), bh.data_ptr(), xc.data_ptr(),
            h0.data_ptr(), hbuf.data_ptr(), out.data_ptr(), H, steps, int(dequant),
            torch.cuda.current_stream(h0.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"persistent_gru kernel launch failed: CUDA error {err}")
    persistent_gru.launches += 1
    return out


persistent_gru.launches = 0
