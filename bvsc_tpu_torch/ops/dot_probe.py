"""The matrix-unit probes: CUDA kernels on the tensor cores and their plain
versions.

Replace the Pallas TPU kernels of ``benchmarks/probe_roofline.py``:

* :func:`dot_chain` (``mk_kernel(M)``'s kernel ``k``): ``reps`` products
  ``w @ x`` summed into one float32 accumulator as a serial chain,
  w (M, 128) and x (128, N) bf16.
* :func:`gridded_dot` (``k2``): ``w @ x`` in float32, cut into output tiles
  over a grid.

For CUDA tensors each wrapper launches ``csrc/dot_probe.cu`` (``wgmma`` for
the chain, ``mma.sync`` for the gridded product, no library GEMM) or raises;
only CPU tensors take the plain version.  The ``utils.tracing`` counters
``dot_chain.launches`` and ``gridded_dot.launches`` count each wrapper's
launches.  The chain kernel gives each warpgroup a 64-row output tile
and keeps several of its products in flight; the gridded kernel is a
persistent grid that streams x through a ring of shared-memory stages.  Each
build reports its launch (:func:`dot_chain_plan`, :func:`gridded_plan`;
:func:`chain_plan` is the chain's rule in Python), and
:func:`dot_chain_tiled` and :func:`gridded_dot_tiled` walk the same
schedules on the CPU.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from bvsc_tpu_torch.ops import _build
from bvsc_tpu_torch.utils import tracing

K = 128  # contraction depth of both probes
REPS = 64  # products in the probe's chain
CHAIN_TILE_M = 64  # the chain's output tile rows: one warpgroup's wgmma
CHAIN_TILE_NS = (8, 16, 32, 64)  # the chain's output tile columns, one build each
CHAIN_IN_FLIGHT = 4  # the chain's products in flight a warpgroup
CHAIN_PASS = 16  # the chain's products a pass of its loop
CHAIN_WARPS = 4  # one warpgroup a block


def dot_chain_plain(w: torch.Tensor, x: torch.Tensor, reps: int = REPS) -> torch.Tensor:
    """``reps`` times ``acc = acc + w @ x`` in float32 (TF32 off on CUDA)."""
    wf, xf = w.float(), x.float()
    acc = torch.zeros(w.shape[0], x.shape[1], device=w.device)
    for _ in range(reps):
        acc = acc + wf @ xf
    return acc


def chain_plan(M: int, N: int, sms: int) -> dict:
    """The chain kernel's launch for (M, N) on a card of ``sms`` SMs, as its
    build computes it (``dot_chain_plan`` gives the build's own): 64-row
    tiles, and of the tile widths the one with the least
    ``ceil(grid / sms) * tile_n`` (a block's time grows with its width, a
    launch takes that many waves), the widest of equals.  Raises for what
    the kernel refuses."""
    if M <= 0 or N <= 0 or N % 8:
        raise ValueError(f"the chain kernel needs M > 0 and N > 0 with N % 8 == 0, got {M}, {N}")
    tiles_m = -(-M // CHAIN_TILE_M)
    best = None
    for tn in CHAIN_TILE_NS:
        grid = tiles_m * -(-N // tn)
        cost = -(-grid // sms) * tn
        if best is None or cost <= best[0]:
            best = cost, tn, grid
    _, tn, grid = best
    return {"tile_m": CHAIN_TILE_M, "tile_n": tn, "warps": CHAIN_WARPS,
            "in_flight": CHAIN_IN_FLIGHT, "smem_bytes": tn * K * 2, "sms": sms, "grid": grid}


def dot_chain_tiled(w: torch.Tensor, x: torch.Tensor, plan: dict, reps: int = REPS,
                    writes: torch.Tensor | None = None) -> torch.Tensor:
    """``reps * (w @ x)`` by the chain kernel's schedule, on the CPU (for the
    tests).

    ``plan`` gives ``tile_m``, ``tile_n``, ``in_flight`` (P) and ``grid``.
    Block b owns output tile (b // tiles_n, b % tiles_n), with rows of w
    past M and columns of x past N as zeros.  Its products go in passes of
    ``CHAIN_PASS``, each through P slots: a pass starts products 0 .. P - 1,
    each from zero in its own slot; then, in rep order, it takes the oldest,
    adds it into one float32 accumulator, and starts the product P ahead in
    the freed slot, until the pass's last product is added.  The products
    that fill no pass go one at a time.  Only the tile's part inside (M, N)
    is written.  The output starts as NaN; ``writes``, an (M, N) integer
    tensor, counts every element written."""
    M, N = w.shape[0], x.shape[1]
    TM, TN, P = plan["tile_m"], plan["tile_n"], plan["in_flight"]
    tiles_n = -(-N // TN)
    out = torch.full((M, N), float("nan"))
    for b in range(plan["grid"]):
        m, n = divmod(b, tiles_n)
        rows, cols = min(TM, M - m * TM), min(TN, N - n * TN)
        slab = torch.zeros(TM, K)
        slab[:rows] = w[m * TM:m * TM + rows].float()
        xs = torch.zeros(K, TN)
        xs[:, :cols] = x[:, n * TN:n * TN + cols].float()
        acc = torch.zeros(TM, TN)
        passes = reps // CHAIN_PASS
        for _ in range(passes):
            slots = [slab @ xs for _ in range(P)]
            for q in range(P, CHAIN_PASS):
                acc = acc + slots[q % P]
                slots[q % P] = slab @ xs
            for q in range(P):
                acc = acc + slots[q]
        for _ in range(passes * CHAIN_PASS, reps):
            acc = acc + slab @ xs
        out[m * TM:m * TM + rows, n * TN:n * TN + cols] = acc[:rows, :cols]
        if writes is not None:
            writes[m * TM:m * TM + rows, n * TN:n * TN + cols] += 1
    return out


def gridded_dot_plain(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``w @ x`` in float32 (TF32 off on CUDA)."""
    return w.float() @ x.float()


def gridded_dot_tiled(w: torch.Tensor, x: torch.Tensor, plan: dict,
                      writes: torch.Tensor | None = None) -> torch.Tensor:
    """``w @ x`` by the gridded kernel's schedule, on the CPU (for the tests).

    ``plan`` gives ``tile_m``, ``tile_n`` and ``grid`` (G).  Block b takes
    output tiles b, b + G, ... of tile_m x tile_n, m-tile major; on its
    first tile of an m-tile it stages that slab of w, rows past M as zeros,
    and each x tile has its columns past N as zeros; each tile is one
    float32 product, and only its part inside (M, N) is written.  The output starts as NaN;
    ``writes``, an (M, N) integer tensor, counts every element written."""
    M, N = w.shape[0], x.shape[1]
    TM, TN, G = plan["tile_m"], plan["tile_n"], plan["grid"]
    tiles_n = -(-N // TN)
    tiles = -(-M // TM) * tiles_n
    out = torch.full((M, N), float("nan"))
    for b in range(G):
        cur_m, slab = -1, None
        for t in range(b, tiles, G):
            m, n = divmod(t, tiles_n)
            if m != cur_m:
                slab = torch.zeros(TM, K)
                slab[:min(TM, M - m * TM)] = w[m * TM:(m + 1) * TM].float()
                cur_m = m
            xs = torch.zeros(K, TN)
            cols = min(TN, N - n * TN)
            xs[:, :cols] = x[:, n * TN:n * TN + cols].float()
            acc = slab @ xs
            rows = min(TM, M - m * TM)
            out[m * TM:m * TM + rows, n * TN:n * TN + cols] = acc[:rows, :cols]
            if writes is not None:
                writes[m * TM:m * TM + rows, n * TN:n * TN + cols] += 1
    return out


def _check(w: torch.Tensor, x: torch.Tensor) -> None:
    if w.dtype != torch.bfloat16 or x.dtype != torch.bfloat16 or w.dim() != 2 or x.dim() != 2:
        raise ValueError(f"expected 2-D bf16 w and x, got {w.dtype} {tuple(w.shape)} "
                         f"and {x.dtype} {tuple(x.shape)}")
    if w.shape[1] != K or x.shape[0] != K:
        raise ValueError(f"the kernels contract over {K}: got w {tuple(w.shape)}, x {tuple(x.shape)}")
    if w.shape[0] == 0 or x.shape[1] == 0 or x.shape[1] % 8:
        raise ValueError(f"need M > 0 and N > 0 with N % 8 == 0, got {w.shape[0]}, {x.shape[1]}")
    if x.device != w.device:
        raise ValueError(f"w is on {w.device}, x on {x.device}")
    for t in (w, x):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("the kernels need contiguous, 16-byte aligned tensors")


CHAIN_PLAN_KEYS = ("tile_m", "tile_n", "warps", "in_flight", "smem_bytes", "sms", "grid")


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Sets the C signatures of a build of ``csrc/dot_probe.cu`` (or a
    source with its interface); ``dot_chain_plan`` only where it has one
    (older builds of the source have none)."""
    lib.dot_chain_bf16.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.gridded_dot_bf16.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    plans = [lib.gridded_dot_plan]
    if hasattr(lib, "dot_chain_plan"):
        plans.append(lib.dot_chain_plan)
    for fn in [lib.dot_chain_bf16, lib.gridded_dot_bf16, *plans]:
        fn.restype = ctypes.c_int
    for fn in plans:
        fn.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p]
    return lib


@functools.cache
def _lib():
    return bind(_build.load("dot_probe"))


def plan_of(lib: ctypes.CDLL, M: int, N: int) -> dict:
    """The chain kernel's launch for (M, N) as the build ``lib`` reports it
    (keys as :func:`chain_plan`'s)."""
    out = (ctypes.c_int * len(CHAIN_PLAN_KEYS))()
    err = lib.dot_chain_plan(M, N, ctypes.addressof(out))
    if err != 0:
        raise ValueError(f"the chain kernel does not take M={M}, N={N} (CUDA error {err})")
    return dict(zip(CHAIN_PLAN_KEYS, out))


def dot_chain_plan(M: int, N: int) -> dict:
    """The chain kernel's launch for (M, N) on the current CUDA device, as
    its build reports it: ``tile_m`` and ``tile_n`` (output tile rows and
    columns), ``warps``, ``in_flight`` (products in flight a warpgroup),
    ``smem_bytes``, ``sms`` and ``grid``.  Builds the kernel if needed;
    needs a card."""
    return plan_of(_lib(), M, N)


def gridded_plan(M: int, N: int) -> dict:
    """The gridded kernel's launch for (M, N) on the current CUDA device, as
    its build reports it: ``tile_m`` and ``tile_n`` (output tile rows and
    columns), ``stages`` (x stages in the ring), ``out_buffers`` (output
    staging buffers), ``threads``, ``smem_bytes``, ``blocks_per_sm`` (CUDA's
    occupancy calculator), ``sms`` and ``grid``.  Builds the kernel if
    needed; needs a card."""
    keys = ("tile_m", "tile_n", "stages", "out_buffers", "threads", "smem_bytes",
            "blocks_per_sm", "sms", "grid")
    out = (ctypes.c_int * len(keys))()
    err = _lib().gridded_dot_plan(M, N, ctypes.addressof(out))
    if err != 0:
        raise ValueError(f"the gridded kernel does not take M={M}, N={N} (CUDA error {err})")
    return dict(zip(keys, out))


def _device(w: torch.Tensor, name: str) -> bool:
    """True for CUDA, False for the CPU; raises for anything else."""
    if w.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{name} runs on cuda or cpu, not {w.device}")
    return w.device.type == "cuda"


def launch(fn, w: torch.Tensor, x: torch.Tensor, *ints) -> torch.Tensor:
    out = torch.empty(w.shape[0], x.shape[1], device=w.device)
    with torch.cuda.device(w.device):
        err = fn(w.data_ptr(), x.data_ptr(), out.data_ptr(), w.shape[0], x.shape[1], *ints,
                 torch.cuda.current_stream(w.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn.__name__} launch failed: CUDA error {err}")
    return out


def dot_chain(w: torch.Tensor, x: torch.Tensor, reps: int = REPS) -> torch.Tensor:
    """``reps * (w @ x)`` summed as one chain into a float32 accumulator."""
    if not _device(w, "dot_chain"):
        return dot_chain_plain(w, x, reps)
    _check(w, x)
    if reps < 1:
        raise ValueError(f"reps must be >= 1, got {reps}")
    out = launch(_lib().dot_chain_bf16, w, x, reps)
    tracing.count("dot_chain.launches")
    return out


def gridded_dot(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``w @ x`` in float32 over a grid of output tiles."""
    if not _device(w, "gridded_dot"):
        return gridded_dot_plain(w, x)
    _check(w, x)
    out = launch(_lib().gridded_dot_bf16, w, x)
    tracing.count("gridded_dot.launches")
    return out
