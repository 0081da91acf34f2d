"""The gridded product (kernel K4, :func:`gridded_dot`) against ``torch.mm``
over several sizes, with the L2 warm and cold, on one CUDA card.

For each (M, N) of :data:`SHAPES` it checks K4 against its plain version
(``GRIDDED_TOL``) and prints one JSON line: the build's plan, and for K4 and
for ``torch.mm`` (bf16 in, float32 out) the device time warm (``graph_ms``:
back-to-back calls replayed from a CUDA graph, so x and the output may stay
in L2) and cold (``cold_ms``: the L2 flushed before each call), each with
its GB/s, beside the byte bound (w and x read once, the float32 output
written once, at 3.35 TB/s); and the time per call from the host
(``call_ms``: back-to-back calls, where the host's work per call counts if
it exceeds the device's).

    python -m bvsc_tpu_torch.benchmarks.dot_sizes
"""

from __future__ import annotations

import json
import subprocess

import torch

from bvsc_tpu_torch.benchmarks import cold_ms, cuda_ms, graph_ms
from bvsc_tpu_torch.ops import dot_probe as DP

SEED = 0
GRIDDED_TOL = 1e-4  # one product, K = 128 in float32
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
# M = 128 at a partial wave, the probe's shape and many waves; M = 256.
SHAPES = ((128, 4096), (128, 32768), (128, 131072), (256, 32768))


def operands(M: int, N: int, seed: int = SEED) -> tuple[torch.Tensor, torch.Tensor]:
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return (torch.randn(M, DP.K, device="cuda", generator=gen).to(torch.bfloat16),
            torch.randn(DP.K, N, device="cuda", generator=gen).to(torch.bfloat16))


def byte_bound_ms(M: int, N: int) -> tuple[int, float]:
    nbytes = 2 * M * DP.K + 2 * DP.K * N + 4 * M * N
    return nbytes, nbytes / PEAK_BYTES * 1e3


def timings(M: int, N: int) -> dict:
    """K4 against plain and ``torch.mm``, warm and cold."""
    w, x = operands(M, N)
    err = (DP.gridded_dot(w, x) - DP.gridded_dot_plain(w, x)).abs().max().item()
    if not err <= GRIDDED_TOL:
        raise AssertionError(f"gridded_dot ({M}, {N}): kernel vs plain {err} > {GRIDDED_TOL}")
    library = lambda: torch.mm(w, x, out_dtype=torch.float32)  # noqa: E731
    nbytes, bound = byte_bound_ms(M, N)
    out = {"shape": [M, DP.K, N], "max_abs_err": err, "bytes": nbytes, "bound_ms": bound}
    for name, fn in (("k4", lambda: DP.gridded_dot(w, x)), ("mm", library)):
        warm, cold = graph_ms(fn), cold_ms(fn)
        out[name] = {"warm_ms": warm, "cold_ms": cold, "call_ms": cuda_ms(fn),
                     "warm_gbps": nbytes / warm / 1e6, "cold_gbps": nbytes / cold / 1e6}
    out["k4_of_bound"] = {"warm": bound / out["k4"]["warm_ms"], "cold": bound / out["k4"]["cold_ms"]}
    out["k4_over_mm"] = {"warm": out["k4"]["warm_ms"] / out["mm"]["warm_ms"],
                         "cold": out["k4"]["cold_ms"] / out["mm"]["cold_ms"]}
    return out


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("dot_sizes times the card; no CUDA device is available")
    print(card(), flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0)}), flush=True)
    for M, N in SHAPES:
        print(json.dumps({"plan": DP.gridded_plan(M, N), **timings(M, N)}), flush=True)


if __name__ == "__main__":
    main()
