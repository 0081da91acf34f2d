"""K3, the dot chain (``csrc/dot_probe.cu``), over the number of products,
on one card.

For each build named on the command line (``repo``, the default, is the
package's own build; any other argument is a CUDA source file with the same
C interface, such as an older commit's ``dot_probe.cu`` or a variant of it)
and each M of the probe (128, 256, 512; N = 1024, the probe's seeded
operands from ``probe_roofline.make_inputs``), it launches K3 with 1, 16 and
64 products and times each on the device alone, from a replayed CUDA graph
(``graph_ms``).  The slope from 16 to 64 products is one product's time
(``us_per_product``), printed beside its bound (one product's operations at
the bf16 peak); the intercept is the rest: the operand loads, the launch and
the tail.  ``share_of_bound`` is the operations bound of the whole launch of
64 products over its time.  Each launch's error against ``dot_chain_plain``
is relative to max |out|; the package's build is held to the smoke's
``CHAIN_RTOL``, another build only reports its error (a variant may leave
work out on purpose).  ``max_diff_first`` is each output's largest
difference from the first build's on the same launch (0: bit-equal).  A
build's plan is printed where its source has ``dot_chain_plan``.  Builds
run in the order given, so ``old.cu repo repo old.cu`` compares two
versions in turns on one card.  Then, per source, the
registers and spill bytes of each kernel as ``nvcc -Xptxas -v`` reports
them, and once the library yardstick: ``torch.mm`` over the stacked
contraction (w repeated 64 times along K against x repeated 64 times, bf16
in, float32 out), warm, with its error against the plain version.

    python -m bvsc_tpu_torch.benchmarks.chain_steps [repo | FILE.cu] ...
"""

from __future__ import annotations

import ctypes
import json
import os
import sys

import torch

from bvsc_tpu_torch.benchmarks import graph_ms
from bvsc_tpu_torch.benchmarks import probe_roofline as probe
from bvsc_tpu_torch.benchmarks.gru_steps import PEAK_BF16_FLOPS, card, ptxas
from bvsc_tpu_torch.device import set_parity_mode
from bvsc_tpu_torch.ops import _build
from bvsc_tpu_torch.ops import dot_probe as DP

PRODUCTS = (1, 16, 64)
CHAIN_RTOL = 1e-5  # as chip_smoke.CHAIN_RTOL: of max |out|


def product_bound_us(M: int, N: int = probe.L) -> float:
    """One product's operations, 2 M 128 N, at the bf16 peak, in µs."""
    return 2 * M * DP.K * N / PEAK_BF16_FLOPS * 1e6


def per_product(ms: dict) -> dict:
    """The slope from 16 to 64 products (µs a product) and the intercept
    (µs) of the times ``ms`` by products."""
    slope = (ms[64] - ms[16]) / (64 - 16)
    return {"us_per_product": slope * 1e3, "intercept_us": (ms[16] - 16 * slope) * 1e3}


def library(w: torch.Tensor, x: torch.Tensor, reps: int = DP.REPS):
    """``torch.mm`` over the stacked contraction: one call computes
    ``sum over reps of w @ x`` with K = 128 reps; the stacked operands are
    made once, here, outside the call."""
    ws, xs = w.repeat(1, reps), x.repeat(reps, 1)
    return lambda: torch.mm(ws, xs, out_dtype=torch.float32)


def runner(build: str):
    """``run(w, x, reps)`` and ``plan(M, N)`` (None where the source has no
    ``dot_chain_plan``) for one build."""
    if build == "repo":
        return DP.dot_chain, DP.dot_chain_plan
    lib = DP.bind(ctypes.CDLL(_build.library_for(build)))
    plan = (lambda M, N: DP.plan_of(lib, M, N)) if hasattr(lib, "dot_chain_plan") else None
    return (lambda w, x, reps: DP.launch(lib.dot_chain_bf16, w, x, reps)), plan


def measure(build: str, chain: dict, first: dict) -> list[dict]:
    """One build's lines; ``first`` keeps the first build's outputs by
    (M, reps)."""
    run, plan = runner(build)
    lines = []
    for M, (w, x) in chain.items():
        N = x.shape[1]
        errs, diffs = {}, {}
        for reps in PRODUCTS:
            ref = DP.dot_chain_plain(w, x, reps)
            out = run(w, x, reps)
            errs[reps] = (out - ref).abs().max().item() / ref.abs().max().item()
            diffs[reps] = (out - first.setdefault((M, reps), out)).abs().max().item()
            if build == "repo" and not errs[reps] <= CHAIN_RTOL:
                raise AssertionError(f"dot_chain M={M} reps={reps}: kernel vs plain {errs[reps]} "
                                     f"> {CHAIN_RTOL} of max |out|")
        ms = {reps: graph_ms(lambda: run(w, x, reps)) for reps in PRODUCTS}
        bound_us = DP.REPS * product_bound_us(M, N)
        lines.append({"build": build, "M": M, "N": N, "graph_ms": ms, **per_product(ms),
                      "bound_us_per_product": product_bound_us(M, N), "bound_us": bound_us,
                      "share_of_bound": bound_us / (ms[DP.REPS] * 1e3), "rel_err": errs,
                      "max_diff_first": diffs,
                      "plan": plan(M, N) if plan else None})
    return lines


def yardstick(chain: dict) -> list[dict]:
    lines = []
    for M, (w, x) in chain.items():
        call = library(w, x)
        ref = DP.dot_chain_plain(w, x)
        lines.append({"library": "torch.mm stacked K", "M": M, "graph_ms": graph_ms(call),
                      "rel_err": (call() - ref).abs().max().item() / ref.abs().max().item()})
    return lines


def main(argv=None) -> None:
    builds = (sys.argv[1:] if argv is None else argv) or ["repo"]
    if not torch.cuda.is_available():
        raise SystemExit("chain_steps times the card; no CUDA device is available")
    dev = torch.device("cuda")
    print(card(), flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0), "builds": builds}), flush=True)
    set_parity_mode()
    sources = {b: os.path.join(_build.CSRC, "dot_probe.cu") if b == "repo" else b
               for b in builds}
    _build.compile_files(list(dict.fromkeys(sources.values())))
    chain = probe.make_inputs(dev)["chain"]
    first = {}
    for build in builds:
        for line in measure(build, chain, first):
            print(json.dumps(line), flush=True)
    for build, src in sources.items():
        print(json.dumps({"build": build, "ptxas": ptxas(src)}), flush=True)
    for line in yardstick(chain):
        print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
