"""Tensor-core rate against output-tile height, a gridded product, and the
rate of an elementwise pass, on one CUDA card.

Port of ``benchmarks/probe_roofline.py`` with the same shapes and seed:

* a serial chain of 64 products ``(M, 128) @ (128, 1024)`` in bf16 with a
  float32 accumulator, M = 128, 256, 512 (kernel :func:`dot_chain`);
* ``(128, 128) @ (128, 64 * 512)`` over a grid of output tiles (kernel
  :func:`gridded_dot`);
* ``torch.tanh`` over 128 x 8 x 88 576 values in float32 and bf16.

Each kernel is timed two ways: per wrapper call with CUDA events around
back-to-back calls (the host's time per call counts where it exceeds the
kernel's), and on the device alone, with the calls captured in a CUDA graph.

    python -m bvsc_tpu_torch.benchmarks.probe_roofline
"""

from __future__ import annotations

import numpy as np
import torch

from bvsc_tpu_torch.benchmarks import cuda_ms, graph_ms
from bvsc_tpu_torch.device import resolve_device
from bvsc_tpu_torch.ops import dot_probe as DP

SEED = 0
L = 1024
REPS = DP.REPS  # serial chain inside the kernel, to dominate overheads
CHAIN_M = (128, 256, 512)
NG = 64  # grid steps of 512 columns
TILE_N = 512
TANH_SHAPE = (128, 8, 88576)


def chain_flops(M: int, N: int = L) -> int:
    return 2 * M * DP.K * N * REPS


def gridded_flops(N: int = NG * TILE_N) -> int:
    return 2 * 128 * DP.K * N


def make_inputs(device, seed: int = SEED) -> dict:
    """The probe's operands in the JAX probe's draw order (tanh inputs are
    drawn by :func:`run` after these)."""
    rng = np.random.default_rng(seed)

    def bf16(shape):
        return torch.from_numpy(rng.standard_normal(shape)).to(torch.bfloat16).to(device)

    chain = {M: (bf16((M, DP.K)), bf16((DP.K, L))) for M in CHAIN_M}
    return {"chain": chain, "gridded": (bf16((128, DP.K)), bf16((DP.K, NG * TILE_N))), "rng": rng}


def run(device=None) -> dict:
    """Times and rates of every part of the probe, on the card."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("the probe times the card; it does not run on the CPU")
    inputs = make_inputs(dev)
    out = {"dot_chain": {}, "tanh": {}}
    for M, (w, x) in inputs["chain"].items():
        ms = cuda_ms(lambda: DP.dot_chain(w, x), reps=20, warmup=1)
        dev_ms = graph_ms(lambda: DP.dot_chain(w, x), reps=20)
        out["dot_chain"][M] = {"ms": ms, "graph_ms": dev_ms, "tflops": chain_flops(M) / ms / 1e9,
                               "graph_tflops": chain_flops(M) / dev_ms / 1e9}
    w, x = inputs["gridded"]
    ms = cuda_ms(lambda: DP.gridded_dot(w, x), reps=20, warmup=1)
    dev_ms = graph_ms(lambda: DP.gridded_dot(w, x), reps=20)
    out["gridded_dot"] = {"ms": ms, "graph_ms": dev_ms, "tflops": gridded_flops() / ms / 1e9,
                          "graph_tflops": gridded_flops() / dev_ms / 1e9}
    for dt in (torch.float32, torch.bfloat16):
        t = torch.from_numpy(inputs["rng"].standard_normal(TANH_SHAPE)).to(dt).to(dev)
        ms = cuda_ms(lambda: torch.tanh(t), reps=10, warmup=1)
        out["tanh"][str(dt).removeprefix("torch.")] = {
            "ms": ms, "gbps": 2 * t.numel() * t.element_size() / ms / 1e6}
        del t
    return out


def main() -> None:
    print("device:", torch.cuda.get_device_name(0) if torch.cuda.is_available() else "none",
          flush=True)
    r = run()
    for M, v in r["dot_chain"].items():
        print(f"M={M}: {v['ms'] * 1e3:8.1f} us -> {v['tflops']:6.1f} TFLOP/s "
              f"(device {v['graph_ms'] * 1e3:8.1f} us -> {v['graph_tflops']:6.1f} TFLOP/s)",
              flush=True)
    v = r["gridded_dot"]
    print(f"gridded 128x128x{TILE_N}x{NG}: {v['ms'] * 1e3:8.1f} us -> {v['tflops']:6.1f} TFLOP/s "
          f"(device {v['graph_ms'] * 1e3:8.1f} us -> {v['graph_tflops']:6.1f} TFLOP/s)", flush=True)
    for name, v in r["tanh"].items():
        print(f"tanh {name}: {v['ms']:6.2f} ms -> {v['gbps']:6.0f} GB/s", flush=True)


if __name__ == "__main__":
    main()
