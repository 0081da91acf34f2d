"""Ports of the JAX package's benchmark probes, run on one CUDA card:

    python -m bvsc_tpu_torch.benchmarks.probe_persistent_gru
    python -m bvsc_tpu_torch.benchmarks.probe_roofline

Each module has a ``main()`` that prints the probe's lines and a ``run()``
that returns its numbers.  Times come from CUDA events (:func:`cuda_ms`);
a probe without a card raises.
"""

from __future__ import annotations

import torch


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds of ``fn`` on the card, by CUDA events around
    ``reps`` back-to-back calls after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int = 20) -> float:
    """Mean device milliseconds of ``fn``: ``reps`` calls captured in one
    CUDA graph and replayed, so the host's time per call does not count."""
    fn()  # warm-up outside the capture: builds, loads, cuBLAS handles
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return cuda_ms(graph.replay, reps=5, warmup=1) / reps
