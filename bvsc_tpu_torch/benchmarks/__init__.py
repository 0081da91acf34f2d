"""Ports of the JAX package's benchmark probes, run on one CUDA card:

    python -m bvsc_tpu_torch.benchmarks.probe_persistent_gru
    python -m bvsc_tpu_torch.benchmarks.probe_roofline

Each module has a ``main()`` that prints the probe's lines and a ``run()``
that returns its numbers.  Times come from CUDA events (:func:`cuda_ms`,
:func:`graph_ms`, :func:`cold_ms`); a probe without a card raises.
``k1_tiles`` and ``dot_sizes`` time single kernels over several shapes.
"""

from __future__ import annotations

import numpy as np
import torch

from bvsc_tpu_torch.models import vocoder as voc_mod


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


def cold_ms(fn, reps: int = 30, flush_bytes: int = 128 << 20) -> float:
    """Median device milliseconds of one call of ``fn`` with the L2 cold:
    before each call, a write of ``flush_bytes`` (more than the H100's
    50 MB of L2) evicts its inputs.  CUDA events time the call alone; a
    spin of ~0.1 ms on the device after the write keeps the device busy
    while the host enqueues the call, so the host's launch time does not
    count."""
    flush = torch.empty(flush_bytes // 4, device=torch.cuda.current_device())
    fn()  # warm-up: builds, loads, library handles
    pairs = []
    for _ in range(reps):
        flush.fill_(1.0)
        torch.cuda._sleep(200_000)  # clock cycles; touches no memory
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    times = sorted(start.elapsed_time(end) for start, end in pairs)
    return times[len(times) // 2]


def seeded_vocoder(vcfg, seed: int = 0) -> dict:
    """A random full-width vocoder from ``seed``, with per-channel snake
    parameters drawn too (the init sets them all to 0), so that the
    kernels' channel indexing is exercised."""
    params = voc_mod.init_generator_params(seed, vcfg)
    rng = np.random.default_rng(seed + 1)
    for act in [a for block in params["resblocks"] for a in block["acts"]] + [params["act_post"]]:
        for key in ("alpha", "beta"):
            act[key] = (0.3 * rng.standard_normal(act[key].shape)).astype(np.float32)
    return params
