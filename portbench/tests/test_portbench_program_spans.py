"""The per-layer metrics that read the program's own spans and counters
(``portbench/lib/spans.py``) after a small traced run of a serve, a decode
and an offline cell on the CPU: a finite positive number in their family,
None in the other, and the copies a tick the engine's inputs and starts
give.  ``pytest portbench/tests``."""

from __future__ import annotations

import math

import pytest
import torch

from portbench import run as bench

CELLS = {"serve": "varbit-f32.serve128", "decode": "varbit-f32.decode128-loss10",
         "offline": "varbit-f32.offline-b256"}
NEW = {"tick_gather_ms.stream": "stream", "tick_copy_ms.stream": "stream",
       "tick_issue_ms.stream": "stream", "tick_wait_ms.stream": "stream",
       "tick_h2d_copies.stream": "stream", "scan_issue_ms.offline": "offline"}


def _small(cell: str) -> dict:
    spec = bench.cell_spec(cell)
    spec["conf"]["codec"].update(h_dim=48, z_dim=12)
    t = spec["traffic"]
    if t["kind"] == "offline":
        t.update(batch=3, clip_s=0.5, shift_s=0.05, check_rows=2)
    else:
        t.update(slots=4, call_s=[0.2, 0.4], warm_ticks=3, warm_s=0.1, check_share=0.5,
                 split_ticks=3, profile_ticks=2)
        if t["kind"] == "serve":
            t["bank_rows"] = 2
    return spec


@pytest.fixture(scope="module")
def runs():
    """Each cell's record, the metrics read right after its run, and the
    registry's snapshot."""
    from bvsc_tpu_torch.utils import tracing

    out = {}
    for kind, cell in CELLS.items():
        tracing.reset()
        rec = bench.run_cell(_small(cell), 2**31 + 29, 0.3, True, torch.device("cpu"))
        read = {m: bench.reader(m)(rec) for m in NEW}
        out[kind] = (rec, read, tracing.snapshot())
    tracing.reset()
    return out


@pytest.mark.parametrize("kind", list(CELLS))
@pytest.mark.parametrize("metric", list(NEW))
def test_portbench_program_span_reader(runs, metric, kind):
    rec, read, _ = runs[kind]
    value = read[metric]
    if rec["family"] == NEW[metric]:
        assert value is not None and math.isfinite(value) and value > 0, (metric, value)
    else:
        assert value is None, (metric, value)


@pytest.mark.parametrize("kind,arrays", [("serve", 3), ("decode", 4)])
def test_portbench_h2d_copies_a_tick(runs, kind, arrays):
    """Serve copies its 3 input arrays a tick and a window a start; decode
    its 4 arrays a tick (one block of slots)."""
    _, read, snap = runs[kind]
    counters = snap["counters"]
    ticks = snap["spans"][f"{kind}.tick"]["count"]
    assert ticks > 0
    want = arrays + counters.get(f"{kind}.starts", 0) / ticks
    assert read["tick_h2d_copies.stream"] == pytest.approx(want, rel=1e-12)
    if kind == "serve":
        assert counters["serve.starts"] > 0
