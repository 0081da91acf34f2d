"""The benchmark's harness on the CPU: files found by name, names and units,
seeded traffic, the timing arithmetic, the refusal to run without a card,
and the imports it may not make.  ``pytest portbench/tests``."""

from __future__ import annotations

import importlib
import json
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from portbench import counts, run as bench
from portbench.lib import stats, trace
from portbench.lib.weights import make_weights

ROOT = bench.ROOT
BENCH = bench.bench_file()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


@pytest.mark.parametrize("cell", CELLS)
def test_portbench_cell_files_found_by_name(cell):
    spec = bench.cell_spec(cell)
    assert spec["conf"]["name"] == spec["cell"]["config"]
    kind = importlib.import_module(f"portbench.kinds.{spec['traffic']['kind']}")
    assert callable(kind.run) and callable(kind.control)
    assert spec["limits"]["limits"], "a cell compares at least one number"
    names = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in names and len(names) >= 2
    assert spec["per_layer"]


@pytest.mark.parametrize("metric", [m["name"] for m in METRICS])
def test_portbench_metric_reader_found_by_name(metric):
    assert callable(bench.reader(metric))


def test_portbench_names_and_units():
    names = [m["name"] for m in METRICS] + CELLS + [c["name"] for c in BENCH["configs"]]
    names += [w["config"] for w in BENCH["workloads"]] + [w["traffic"] for w in BENCH["workloads"]]
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    assert len({m["name"] for m in METRICS}) == len(METRICS)
    assert all(UNIT.match(m["unit"]) for m in METRICS)
    assert all(m["better"] in ("lower", "higher") for m in METRICS)
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert all("\n" not in lay and len(lay) <= 200 for lay in layers)
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert all(m["moves"] in e2e for m in BENCH["per_layer"])


def test_portbench_every_configuration_is_used_and_unreduced():
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert c["name"] in used
        conf = bench.load(os.path.join(ROOT, c["file"]))
        assert conf["reduced"] == c["reduced"] == []
        assert conf["source"] == c["source"]


def _run(cell, seed, **traffic):
    spec = bench.cell_spec(cell)
    spec["conf"]["codec"].update(h_dim=48, z_dim=12)
    spec["traffic"].update(traffic)
    return bench.Run(spec, seed, 1.0, False, torch.device("cpu"), 0.0)


def test_portbench_offline_traffic_same_for_same_seed():
    from portbench.kinds.offline import Calls

    def call(seed, i):
        run = _run("varbit-f32.offline-b256", seed, batch=3, clip_s=0.2, shift_s=0.05)
        return Calls(run, run.conf, run.traffic)(i)

    (x1, b1), (x2, b2), (x3, b3) = call(2**31 + 7, 1), call(2**31 + 7, 1), call(2**31 + 8, 1)
    assert torch.equal(x1, x2) and np.array_equal(b1, b2)
    assert not torch.equal(x1, x3)
    assert x1.abs().max() <= 0.7 + 1e-6 and x1.std() > 0.01


@pytest.mark.parametrize("kind", ["serve", "decode"])
def test_portbench_stream_traffic_same_for_same_seed(kind):
    cell = {"serve": "varbit-f32.serve128", "decode": "varbit-f32.decode128-loss10"}[kind]
    plan_of = importlib.import_module(f"portbench.kinds.{kind}").Plan
    extra = {"bank_rows": 2} if kind == "serve" else {}
    plans = [plan_of(_run(cell, s, call_s=[0.3, 0.6], **extra), build=False)
             for s in (5, 5, 6)]
    p = [[pl.params(j) for j in range(4)] for pl in plans]
    for a, b in zip(p[0], p[1]):
        assert all(np.array_equal(a[k], b[k]) for k in a)
    assert any(a["frames"] != c["frames"] or a["bits"] != c["bits"] for a, c in zip(p[0], p[2]))


@pytest.mark.parametrize("kind", ["serve", "decode"])
def test_portbench_every_seed_gives_the_same_call_lengths(kind):
    from portbench.lib import closed

    cell = {"serve": "varbit-f32.serve128", "decode": "varbit-f32.decode128-loss10"}[kind]
    runs = [_run(cell, s, slots=8, call_s=[10.0, 60.0]) for s in (5, 6)]
    rounds = [[closed.call_seconds(r, j) for j in range(16)] for r in runs]
    assert rounds[0] != rounds[1]
    for k in (0, 8):
        assert sorted(rounds[0][k: k + 8]) == sorted(rounds[1][k: k + 8])
    assert sorted(rounds[0][:8]) == pytest.approx([10 + 50 * (i + 0.5) / 8 for i in range(8)])


def test_portbench_losses_have_the_mean_and_burst():
    from portbench.kinds.decode import markov_losses

    lost = markov_losses(np.random.default_rng(0), 200_000, 0.1, 2.0)
    runs = np.diff(np.flatnonzero(np.diff(np.concatenate([[0], lost, [0]]))))[::2]
    assert abs(lost.mean() - 0.1) < 0.01
    assert abs(runs.mean() - 2.0) < 0.1


def test_portbench_arithmetic_on_hand_made_inputs():
    assert stats.percentile([1, 2, 3, 4, 5], 95) == pytest.approx(4.8)
    assert stats.percentile([3.0], 95) == 3.0
    assert stats.median([4, 1, 3]) == 3
    assert stats.rate(30.0, 1.5) == 20.0
    assert stats.union_length([(0, 2), (1, 3), (5, 6), (5.5, 5.7)]) == pytest.approx(4.0)
    rec = {"kind": "serve", "family": "stream", "frames": 22050 / 256 * 200, "window_s": 2.0,
           "fs": 22050, "hop": 256,
           "ticks_s": [0.001 * i for i in range(1, 101)]}
    assert bench.reader("rt_streams")(rec) == pytest.approx(100.0)
    assert bench.reader("tick_p95_ms")(rec) == pytest.approx(95.05)
    rec["profile"] = {"n_device_ops": 3, "busy_s": 0.25, "window_s": 1.0}
    rec["profile_ticks"] = 50
    assert bench.reader("idle_share.stream")(rec) == pytest.approx(75.0)
    assert bench.reader("tick_device_ms.stream")(rec) == pytest.approx(5.0)
    assert bench.reader("idle_share.offline")(rec) is None


def test_portbench_trace_reduction_labels_by_enclosing_range():
    def x(cat, name, ts, dur, corr=None):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
                **({} if corr is None else {"args": {"correlation": corr}})}

    ev = [x("user_annotation", "portbench.scan", 0, 100),
          x("user_annotation", "portbench.stage", 100, 50),
          x("cuda_runtime", "launch", 10, 1, 1), x("cuda_runtime", "launch", 120, 1, 2),
          x("kernel", "gemm", 20, 30, 1), x("kernel", "k1", 130, 10, 2)]
    r = trace.reduce_events(ev)
    assert r["busy_s"] == pytest.approx(40e-6)
    assert r["label_device_s"] == {"scan": pytest.approx(30e-6), "stage": pytest.approx(10e-6)}
    assert r["idle_gaps"] == [["stage", pytest.approx(80e-6)]]
    assert trace.reduce_events(ev[:4]) == {"n_device_ops": 0}


def test_portbench_counts_from_weight_shapes():
    conf = bench.cell_spec("varbit-f32.offline-b256")["conf"]["codec"]
    p, _ = make_weights(dict(conf, h_dim=48, z_dim=12), 1, "cpu")
    mats = sum(2 * lyr["w"].numel() for k in ("phi_z", "enc", "dec") for lyr in p[k])
    mats += 2 * 2 * sum(lyr["w"].numel() for lyr in p["phi_x"])
    mats += 2 * (p["gru"]["w_ih"].numel() + p["gru"]["w_hh"].numel())
    assert counts.bvrnn_frame_flops(80, 48, 12) == mats
    assert counts.bvrnn_frame_flops(80, 1024, 64) == 2 * 23_445_504
    # stage i at 8 * 8 * 2 * 2 / prod(rates so far) samples a frame, 252 C^2 each
    voc = counts.vocoder_frame_flops(conf["vocoder_config"], 80)
    assert voc == 2 * 80 * 128 * 7 + 2 * (128 * 64 * 16 + 8 * 64 * 32 * 16 + 64 * 32 * 16 * 4
                                          + 128 * 16 * 8 * 4) \
        + 252 * (8 * 64 ** 2 + 64 * 32 ** 2 + 128 * 16 ** 2 + 256 * 8 ** 2) + 2 * 256 * 8 * 7


def test_portbench_kernel_and_direct_paths_get_the_same_counts():
    from portbench.lib import program

    spec = bench.cell_spec("varbit-f32.offline-b256")
    conf = spec["conf"]
    conf["codec"].update(h_dim=48, z_dim=12)
    bv, voc = make_weights(conf["codec"], 3, "cpu")
    x = torch.randn(2, 4096) * 0.1
    bounds = []
    for use_pallas in (True, False):
        codec = program.build_codec(conf, bv, voc, "cpu", use_pallas=use_pallas)
        log = program.StageLog(conf["codec"]["vocoder_config"], "float32", "float32")
        log.on = True
        with program.stage_ranges(log):
            codec(x, 3000.0)
        bounds.append((log.calls, log.bound_s))
    assert bounds[0] == bounds[1] and bounds[0][0] == 4


def test_portbench_stage_bound_picks_the_longer_side():
    t, which = counts.stage_bound_s(64, [3, 7, 11], [[1, 3, 5]] * 3, 4, 8192, "float32")
    assert which == "operations"
    assert t == pytest.approx(252 * 64 * 64 * 4 * 8192 / 67e12)
    t, which = counts.stage_bound_s(8, [3, 7, 11], [[1, 3, 5]] * 3, 4, 8192, "bfloat16")
    assert which == "bytes"


def test_portbench_refuses_to_run_without_a_card(tmp_path):
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", CELLS[0], "--seed",
                          str(2**31 + 5), "--seconds", "1", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA card" in out.stderr


def test_portbench_refuses_to_run_outside_a_checkout(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", CELLS[0], "--seed",
                          "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


IMPORTS = ("import portbench.run, portbench.control, portbench.counts; "
           "import portbench.kinds.offline, portbench.kinds.serve, portbench.kinds.decode; "
           "from portbench.lib import program; program.import_program(); ")


def _modules(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "import sys, json; "
                          "print(json.dumps(sorted(sys.modules)))"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=ROOT))
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_portbench_imports_no_jax_and_the_reference_nothing_of_the_program():
    tops = {m.split(".")[0] for m in _modules(IMPORTS)}
    assert "bvsc_tpu_torch" in tops  # compared whole: the program's name begins with bvsc_tpu
    assert not tops & {"jax", "jaxlib", "flax", "bvsc_tpu", "benchmarks", "bench"}
    ref = _modules("import portbench.reference.bvrnn_codec, portbench.reference.compare; ")
    assert not {m.split(".")[0] for m in ref} & {"bvsc_tpu_torch", "bvsc_tpu", "jax"}


def test_portbench_forbidden_names_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "bvsc_tpu_torch_x", sys)
    assert "bvsc_tpu_torch_x" not in bench.loaded_forbidden()
    monkeypatch.setitem(sys.modules, "bvsc_tpu.fake", sys)
    assert "bvsc_tpu.fake" in bench.loaded_forbidden()


def test_portbench_verdict_needs_every_number_within_its_limit():
    limits = {"limits": {"a": {"limit": 1.0}, "b": {"limit": 2.0}}}
    assert bench.verdict({"checks": {"a": 0.5, "b": 2.0}}, limits)[0]
    assert not bench.verdict({"checks": {"a": 0.5, "b": 2.5}}, limits)[0]
    assert not bench.verdict({"checks": {"a": 0.5}}, limits)[0]
    assert not bench.verdict({"checks": {"a": float("nan"), "b": 0}}, limits)[0]
    assert not bench.verdict({"checks": {"a": 0, "b": 0}, "problems": ["x"]}, limits)[0]


def test_portbench_closed_loop_keeps_every_slot_busy():
    rec = bench.run_cell(_spec_small("varbit-f32.serve128"), 2**31 + 11, 0.5, False,
                         torch.device("cpu"))
    assert rec["frames"] == len(rec["ticks_s"]) * 4
    assert rec["checked"] >= 1
    assert set(rec["checks"]) == {"code_gap", "code_gap_mean", "code_flips", "wave_err"}


def _spec_small(cell):
    spec = bench.cell_spec(cell)
    spec["conf"]["codec"].update(h_dim=48, z_dim=12)
    spec["traffic"].update(slots=4, call_s=[0.2, 0.4], warm_ticks=3, warm_s=0.1, check_share=0.5,
                           split_ticks=3, profile_ticks=2)
    if spec["traffic"]["kind"] == "serve":
        spec["traffic"]["bank_rows"] = 2
    return spec
