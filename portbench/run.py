"""Run one cell of the benchmark of ``bvsc_tpu_torch`` once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cell's CUDA cards.  It
builds the cell from files found by the names in ``BENCHMARK.json``: the
configuration ``portbench/configs/<config>.json``, the traffic
``portbench/traffic/<traffic>.json`` (whose ``kind`` names its module,
``portbench/kinds/<kind>.py``), the check's limits
``portbench/limits/<cell>.json`` and one reader a metric,
``portbench/metrics/<metric>.py``, which reads what the kind's record holds
(a record names its ``family``: ``offline`` or ``stream``).  It sets up
(weights and inputs from the seed, the program built and warmed at the
cell's shapes), measures for ``--seconds``, checks the outputs against the
plain reference, and prints the numbers compared beside their limits as the
last lines of standard error and one JSON line as the last line of standard
output.  ``--trace 1`` reports the per-layer metrics (with profiled stretches
after the window) instead of the end-to-end ones.

It exits non-zero, printing no result, without enough CUDA cards, outside a
checkout that holds the program, or when JAX, the JAX package or its
benchmarks were imported.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
PROGRAM = "bvsc_tpu_torch"
# top-level module names that may not be loaded: JAX, the JAX package and
# its benchmarks, compared whole (the program's own name begins with one)
FORBIDDEN = ("jax", "jaxlib", "flax", "bvsc_tpu", "benchmarks", "bench")
CACHE = os.path.join(ROOT, ".portbench_cache")
# the script's own directory would shadow top-level modules by its files' names
sys.path[:] = [p for p in sys.path if os.path.abspath(p or os.curdir) != HERE]


class Failure(Exception):
    """A run that cannot give a result: its message goes to standard error."""


def set_caches() -> None:
    """Every compiler cache inside the checkout, at fixed paths; nothing
    may load JAX through a library that would."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = os.path.join(CACHE, sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def load(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def bench_file() -> dict:
    return load(os.path.join(ROOT, "BENCHMARK.json"))


def cell_spec(name: str, bench: dict | None = None) -> dict:
    """Everything the names in ``BENCHMARK.json`` give for cell ``name``."""
    bench = bench or bench_file()
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise Failure(f"no workload {name!r} in BENCHMARK.json (has {sorted(cells)})")
    cell = cells[name]

    def applies(m):
        return name in m.get("workloads", [name])

    return {"cell": cell,
            "conf": load(os.path.join(HERE, "configs", f"{cell['config']}.json")),
            "traffic": load(os.path.join(HERE, "traffic", f"{cell['traffic']}.json")),
            "limits": load(os.path.join(HERE, "limits", f"{name}.json")),
            "end_to_end": [m for m in bench["end_to_end"] if applies(m)],
            "per_layer": [m for m in bench["per_layer"] if applies(m)]}


def reader(metric: str):
    """The ``read(record)`` of ``portbench/metrics/<metric>.py``."""
    path = os.path.join(HERE, "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location("portbench_metric_" + metric.replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Run:
    """One run's settings, handed to the kind's ``run``."""

    def __init__(self, spec: dict, seed: int, seconds: float, trace: bool, device, t0: float):
        self.cell, self.conf, self.traffic = spec["cell"], spec["conf"], spec["traffic"]
        self.seed, self.seconds, self.trace = int(seed), float(seconds), bool(trace)
        self.device, self.t0 = device, t0

    def memory_peak(self) -> int:
        import torch

        if self.device.type != "cuda":
            return 0
        return max(torch.cuda.max_memory_allocated(d) for d in range(torch.cuda.device_count()))

    def free(self) -> None:
        """Release what the program held before the reference runs."""
        import torch

        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()


def run_cell(spec: dict, seed: int, seconds: float, trace: bool, device,
             t0: float | None = None) -> dict:
    """The record of one run of the cell (no result line)."""
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    kind = spec["traffic"]["kind"]
    runner = importlib.import_module(f"portbench.kinds.{kind}")
    run = Run(spec, seed, seconds, trace, device, time.perf_counter() if t0 is None else t0)
    rec = runner.run(run)
    rec["conf"] = spec["conf"]
    return rec


def verdict(rec: dict, limits: dict) -> tuple[bool, list]:
    """(correct, [(name, value, limit)]) of a record's checks."""
    ok = not rec.get("problems")
    rows = []
    checks = rec.get("checks", {})
    for name, lim in limits["limits"].items():
        value = checks.get(name)
        if value is None or not math.isfinite(value) or value > lim["limit"]:
            ok = False
        rows.append((name, value, lim["limit"]))
    return ok and bool(rows), rows


def metrics(rec: dict, chosen: list, required: bool) -> dict:
    out = {}
    for m in chosen:
        value = reader(m["name"])(rec)
        if value is None:
            if required:
                raise Failure(f"end-to-end metric {m['name']} read nothing")
            continue
        out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def loaded_forbidden() -> list:
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


def result(spec: dict, rec: dict, trace: bool, device_info: dict) -> tuple[dict, list]:
    correct, rows = verdict(rec, spec["limits"])
    out = {"correct": correct, "attempted": int(rec["attempted"]), "failed": int(rec["failed"]),
           "metrics": metrics(rec, spec["per_layer"] if trace else spec["end_to_end"], not trace),
           "device": dict(device_info, memory_peak_bytes=int(rec["memory_peak_bytes"]))}
    prof = rec.get("profile")
    if trace and prof is not None and prof.get("n_device_ops"):
        out["device"].update(busy_s=prof["busy_s"], window_s=prof["window_s"])
        gaps = (rec.get("ranges") or prof)["idle_gaps"]
        out["breakdown"] = {"device_ops": prof["device_ops"], "idle_gaps": gaps}
    out["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in rows}
    if rec.get("problems"):
        out["checks"]["problems"] = rec["problems"]
    return out, rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    try:
        if not os.path.isdir(os.path.join(ROOT, PROGRAM)):
            raise Failure(f"{PROGRAM}/ is not beside portbench/ in {ROOT}: run from a checkout")
        set_caches()
        spec = cell_spec(args.workload)
        import torch

        chips = spec["cell"]["chips"]
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            raise Failure(f"the cell needs {chips} CUDA card(s); "
                          f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found")
        sys.path.insert(0, ROOT)
        rec = run_cell(spec, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0),
                       T0)
        program = sys.modules.get(PROGRAM)
        if program is None or not os.path.abspath(program.__file__).startswith(ROOT + os.sep):
            raise Failure(f"{PROGRAM} was not loaded from this checkout")
        bad = loaded_forbidden()
        if bad:
            raise Failure(f"forbidden modules loaded: {', '.join(bad)}")
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips}
        out, rows = result(spec, rec, bool(args.trace), info)
    except Failure as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    compared = {name for name, _, _ in rows}
    for name, value in sorted(rec.get("checks", {}).items()):
        if name not in compared:
            print(f"reading {name} {value!r} (not compared)", file=sys.stderr)
    for problem in rec.get("problems", []):
        print(f"check problem: {problem}", file=sys.stderr)
    for name, value, limit in rows:
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
