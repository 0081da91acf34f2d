"""K2, the persistent GRU (``csrc/persistent_gru.cu``), over the number of
steps, in bf16 and int8, on one card.

For each build named on the command line (``repo``, the default, is the
package's own build; any other argument is a CUDA source file with the same
C interface, such as an older commit's ``persistent_gru.cu`` or a variant
of it) and each weight type, it launches K2 at H = 1024 on the probe's
seeded inputs for T = 1, 64 and 512 steps and times each with CUDA events
(``ms``: back-to-back calls, the host's launch included).  The slope between
T = 64 and T = 512 is the loop's cost per step (``us_per_step``), printed
beside the per-step bound (one step's operations at the bf16 peak); the
intercept is the rest, staging 18.9 MB of weights and the launch.  The
package's build is held to the smoke's one-step bounds against the plain
version; another build only reports its error (a variant may leave work out
on purpose).  Builds run in the order given, so ``old.cu repo repo old.cu``
compares two versions in turns on one card.  Then, per build, the registers
and spill bytes of each kernel as ``nvcc -Xptxas -v`` reports them, and
last the package's build timed at T = 1 and 64 from a replayed CUDA graph.

    python -m bvsc_tpu_torch.benchmarks.gru_steps [repo | FILE.cu] ...
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess
import sys

import torch

from bvsc_tpu_torch.benchmarks import cuda_ms, graph_ms
from bvsc_tpu_torch.benchmarks import probe_persistent_gru as probe
from bvsc_tpu_torch.device import set_parity_mode
from bvsc_tpu_torch.ops import _build
from bvsc_tpu_torch.ops import persistent_gru as PG

STEPS = (1, 64, 512)
REPS = {1: 50, 64: 20, 512: 10}
PEAK_BF16_FLOPS = 989e12  # H100 SXM tensor cores, dense (NVIDIA data sheet)
# As chip_smoke.GRU_STEP_TOL and GRU_TOL: one step from the same operands.
STEP_TOL = {"bf16": 1e-5, "int8": 2e-2}
SCRATCH_BYTES = 1 << 20  # scratch for another build: more than any version needs


def step_bound_us(H: int = probe.H) -> float:
    """One step's operations, 2 * 8 * 3H * 3H, at the bf16 peak, in µs."""
    return 2 * PG.LANES * 3 * H * 3 * H / PEAK_BF16_FLOPS * 1e6


def per_step(ms: dict) -> dict:
    """The slope between T = 64 and T = 512 (µs a step) and the intercept
    (ms) of the times ``ms`` by T."""
    slope = (ms[512] - ms[64]) / (512 - 64)
    return {"us_per_step": slope * 1e3, "intercept_ms": ms[64] - 64 * slope}


def inputs(dev: torch.device) -> dict:
    """The probe's seeded inputs: per weight type the two weights, then the
    biases, xconst and h0."""
    raw = probe.make_inputs()
    a = {k: torch.from_numpy(v).to(dev) for k, v in raw.items()}
    rest = (a["b_ih"], a["b_hh"], a["xc"], a["h0"])
    return {"bf16": ((a["w_ih"].to(torch.bfloat16), a["w_hh"].to(torch.bfloat16)), rest),
            "int8": ((PG.quantize(raw["w_ih"])[0].to(dev), PG.quantize(raw["w_hh"])[0].to(dev)),
                     rest)}


def runner(build: str, dev: torch.device):
    """``run(w, rest, T, dequant)`` for one build."""
    if build == "repo":
        return lambda w, rest, T, dq: PG.persistent_gru(*w, *rest, T, dequant=dq)
    lib = PG.bind(ctypes.CDLL(_build.library_for(build)))
    scratch = torch.zeros(SCRATCH_BYTES, dtype=torch.uint8, device=dev)
    return lambda w, rest, T, dq: PG.launch(lib, *w, *rest, T, dq, scratch)


def measure(build: str, dev: torch.device, data: dict) -> list[dict]:
    run = runner(build, dev)
    lines = []
    for dt, (w, rest) in data.items():
        dq = dt == "int8"
        err = (run(w, rest, 1, dq) - PG.persistent_gru_plain(*w, *rest, 1, dequant=dq)).abs().max().item()
        if build == "repo" and not err <= STEP_TOL[dt]:
            raise AssertionError(f"persistent_gru {dt} T=1: kernel vs plain {err} > {STEP_TOL[dt]}")
        ms = {T: cuda_ms(lambda: run(w, rest, T, dq), reps=REPS[T], warmup=2) for T in STEPS}
        lines.append({"build": build, "dtype": dt, "H": probe.H, "max_abs_err_T1": err,
                      "ms": ms, **per_step(ms), "bound_us_per_step": step_bound_us()})
    return lines


def ptxas(source: str) -> list[dict]:
    """Registers and spill bytes of each kernel in ``source``, from
    ``nvcc -Xptxas -v`` (a cubin into the build directory)."""
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    cubin = os.path.join(_build.BUILD_DIR, f"ptxas-{os.getpid()}.cubin")
    text = subprocess.run([_build._nvcc(), *flags, "-cubin", "-Xptxas", "-v", "-o", cubin, source],
                          capture_output=True, text=True, check=True, timeout=300)
    text = text.stdout + text.stderr
    os.remove(cubin)
    rows, cur = [], None
    for line in text.splitlines():
        if m := re.search(r"Compiling entry function '(\S+)'", line):
            cur = {"function": m[1]}
            rows.append(cur)
        elif cur is not None and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            cur["spill_store_bytes"], cur["spill_load_bytes"] = int(m[1]), int(m[2])
        elif cur is not None and (m := re.search(r"Used (\d+) registers", line)):
            cur["registers"] = int(m[1])
    return rows


def graph_times(data: dict) -> dict:
    """The package's build at T = 1 and 64 from a replayed CUDA graph: the
    device's time alone (a cooperative launch can be captured)."""
    w, rest = data["bf16"]
    return {f"T{T}_ms": graph_ms(lambda: PG.persistent_gru(*w, *rest, T)) for T in (1, 64)}


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def main(argv=None) -> None:
    builds = (sys.argv[1:] if argv is None else argv) or ["repo"]
    if not torch.cuda.is_available():
        raise SystemExit("gru_steps times the card; no CUDA device is available")
    dev = torch.device("cuda")
    print(card(), flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0), "builds": builds}), flush=True)
    set_parity_mode()
    sources = {b: os.path.join(_build.CSRC, "persistent_gru.cu") if b == "repo" else b
               for b in builds}
    _build.compile_files(list(dict.fromkeys(sources.values())))
    data = inputs(dev)
    for build in builds:
        for line in measure(build, dev, data):
            print(json.dumps(line), flush=True)
    for build, src in sources.items():
        print(json.dumps({"build": build, "ptxas": ptxas(src)}), flush=True)
    if "repo" in builds:
        print(json.dumps({"build": "repo", "graph": graph_times(data)}), flush=True)


if __name__ == "__main__":
    main()
