"""The control of a cell's check: what one precision step below the
configuration's gives, judged as the program's outputs are.

    python3 portbench/control.py --workload <cell> --seeds 11 12 13

The configuration's ``control`` says what stands in the program's place:

* ``arith`` alone: the reference itself, run free in that arithmetic (a
  float32 configuration's control is the reference with TF32 operands);
* ``program`` and ``arith``: the program built with those arguments (its own
  lower-precision path, here the weight-only int8 BVRNN), its decoded mel
  vocoded by the reference in ``arith['vocoder']`` where the program has no
  lower path of its own (float8 e4m3 operands for a bf16 vocoder).

The cell's kind (``portbench/kinds/<kind>.py``, found by the traffic's
``kind``) gives ``control(run, ctl) -> (numbers, items checked)``: the same
inputs a run of the cell checks, at the cell's sizes.  It prints one JSON
line a seed.  The benchmark's runs never run it; its readings set the limits'
upper ends (``portbench/limits/<cell>.json``).
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:] = [p for p in sys.path if os.path.abspath(p or os.curdir) != HERE]
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402

from portbench import run as bench  # noqa: E402


def control(spec: dict, seed: int, device) -> dict:
    run = bench.Run(spec, seed, 0, False, device, 0.0)
    kind = importlib.import_module(f"portbench.kinds.{spec['traffic']['kind']}")
    checks, checked = kind.control(run, spec["conf"]["control"])
    return {"seed": seed, "checks": checks, "checked": checked}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    spec = bench.cell_spec(args.workload)
    for seed in args.seeds:
        print(json.dumps(dict(control(spec, seed, torch.device(args.device)),
                              workload=args.workload)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
