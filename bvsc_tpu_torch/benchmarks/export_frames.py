"""A serving bundle's one-shot programs at a long bucket, on one CUDA card.

Exports the trained pair's parity bundle at the 65 536-sample bucket (256
frames) through the export CLI, as a user runs it (``--no_packet``), then
loads each program onto the card and holds ``forward`` on the demo
utterance against the live codec (the largest gap, bit-equality, and each
call's milliseconds: CUDA events, median of 5 in turns).  Beside it, the
same ``forward`` program traced in this process at ``UNROLLED_FRAMES``
frames with its frame loop unrolled (the live path's Python loop traced
step by step), and with the scan operator the exporter uses, each with its
node count, export, save and load seconds, and bytes.  Prints one JSON
line.

    python -m bvsc_tpu_torch.benchmarks.export_frames
"""

from __future__ import annotations

import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from bvsc_tpu_torch.cli import export_cli
from bvsc_tpu_torch.codec import BVRNNCodecModel, _forward_impl
from bvsc_tpu_torch.data.audio import load_wav
from bvsc_tpu_torch.serve import export as E

BUCKET = 65536  # samples: 256 frames, the demo's bucket at the default length bucket
UNROLLED_FRAMES = 64  # the unrolled trace's frames (its cost grows with them)
WAV = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
                   "docs", "artifacts", "demo_stim15_3kbps.wav")
BITRATE = 3000


def trace_forward(codec: BVRNNCodecModel, frames: int, traced: bool) -> dict:
    """``forward`` of ``frames`` frames at B = 1, its loop traced as scan or
    unrolled: nodes, export / save / load seconds, bytes."""
    items = E._flatten(codec.weights.tree())
    keys, weights = [k for k, _ in items], [t for _, t in items]
    Lp = frames * codec.conf.hopsize

    class Forward(torch.nn.Module):
        def forward(self, ws, x, bits, n):
            w = codec.weights.with_tree(E._unflatten(zip(keys, ws)), traced=traced)
            return _forward_impl(w, x, bits, n, Lp)

    dev = codec.device
    args = (weights, torch.zeros(1, Lp, device=dev), torch.zeros(1, frames, device=dev),
            torch.tensor(frames, device=dev))
    t0 = time.perf_counter()
    with torch.no_grad():
        ep = torch.export.export(Forward(), args)
    t1 = time.perf_counter()
    ep.example_inputs = None
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    t2 = time.perf_counter()
    torch.export.load(io.BytesIO(buf.getvalue()))
    t3 = time.perf_counter()
    return {"frames": frames, "loop": "scan" if traced else "unrolled",
            "nodes": len(ep.graph.nodes), "export_s": t1 - t0, "save_s": t2 - t1,
            "load_s": t3 - t2, "bytes": len(buf.getvalue())}


def call_ms(fns: dict, rounds: int = 5) -> dict:
    """CUDA-event milliseconds of each function, called in turns after one
    warm-up round: median, least, most."""
    times = {k: [] for k in fns}
    for r in range(rounds + 1):
        for k, fn in fns.items():
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            if r:
                times[k].append(start.elapsed_time(end))
    return {k: {"median": float(np.median(v)), "min": min(v), "max": max(v)}
            for k, v in times.items()}


def main() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("export_frames needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    codec = BVRNNCodecModel(bvrnn_chkpt_path=export_cli.BVRNN_NPZ,
                            vocoder_chkpt_path=export_cli.VOCODER_NPZ)
    out = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi, "torch": torch.__version__}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "b.bvscx")
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "bvsc_tpu_torch.cli.export_cli", "--out",
                               path, "--batch", "1", "--seconds", str(BUCKET / codec.conf.fs),
                               "--no_packet"], capture_output=True, text=True, timeout=1800)
        if proc.returncode != 0:
            raise SystemExit(f"the export CLI failed: {proc.stderr[-3000:]}")
        out["cli"] = {**json.loads(proc.stdout.strip().splitlines()[-1]),
                      "process_s": time.perf_counter() - t0}
        t0 = time.perf_counter()
        bundle = E.ServingBundle(path)
        out["load_s"] = {"manifest_and_weights": time.perf_counter() - t0}
        for kind, name in bundle.meta["buckets"][0]["programs"].items():
            t0 = time.perf_counter()
            bundle._program(name)
            out["load_s"][kind] = time.perf_counter() - t0
        wav, _ = load_wav(WAV)
        x = torch.from_numpy(np.ascontiguousarray(wav[None].astype(np.float32))).cuda()
        with torch.no_grad():
            live, got = codec(x, BITRATE), bundle(x, BITRATE)
            out["forward"] = {"samples": x.shape[1], "bucket": bundle._bucket(x.shape[1])["length"],
                              "max_abs_gap": (got - live).abs().max().item(),
                              "bitwise": bool(torch.equal(got, live)),
                              "ms": call_ms({"live": lambda: codec(x, BITRATE),
                                             "bundle": lambda: bundle(x, BITRATE)})}
    out["traces"] = [trace_forward(codec, UNROLLED_FRAMES, traced)
                     for traced in (True, False)]
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
