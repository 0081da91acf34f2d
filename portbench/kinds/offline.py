"""Offline resynthesis: ``BVRNNCodecModel.__call__`` on batches of utterances,
calls back to back.

Traffic keys: ``batch`` (utterances a call), ``clip_s`` (seconds each),
``bits`` ([low, high] bits a frame, one draw a clip), ``shift_s`` (the
seconds by which each call's cut of the seeded speech may shift),
``check_rows`` (rows checked in each of two calls: one drawn from the first
three, and the window's last), ``profile_calls`` (calls in the profiled
stretches of a traced run).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench.counts import bvrnn_frame_flops, vocoder_frame_flops
from portbench.lib import program, seeds, trace
from portbench.lib.program import sync
from portbench.lib.speech import speech
from portbench.lib.weights import make_weights
from portbench.reference import bvrnn_codec as R, free
from portbench.reference.compare import Judge

KIND = "offline"


class Calls:
    """The cell's calls from the seed: call i's rows are a seeded
    permutation of the speech bank, cut at a seeded shift, with one bitrate
    a row."""

    def __init__(self, run, conf, traffic):
        c = conf["codec"]
        self.fs, self.hop = c["fs"], c["hopsize"]
        self.B = traffic["batch"]
        self.L = int(round(traffic["clip_s"] * self.fs))
        self.shift = int(round(traffic["shift_s"] * self.fs))
        self.frames = 1 + (self.L - self.hop) // self.hop
        self.lo, self.hi = traffic["bits"]
        self.bank = speech(seeds.generator(run.seed, "speech", run.device), self.B,
                           self.L + self.shift, self.fs, run.device)
        self.seed = run.seed
        self.device = run.device

    def __call__(self, i: int):
        """(input (B, L) on the device, bits a frame (B,) ints) of call ``i``."""
        rng = seeds.rng(self.seed, f"call-{i}")
        perm = torch.as_tensor(rng.permutation(self.B), device=self.device)
        off = int(rng.integers(0, self.shift + 1))
        bits = rng.integers(self.lo, self.hi + 1, self.B)
        return self.bank[perm, off: off + self.L], bits

    def padded(self, conf) -> int:
        """Samples a call is framed over: the clip rounded up to the
        codec's length bucket (frames a bucket, ``length_bucket``)."""
        bucket = self.hop * conf["program"].get("length_bucket", 64)
        return -(-self.L // bucket) * bucket

    def bitrate(self, bits: np.ndarray) -> np.ndarray:
        """The codec's per-frame bitrate argument: bits a frame as bps."""
        return np.repeat((bits * self.fs / self.hop)[:, None], self.frames, 1)


def check_rows(run, calls: Calls) -> tuple[int, list]:
    """(the first checked call, drawn from the first three; the rows checked
    in it and in the second call checked)."""
    pick = seeds.rng(run.seed, "check")
    first = int(pick.integers(0, 3))
    return first, [np.sort(pick.choice(calls.B, run.traffic["check_rows"], replace=False))
                   for _ in range(2)]


def run(run) -> dict:
    conf, traffic, device = run.conf, run.traffic, run.device
    bvrnn, voc = make_weights(conf["codec"], run.seed, device)
    codec = program.build_codec(conf, bvrnn, voc, device)
    calls = Calls(run, conf, traffic)
    frames = calls.frames
    x, bits = calls(-1)  # the warm call, at the cell's shape
    codec(x, calls.bitrate(bits))
    sync(device)
    setup_s = time.perf_counter() - run.t0

    first, rows = check_rows(run, calls)
    events = trace.PhaseEvents(device) if run.trace else None
    holder, kept, n = {}, {}, 0
    with program.capture_scan(holder), program.call_ranges(events):
        t0 = time.perf_counter()
        while True:
            x, bits = calls(n)
            y = codec(x, calls.bitrate(bits))
            out = {"x": x, "bits": bits, "y": y, "scan": holder.pop("scan", None)}
            if n == first:
                kept["first"] = out
            kept["last"] = out
            n += 1
            if time.perf_counter() - t0 >= run.seconds:
                break
        sync(device)
        window_s = time.perf_counter() - t0
    flops = n * calls.B * frames * (
        bvrnn_frame_flops(conf["codec"]["num_mels"], conf["codec"]["h_dim"], conf["codec"]["z_dim"])
        + vocoder_frame_flops(conf["codec"]["vocoder_config"], conf["codec"]["num_mels"]))
    rec = {"kind": KIND, "family": "offline", "setup_s": setup_s, "window_s": window_s, "calls": n,
           "attempted": n * calls.B, "failed": 0, "audio_s": n * calls.B * calls.L / calls.fs,
           "model_flops": flops}
    if run.trace:
        rec["phase_s"] = events.seconds()
        log = program.StageLog(conf["codec"]["vocoder_config"], conf["vocoder_compute"],
                               conf["activations"])

        def some_calls(first):
            for i in range(traffic["profile_calls"]):
                x, bits = calls(first + i)
                codec(x, calls.bitrate(bits))

        def stretch():
            log.on = True
            some_calls(n + traffic["profile_calls"])
            log.on = False

        rec["profile"] = trace.profile(lambda: some_calls(n), device)
        with program.stage_ranges(log), program.call_ranges():
            rec["ranges"] = trace.profile(stretch, device, ranges=True)
        rec["stage_bound_s"] = log.bound_s
    rec["memory_peak_bytes"] = run.memory_peak()

    items = []
    for key, sel in (("first", rows[0]), ("last", rows[1])):
        if key == "first" and kept.get("first", kept["last"]) is kept["last"]:
            continue
        out = kept[key]
        codes = None if out["scan"] is None else out["scan"][0]
        for r in sel.tolist():
            items.append({"x": out["x"][r], "pad_to": calls.padded(conf), "y": out["y"][r],
                          "bits": int(out["bits"][r]),
                          "codes": None if codes is None else codes[r]})
    del codec, holder
    run.free()
    if any(it["codes"] is None for it in items):
        rec["problems"] = ["the codes of a checked call were not read: models.bvrnn.encode_decode "
                           "was not called by the codec"]
        return rec
    judge = Judge(conf, bvrnn, voc, device)
    judge.encode_items(items)
    rec["checks"] = judge.numbers()
    rec["checked"] = judge.items
    return rec


def control(run, ctl: dict) -> tuple[dict, int]:
    """The control's numbers on the rows of the calls a run checks (the
    first checked call and the one after it), as ``portbench/control.py``
    describes ``ctl``."""
    conf, device = run.conf, run.device
    bvrnn, voc = make_weights(conf["codec"], run.seed, device)
    calls = Calls(run, conf, run.traffic)
    first, rows = check_rows(run, calls)
    codec = (program.build_codec(conf, bvrnn, voc, device, **ctl["program"])
             if "program" in ctl else None)
    items = []
    for i, sel in zip((first, first + 1), rows):
        x, bits = calls(i)
        new = [{"x": x[r], "pad_to": calls.padded(conf), "bits": int(bits[r])}
               for r in sel.tolist()]
        if codec is not None:
            holder = {}
            with program.capture_scan(holder):
                codec(x, calls.bitrate(bits))
            codes, mel = holder["scan"]
            y = R.vocoder(voc, conf["codec"]["vocoder_config"], mel.transpose(1, 2).float(),
                          calls.padded(conf), ctl["arith"]["vocoder"])
            for it, r in zip(new, sel.tolist()):
                it.update(codes=codes[r], y=y[r, : calls.L])
        items += new
    if codec is None:
        free.encode(ctl["arith"], bvrnn, voc, conf["codec"], items, device)
    del codec
    run.free()
    judge = Judge(conf, bvrnn, voc, device)
    judge.encode_items(items)
    return judge.numbers(), judge.items
