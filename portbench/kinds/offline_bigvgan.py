"""Offline resynthesis with the published BigVGAN as the vocoder:
``BVRNNCodecModel.__call__`` on batches of utterances, calls back to back,
as :mod:`portbench.kinds.offline` runs them (its traffic keys, calls and
checked rows), judged by :mod:`portbench.reference.compare_bigvgan`.

A traced run ranges every anti-aliased activation
(``models.vocoder.antialiased``, ``portbench.aa``) in the stretch that
records the ranges, and keeps the elements the program's
``vocoder.aa_elements`` counter added over it (``aa_elements``).  The kind
stops before set-up where the program has no such entry point: a program
without it has no anti-aliased activation to measure.
"""

from __future__ import annotations

import time

from portbench.counts import bvrnn_frame_flops, vocoder_frame_flops
from portbench.kinds.offline import Calls, check_rows
from portbench.lib import program, spans, trace
from portbench.lib.program import sync
from portbench.lib.weights import make_weights
from portbench.reference import compare_bigvgan

KIND = "offline_bigvgan"
ENTRY = "antialiased"  # models.vocoder's anti-aliased activation


def _entry_point():
    vocoder = program.import_program()["vocoder"]
    if not callable(getattr(vocoder, ENTRY, None)):
        raise RuntimeError(f"bvsc_tpu_torch.models.vocoder has no {ENTRY}(): this program has no "
                           f"anti-aliased activation entry point to range")
    return vocoder


def run(run) -> dict:
    conf, traffic, device = run.conf, run.traffic, run.device
    vocoder = _entry_point()
    bvrnn, voc = make_weights(conf["codec"], run.seed, device)
    codec = program.build_codec(conf, bvrnn, voc, device)
    calls = Calls(run, conf, traffic)
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
    c = conf["codec"]
    flops = n * calls.B * calls.frames * (
        bvrnn_frame_flops(c["num_mels"], c["h_dim"], c["z_dim"])
        + vocoder_frame_flops(c["vocoder_config"], c["num_mels"]))
    rec = {"kind": KIND, "family": "offline", "setup_s": setup_s, "window_s": window_s, "calls": n,
           "attempted": n * calls.B, "failed": 0, "audio_s": n * calls.B * calls.L / calls.fs,
           "model_flops": flops, "profile_calls": traffic["profile_calls"]}
    if run.trace:
        rec["phase_s"] = events.seconds()

        def some_calls(first):
            for i in range(traffic["profile_calls"]):
                x, bits = calls(first + i)
                codec(x, calls.bitrate(bits))

        rec["profile"] = trace.profile(lambda: some_calls(n), device)
        before = spans.counter("vocoder.aa_elements")
        with trace.wrapped(vocoder, ENTRY, trace.ranged("aa")), program.call_ranges():
            rec["ranges"] = trace.profile(lambda: some_calls(n + traffic["profile_calls"]),
                                          device, ranges=True)
        after = spans.counter("vocoder.aa_elements")
        if before is not None and after is not None:
            rec["aa_elements"] = after - before
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
    judge = compare_bigvgan.Judge(conf, bvrnn, voc, device)
    judge.encode_items(items)
    rec["checks"] = judge.numbers()
    rec["checked"] = judge.items
    return rec


def control(run, ctl: dict) -> tuple[dict, int]:
    """The reference run free in ``ctl['arith']`` (the only control this
    kind takes) on the rows of the calls a run checks (the first checked
    call and the one after it), judged as the program's outputs are."""
    if set(ctl) != {"arith"}:
        raise ValueError(f"this kind's control is the reference in an arithmetic; got {ctl}")
    conf, device = run.conf, run.device
    bvrnn, voc = make_weights(conf["codec"], run.seed, device)
    calls = Calls(run, conf, run.traffic)
    first, rows = check_rows(run, calls)
    items = []
    for i, sel in zip((first, first + 1), rows):
        x, bits = calls(i)
        items += [{"x": x[r], "pad_to": calls.padded(conf), "bits": int(bits[r])}
                  for r in sel.tolist()]
    compare_bigvgan.encode(ctl["arith"], bvrnn, voc, conf["codec"], items, device)
    run.free()
    judge = compare_bigvgan.Judge(conf, bvrnn, voc, device)
    judge.encode_items(items)
    return judge.numbers(), judge.items

