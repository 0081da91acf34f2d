"""The run of a closed-loop serving cell (kinds ``serve`` and ``decode``).

Set-up builds the codec and the engine (which ticks once by itself), runs
``warm_ticks`` ticks of short warm-up calls with churn and closes them, and
opens the first call in every slot.  The window ticks back to back for
``--seconds``, each call replaced as it drains.  A traced run then times
``split_ticks`` ticks with the engine's device step synchronised (the host's
part of a tick) and profiles ``profile_ticks`` more, twice (module
``trace``).  The check samples calls from the seed, and always the longest
call of the first wave that the window should finish (its ticks estimated
from the warm-up's); after the window the loop ticks on, opening nothing,
until that call has drained, or for at most a minute.

The plan (its kind's) gives: ``params(j)``, a call's parameters from the
seed (its length from :func:`call_seconds`); ``open(eng, p)`` -> (sid,
frames); ``keep`` and ``item`` for the check; ``flops(p, first, last)``, the
model's operations for frames [first, last) of a call.
"""

from __future__ import annotations

import time

from portbench.lib import program, seeds, trace
from portbench.lib.loop import ClosedLoop
from portbench.lib.program import sync


def run(run, engine_class: str, plan) -> dict:
    conf, traffic, device = run.conf, run.traffic, run.device
    m = program.import_program()
    eng = getattr(m["engine"], engine_class)(plan.codec, max_streams=traffic["slots"])
    B = eng.B

    warm = [plan.warm_params(j) for j in range(traffic["warm_calls"])]
    warm_calls = {}  # each warm call's own copy of its parameters

    def warm_call(j):
        return warm_calls.setdefault(j, dict(warm[j % len(warm)]))

    wl = ClosedLoop(eng, lambda j: (*plan.open(eng, warm_call(j)), False), None)
    wl.fill()
    warm_s = [wl.tick()[0] for _ in range(traffic["warm_ticks"])]
    for sid in list(wl.calls):
        eng.close_stream(sid)
    sync(device)
    # ticks the window should hold, with room: at the median pace of the
    # warm-up's later half
    fits = 0.8 * run.seconds / (sorted(warm_s[len(warm_s) // 2:])[len(warm_s) // 4] or 1e-3)

    params = {}

    def get(j):
        if j not in params:
            params[j] = plan.params(j)
        return params[j]

    fitting = [j for j in range(B) if get(j)["frames"] <= fits] or [
        min(range(B), key=lambda j: get(j)["frames"])]
    longest = max(fitting, key=lambda j: (get(j)["frames"], -j))
    kept = {}

    def open_call(j):
        p = get(j)
        sid, frames = plan.open(eng, p)
        sampled = p["sampled"] or j == longest
        if sampled:
            kept[j] = plan.buffers(p)
        return sid, frames, sampled

    loop = ClosedLoop(eng, open_call, lambda call, res: plan.keep(kept[call["j"]], call, res))
    loop.fill()
    sync(device)
    setup_s = time.perf_counter() - run.t0

    start = {c["j"]: c["done"] for c in loop.calls.values()}
    ticks, frames = [], 0
    t0 = time.perf_counter()
    while True:
        dt, n = loop.tick()
        ticks.append(dt)
        frames += n
        if time.perf_counter() - t0 >= run.seconds:
            break
    window_s = time.perf_counter() - t0
    ops = 0
    for call in loop.finished + list(loop.calls.values()):
        ops += plan.flops(get(call["j"]), start.get(call["j"], 0), call["done"])
    rec = {"kind": plan.KIND, "family": "stream", "setup_s": setup_s, "window_s": window_s,
           "ticks_s": ticks, "frames": frames, "fs": conf["codec"]["fs"],
           "hop": conf["codec"]["hopsize"],
           "model_flops": ops, "attempted": loop.next, "failed": 0}
    if run.trace:
        rec.update(traced(run, eng, loop))
    rec["memory_peak_bytes"] = run.memory_peak()

    loop.drain(lambda: any(c["j"] == longest for c in loop.calls.values()))
    done = sorted((c for c in loop.finished if c["sampled"]), key=lambda c: c["j"])
    done = [c for c in done if c["j"] == longest] + [c for c in done if c["j"] != longest]
    items = [plan.item(get(c["j"]), kept[c["j"]]) for c in done[: traffic["check_max"]]]
    del eng, loop, wl, kept
    plan.codec = None
    run.free()
    if not items:
        rec["problems"] = ["no sampled call finished"]
        return rec
    rec["checks"] = plan.judge(items)
    rec["checked"] = len(items)
    return rec


def traced(run, eng, loop) -> dict:
    """The host part of ``split_ticks`` ticks, then a profiled stretch."""
    traffic, device = run.traffic, run.device
    step = eng._tick_call
    steps, walls = [], []

    def timed_step(*args, **kwargs):
        sync(device)
        t = time.perf_counter()
        out = step(*args, **kwargs)
        sync(device)
        steps.append(time.perf_counter() - t)
        return out

    eng._tick_call = timed_step
    try:
        for _ in range(traffic["split_ticks"]):
            n0 = len(steps)
            dt, _ = loop.tick()
            if len(steps) == n0 + 1:
                walls.append(dt - steps[-1])
    finally:
        del eng._tick_call
    log = program.StageLog(run.conf["codec"]["vocoder_config"], run.conf["vocoder_compute"],
                           run.conf["activations"])
    n = traffic["profile_ticks"]

    def ticks():
        for _ in range(n):
            loop.tick()

    prof = trace.profile(ticks, device)
    eng.tick = trace.ranged("tick")(eng.tick)
    eng._tick_call = trace.ranged("step")(step)

    def stretch():
        log.on = True
        ticks()
        log.on = False

    try:
        with program.stage_ranges(log):
            ranges = trace.profile(stretch, device, ranges=True)
    finally:
        del eng.tick, eng._tick_call
    return {"tick_host_s": walls, "profile": prof, "ranges": ranges, "profile_ticks": n,
            "stage_bound_s": log.bound_s}


def call_seed(run, j: int):
    """The generator of call ``j``'s parameters."""
    return seeds.rng(run.seed, f"call-{j}")


def call_seconds(run, j: int) -> float:
    """Call ``j``'s length.  The calls come in rounds of ``slots``, and every
    round holds the same lengths, spread evenly over ``call_s``, in an order
    drawn from the seed: every seed gives the engine the same work (a call's
    length sets how much input its slot holds queued)."""
    B = run.traffic["slots"]
    lo, hi = run.traffic["call_s"]
    order = seeds.rng(run.seed, f"round-{j // B}").permutation(B)
    return lo + (hi - lo) * (order[j % B] + 0.5) / B


def control_calls(run, plan, ctl: dict) -> list:
    """The parameters of the calls a run's check holds: the first wave's
    longest, then those the seed samples, at most ``check_max``.  A stream
    kind's control is the reference run free (``ctl['arith']``) alone."""
    if set(ctl) != {"arith"}:
        raise ValueError(f"a stream cell's control is the reference in an arithmetic; got {ctl}")
    B = run.traffic["slots"]
    params = [plan.params(j) for j in range(B)]
    longest = max(range(B), key=lambda j: (params[j]["frames"], -j))
    chosen = [longest] + [j for j in range(B) if params[j]["sampled"] and j != longest]
    return [params[j] for j in chosen[: run.traffic["check_max"]]]
