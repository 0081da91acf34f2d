"""Full-duplex serving: ``ServingEngine.tick`` over every slot, closed loop.

Traffic keys: ``slots``; ``call_s`` ([low, high] seconds of a call's input:
each round of ``slots`` calls spreads its lengths evenly over it, in a seeded
order, ``closed.call_seconds``); ``bits`` ([low, high] bits a frame, one
draw a call); ``bank_rows`` (rows of seeded speech the calls are cut from); ``warm_calls``,
``warm_s``, ``warm_ticks`` (set-up); ``check_share`` (the share of calls the
check samples, besides the first wave's longest), ``check_max`` (at most
this many checked); ``split_ticks``, ``profile_ticks`` (traced run).

A call's whole input is queued when it opens and its end marked
(``begin_flush``); it drains in ``(L - hop) // hop + 1`` ticks.  The check
holds each sampled call's codes and audio, tick by tick, against the
reference's one-shot of that call's input.
"""

from __future__ import annotations

import numpy as np

from portbench.counts import bvrnn_frame_flops, vocoder_frame_flops
from portbench.lib import closed, program, seeds
from portbench.lib.speech import speech
from portbench.lib.weights import make_weights
from portbench.reference import free
from portbench.reference.compare import Judge


class Plan:
    KIND = "serve"

    def __init__(self, run, build: bool = True):
        """``build``: the program too (a control reads the plan alone)."""
        self.run = run
        conf, traffic = run.conf, run.traffic
        c = conf["codec"]
        self.fs, self.hop, self.z = c["fs"], c["hopsize"], c["z_dim"]
        self.traffic = traffic
        self.bvrnn, self.voc = make_weights(c, run.seed, run.device)
        self.codec = program.build_codec(conf, self.bvrnn, self.voc, run.device) if build else None
        self.bank_len = int(round(traffic["call_s"][1] * self.fs * 1.25))
        self.bank = speech(seeds.generator(run.seed, "speech", run.device), traffic["bank_rows"],
                           self.bank_len, self.fs, run.device).cpu().numpy()
        self.per_frame = (bvrnn_frame_flops(c["num_mels"], c["h_dim"], c["z_dim"])
                          + vocoder_frame_flops(c["vocoder_config"], c["num_mels"]))

    def _params(self, rng, seconds: float):
        L = int(round(seconds * self.fs))
        return {"L": L, "frames": 1 + (L - self.hop) // self.hop,
                "bits": int(rng.integers(self.traffic["bits"][0], self.traffic["bits"][1] + 1)),
                "row": int(rng.integers(0, self.bank.shape[0])),
                "off": int(rng.integers(0, self.bank_len - L + 1)),
                "sampled": bool(rng.random() < self.traffic["check_share"])}

    def params(self, j: int) -> dict:
        return self._params(closed.call_seed(self.run, j), closed.call_seconds(self.run, j))

    def warm_params(self, j: int) -> dict:
        return self._params(seeds.rng(self.run.seed, f"warm-{j}"), self.traffic["warm_s"])

    def audio(self, p) -> np.ndarray:
        return self.bank[p["row"], p["off"]: p["off"] + p["L"]]

    def open(self, eng, p):
        sid = eng.open_stream(p["bits"] * self.fs / self.hop)
        eng.push(sid, self.audio(p))
        eng.begin_flush(sid)
        return sid, p["frames"]

    def buffers(self, p) -> dict:
        return {"codes": np.empty((p["frames"], self.z), np.float32),
                "y": np.empty((p["frames"], self.hop), np.float32)}

    def keep(self, buf, call, res) -> None:
        buf["codes"][call["done"]], buf["y"][call["done"]] = res

    def item(self, p, buf) -> dict:
        return {"x": self.audio(p), "pad_to": p["L"], "bits": p["bits"], "codes": buf["codes"],
                "y": buf["y"].reshape(-1)}

    def flops(self, p, first: int, last: int) -> int:
        return (last - first) * self.per_frame

    def judge(self, items) -> dict:
        judge = Judge(self.run.conf, self.bvrnn, self.voc, self.run.device)
        judge.encode_items(items)
        return judge.numbers()


def run(run) -> dict:
    return closed.run(run, "ServingEngine", Plan(run))


def control(run, ctl: dict) -> tuple[dict, int]:
    """The reference in ``ctl['arith']`` on the inputs of the calls a run
    checks, judged as the program's ticks are."""
    plan = Plan(run, build=False)
    items = [{"x": plan.audio(p), "pad_to": p["L"], "bits": p["bits"]}
             for p in closed.control_calls(run, plan, ctl)]
    free.encode(ctl["arith"], plan.bvrnn, plan.voc, run.conf["codec"], items, run.device)
    return plan.judge(items), len(items)
