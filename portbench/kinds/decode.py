"""Decode-only serving with packet loss: ``DecodeEngine.tick``, closed loop.

Traffic keys: ``slots``; ``call_s`` ([low, high] seconds of a call's audio,
spread as for ``serve``); ``bits`` ([low, high] bits a frame, one draw a
call); ``loss`` (the mean share of frames lost) and ``burst`` (the mean
frames a loss lasts): a two-state Markov chain per call, started in its
stationary state; ``warm_calls``, ``warm_s``, ``warm_ticks``,
``check_share``, ``check_max``, ``split_ticks``, ``profile_ticks`` as for
``serve``.

A call's codes are seeded random bits on its first ``bits`` bits, 0.5 past
them, all queued when it opens; lost frames reach the engine as lost, and it
conceals them from the prior, masked to the call's bits.  The check holds
each sampled call's audio against the reference's decode of the same codes
and losses.
"""

from __future__ import annotations

import numpy as np

from portbench.counts import bvrnn_frame_flops, prior_flops, vocoder_frame_flops
from portbench.lib import closed, program, seeds
from portbench.lib.weights import make_weights
from portbench.reference import free
from portbench.reference.compare import Judge


def markov_losses(rng: np.random.Generator, frames: int, loss: float, burst: float) -> np.ndarray:
    """(frames,) 0/1 losses: lost runs of mean ``burst`` frames, received
    runs of mean ``burst * (1 - loss) / loss``, alternating, the first run
    lost with probability ``loss``."""
    mean = {1: burst, 0: burst * (1 - loss) / loss}
    out, state, n = [], int(rng.random() < loss), 0
    while n < frames:
        run = int(rng.geometric(1 / mean[state]))
        out.append(np.full(min(run, frames - n), state, np.float32))
        n += run
        state = 1 - state
    return np.concatenate(out)


class Plan:
    KIND = "decode"

    def __init__(self, run, build: bool = True):
        """``build``: the program too (a control reads the plan alone)."""
        self.run = run
        conf, traffic = run.conf, run.traffic
        c = conf["codec"]
        self.fs, self.hop, self.z = c["fs"], c["hopsize"], c["z_dim"]
        self.traffic = traffic
        self.bvrnn, self.voc = make_weights(c, run.seed, run.device)
        self.codec = program.build_codec(conf, self.bvrnn, self.voc, run.device) if build else None
        self.per_frame = (bvrnn_frame_flops(c["num_mels"], c["h_dim"], c["z_dim"], encode=False)
                          + vocoder_frame_flops(c["vocoder_config"], c["num_mels"]))
        self.per_lost = prior_flops(c["h_dim"], c["z_dim"])

    def _params(self, rng, seconds: float):
        t = self.traffic
        frames = int(round(seconds * self.fs / self.hop))
        bits = int(rng.integers(t["bits"][0], t["bits"][1] + 1))
        codes = (rng.random((frames, self.z)) < 0.5).astype(np.float32)
        codes[:, bits:] = 0.5
        lost = markov_losses(rng, frames, t["loss"], t["burst"])
        return {"frames": frames, "bits": bits, "codes": codes, "lost": lost,
                "lost_before": np.concatenate([[0], np.cumsum(lost)]),
                "sampled": bool(rng.random() < t["check_share"])}

    def params(self, j: int) -> dict:
        return self._params(closed.call_seed(self.run, j), closed.call_seconds(self.run, j))

    def warm_params(self, j: int) -> dict:
        return self._params(seeds.rng(self.run.seed, f"warm-{j}"), self.traffic["warm_s"])

    def open(self, eng, p):
        sid = eng.open_stream(conceal_bitrate=p["bits"] * self.fs / self.hop)
        eng.push(sid, p["codes"], p["lost"])
        return sid, p["frames"]

    def buffers(self, p) -> dict:
        return {"y": np.empty((p["frames"], self.hop), np.float32)}

    def keep(self, buf, call, res) -> None:
        buf["y"][call["done"]] = res

    def item(self, p, buf) -> dict:
        return {"codes": p["codes"], "lost": p["lost"], "conceal_bits": p["bits"],
                "y": buf["y"].reshape(-1)}

    def flops(self, p, first: int, last: int) -> int:
        lost = p["lost_before"][last] - p["lost_before"][first]
        return int((last - first) * self.per_frame + lost * self.per_lost)

    def judge(self, items) -> dict:
        judge = Judge(self.run.conf, self.bvrnn, self.voc, self.run.device)
        judge.decode_items(items)
        return judge.numbers()


def run(run) -> dict:
    return closed.run(run, "DecodeEngine", Plan(run))


def control(run, ctl: dict) -> tuple[dict, int]:
    """The reference's decode in ``ctl['arith']`` of the codes and losses of
    the calls a run checks, judged as the program's ticks are."""
    plan = Plan(run, build=False)
    items = [{"codes": p["codes"], "lost": p["lost"], "conceal_bits": p["bits"]}
             for p in closed.control_calls(run, plan, ctl)]
    free.decode(ctl["arith"], plan.bvrnn, plan.voc, run.conf["codec"], items, run.device)
    return plan.judge(items), len(items)
