"""A closed loop over a serving engine's slots: every slot holds a call whose
whole input is queued when it opens; when a call has drained, it is closed
and the next call of the seeded plan opens in its slot at once, so every
tick advances every slot.

The kinds give the plan (how a call opens, its frames) and the loop keeps
the outputs of the calls the check samples.
"""

from __future__ import annotations

import time

DRAIN_S = 60.0  # the most seconds past the window spent finishing a checked call


class ClosedLoop:
    """``open_call(j) -> (sid, frames, sampled)`` opens call ``j`` (the j-th
    of the plan) in the engine; ``keep(call, out)`` stores one sampled
    call's output of a tick."""

    def __init__(self, eng, open_call, keep):
        self.eng, self.open_call, self.keep = eng, open_call, keep
        self.calls: dict[int, dict] = {}  # sid -> the call it holds
        self.finished: list[dict] = []
        self.next = 0
        self.opening = True

    def fill(self) -> None:
        """A call in every free slot."""
        while self.opening and len(self.calls) < self.eng.B:
            self._open()

    def _open(self) -> None:
        sid, frames, sampled = self.open_call(self.next)
        self.calls[sid] = {"j": self.next, "sid": sid, "left": frames, "frames": frames,
                           "sampled": sampled, "done": 0}
        self.next += 1

    def tick(self) -> tuple[float, int]:
        """One tick and its bookkeeping: (seconds of ``eng.tick()``, frames
        it advanced)."""
        t = time.perf_counter()
        out = self.eng.tick()
        dt = time.perf_counter() - t
        for sid, res in out.items():
            call = self.calls[sid]
            if call["sampled"]:
                self.keep(call, res)
            call["done"] += 1
            call["left"] -= 1
            if call["left"] == 0:
                if self.eng.has_frame(sid):
                    raise RuntimeError(f"call {call['j']} drained in {call['frames']} frames "
                                       "but its slot still has a frame")
                self.eng.close_stream(sid)
                del self.calls[sid]
                self.finished.append(call)
                if self.opening:
                    self._open()
        return dt, len(out)

    def drain(self, waiting) -> None:
        """Tick on, opening nothing, until ``waiting()`` is False or
        :data:`DRAIN_S` have passed."""
        self.opening = False
        t0 = time.perf_counter()
        while waiting() and self.calls and time.perf_counter() - t0 < DRAIN_S:
            self.tick()

