"""Adaptive entropy coding for BVSP code payloads (the wire option).

Port of ``bvsc_tpu/serve/entropy_wire.py``, byte for byte the same
payloads: the model is integer counts only, so the two packages' coders
agree on any machine.  Codes are sent raw at k bits/frame unless a stream
negotiates ``FLAG_ENTROPY`` (``serve/protocol.py``).  The codes can be far
from incompressible: the Bernoulli-KL training objective leaves bit
positions biased, so an order-0 adaptive model captures real redundancy,
but how much depends on the model (``bvsc_tpu``'s own measurement,
``docs/artifacts/entropy_wire_stats.json``, 8-frame blocks: 74-77 % on an
overfit checkpoint, 21-33 % at 3-5.5 kbps on a healthier one, and negative
at 1.38 kbps there, where the ~4-byte per-block rANS flush exceeds the
savings).  Treat savings as opportunistic.

Design constraints (why this is not the prior coder of
``bvsc_tpu_torch/entropy.py``):

* **Model-free**: the receiving end of an encode stream (and the sending
  end of a decode stream) is a thin client, numpy and the standard library
  or the native C binary, with no BVRNN weights; per-position adaptive
  counts need 2 x z_dim integers.
* **Machine-independent determinism**: both ends run integer arithmetic
  only (Krichevsky-Trofimov-style counts, fixed halving), so the
  probability model is bit-identical across architectures.
* **Loss-robust by construction**: the model state advances only over
  frames carried in entropy messages.  BVSP rides TCP, so both ends always
  see the same message sequence; upstream losses are reported with
  ``LOST``, which carries no bits and touches no coder state.

Per-message framing: each ``CODES_ENT``/``CODES_ENT_OUT`` message is one
self-contained rANS payload (``ops/rans.py``) over its frames' first-k
bits; the adaptive counts persist across messages within a stream.  The
~4-byte rANS flush amortizes over the daemon's ``entropy_block`` frames
per message (default 8 = 93 ms aggregation on the encode side; decode-mode
clients choose their own message granularity).
"""

from __future__ import annotations

import numpy as np

from bvsc_tpu_torch.ops import rans

# probability clamp mirrors rans.quantize_probs ([16, 65520] on 2^16)
_PMIN, _PMAX = 16, (1 << 16) - 16
# halve counts when their sum reaches this (exponential forgetting; bounds
# the integers and tracks slow drift in the code statistics)
_HALVE_AT = 1024


class AdaptiveBitModel:
    """Per-position adaptive binary probability model (integer KT counts).

    Deterministic integer arithmetic only: encoder and decoder mirrors
    stay bit-identical on any architecture.  One instance per direction
    per stream.
    """

    def __init__(self, n_pos: int):
        self.c0 = np.ones(n_pos, np.uint32)
        self.c1 = np.ones(n_pos, np.uint32)

    def probs_q16(self, k: int) -> np.ndarray:
        """uint16 P(bit==1) on the 2^16 scale for positions [0, k)."""
        c0 = self.c0[:k].astype(np.uint64)
        c1 = self.c1[:k].astype(np.uint64)
        p = (c1 << 16) // (c0 + c1)
        return np.clip(p, _PMIN, _PMAX).astype(np.uint16)

    def update(self, bits: np.ndarray, k: int) -> None:
        """Account one frame's first-k bits (uint8 {0,1})."""
        b = bits[:k].astype(np.uint32)
        self.c1[:k] += b
        self.c0[:k] += 1 - b
        tot = self.c0[:k] + self.c1[:k]
        halve = tot >= _HALVE_AT
        if halve.any():
            # +1 before the shift keeps counts >= 1
            self.c0[:k] = np.where(halve, (self.c0[:k] + 1) >> 1, self.c0[:k])
            self.c1[:k] = np.where(halve, (self.c1[:k] + 1) >> 1, self.c1[:k])


class AdaptiveCodesCoder:
    """Stateful encode/decode of code-frame blocks against the adaptive
    model.  The counts advance across calls: both ends must process the
    same block sequence (BVSP/TCP guarantees this within a stream)."""

    def __init__(self, z_dim: int):
        self.z_dim = z_dim
        self.model = AdaptiveBitModel(z_dim)

    def encode_block(self, codes: np.ndarray, bits: int) -> bytes:
        """codes: (frames, z_dim) float {0,1} with 0.5 midpoints; bits: the
        per-frame allocation k.  Returns one self-contained rANS payload."""
        codes = np.asarray(codes, np.float32)
        frames = codes.shape[0]
        k = int(bits)
        hard = (codes[:, :k] > 0.5 + 1e-6).astype(np.uint8)
        if k == 0 or frames == 0:
            return b""
        flat_bits, flat_probs = [], []
        for t in range(frames):
            flat_probs.append(self.model.probs_q16(k))
            flat_bits.append(hard[t])
            self.model.update(hard[t], k)
        return rans.rans_encode(
            np.concatenate(flat_bits), np.concatenate(flat_probs)
        )

    def decode_block(self, payload: bytes, frames: int, bits: int) -> np.ndarray:
        """Inverse of :meth:`encode_block`: (frames, z_dim) float32 codes
        with 0.5 midpoints.  Raises ``ValueError`` on truncated/corrupt
        payloads (rANS state-unwind check)."""
        k = int(bits)
        out = np.full((frames, self.z_dim), 0.5, np.float32)
        if k == 0 or frames == 0:
            if payload:
                raise ValueError("nonempty payload for zero transmitted bits")
            return out
        dec = rans.RansDecoder(payload)
        for t in range(frames):
            row = dec.decode_bits(self.model.probs_q16(k))
            out[t, :k] = row
            self.model.update(row, k)
        dec.finish()
        return out
