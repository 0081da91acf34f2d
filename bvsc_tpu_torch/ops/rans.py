"""Binary rANS entropy coder.

Port of ``bvsc_tpu/ops/rans.py``, byte for byte the same streams: a ctypes
wrapper around the port's own ``bvsc_tpu_torch/native/rans.c`` (a copy of
``bvsc_tpu``'s), compiled on first use with ``cc`` into
``bvsc_tpu_torch/_build/`` (``ops._cc``), with a numpy mirror that produces
byte-identical streams when there is no C compiler.  Probabilities are
uint16 P(bit==1) on a 2^16 scale, clamped to [16, 65520] by
:func:`quantize_probs`; encoder and decoder must see bit-identical values
(``bvsc_tpu_torch/entropy.py`` computes both sides' priors in one fixed
float64 order on the host; ``serve/entropy_wire.py`` uses integer counts).

The decoder is *streaming*: :class:`RansDecoder` yields bits in forward
order as per-frame probabilities become available, which the prior
P(z_t | h_t) needs, since it is computable only after z_{<t} are decoded.
"""

from __future__ import annotations

import ctypes

import numpy as np

from bvsc_tpu_torch.ops import _cc

RANS_L = 1 << 23
PROB_SCALE = 1 << 16
# Worst-case ~12.04 bits/symbol at the [16, 65520] clamp, + 4 flush bytes.
_CAP_PER_BIT = 2

_SRC = _cc.source("rans")
_lib = None
_tried = False


def _load_native():
    """Compile rans.c (``ops._cc``) and load it; None when there is no C
    compiler (the numpy mirror)."""
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    lib = _cc.load("rans")
    if lib is not None:
        u8p = ctypes.POINTER(ctypes.c_uint8)
        u16p = ctypes.POINTER(ctypes.c_uint16)
        u64p = ctypes.POINTER(ctypes.c_uint64)
        lib.bvsc_rans_encode.restype = ctypes.c_long
        lib.bvsc_rans_encode.argtypes = [u8p, u16p, ctypes.c_long, u8p, ctypes.c_long]
        lib.bvsc_rans_dec_init.restype = ctypes.c_long
        lib.bvsc_rans_dec_init.argtypes = [u8p, ctypes.c_long, u64p]
        lib.bvsc_rans_dec_bits.restype = ctypes.c_long
        lib.bvsc_rans_dec_bits.argtypes = [u8p, ctypes.c_long, u64p, u16p,
                                           ctypes.c_long, u8p]
    _lib = lib
    return _lib


def quantize_probs(p1: np.ndarray) -> np.ndarray:
    """float P(bit==1) -> uint16 on the 2^16 scale, clamped to [16, 65520].

    The clamp bounds both symbols' frequencies away from zero so a
    confidently-wrong prior costs at most ~12 bits, and the coder never
    sees a zero-frequency symbol.  Must be applied identically on both
    sides (it is part of the entropy model)."""
    q = np.rint(np.asarray(p1, np.float64) * PROB_SCALE)
    return np.clip(q, 16, PROB_SCALE - 16).astype(np.uint16)


def _check(p1: np.ndarray) -> np.ndarray:
    p1 = np.ascontiguousarray(p1, np.uint16)
    if p1.size and (p1.min() < 1 or p1.max() > PROB_SCALE - 1):
        raise ValueError("probabilities must be in [1, 65535]")
    return p1


def rans_encode(bits: np.ndarray, p1: np.ndarray) -> bytes:
    """Encode flat {0,1} bits against per-bit uint16 P(bit==1)."""
    bits = np.ascontiguousarray(np.asarray(bits).reshape(-1), np.uint8)
    p1 = _check(np.asarray(p1).reshape(-1))
    if bits.shape != p1.shape:
        raise ValueError(f"bits {bits.shape} vs probs {p1.shape}")
    n = bits.size
    cap = _CAP_PER_BIT * n + 16
    lib = _load_native()
    if lib is not None:
        out = np.empty(cap, np.uint8)
        w = lib.bvsc_rans_encode(
            bits.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            p1.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
            n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), cap,
        )
        if w < 0:  # pragma: no cover - cap covers the worst case
            raise ValueError("rANS capacity exceeded")
        return out[:w].tobytes()
    # numpy mirror (identical integer arithmetic)
    x = RANS_L
    out = bytearray()
    for i in range(n - 1, -1, -1):
        f1 = int(p1[i])
        if bits[i]:
            f, c = f1, PROB_SCALE - f1
        else:
            f, c = PROB_SCALE - f1, 0
        x_max = f << 15
        while x >= x_max:
            out.append(x & 0xFF)
            x >>= 8
        x = ((x // f) << 16) + (x % f) + c
    for _ in range(4):
        out.append(x & 0xFF)
        x >>= 8
    out.reverse()
    return bytes(out)


class RansDecoder:
    """Forward-streaming binary rANS decoder.

    Call :meth:`decode_bits` once per frame with that frame's quantised
    probabilities; call :meth:`finish` after the last frame to verify the
    stream fully and exactly unwinds to the encoder's initial state (a
    cheap integrity check on the whole payload)."""

    def __init__(self, payload: bytes):
        self._buf = np.frombuffer(payload, np.uint8)
        if self._buf.size < 4:
            raise ValueError("rANS payload shorter than the 4-byte state")
        self._lib = _load_native()
        if self._lib is not None:
            self._st = np.zeros(2, np.uint64)
            rc = self._lib.bvsc_rans_dec_init(
                self._buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                self._buf.size,
                self._st.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            )
            if rc < 0:  # pragma: no cover - size checked above
                raise ValueError("rANS payload truncated")
        else:
            b = self._buf
            self._x = (int(b[0]) << 24) | (int(b[1]) << 16) | (int(b[2]) << 8) | int(b[3])
            self._pos = 4

    def decode_bits(self, p1: np.ndarray) -> np.ndarray:
        """Decode len(p1) bits; p1 = per-bit uint16 P(bit==1)."""
        p1 = _check(np.asarray(p1).reshape(-1))
        k = p1.size
        out = np.empty(k, np.uint8)
        if self._lib is not None:
            rc = self._lib.bvsc_rans_dec_bits(
                self._buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                self._buf.size,
                self._st.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
                p1.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
                k, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            )
            if rc < 0:
                raise ValueError("rANS payload truncated")
            return out
        x, pos, buf = self._x, self._pos, self._buf
        for i in range(k):
            f1 = int(p1[i])
            f0 = PROB_SCALE - f1
            slot = x & 0xFFFF
            bit = slot >= f0
            f, c = (f1, f0) if bit else (f0, 0)
            x = f * (x >> 16) + slot - c
            while x < RANS_L:
                if pos >= buf.size:
                    raise ValueError("rANS payload truncated")
                x = (x << 8) | int(buf[pos])
                pos += 1
            out[i] = bit
        self._x, self._pos = x, pos
        return out

    def finish(self) -> None:
        """Verify the stream unwound exactly to the encoder's start state."""
        if self._lib is not None:
            x, pos = int(self._st[0]), int(self._st[1])
        else:
            x, pos = self._x, self._pos
        if x != RANS_L or pos != self._buf.size:
            raise ValueError(
                "corrupt rANS payload: decoder state/position did not "
                f"unwind (x={x:#x}, consumed {pos}/{self._buf.size} B)"
            )
