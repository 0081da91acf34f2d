"""Bitstream packing of binary codes (wire format).

Port of ``bvsc_tpu/ops/bitpack.py``, byte for byte the same format: packs
the first-k priority bits of each frame into a contiguous little-endian
bitstream (k bits per 11.6 ms frame = the actual transmitted payload).  Uses
the port's own C source (``bvsc_tpu_torch/native/bitpack.c``), compiled on
first use with ``cc`` into ``bvsc_tpu_torch/_build/`` (``ops._cc``), with a
pure-numpy fallback when no C compiler is there.

Both paths validate the payload length before touching native memory:
``unpack_codes`` raises ``ValueError`` on a truncated payload instead of
reading out of bounds, and negative bit counts are clamped to zero.
"""

from __future__ import annotations

import ctypes

import numpy as np

from bvsc_tpu_torch.ops import _cc

_SRC = _cc.source("bitpack")
BUILD_DIR = _cc.BUILD_DIR
_lib = None
_tried = False


def _load_native():
    """Compile bitpack.c (``ops._cc``) and load it; None when there is no C
    compiler."""
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    lib = _cc.load("bitpack")
    if lib is not None:
        lib.bvsc_pack.restype = ctypes.c_long
        lib.bvsc_pack.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_long, ctypes.c_long, ctypes.POINTER(ctypes.c_uint8),
        ]
        lib.bvsc_unpack.restype = ctypes.c_long
        lib.bvsc_unpack.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_long,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_long, ctypes.c_long, ctypes.POINTER(ctypes.c_float),
        ]
    _lib = lib
    return _lib


def _as_bits(bits_per_frame, frames: int) -> np.ndarray:
    # ceil, not truncate: the model's bit mask transmits every bit index
    # strictly below the (possibly fractional) allocation
    # (models.bvrnn.bit_mask_from_bitrate uses ``>``): 34.8 bits -> 35 bits
    bits = np.ceil(np.asarray(bits_per_frame, np.float64)).astype(np.int32)
    if bits.ndim == 0:
        bits = np.full(frames, int(bits), np.int32)
    if bits.shape != (frames,):
        raise ValueError(f"bits_per_frame shape {bits.shape} != ({frames},)")
    return np.ascontiguousarray(np.clip(bits, 0, None))


def _total_bits(bits_per_frame, frames: int, z_dim: int) -> int:
    """Total transmitted bits, without a per-frame array for scalar
    allocations (an untrusted multi-GB ``frames`` header must be rejectable
    without a proportional allocation)."""
    bits = np.ceil(np.asarray(bits_per_frame, np.float64)).astype(np.int64)
    if bits.ndim == 0:
        return max(0, min(int(bits), z_dim)) * frames
    if bits.shape != (frames,):
        raise ValueError(f"bits_per_frame shape {bits.shape} != ({frames},)")
    return int(np.minimum(np.clip(bits, 0, None), z_dim).sum())


def payload_nbytes(bits_per_frame, frames: int, z_dim: int) -> int:
    """Exact packed-payload size for a given bit allocation."""
    return (_total_bits(bits_per_frame, frames, z_dim) + 7) // 8


def pack_codes(codes: np.ndarray, bits_per_frame) -> bytes:
    """codes: (frames, z_dim) of {0,1} (0.5 midpoints allowed in masked
    positions); bits_per_frame: scalar or (frames,).  Returns the packed
    payload (ceil(sum(k)/8) bytes)."""
    codes = np.ascontiguousarray(np.asarray(codes), np.float32)
    frames, z_dim = codes.shape
    bits = _as_bits(bits_per_frame, frames)
    hard = (codes > 0.5 + 1e-6).astype(np.uint8)
    total_bits = int(np.minimum(bits, z_dim).sum())
    out = np.zeros((total_bits + 7) // 8, np.uint8)
    lib = _load_native()
    if lib is not None:
        n = lib.bvsc_pack(
            np.ascontiguousarray(hard).ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            bits.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            frames, z_dim, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        )
        return out[:n].tobytes()
    flat = np.concatenate(
        [hard[t, : min(int(bits[t]), z_dim)] for t in range(frames)]
    ) if frames else np.zeros(0, np.uint8)
    return np.packbits(flat, bitorder="little").tobytes()


def unpack_codes(payload: bytes, bits_per_frame, frames: int, z_dim: int) -> np.ndarray:
    """Inverse of :func:`pack_codes`: (frames, z_dim) float32 with 0.5 in
    untransmitted positions.  Raises ``ValueError`` if the payload is too
    short for the requested bit allocation (native and numpy paths agree);
    the length check runs before any frames-proportional allocation."""
    total_bits = _total_bits(bits_per_frame, frames, z_dim)
    buf = np.frombuffer(payload, np.uint8)
    if buf.size * 8 < total_bits:
        raise ValueError(
            f"payload too short: {buf.size} B < {(total_bits + 7) // 8} B "
            f"needed for {frames} frames"
        )
    bits = _as_bits(bits_per_frame, frames)
    out = np.empty((frames, z_dim), np.float32)
    lib = _load_native()
    if lib is not None:
        rc = lib.bvsc_unpack(
            np.ascontiguousarray(buf).ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            buf.size,
            bits.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            frames, z_dim, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        )
        if rc < 0:  # defense in depth; the length check above already caught it
            raise ValueError("payload too short for requested bit allocation")
        return out
    flat = np.unpackbits(buf, bitorder="little")
    out[:] = 0.5
    pos = 0
    for t in range(frames):
        k = min(int(bits[t]), z_dim)
        out[t, :k] = flat[pos: pos + k]
        pos += k
    return out
