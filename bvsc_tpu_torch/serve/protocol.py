"""BVSP/1 — the serving wire protocol (shared client/server part).

A copy of ``bvsc_tpu/serve/protocol.py``, byte for byte the same wire
format, on the port's own bit packing (``bvsc_tpu_torch/ops/bitpack.py``):
a small, framed, little-endian binary protocol for streaming speech through
a :class:`bvsc_tpu_torch.serve.daemon.CodecDaemon` over TCP.  Code
payloads use the same first-k bit packing as ``.bvsc`` files.

This module imports numpy and the standard library only.

Framing
-------
Every message is ``<BI`` (type: u8, payload_len: u32, little-endian)
followed by ``payload_len`` bytes of payload.  Payload lengths are bounded
per type; an oversized or malformed message is a protocol error and the
peer closes the connection after an ``ERROR`` message.

Session
-------
One TCP connection == one stream.  The client opens with ``HELLO``
(magic ``b"BVSP"``, version 1, mode, bitrate) and the server answers
``OPENED`` (slot id, z_dim, hop).  Modes:

  * ``MODE_RESYNTH`` (0): float32 audio in -> float32 audio out
    (full encode -> decode -> vocoder chain, one slot of ``ServingEngine``),
  * ``MODE_ENCODE`` (1): float32 audio in -> packed binary codes out
    (``CODES`` messages, one 11.6 ms frame each),
  * ``MODE_DECODE`` (2): packed codes (+ ``LOST`` concealment requests) in
    -> float32 audio out (one slot of ``DecodeEngine``; the HELLO bitrate
    field is the concealment bit allocation, NaN = all prior bits).

Audio payloads are raw float32 samples at the codec rate (22.05 kHz for the
shipped configs); PCM conversion is the application's concern.  ``CODES``
payloads are ``<HB`` (frames: u16, bits_per_frame: u8) + the packed
first-k-priority bitstream produced by
:func:`bvsc_tpu_torch.ops.bitpack.pack_codes`.  A stream that negotiates
``FLAG_ENTROPY`` in its HELLO (echoed in ``OPENED``) carries its codes as
``CODES_ENT`` / ``CODES_ENT_OUT`` instead: the same ``<HB`` header and one
rANS payload against integer adaptive counts
(``bvsc_tpu_torch/serve/entropy_wire.py``).

The client half is :class:`bvsc_tpu_torch.serve.client.CodecClient`; the
server half is :class:`bvsc_tpu_torch.serve.daemon.CodecDaemon`.
"""

from __future__ import annotations

import math
import socket
import struct

import numpy as np

MAGIC = b"BVSP"
VERSION = 1

# client -> server
MSG_HELLO = 0x01
MSG_AUDIO = 0x02
MSG_CODES = 0x03
MSG_LOST = 0x04
MSG_SET_BITRATE = 0x05
MSG_CLOSE = 0x06
MSG_CODES_ENT = 0x07  # entropy-coded CODES (decode mode, negotiated)

# server -> client
MSG_OPENED = 0x81
MSG_CODES_OUT = 0x82
MSG_AUDIO_OUT = 0x83
MSG_CODES_ENT_OUT = 0x84  # entropy-coded CODES_OUT (encode mode, negotiated)
MSG_ERROR = 0xFF

MODE_RESYNTH = 0
MODE_ENCODE = 1
MODE_DECODE = 2

# HELLO/OPENED option flags (the optional 2-byte extension; see pack_hello)
FLAG_ENTROPY = 0x01  # adaptive entropy-coded code payloads (serve/entropy_wire.py)

_HDR = struct.Struct("<BI")
_HELLO = struct.Struct("<4sBBf")
_HELLO_EXT = struct.Struct("<BB")  # flags u8, entropy_block u8 (frames/msg)
_OPENED = struct.Struct("<HHH")  # sid u16 (slot counts up to 65535), z_dim, hop
_OPENED_EXT = struct.Struct("<B")  # accepted flags echo
_CODES_HDR = struct.Struct("<HB")

# one AUDIO message carries at most this many float32 samples (stays under
# MAX_PAYLOAD[MSG_AUDIO]); senders chunk transparently (TCP is a stream)
MAX_AUDIO_SAMPLES = 1 << 20

# per-type payload bounds (defense against hostile/corrupt peers)
MAX_PAYLOAD = {
    MSG_HELLO: _HELLO.size + _HELLO_EXT.size,
    MSG_AUDIO: 4 << 20,  # ~47 s of float32 audio per message
    MSG_CODES: 1 << 20,
    MSG_LOST: 2,
    MSG_SET_BITRATE: 4,
    MSG_CLOSE: 0,
    MSG_CODES_ENT: 1 << 20,
    MSG_OPENED: _OPENED.size + _OPENED_EXT.size,
    MSG_CODES_OUT: 1 << 20,
    MSG_AUDIO_OUT: 4 << 20,
    MSG_CODES_ENT_OUT: 1 << 20,
    MSG_ERROR: 4096,
}


class ProtocolError(ValueError):
    """Malformed or out-of-bounds BVSP message."""


def write_msg(sock: socket.socket, msg_type: int, payload: bytes = b"") -> None:
    sock.sendall(_HDR.pack(msg_type, len(payload)) + payload)


def read_exact(sock: socket.socket, n: int) -> bytes | None:
    """Read exactly n bytes; None on clean EOF at a message boundary."""
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            if not buf:
                return None
            raise ProtocolError("connection closed mid-message")
        buf += chunk
    return bytes(buf)


def read_msg(sock: socket.socket) -> tuple[int, bytes] | None:
    """Read one framed message; None on clean EOF."""
    hdr = read_exact(sock, _HDR.size)
    if hdr is None:
        return None
    msg_type, length = _HDR.unpack(hdr)
    limit = MAX_PAYLOAD.get(msg_type)
    if limit is None:
        raise ProtocolError(f"unknown message type 0x{msg_type:02x}")
    if length > limit:
        raise ProtocolError(
            f"payload of {length} B exceeds the {limit} B bound "
            f"for message type 0x{msg_type:02x}"
        )
    payload = read_exact(sock, length) if length else b""
    if length and payload is None:
        raise ProtocolError("connection closed mid-message")
    return msg_type, payload


def pack_hello(mode: int, bitrate: float | None, flags: int = 0,
               entropy_block: int = 8) -> bytes:
    """bitrate None (decode mode: conceal with all prior bits) -> NaN.

    flags/entropy_block: optional 2-byte extension (omitted when flags==0,
    so plain clients stay wire-compatible with v1 servers).  entropy_block
    is the server's encode-side aggregation (frames per CODES_ENT_OUT
    message; the rANS flush amortizes over it)."""
    if mode not in (MODE_RESYNTH, MODE_ENCODE, MODE_DECODE):
        raise ValueError(f"unknown mode {mode}")
    br = float("nan") if bitrate is None else float(bitrate)
    base = _HELLO.pack(MAGIC, VERSION, mode, br)
    if not flags:
        return base
    if not 1 <= entropy_block <= 255:
        raise ValueError("entropy_block must be in [1, 255]")
    return base + _HELLO_EXT.pack(flags, entropy_block)


def unpack_hello(payload: bytes) -> tuple[int, float | None, int, int]:
    """-> (mode, bitrate, flags, entropy_block); flags==0 for plain HELLO."""
    flags, block = 0, 8
    if len(payload) == _HELLO.size + _HELLO_EXT.size:
        flags, block = _HELLO_EXT.unpack(payload[_HELLO.size:])
        if block < 1:
            raise ProtocolError("bad entropy_block 0")
        payload = payload[: _HELLO.size]
    if len(payload) != _HELLO.size:
        raise ProtocolError("bad HELLO length")
    magic, version, mode, bitrate = _HELLO.unpack(payload)
    if magic != MAGIC:
        raise ProtocolError("bad magic (not a BVSP client)")
    if version != VERSION:
        raise ProtocolError(f"unsupported BVSP version {version}")
    if mode not in (MODE_RESYNTH, MODE_ENCODE, MODE_DECODE):
        raise ProtocolError(f"unknown mode {mode}")
    return mode, (None if math.isnan(bitrate) else bitrate), flags, block


def pack_opened(sid: int, z_dim: int, hop: int, flags: int = 0) -> bytes:
    base = _OPENED.pack(sid, z_dim, hop)
    return base + _OPENED_EXT.pack(flags) if flags else base


def unpack_opened(payload: bytes) -> tuple[int, int, int, int]:
    """-> (sid, z_dim, hop, accepted_flags)."""
    flags = 0
    if len(payload) == _OPENED.size + _OPENED_EXT.size:
        (flags,) = _OPENED_EXT.unpack(payload[_OPENED.size:])
        payload = payload[: _OPENED.size]
    if len(payload) != _OPENED.size:
        raise ProtocolError("bad OPENED length")
    return _OPENED.unpack(payload) + (flags,)


def pack_audio(samples: np.ndarray) -> bytes:
    # explicit little-endian: the wire format is LE regardless of host order
    x = np.asarray(samples).reshape(-1).astype("<f4", copy=False)
    return np.ascontiguousarray(x).tobytes()


def iter_audio_chunks(samples: np.ndarray):
    """Split samples into MSG_AUDIO-sized pieces (<= MAX_AUDIO_SAMPLES each);
    framing is stream-oriented, so chunking is invisible to the receiver."""
    x = np.asarray(samples).reshape(-1)
    if x.size == 0:
        yield x
        return
    for i in range(0, x.size, MAX_AUDIO_SAMPLES):
        yield x[i : i + MAX_AUDIO_SAMPLES]


def unpack_audio(payload: bytes) -> np.ndarray:
    if len(payload) % 4:
        raise ProtocolError("AUDIO payload not a multiple of 4 bytes")
    return np.frombuffer(payload, "<f4").astype(np.float32)


def pack_codes_msg(codes: np.ndarray, bits: int) -> bytes:
    """codes: (frames, z_dim) of {0,1} (0.5 in masked slots); bits: the
    integer per-frame allocation the first-k packing uses."""
    from bvsc_tpu_torch.ops.bitpack import pack_codes

    codes = np.asarray(codes, np.float32)
    frames = codes.shape[0]
    if frames > 0xFFFF:
        raise ValueError("at most 65535 frames per CODES message")
    if not 0 <= bits <= 0xFF:
        raise ValueError("bits must be in [0, 255]")
    return _CODES_HDR.pack(frames, bits) + pack_codes(codes, bits)


def unpack_codes_msg(payload: bytes, z_dim: int) -> tuple[np.ndarray, int]:
    """-> ((frames, z_dim) float32 codes with 0.5 midpoints, bits)."""
    from bvsc_tpu_torch.ops.bitpack import unpack_codes

    if len(payload) < _CODES_HDR.size:
        raise ProtocolError("bad CODES length")
    frames, bits = _CODES_HDR.unpack(payload[: _CODES_HDR.size])
    body = payload[_CODES_HDR.size :]
    try:
        codes = unpack_codes(body, float(bits), frames, z_dim)
    except ValueError as e:
        raise ProtocolError(str(e)) from e
    return codes, bits


def pack_codes_ent_msg(body: bytes, frames: int, bits: int) -> bytes:
    """Entropy-coded codes frame: same ``<HB`` header as CODES, body = one
    self-contained rANS payload (``bvsc_tpu_torch/serve/entropy_wire.py``) over the
    frames' first-``bits`` bits under the stream's adaptive model."""
    if not 0 <= frames <= 0xFFFF:
        raise ValueError("at most 65535 frames per CODES_ENT message")
    if not 0 <= bits <= 0xFF:
        raise ValueError("bits must be in [0, 255]")
    return _CODES_HDR.pack(frames, bits) + body


def unpack_codes_ent_msg(payload: bytes) -> tuple[int, int, bytes]:
    """-> (frames, bits, rANS body); the caller decodes with its stream
    coder (the body is stateful — blocks must be decoded in order)."""
    if len(payload) < _CODES_HDR.size:
        raise ProtocolError("bad CODES_ENT length")
    frames, bits = _CODES_HDR.unpack(payload[: _CODES_HDR.size])
    return frames, bits, payload[_CODES_HDR.size:]


def pack_u16(n: int) -> bytes:
    return struct.pack("<H", n)


def unpack_u16(payload: bytes) -> int:
    if len(payload) != 2:
        raise ProtocolError("bad u16 payload")
    return struct.unpack("<H", payload)[0]


def pack_f32(v: float) -> bytes:
    return struct.pack("<f", v)


def unpack_f32(payload: bytes) -> float:
    if len(payload) != 4:
        raise ProtocolError("bad f32 payload")
    return struct.unpack("<f", payload)[0]
