"""BVSP/1 client: talk to a :class:`bvsc_tpu_torch.serve.daemon.CodecDaemon`.

A copy of ``bvsc_tpu/serve/client.py`` on the port's protocol
(``bvsc_tpu_torch/serve/protocol.py``); either client talks to either
daemon.  The module itself imports numpy, the standard library and the
port's protocol and wire coder, which import nothing more.
One client == one stream.

Example (full resynthesis round trip)::

    from bvsc_tpu_torch.serve.client import CodecClient

    with CodecClient(host, port, mode="resynth", bitrate=3000) as c:
        c.send_audio(samples)          # float32 at the codec rate
        c.close_input()                # half-close: drain what's queued
        audio = c.drain()["audio"]     # everything the stream produced

Modes: ``resynth`` (audio -> audio), ``encode`` (audio -> packed code
frames), ``decode`` (packed code frames / loss reports -> audio).  With
``entropy=True`` (encode and decode modes) the code payloads travel
rANS-coded against integer adaptive counts (``serve/entropy_wire.py``),
transparently at this API.
"""

from __future__ import annotations

import socket

import numpy as np

from bvsc_tpu_torch.serve import protocol as P
from bvsc_tpu_torch.serve.entropy_wire import AdaptiveCodesCoder

_MODES = {"resynth": P.MODE_RESYNTH, "encode": P.MODE_ENCODE,
          "decode": P.MODE_DECODE}


class ServerError(RuntimeError):
    """The daemon reported a protocol error and closed the stream."""


class CodecClient:
    def __init__(self, host: str, port: int, mode: str = "resynth",
                 bitrate: float | None = 3000.0, timeout: float = 600.0,
                 entropy: bool = False, entropy_block: int = 8):
        """mode: 'resynth' | 'encode' | 'decode'.  bitrate: stream bps for
        encode/resynth; for decode it is the PLC concealment allocation
        (None = conceal with all prior bits).

        entropy: negotiate adaptive entropy coding of the code payloads
        (encode/decode modes; ``serve/entropy_wire.py``: integer-adaptive,
        model-free, so this client stays numpy and the standard library).
        Transparent at the API: recv()/drain() still yield plain code
        frames; send_codes() still takes them.  entropy_block sets the
        server's encode-side aggregation (frames per message; the rANS
        flush amortizes over it, at block x 11.6 ms added batching
        latency).  Payload accounting in ``entropy_stats``.

        timeout is the socket deadline for every blocking call.  The
        default is generous: the port's daemon builds its kernels when its
        engines are built, before it listens, but a first tick on a cold
        host can still take seconds."""
        if mode not in _MODES:
            raise ValueError(f"mode must be one of {sorted(_MODES)}")
        if entropy and mode == "resynth":
            raise ValueError("entropy coding applies to encode/decode modes")
        self.mode = mode
        self.entropy = bool(entropy)
        self._coder = None
        self.entropy_stats = {"raw_payload_bytes": 0, "wire_payload_bytes": 0}
        self.sock = socket.create_connection((host, port), timeout=timeout)
        try:
            self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._input_closed = False
            P.write_msg(self.sock, P.MSG_HELLO,
                        P.pack_hello(_MODES[mode], bitrate,
                                     flags=P.FLAG_ENTROPY if entropy else 0,
                                     entropy_block=entropy_block))
            msg = self._recv()
            if msg is None:
                raise ServerError("server closed the connection during handshake")
            msg_type, payload = msg
            if msg_type != P.MSG_OPENED:
                raise ServerError("handshake failed")
            self.sid, self.z_dim, self.hop, flags = P.unpack_opened(payload)
            if entropy and not flags & P.FLAG_ENTROPY:
                raise ServerError("server did not accept entropy coding")
            if entropy:
                self._coder = AdaptiveCodesCoder(self.z_dim)
        except BaseException:
            self.sock.close()  # no fd leak when the handshake is rejected
            raise

    # -- sending ----------------------------------------------------------------

    def send_audio(self, samples: np.ndarray) -> None:
        """float32 samples at the codec rate (encode/resynth modes); any
        length, split into protocol-sized messages."""
        for chunk in P.iter_audio_chunks(samples):
            P.write_msg(self.sock, P.MSG_AUDIO, P.pack_audio(chunk))

    def send_codes(self, codes: np.ndarray, bits: int) -> None:
        """codes: (frames, z_dim) of {0,1} (0.5 in masked slots); bits: the
        integer per-frame allocation (decode mode).  With negotiated
        entropy coding each call becomes one rANS block (the caller's
        message granularity is the aggregation unit)."""
        if self._coder is not None:
            codes = np.asarray(codes, np.float32)
            body = self._coder.encode_block(codes, bits)
            self.entropy_stats["raw_payload_bytes"] += (codes.shape[0] * bits + 7) // 8
            self.entropy_stats["wire_payload_bytes"] += len(body)
            P.write_msg(self.sock, P.MSG_CODES_ENT,
                        P.pack_codes_ent_msg(body, codes.shape[0], bits))
            return
        P.write_msg(self.sock, P.MSG_CODES, P.pack_codes_msg(codes, bits))

    def send_lost(self, n: int = 1) -> None:
        """Report n frames lost in transit: the server decodes them from the
        model's own prior (packet-loss concealment), no output gap."""
        P.write_msg(self.sock, P.MSG_LOST, P.pack_u16(n))

    def set_bitrate(self, bitrate: float) -> None:
        """Mid-stream bitrate switch (encode/resynth modes)."""
        P.write_msg(self.sock, P.MSG_SET_BITRATE, P.pack_f32(bitrate))

    def close_input(self) -> None:
        """No more input: the server drains queued frames, sends their
        output, then closes the connection (read it with drain())."""
        if not self._input_closed:
            P.write_msg(self.sock, P.MSG_CLOSE)
            self._input_closed = True

    # -- receiving --------------------------------------------------------------

    def _recv(self):
        msg = P.read_msg(self.sock)
        if msg is not None and msg[0] == P.MSG_ERROR:
            raise ServerError(msg[1].decode(errors="replace"))
        return msg

    def recv(self):
        """One output item, or None when the server has closed the stream.

        -> ('audio', (n,) float32) or ('codes', ((1, z_dim) float32, bits)).
        """
        msg = self._recv()
        if msg is None:
            return None
        msg_type, payload = msg
        if msg_type == P.MSG_AUDIO_OUT:
            return "audio", P.unpack_audio(payload)
        if msg_type == P.MSG_CODES_OUT:
            return "codes", P.unpack_codes_msg(payload, self.z_dim)
        if msg_type == P.MSG_CODES_ENT_OUT:
            if self._coder is None:
                raise ServerError("CODES_ENT_OUT without negotiated entropy")
            frames, bits, body = P.unpack_codes_ent_msg(payload)
            try:
                codes = self._coder.decode_block(body, frames, bits)
            except ValueError as e:
                raise ServerError(f"corrupt entropy payload: {e}") from e
            self.entropy_stats["raw_payload_bytes"] += (frames * bits + 7) // 8
            self.entropy_stats["wire_payload_bytes"] += len(body)
            return "codes", (codes, bits)
        raise ServerError(f"unexpected message 0x{msg_type:02x}")

    def drain(self) -> dict:
        """Read until the server closes; aggregate all output.

        -> {'audio': (n,) float32, 'codes': (frames, z_dim) float32,
            'bits': list[int]}.
        """
        audio, codes, bits = [], [], []
        while True:
            item = self.recv()
            if item is None:
                break
            kind, value = item
            if kind == "audio":
                audio.append(value)
            else:
                frame, b = value
                codes.append(frame)
                bits.append(b)
        return {
            "audio": np.concatenate(audio) if audio else np.zeros(0, np.float32),
            "codes": (np.concatenate(codes, axis=0) if codes
                      else np.zeros((0, self.z_dim), np.float32)),
            "bits": bits,
        }

    # -- lifecycle ----------------------------------------------------------------

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
