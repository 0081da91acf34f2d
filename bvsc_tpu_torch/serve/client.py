"""BVSP/1 client: talk to a :class:`bvsc_tpu_torch.serve.daemon.CodecDaemon`.

A copy of ``bvsc_tpu/serve/client.py`` on the port's protocol
(``bvsc_tpu_torch/serve/protocol.py``); either client talks to either
daemon.  The module itself imports numpy and the standard library only.
One client == one stream.

Example (full resynthesis round trip)::

    from bvsc_tpu_torch.serve.client import CodecClient

    with CodecClient(host, port, mode="resynth", bitrate=3000) as c:
        c.send_audio(samples)          # float32 at the codec rate
        c.close_input()                # half-close: drain what's queued
        audio = c.drain()["audio"]     # everything the stream produced

Modes: ``resynth`` (audio -> audio), ``encode`` (audio -> packed code
frames), ``decode`` (packed code frames / loss reports -> audio).  The
entropy-coded wire option is not ported yet (``ROADMAP.md``, queue 1,
item 8): ``entropy=True`` raises NotImplementedError.
"""

from __future__ import annotations

import socket

import numpy as np

from bvsc_tpu_torch.serve import protocol as P

_MODES = {"resynth": P.MODE_RESYNTH, "encode": P.MODE_ENCODE,
          "decode": P.MODE_DECODE}


class ServerError(RuntimeError):
    """The daemon reported a protocol error and closed the stream."""


class CodecClient:
    def __init__(self, host: str, port: int, mode: str = "resynth",
                 bitrate: float | None = 3000.0, timeout: float = 600.0,
                 entropy: bool = False):
        """mode: 'resynth' | 'encode' | 'decode'.  bitrate: stream bps for
        encode/resynth; for decode it is the PLC concealment allocation
        (None = conceal with all prior bits).

        entropy: the entropy-coded wire option of ``bvsc_tpu``'s client;
        not ported yet, ``entropy=True`` raises NotImplementedError.

        timeout is the socket deadline for every blocking call.  The
        default is generous: the port's daemon builds its kernels when its
        engines are built, before it listens, but a first tick on a cold
        host can still take seconds."""
        if mode not in _MODES:
            raise ValueError(f"mode must be one of {sorted(_MODES)}")
        if entropy:
            raise NotImplementedError(
                "entropy-coded payloads are not ported yet; they come with "
                "ROADMAP.md, queue 1, item 8")
        self.mode = mode
        self.sock = socket.create_connection((host, port), timeout=timeout)
        try:
            self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._input_closed = False
            P.write_msg(self.sock, P.MSG_HELLO, P.pack_hello(_MODES[mode], bitrate))
            msg = self._recv()
            if msg is None:
                raise ServerError("server closed the connection during handshake")
            msg_type, payload = msg
            if msg_type != P.MSG_OPENED:
                raise ServerError("handshake failed")
            self.sid, self.z_dim, self.hop, _ = P.unpack_opened(payload)
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
        integer per-frame allocation (decode mode)."""
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
