"""BVSP/1 TCP serving daemon: the network face of the batched engines.

Port of ``bvsc_tpu/serve/daemon.py``.  A TCP server that multiplexes many
client connections onto the fixed-shape batched state of
:class:`bvsc_tpu_torch.serve.engine.ServingEngine` (encode and
full-resynthesis streams) and :class:`~bvsc_tpu_torch.serve.engine.DecodeEngine`
(decode-only streams with packet-loss concealment).  One connection == one
stream slot; a tick advances every stream with a full frame queued in one
batched step per engine, however many clients are connected.

Wire protocol: ``bvsc_tpu_torch/serve/protocol.py`` (framed little-endian
binary, the same bytes as ``bvsc_tpu``'s; code payloads use the first-k bit
packing of ``.bvsc`` files, or, for a stream that negotiates
``FLAG_ENTROPY``, the adaptive rANS coding of ``serve/entropy_wire.py``).
Clients: ``bvsc_tpu_torch/serve/client.py``, ``bvsc_tpu``'s own Python
client and its native C client all speak it.

Threading model: per-connection reader threads parse messages and enqueue
input; one ticker thread owns all device work (the engines are advanced and
outputs routed under one condition variable, so the device state is never
touched concurrently); per-connection writer threads drain bounded output
queues, so one slow-reading client can never stall the ticker or any other
stream: a peer whose queue overflows is evicted instead.  A client that
half-closes after ``CLOSE`` still receives everything its queued input
produces (the one-shot-equivalent flush tail included) before the server
closes the socket; a client that vanishes (EOF without ``CLOSE``) has its
slot freed at once.

Entropy-coded streams (``FLAG_ENTROPY``, encode and decode modes): the
reader thread decodes each ``CODES_ENT`` in arrival order with its
connection's coder; the ticker aggregates ``entropy_block`` encoded frames
per ``CODES_ENT_OUT`` (a bitrate change flushes the pending block first,
and a drained stream flushes its remainder), so the block boundaries
follow the codes and the rate schedule alone, never the tick timing, and
the wire bytes are reproducible.  A corrupt payload is a protocol error on
its connection; the daemon keeps serving.

The daemon serves a live codec or an AOT serving bundle
(``serve.export.ServingBundle``): a bundle's engines run its exported tick
programs, at the slot count it was exported with.
"""

from __future__ import annotations

import collections
import logging
import math
import socket
import struct
import threading
import time

import numpy as np

from bvsc_tpu_torch.codec import BVRNNCodecModel
from bvsc_tpu_torch.serve import protocol as P
from bvsc_tpu_torch.serve.engine import DecodeEngine, EngineStateLost, ServingEngine
from bvsc_tpu_torch.serve.entropy_wire import AdaptiveCodesCoder
from bvsc_tpu_torch.serve.export import BundleDecodeEngine, BundleServingEngine, ServingBundle

log = logging.getLogger("bvsc_tpu_torch.serve.daemon")


class _Conn:
    """Per-connection state (owned by the daemon lock after HELLO).

    Output goes through a bounded queue drained by a dedicated writer
    thread: the ticker (the one thread every stream depends on) only ever
    does O(1) non-blocking ``enqueue`` calls, so a stalled reader blocks its
    own writer thread, never the tick.
    """

    def __init__(self, sock: socket.socket, outq_limit: int):
        self.sock = sock
        self.send_lock = threading.Lock()  # serializes raw socket writes
        self.mode: int | None = None
        self.sid: int | None = None
        self.closing = False  # CLOSE received: drain queued input, then FIN
        self.dead = False  # slot freed; no more routing to this conn
        # negotiated adaptive entropy coding (protocol.FLAG_ENTROPY):
        # enc_coder compresses outbound code frames (ticker thread only),
        # dec_coder decompresses inbound CODES_ENT (reader thread only)
        self.ent_block = 8
        self.enc_coder: AdaptiveCodesCoder | None = None
        self.dec_coder: AdaptiveCodesCoder | None = None
        self.ent_pending: list[np.ndarray] = []  # buffered outbound frames
        self.ent_pending_bits = -1
        self._outq: collections.deque[tuple[int, bytes]] = collections.deque()
        self._out_bytes = 0
        self._outq_limit = outq_limit
        self._out_cond = threading.Condition()
        self._fin = False  # flush the queue, then close the socket
        self._sock_done = False  # socket shut down (close owned by writer)
        self._writer: threading.Thread | None = None

    def send(self, msg_type: int, payload: bytes = b"") -> bool:
        """Direct blocking send (handshake and error paths; bounded by the
        socket's SO_SNDTIMEO once set)."""
        try:
            with self.send_lock:
                P.write_msg(self.sock, msg_type, payload)
            return True
        except OSError:
            return False

    # -- writer-thread output path ------------------------------------------

    def enqueue(self, msg_type: int, payload: bytes = b"") -> bool:
        """O(1), non-blocking: queue a message for the writer thread.
        False when the connection is finished or the peer reads too slowly
        (bounded queue): the caller should evict it."""
        with self._out_cond:
            if self._fin or self._sock_done:
                return False
            if self._out_bytes + len(payload) > self._outq_limit:
                return False
            self._outq.append((msg_type, payload))
            self._out_bytes += len(payload) + 5  # + frame header
            self._out_cond.notify()
        return True

    def start_writer(self, name: str) -> None:
        self._writer = threading.Thread(target=self._writer_loop, name=name, daemon=True)
        self._writer.start()

    def _writer_loop(self) -> None:
        while True:
            with self._out_cond:
                while not self._outq and not self._fin and not self._sock_done:
                    self._out_cond.wait(timeout=0.5)
                if self._sock_done:
                    return
                if not self._outq:  # fin and fully flushed: FIN the peer
                    self._shutdown_sock()
                    return
                msg_type, payload = self._outq.popleft()
                self._out_bytes -= len(payload) + 5
            if not self.send(msg_type, payload):
                with self._out_cond:
                    self._shutdown_sock()
                return

    def finish(self) -> None:
        """Graceful: the writer flushes queued output, then closes the
        socket."""
        with self._out_cond:
            self._fin = True
            self._out_cond.notify()
            if self._writer is None:
                self._shutdown_sock()

    def abort(self) -> None:
        """Immediate: drop queued output and shut the socket down (unblocks
        a writer stuck in sendall and the reader's recv)."""
        with self._out_cond:
            self._outq.clear()
            self._out_bytes = 0
            self._shutdown_sock()
            self._out_cond.notify()

    def _shutdown_sock(self) -> None:
        """Caller holds _out_cond.  Idempotent."""
        if self._sock_done:
            return
        self._sock_done = True
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self.sock.close()


class CodecDaemon:
    """Serve a port :class:`bvsc_tpu_torch.codec.BVRNNCodecModel`, or a
    :class:`~bvsc_tpu_torch.serve.export.ServingBundle`, over TCP (BVSP/1).

    ``max_streams`` (default 128) is each engine's slot count, the fixed
    batch of its device state; a bundle's is its ``engine_batch``.  Bind
    ``port=0`` for an ephemeral port (read it back from ``.port`` after
    ``start()``).  Both engines are built, and their first tick run, in the
    constructor, so the kernels are built before the daemon listens.
    """

    def __init__(self, codec, host: str = "127.0.0.1", port: int = 0,
                 max_streams: int | None = None, mesh=None,
                 handshake_timeout: float = 30.0, send_timeout: float = 15.0,
                 send_queue_bytes: int = 32 << 20,
                 max_buffered_seconds: float = 600.0,
                 sndbuf: int | None = None):
        """codec: a live port ``BVRNNCodecModel``, or a ``ServingBundle``
        exported with ``engine_batch=N`` (then ``max_streams`` is None or
        N, else ValueError); anything else is a TypeError.  mesh: a
        ``parallel.mesh.Mesh`` whose devices the engines split their slots
        over (``serve.engine``).

        handshake_timeout bounds how long an accepted connection may take
        to complete HELLO (before it owns a slot).  send_timeout bounds a
        single socket send (kernel SO_SNDTIMEO): a dead peer with a full
        TCP window fails its writer thread instead of wedging it.
        send_queue_bytes bounds each connection's outbound queue: a client
        that reads slower than its stream produces is evicted when the
        queue overflows, never stalling the shared ticker.
        max_buffered_seconds bounds each stream's not-yet-processed input
        backlog (audio seconds, or the equivalent frame count for decode
        streams); input beyond it is a protocol error.  sndbuf, if set,
        caps each connection's kernel send buffer (SO_SNDBUF)."""
        if not isinstance(codec, (BVRNNCodecModel, ServingBundle)):
            raise TypeError(f"CodecDaemon serves a BVRNNCodecModel or a ServingBundle, got "
                            f"{type(codec).__name__}")
        if isinstance(codec, ServingBundle):
            if not codec.meta.get("engine"):
                raise ValueError("the bundle was exported without engine programs; export "
                                 "with engine_batch=N to serve it")
            slots = codec.meta["engine"]["batch"]
            if max_streams is not None and max_streams != slots:
                raise ValueError(f"the bundle exports {slots} stream slots, got "
                                 f"max_streams={max_streams}")
            max_streams = slots
        max_streams = 128 if max_streams is None else max_streams
        if not 1 <= max_streams <= 0xFFFF:
            raise ValueError("max_streams must be in [1, 65535] "
                             "(the wire carries slot ids as u16)")
        self.codec = codec
        self._host, self._requested_port = host, port
        self._handshake_timeout = handshake_timeout
        self._send_timeout = send_timeout
        self._send_queue_bytes = send_queue_bytes
        self._sndbuf = sndbuf
        self._max_buffered_samples = int(max_buffered_seconds * codec.conf.fs)
        self._max_buffered_frames = max(1, self._max_buffered_samples // codec.conf.hopsize)
        self._cond = threading.Condition()
        if isinstance(codec, ServingBundle):
            self._eng = BundleServingEngine(codec, mesh=mesh)
            self._dec = BundleDecodeEngine(codec, mesh=mesh)
        else:
            self._eng = ServingEngine(codec, max_streams=max_streams, mesh=mesh)
            self._dec = DecodeEngine(codec, max_streams=max_streams, mesh=mesh)
        self._conns: set[_Conn] = set()
        self._by_slot: dict[tuple[str, int], _Conn] = {}
        self._listener: socket.socket | None = None
        self._threads: list[threading.Thread] = []
        self._shutdown = False

    # -- lifecycle -------------------------------------------------------------

    def start(self) -> None:
        self._listener = socket.create_server((self._host, self._requested_port),
                                              reuse_port=False)
        self._listener.settimeout(0.2)
        self.port = self._listener.getsockname()[1]
        for target, name in ((self._accept_loop, "bvsp-accept"), (self._tick_loop, "bvsp-tick")):
            t = threading.Thread(target=target, name=name, daemon=True)
            t.start()
            self._threads.append(t)
        log.info("BVSP daemon listening on %s:%d", self._host, self.port)

    def close(self) -> None:
        with self._cond:
            self._shutdown = True
            self._cond.notify_all()
        if self._listener is not None:
            self._listener.close()
        for t in self._threads:
            t.join(timeout=10)
        with self._cond:
            for conn in list(self._conns):
                self._teardown(conn)

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.close()

    # -- accept + reader threads ------------------------------------------------

    def _accept_loop(self) -> None:
        while not self._shutdown:
            try:
                sock, addr = self._listener.accept()
            except socket.timeout:
                continue
            except OSError:
                return  # listener closed
            # bounded handshake; lifted to blocking reads once the
            # connection owns a slot (an idle live stream is legitimate:
            # SO_KEEPALIVE reclaims dead peers)
            sock.settimeout(self._handshake_timeout)
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_KEEPALIVE, 1)
            if self._sndbuf is not None:
                sock.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, self._sndbuf)
            t = threading.Thread(target=self._reader, args=(sock,),
                                 name=f"bvsp-conn-{addr[1]}", daemon=True)
            t.start()

    def _reader(self, sock: socket.socket) -> None:
        conn = _Conn(sock, self._send_queue_bytes)
        with self._cond:
            if self._shutdown:
                sock.close()
                return
            self._conns.add(conn)  # tracked pre-handshake so close() reaches it
        try:
            self._handshake(conn)
            # slot owned: lift the handshake deadline (blocking reads; dead
            # peers are reclaimed by TCP keepalive) and bound single sends
            # at the kernel so a dead peer fails its writer thread promptly
            sock.settimeout(None)
            sec = int(self._send_timeout)
            usec = int((self._send_timeout - sec) * 1e6)
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_SNDTIMEO, struct.pack("ll", sec, usec))
            conn.start_writer(f"bvsp-write-{conn.sid}")
            while True:
                msg = P.read_msg(sock)
                if msg is None:  # EOF
                    with self._cond:
                        if not conn.closing:
                            # vanished without CLOSE: free the slot now
                            self._teardown(conn)
                    return
                msg_type, payload = msg
                if msg_type == P.MSG_CLOSE:
                    with self._cond:
                        conn.closing = True
                        if conn.mode != P.MODE_DECODE and not conn.dead:
                            # one-shot-equivalent tail: drain through the
                            # right reflect padding (engine.begin_flush)
                            self._eng.begin_flush(conn.sid)
                        self._cond.notify_all()
                    # keep the socket open for the drain; stop reading
                    return
                self._dispatch(conn, msg_type, payload)
        except P.ProtocolError as e:
            conn.send(P.MSG_ERROR, str(e).encode())
            with self._cond:
                self._teardown(conn)
        except OSError:
            with self._cond:
                self._teardown(conn)

    def _check_bitrate(self, bitrate: float) -> float:
        """Reject bitrates whose per-frame allocation the wire cannot carry
        (or that are not finite) before they reach the shared tick loop."""
        if not math.isfinite(bitrate) or bitrate < 0:
            raise P.ProtocolError(f"invalid bitrate {bitrate!r}")
        bits = float(self.codec.bits_per_frame(float(bitrate)))
        if not math.isfinite(bits) or not 0 <= math.ceil(bits) <= 0xFF:
            raise P.ProtocolError(f"bitrate {bitrate!r} -> {bits!r} bits/frame out of range")
        conf = self.codec.conf
        if not conf.var_bit and int(round(bits)) != conf.z_dim:
            # a fixed-bitrate model (var_bit=false) emits z_dim informative
            # bits every frame whatever the request; packing fewer on the
            # wire would silently corrupt the decode
            full = conf.z_dim * conf.fs / conf.hopsize
            raise P.ProtocolError(
                f"fixed-bitrate codec: the wire carries exactly {conf.z_dim} bits/frame "
                f"(= {full:.0f} bps), got {bitrate!r}")
        return bitrate

    def _handshake(self, conn: _Conn) -> None:
        msg = P.read_msg(conn.sock)
        if msg is None or msg[0] != P.MSG_HELLO:
            raise P.ProtocolError("expected HELLO")
        mode, bitrate, flags, ent_block = P.unpack_hello(msg[1])
        if flags & ~P.FLAG_ENTROPY:
            raise P.ProtocolError(f"unsupported HELLO flags 0x{flags:02x}")
        if bitrate is not None:
            bitrate = self._check_bitrate(bitrate)
        if flags & P.FLAG_ENTROPY:
            if mode == P.MODE_RESYNTH:
                raise P.ProtocolError("entropy coding applies to encode/decode streams only")
            conn.ent_block = ent_block
            coder = AdaptiveCodesCoder(self.codec.conf.z_dim)
            if mode == P.MODE_ENCODE:
                conn.enc_coder = coder
            else:
                conn.dec_coder = coder
        conn.mode = mode
        with self._cond:
            if self._shutdown:
                raise P.ProtocolError("server shutting down")
            try:
                if mode == P.MODE_DECODE:
                    conn.sid = self._dec.open_stream(conceal_bitrate=bitrate)
                    self._by_slot[("d", conn.sid)] = conn
                else:
                    if bitrate is None:
                        raise P.ProtocolError("encode/resynth HELLO needs a bitrate")
                    conn.sid = self._eng.open_stream(bitrate)
                    self._by_slot[("e", conn.sid)] = conn
            except RuntimeError as e:  # no free slots
                raise P.ProtocolError(str(e)) from e
        conf = self.codec.conf
        conn.send(P.MSG_OPENED, P.pack_opened(conn.sid, conf.z_dim, conf.hopsize,
                                              flags=flags & P.FLAG_ENTROPY))

    def _push_decode(self, conn: _Conn, frames: int, push) -> None:
        """Queue ``frames`` decode frames through ``push`` under the lock,
        within the backlog bound."""
        with self._cond:
            if conn.dead:
                return
            if self._dec.queued(conn.sid) + frames > self._max_buffered_frames:
                raise P.ProtocolError("input backlog exceeds max_buffered_seconds")
            push()
            self._cond.notify_all()

    def _dispatch(self, conn: _Conn, msg_type: int, payload: bytes) -> None:
        conf = self.codec.conf
        if conn.mode == P.MODE_DECODE:
            if msg_type == P.MSG_CODES:
                codes, bits = P.unpack_codes_msg(payload, conf.z_dim)
                if not conf.var_bit and bits != conf.z_dim:
                    # the guard of _check_bitrate at the decode path's wire
                    # boundary: a fixed-bitrate model was never trained with
                    # midpoint-masked bits
                    raise P.ProtocolError(
                        f"fixed-bitrate codec: CODES must carry exactly {conf.z_dim} "
                        f"bits/frame, got {bits}")
                self._push_decode(conn, codes.shape[0], lambda: self._dec.push(conn.sid, codes))
            elif msg_type == P.MSG_LOST:
                n = P.unpack_u16(payload)
                self._push_decode(conn, n, lambda: self._dec.push_lost(conn.sid, n))
            elif msg_type == P.MSG_CODES_ENT:
                if conn.dec_coder is None:
                    raise P.ProtocolError("CODES_ENT without negotiated entropy coding")
                frames, bits, body = P.unpack_codes_ent_msg(payload)
                if not conf.var_bit and bits != conf.z_dim:
                    raise P.ProtocolError(
                        f"fixed-bitrate codec: CODES_ENT must carry exactly {conf.z_dim} "
                        f"bits/frame, got {bits}")
                if bits > conf.z_dim:
                    raise P.ProtocolError(f"CODES_ENT bits {bits} > z_dim {conf.z_dim}")
                try:
                    # stateful: blocks decode in arrival order (the reader
                    # thread owns this connection's coder)
                    codes = conn.dec_coder.decode_block(body, frames, bits)
                except ValueError as e:
                    raise P.ProtocolError(str(e)) from e
                self._push_decode(conn, frames, lambda: self._dec.push(conn.sid, codes))
            else:
                raise P.ProtocolError(f"message 0x{msg_type:02x} not valid in decode mode")
        elif msg_type == P.MSG_AUDIO:
            samples = P.unpack_audio(payload)
            with self._cond:
                if conn.dead:
                    return
                if self._eng.queued(conn.sid) + samples.size > self._max_buffered_samples:
                    raise P.ProtocolError("input backlog exceeds max_buffered_seconds")
                self._eng.push(conn.sid, samples)
                self._cond.notify_all()
        elif msg_type == P.MSG_SET_BITRATE:
            bps = self._check_bitrate(P.unpack_f32(payload))
            with self._cond:
                if conn.dead:
                    return
                self._eng.set_bitrate(conn.sid, bps)
        else:
            raise P.ProtocolError(f"message 0x{msg_type:02x} not valid in encode/resynth mode")

    # -- ticker ------------------------------------------------------------------

    def _has_work(self) -> bool:
        for (kind, sid), conn in self._by_slot.items():
            if conn.dead:
                continue
            eng = self._dec if kind == "d" else self._eng
            if eng.has_frame(sid):
                return True
        return False

    def _tick_loop(self) -> None:
        while True:
            try:
                if self._tick_once():
                    return
            except Exception:  # the ticker must outlive any bug: every stream depends on it
                log.exception("tick loop error; continuing")
                time.sleep(0.1)

    def _tick_once(self) -> bool:
        """One wait+tick+route cycle; True when shutting down.

        Routing is O(1) non-blocking enqueues to per-connection writer
        threads: the ticker never touches a socket, so a stalled reader
        cannot delay any other stream's tick."""
        with self._cond:
            while not self._shutdown and not self._has_work():
                self._finish_drained()
                self._cond.wait(timeout=0.2)
            if self._shutdown:
                return True
            try:
                enc_out = self._eng.tick()
            except EngineStateLost:
                log.exception("serving-engine device state lost")
                self._fail_slots("e")
                enc_out = {}
            try:
                dec_out = self._dec.tick()
            except EngineStateLost:
                log.exception("decode-engine device state lost")
                self._fail_slots("d")
                dec_out = {}
            for sid, (codes, wav) in enc_out.items():
                conn = self._by_slot.get(("e", sid))
                if conn is None or conn.dead:
                    continue
                if conn.enc_coder is not None:
                    # ent_block frames per rANS payload (the ~4-byte flush
                    # amortizes); a change of bits flushes the pending
                    # block first
                    bits = int(math.ceil(self._eng.bits[sid]))
                    ok = (not conn.ent_pending or bits == conn.ent_pending_bits
                          or self._flush_entropy(conn))
                    if ok:
                        conn.ent_pending.append(np.asarray(codes, np.float32))
                        conn.ent_pending_bits = bits
                        ok = len(conn.ent_pending) < conn.ent_block or self._flush_entropy(conn)
                elif conn.mode == P.MODE_ENCODE:
                    bits = int(math.ceil(self._eng.bits[sid]))
                    ok = conn.enqueue(P.MSG_CODES_OUT, P.pack_codes_msg(codes[None, :], bits))
                else:
                    ok = conn.enqueue(P.MSG_AUDIO_OUT, P.pack_audio(wav))
                if not ok:
                    log.warning("slot e%d: send queue overflow, evicting slow reader", sid)
                    self._teardown(conn)
            for sid, wav in dec_out.items():
                conn = self._by_slot.get(("d", sid))
                if conn is None or conn.dead:
                    continue
                if not conn.enqueue(P.MSG_AUDIO_OUT, P.pack_audio(wav)):
                    log.warning("slot d%d: send queue overflow, evicting slow reader", sid)
                    self._teardown(conn)
            # after this tick's outputs are enqueued: FIN any stream that
            # has now drained (the writer flushes before closing, so the
            # final frame is never lost)
            self._finish_drained()
        return False

    def _fail_slots(self, kind: str) -> None:
        """A tick failed and the engine rebuilt zeroed device state: every
        stream on that engine lost its hidden state mid-stream; notify and
        release them all (clients reconnect for fresh state).  Caller holds
        the lock."""
        for (k, _), conn in list(self._by_slot.items()):
            if k != kind or conn.dead:
                continue
            conn.enqueue(P.MSG_ERROR, b"engine device state lost; stream reset - reconnect")
            self._release(conn, graceful=True)

    def _flush_entropy(self, conn: _Conn) -> bool:
        """Entropy-encode and enqueue the pending outbound frame block (the
        ticker thread owns enc_coder; caller holds the lock).  False on
        queue overflow, like enqueue."""
        if not conn.ent_pending:
            return True
        block = np.stack(conn.ent_pending)
        bits = conn.ent_pending_bits
        conn.ent_pending = []
        body = conn.enc_coder.encode_block(block, bits)
        return conn.enqueue(P.MSG_CODES_ENT_OUT,
                            P.pack_codes_ent_msg(body, block.shape[0], bits))

    def _finish_drained(self) -> None:
        """FIN connections that sent CLOSE and have no input left (caller
        holds the lock).  Graceful: the slot is freed now, but the socket
        closes only after the writer thread has flushed the queued tail."""
        for conn in [c for c in self._conns if c.closing and not c.dead]:
            eng = self._dec if conn.mode == P.MODE_DECODE else self._eng
            if not eng.has_frame(conn.sid):
                if conn.ent_pending:  # the sub-block remainder of a drained encode stream
                    self._flush_entropy(conn)
                self._release(conn, graceful=True)

    def _teardown(self, conn: _Conn) -> None:
        """Free the slot and close the socket at once, dropping any queued
        output (error and eviction paths; caller holds the lock)."""
        self._release(conn, graceful=False)

    def _release(self, conn: _Conn, graceful: bool) -> None:
        """Free the slot; graceful=True flushes queued output before the
        socket closes, False aborts it now (caller holds the lock)."""
        if conn.dead:
            return
        conn.dead = True
        if conn.sid is not None:
            if conn.mode == P.MODE_DECODE:
                self._dec.close_stream(conn.sid)
                self._by_slot.pop(("d", conn.sid), None)
            else:
                self._eng.close_stream(conn.sid)
                self._by_slot.pop(("e", conn.sid), None)
        self._conns.discard(conn)
        if graceful:
            conn.finish()
        else:
            conn.abort()
