"""The port's BVSP/1 daemon (bvsc_tpu_torch.serve.daemon, device='cpu') on
loopback TCP, on the codec of tests/test_torch_codec.py (a small BVRNN,
h 48 / z 12, and the full-width seeded vocoder).

Parity targets are the port's engines (held against the streaming classes
and against ``bvsc_tpu`` in tests/test_torch_serving.py): what the daemon
serves over the wire must equal a direct engine run bit for bit, since the
wire carries float32 audio and the packed first-k bitstream, both lossless.
Three clients are held to that: ``bvsc_tpu``'s Python client, the port's
copy of it, and ``bvsc_tpu``'s native C client.  The rest are the protocol
cases of tests/test_daemon.py.  Every socket and thread wait has a
deadline.  Last, the port's bit packing (numpy and native) and protocol
are held byte for byte against ``bvsc_tpu``'s.
"""

import shutil
import socket
import struct
import threading
import time

import numpy as np
import pytest
import torch

from bvsc_tpu.ops import bitpack as JB
from bvsc_tpu.serve import client as JC
from bvsc_tpu.serve import protocol as JP
from bvsc_tpu_torch import BVRNNCodecModel
from bvsc_tpu_torch import streaming as S
from bvsc_tpu_torch.config import CodecConfig
from bvsc_tpu_torch.ops import bitpack as TB
from bvsc_tpu_torch.serve import client as TC
from bvsc_tpu_torch.serve import protocol as P
from bvsc_tpu_torch.serve.daemon import CodecDaemon
from bvsc_tpu_torch.serve.engine import DecodeEngine, ServingEngine
from test_torch_codec import SMALL, _port_codec, trees  # noqa: F401

torch.set_num_threads(1)

BITRATE = 600  # -> 7 bits/frame on z_dim=12: exercises the VBR midpoints
HOP = 256
TIMEOUT = 60  # every client socket's deadline, seconds
CLIENTS = {"jax_client": JC.CodecClient, "port_client": TC.CodecClient}
needs_cc = pytest.mark.skipif(shutil.which("cc") is None, reason="no C toolchain")


@pytest.fixture(scope="module")
def codec(trees):  # noqa: F811
    return _port_codec(trees)


@pytest.fixture()
def daemon(codec):
    d = CodecDaemon(codec, port=0, max_streams=4)
    d.start()
    yield d
    d.close()


def _noise(seed: int, n: int, scale: float = 0.3) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal(n) * scale).astype(np.float32)


def _frames(seed: int, n: int, z: int, lost=()):
    rng = np.random.default_rng(seed)
    return [(None, True) if t in lost else (rng.integers(0, 2, z).astype(np.float32), False)
            for t in range(n)]


def solo_engine_run(codec, x, bitrate):
    """Direct ServingEngine single-slot run, flushed as the daemon's CLOSE
    flushes -> (codes (T, z), wav (n,))."""
    eng = ServingEngine(codec, max_streams=4)
    sid = eng.open_stream(bitrate)
    eng.push(sid, x)
    eng.begin_flush(sid)
    cs, ws = [], []
    while True:
        out = eng.tick()
        if sid not in out:
            break
        cs.append(out[sid][0])
        ws.append(out[sid][1])
    return np.stack(cs), np.concatenate(ws)


def solo_decode_run(codec, frames, conceal_bitrate=None):
    """Direct DecodeEngine run over [(codes, lost)] frames -> wav."""
    eng = DecodeEngine(codec, max_streams=4)
    sid = eng.open_stream(conceal_bitrate=conceal_bitrate)
    for codes, lost in frames:
        if lost:
            eng.push_lost(sid, 1)
        else:
            eng.push(sid, codes[None, :])
    ws = []
    while True:
        out = eng.tick()
        if sid not in out:
            break
        ws.append(out[sid])
    return np.concatenate(ws)


def _wait_slots_free(d, seconds=60):
    deadline = time.time() + seconds
    while time.time() < deadline and d._by_slot:
        time.sleep(0.05)
    return not d._by_slot


# --- the wire against direct engine runs, per client ---------------------------


@pytest.mark.parametrize("client", CLIENTS)
def test_resynth_matches_engine(codec, daemon, client):
    x = _noise(1, 768 + HOP * 5)
    _, wav_ref = solo_engine_run(codec, x, BITRATE)
    with CLIENTS[client]("127.0.0.1", daemon.port, mode="resynth", bitrate=BITRATE,
                         timeout=TIMEOUT) as c:
        assert c.z_dim == codec.conf.z_dim and c.hop == HOP
        c.send_audio(x)
        c.close_input()
        out = c.drain()
    np.testing.assert_array_equal(out["audio"], wav_ref)
    assert out["codes"].shape == (0, codec.conf.z_dim)


@pytest.mark.parametrize("client", CLIENTS)
def test_encode_codes_bit_exact(codec, daemon, client):
    x = _noise(2, 768 + HOP * 5)
    codes_ref, _ = solo_engine_run(codec, x, BITRATE)
    k = int(np.ceil(codec.bits_per_frame(BITRATE)))
    with CLIENTS[client]("127.0.0.1", daemon.port, mode="encode", bitrate=BITRATE,
                         timeout=TIMEOUT) as c:
        c.send_audio(x)
        c.close_input()
        out = c.drain()
    assert out["bits"] == [k] * codes_ref.shape[0]
    # the transmitted first k bits exact, the rest 0.5: the engine's codes
    np.testing.assert_array_equal(out["codes"], codes_ref)
    assert (out["codes"][:, k:] == 0.5).all() and out["audio"].size == 0


@pytest.mark.parametrize("client", CLIENTS)
def test_decode_with_plc_matches_engine(codec, daemon, client):
    z = codec.conf.z_dim
    frames = _frames(3, 9, z, lost=(4, 5))
    wav_ref = solo_decode_run(codec, frames, conceal_bitrate=BITRATE)
    with CLIENTS[client]("127.0.0.1", daemon.port, mode="decode", bitrate=BITRATE,
                         timeout=TIMEOUT) as c:
        for codes, lost in frames:
            if lost:
                c.send_lost(1)
            else:
                c.send_codes(codes[None, :], bits=z)
        c.close_input()
        out = c.drain()
    np.testing.assert_array_equal(out["audio"], wav_ref)


def test_concurrent_clients_are_independent(codec, daemon):
    """Three modes at once; every stream equals its solo engine run."""
    x1, x2 = _noise(4, 768 + HOP * 4), _noise(5, 768 + HOP * 4, 0.2)
    z = codec.conf.z_dim
    dframes = _frames(6, 5, z, lost=(2,))
    _, wav1 = solo_engine_run(codec, x1, BITRATE)
    codes2, _ = solo_engine_run(codec, x2, 3000)
    wav3 = solo_decode_run(codec, dframes)
    results = {}

    def run(name, mode, bitrate, feed):
        with TC.CodecClient("127.0.0.1", daemon.port, mode=mode, bitrate=bitrate,
                            timeout=TIMEOUT) as c:
            feed(c)
            c.close_input()
            results[name] = c.drain()

    def feed_decode(c):
        for f, lost in dframes:
            c.send_lost(1) if lost else c.send_codes(f[None, :], bits=z)

    threads = [threading.Thread(target=run, args=a) for a in (
        ("resynth", "resynth", BITRATE, lambda c: c.send_audio(x1)),
        ("encode", "encode", 3000, lambda c: c.send_audio(x2)),
        ("decode", "decode", None, feed_decode))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive(), "client thread hung"
    np.testing.assert_array_equal(results["resynth"]["audio"], wav1)
    np.testing.assert_array_equal(results["encode"]["codes"], codes2)
    np.testing.assert_array_equal(results["decode"]["audio"], wav3)


# --- bvsc_tpu's native C client ---------------------------------------------------


def _parse_bvspf(blob: bytes):
    """-> list of (type, payload) wire frames from a .bvspf byte stream."""
    frames, pos = [], 0
    while pos < len(blob):
        t, n = struct.unpack_from("<BI", blob, pos)
        pos += 5
        frames.append((t, blob[pos: pos + n]))
        assert len(frames[-1][1]) == n, "truncated .bvspf"
        pos += n
    return frames


@needs_cc
def test_native_client_resynth_matches_engine(codec, daemon):
    from bvsc_tpu.serve.native_client import run_native_client

    x = _noise(7, 768 + HOP * 5 + 40)
    _, wav_ref = solo_engine_run(codec, x, BITRATE)
    proc = run_native_client("127.0.0.1", daemon.port, "resynth", BITRATE,
                             x.astype("<f4").tobytes(), timeout=TIMEOUT)
    assert proc.returncode == 0, proc.stderr.decode()
    np.testing.assert_array_equal(np.frombuffer(proc.stdout, "<f4"), wav_ref)


@needs_cc
def test_native_client_encode_matches_engine(codec, daemon):
    from bvsc_tpu.serve.native_client import run_native_client

    x = _noise(8, 768 + HOP * 5)
    codes_ref, _ = solo_engine_run(codec, x, BITRATE)
    proc = run_native_client("127.0.0.1", daemon.port, "encode", BITRATE,
                             x.astype("<f4").tobytes(), timeout=TIMEOUT)
    assert proc.returncode == 0, proc.stderr.decode()
    frames = _parse_bvspf(proc.stdout)
    assert frames and all(t == P.MSG_CODES_OUT for t, _ in frames)
    codes = np.concatenate([P.unpack_codes_msg(p, codec.conf.z_dim)[0] for _, p in frames])
    np.testing.assert_array_equal(codes, codes_ref)


@needs_cc
def test_native_client_decode_with_plc_matches_engine(codec, daemon):
    from bvsc_tpu.serve.native_client import run_native_client

    z = codec.conf.z_dim
    frames = _frames(9, 8, z, lost=(3,))
    wav_ref = solo_decode_run(codec, frames)
    blob = b""
    for codes, lost in frames:
        if lost:
            payload = P.pack_u16(1)
            blob += struct.pack("<BI", P.MSG_LOST, len(payload)) + payload
        else:
            payload = P.pack_codes_msg(codes[None, :], bits=z)
            blob += struct.pack("<BI", P.MSG_CODES, len(payload)) + payload
    proc = run_native_client("127.0.0.1", daemon.port, "decode", None, blob, timeout=TIMEOUT)
    assert proc.returncode == 0, proc.stderr.decode()
    np.testing.assert_array_equal(np.frombuffer(proc.stdout, "<f4"), wav_ref)


@needs_cc
def test_native_client_entropy_refused(codec, daemon):
    """The native client's entropy mode gets the port daemon's error (exit 2)
    when its payload is refused: a CODES_ENT claiming more bits than z_dim."""
    from bvsc_tpu.serve.native_client import run_native_client

    payload = P.pack_codes_ent_msg(b"\0\0\x80\0", 1, codec.conf.z_dim + 1)
    blob = struct.pack("<BI", P.MSG_CODES_ENT, len(payload)) + payload
    proc = run_native_client("127.0.0.1", daemon.port, "decode-ent", None, blob, timeout=TIMEOUT)
    assert proc.returncode == 2 and b"z_dim" in proc.stderr


# --- protocol cases -------------------------------------------------------------------


def test_mid_stream_bitrate_switch(codec, daemon):
    """A client-driven rate switch lands on a frame boundary when the client
    waits for its outputs before switching."""
    x = _noise(10, 768 + HOP * 5)
    head, tail = x[: 768 + HOP * 2], x[768 + HOP * 2:]
    eng = ServingEngine(codec, max_streams=4)
    sid = eng.open_stream(BITRATE)
    eng.push(sid, x)
    cs = [eng.tick()[sid][0] for _ in range(3)]
    eng.set_bitrate(sid, 300)
    eng.begin_flush(sid)
    while True:
        out = eng.tick()
        if sid not in out:
            break
        cs.append(out[sid][0])
    codes_ref = np.stack(cs)

    with TC.CodecClient("127.0.0.1", daemon.port, mode="encode", bitrate=BITRATE,
                        timeout=TIMEOUT) as c:
        c.send_audio(head)  # exactly 3 frames' worth
        got = [c.recv() for _ in range(3)]  # wait until all 3 are consumed
        c.set_bitrate(300)
        c.send_audio(tail)
        c.close_input()
        rest = c.drain()
    np.testing.assert_array_equal(np.concatenate([v[0] for _, v in got]), codes_ref[:3])
    np.testing.assert_array_equal(rest["codes"], codes_ref[3:])
    assert [b for _, (_, b) in got] == [7] * 3 and set(rest["bits"]) == {3}


def test_close_flush_matches_fused_packet_codec(codec, daemon):
    """CLOSE drains through the one-shot right reflect padding: the wire
    output equals FusedPacketCodec process() + flush(), with a sub-hop
    remainder."""
    x = _noise(11, 768 + HOP * 4 + 100)
    fpc = S.FusedPacketCodec(codec, batch=1, bitrate=BITRATE)
    ref = torch.cat([fpc.process(x[None]), fpc.flush()], 1)[0].numpy()
    with TC.CodecClient("127.0.0.1", daemon.port, mode="resynth", bitrate=BITRATE,
                        timeout=TIMEOUT) as c:
        c.send_audio(x)
        c.close_input()
        out = c.drain()
    assert out["audio"].shape == ref.shape
    assert np.abs(out["audio"] - ref).max() <= 1e-5


def test_bad_magic_rejected(daemon):
    with socket.create_connection(("127.0.0.1", daemon.port), timeout=TIMEOUT) as s:
        P.write_msg(s, P.MSG_HELLO, struct.pack("<4sBBf", b"NOPE", 1, 0, 3000.0))
        msg = P.read_msg(s)
        assert msg is not None and msg[0] == P.MSG_ERROR and b"magic" in msg[1]
        assert P.read_msg(s) is None  # server closed


def test_oversized_payload_rejected(daemon):
    with socket.create_connection(("127.0.0.1", daemon.port), timeout=TIMEOUT) as s:
        s.sendall(struct.pack("<BI", P.MSG_LOST, 1 << 30))  # far beyond LOST's 2 bytes
        msg = P.read_msg(s)
        assert msg is not None and msg[0] == P.MSG_ERROR


def test_wrong_mode_message_rejected(codec, daemon):
    c = TC.CodecClient("127.0.0.1", daemon.port, mode="encode", bitrate=BITRATE,
                       timeout=TIMEOUT)
    try:
        with pytest.raises(TC.ServerError, match="not valid in encode"):
            c.send_codes(np.zeros((1, codec.conf.z_dim), np.float32), bits=codec.conf.z_dim)
            c.drain()
    finally:
        c.close()


def test_slot_exhaustion_reports_error(daemon):
    clients = [TC.CodecClient("127.0.0.1", daemon.port, mode="resynth", bitrate=3000,
                              timeout=TIMEOUT) for _ in range(4)]
    try:
        with pytest.raises(TC.ServerError, match="no free"):
            TC.CodecClient("127.0.0.1", daemon.port, mode="resynth", bitrate=3000,
                           timeout=TIMEOUT)
        # the decode engine has its own slots
        TC.CodecClient("127.0.0.1", daemon.port, mode="decode", bitrate=None,
                       timeout=TIMEOUT).close()
    finally:
        for c in clients:
            c.close()


def test_client_vanishing_frees_slot(daemon):
    """EOF without CLOSE frees the slot for the next client."""
    for _ in range(6):  # more than max_streams if slots leaked
        TC.CodecClient("127.0.0.1", daemon.port, mode="resynth", bitrate=3000,
                       timeout=TIMEOUT).close()  # abrupt: no MSG_CLOSE
    assert _wait_slots_free(daemon), "slots leaked after abrupt disconnects"


def test_encode_hello_requires_bitrate(daemon):
    with pytest.raises(TC.ServerError, match="needs a bitrate"):
        TC.CodecClient("127.0.0.1", daemon.port, mode="encode", bitrate=None, timeout=TIMEOUT)


@pytest.mark.parametrize("bad", [-5.0, 1e12, float("inf")])
def test_invalid_hello_bitrate_rejected(daemon, bad):
    """Out-of-range bitrates are rejected at HELLO and never reach the
    shared tick loop."""
    with pytest.raises(TC.ServerError):
        TC.CodecClient("127.0.0.1", daemon.port, mode="encode", bitrate=bad, timeout=TIMEOUT)


def test_invalid_set_bitrate_kills_stream_not_daemon(codec, daemon):
    x = _noise(12, 768 + HOP)
    with pytest.raises(TC.ServerError, match="invalid bitrate"):
        with TC.CodecClient("127.0.0.1", daemon.port, mode="encode", bitrate=BITRATE,
                            timeout=TIMEOUT) as c:
            c.set_bitrate(float("nan"))
            c.send_audio(x)
            c.drain()
    codes_ref, _ = solo_engine_run(codec, x, BITRATE)
    with TC.CodecClient("127.0.0.1", daemon.port, mode="encode", bitrate=BITRATE,
                        timeout=TIMEOUT) as c:
        c.send_audio(x)
        c.close_input()
        np.testing.assert_array_equal(c.drain()["codes"], codes_ref)


def test_entropy_hello_refused_with_item(codec, daemon):
    """A HELLO asking for entropy-coded payloads on a resynthesis stream
    (which carries no codes) gets a protocol error that says so; both
    Python clients refuse it before connecting; the daemon keeps serving."""
    with socket.create_connection(("127.0.0.1", daemon.port), timeout=TIMEOUT) as s:
        P.write_msg(s, P.MSG_HELLO, P.pack_hello(P.MODE_RESYNTH, BITRATE, flags=P.FLAG_ENTROPY))
        msg = P.read_msg(s)
        assert msg is not None and msg[0] == P.MSG_ERROR
        assert b"encode/decode streams only" in msg[1]
    for client in CLIENTS.values():
        with pytest.raises(ValueError, match="encode/decode"):
            client("127.0.0.1", daemon.port, mode="resynth", bitrate=BITRATE, timeout=TIMEOUT,
                   entropy=True)
    x = _noise(13, 768 + HOP)
    _, wav_ref = solo_engine_run(codec, x, BITRATE)
    with TC.CodecClient("127.0.0.1", daemon.port, mode="resynth", bitrate=BITRATE,
                        timeout=TIMEOUT) as c:
        c.send_audio(x)
        c.close_input()
        np.testing.assert_array_equal(c.drain()["audio"], wav_ref)


def test_non_codec_refused_with_item(codec):
    # a live codec or a serving bundle (tests/test_torch_export.py), nothing else
    with pytest.raises(TypeError, match="BVRNNCodecModel or a ServingBundle"):
        CodecDaemon(object())
    with pytest.raises(ValueError, match="65535"):
        CodecDaemon(codec, max_streams=70000)


@pytest.mark.parametrize("mode", ["encode", "decode"])
def test_fixed_bitrate_codec_rejects_partial_allocation(trees, mode):  # noqa: F811
    """A var_bit=false model emits z_dim informative bits a frame: the
    daemon refuses wire allocations that would truncate them, and takes
    exactly the full rate."""
    _, btree, vtree = trees
    conf = CodecConfig(**SMALL, var_bit=False)
    from bvsc_tpu_torch.convert import bvrnn_params_from_jax, vocoder_params_from_jax

    fixed = BVRNNCodecModel(config=conf, bvrnn_params=bvrnn_params_from_jax(btree),
                            vocoder_params=vocoder_params_from_jax(vtree), device="cpu")
    z = conf.z_dim
    full_bps = z * conf.fs / conf.hopsize
    with CodecDaemon(fixed, port=0, max_streams=2) as d:
        with pytest.raises(TC.ServerError, match="fixed-bitrate"):
            with TC.CodecClient("127.0.0.1", d.port, mode=mode,
                                bitrate=BITRATE if mode == "encode" else None,
                                timeout=TIMEOUT) as c:
                c.send_codes(np.zeros((1, z), np.float32), bits=7)
                c.drain()
        bitrate = full_bps if mode == "encode" else None
        with TC.CodecClient("127.0.0.1", d.port, mode=mode, bitrate=bitrate,
                            timeout=TIMEOUT) as c:
            if mode == "decode":
                c.send_codes(np.zeros((2, z), np.float32), bits=z)
                c.close_input()
                assert c.drain()["audio"].size == 2 * HOP
            else:
                assert c.z_dim == z


def test_slow_reader_evicted_without_stalling_others(codec):
    """A client that stops reading fills the kernel buffers, then its
    bounded send queue, and is evicted; every other stream keeps flowing
    meanwhile (the ticker only does non-blocking enqueues)."""
    x = _noise(14, 768 + HOP * 20)
    _, wav_ref = solo_engine_run(codec, x, BITRATE)
    # the stalled peer's output (~120 KB) overflows the 32 KB queue even if
    # its send timeout races; the healthy stream's ~22 KB never can
    x_stalled = _noise(15, 768 + HOP * 120)
    with CodecDaemon(codec, port=0, max_streams=4, send_queue_bytes=32768,
                     send_timeout=2.0, sndbuf=4096) as d:
        s = socket.socket()
        s.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 2048)  # before connect
        s.settimeout(TIMEOUT)
        try:
            s.connect(("127.0.0.1", d.port))
            P.write_msg(s, P.MSG_HELLO, P.pack_hello(P.MODE_RESYNTH, BITRATE))
            msg = P.read_msg(s)
            assert msg is not None and msg[0] == P.MSG_OPENED
            P.write_msg(s, P.MSG_AUDIO, P.pack_audio(x_stalled))  # never read
            with TC.CodecClient("127.0.0.1", d.port, mode="resynth", bitrate=BITRATE,
                                timeout=TIMEOUT) as c:
                c.send_audio(x)
                c.close_input()
                np.testing.assert_array_equal(c.drain()["audio"], wav_ref)
            assert _wait_slots_free(d, 120), "slow reader was not evicted"
        finally:
            s.close()


def test_input_backlog_cap_rejected(codec):
    """Unread input beyond max_buffered_seconds is a protocol error, not
    unbounded host memory."""
    with CodecDaemon(codec, port=0, max_streams=2, max_buffered_seconds=0.05) as d:
        with pytest.raises(TC.ServerError, match="backlog"):
            with TC.CodecClient("127.0.0.1", d.port, mode="resynth", bitrate=BITRATE,
                                timeout=TIMEOUT) as c:
                c.send_audio(np.zeros(4096, np.float32))
                c.drain()


def test_garbage_never_crashes_daemon(codec, daemon):
    """Random bytes at the socket are rejected cleanly (ERROR or close),
    never crash the daemon or leak slots: a valid client still works."""
    rng = np.random.default_rng(16)
    for _ in range(16):
        with socket.create_connection(("127.0.0.1", daemon.port), timeout=TIMEOUT) as s:
            try:  # the server may reset mid-send once it spots the garbage
                s.sendall(rng.integers(0, 256, rng.integers(1, 200), dtype=np.uint8).tobytes())
                s.shutdown(socket.SHUT_WR)
                s.settimeout(10)
                while s.recv(4096):
                    pass
            except OSError:
                pass
    assert _wait_slots_free(daemon), "garbage connections leaked slots"
    x = _noise(17, 768 + HOP)
    _, wav_ref = solo_engine_run(codec, x, BITRATE)
    with TC.CodecClient("127.0.0.1", daemon.port, mode="resynth", bitrate=BITRATE,
                        timeout=TIMEOUT) as c:
        c.send_audio(x)
        c.close_input()
        np.testing.assert_array_equal(c.drain()["audio"], wav_ref)


def test_many_clients_under_fast_thread_switching(codec):
    """Eight streams at once on an 8-slot daemon while the interpreter
    switches threads every 10 µs: every stream's wire output still equals
    the same streams run directly on one engine (a push or route lost to a
    race between a reader thread and the ticker would break it)."""
    import sys

    xs = [_noise(40 + i, 768 + HOP * (2 + i % 3)) for i in range(8)]
    rates = [300.0 * (1 + i % 4) for i in range(8)]
    eng = ServingEngine(codec, max_streams=8)
    sids = [eng.open_stream(r) for r in rates]
    for sid, x in zip(sids, xs):
        eng.push(sid, x)
        eng.begin_flush(sid)
    ref = {sid: [] for sid in sids}
    while (out := eng.tick()):
        for sid, (_, w) in out.items():
            ref[sid].append(w)
    results = {}

    def run(i):
        with TC.CodecClient("127.0.0.1", d.port, mode="resynth", bitrate=rates[i],
                            timeout=TIMEOUT) as c:
            c.send_audio(xs[i])
            c.close_input()
            results[i] = c.drain()["audio"]

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with CodecDaemon(codec, port=0, max_streams=8) as d:
            threads = [threading.Thread(target=run, args=(i,)) for i in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
            assert not any(t.is_alive() for t in threads), "client thread hung"
    finally:
        sys.setswitchinterval(interval)
    assert sorted(results) == list(range(8))
    for i, sid in enumerate(sids):
        np.testing.assert_array_equal(results[i], np.concatenate(ref[sid]))


def test_daemon_ticks_from_its_own_thread(codec, daemon):
    """The ticker thread runs the engines with autograd off whatever the
    thread that built the codec had set."""
    with torch.enable_grad():
        x = _noise(18, 768 + HOP)
        with TC.CodecClient("127.0.0.1", daemon.port, mode="resynth", bitrate=BITRATE,
                            timeout=TIMEOUT) as c:
            c.send_audio(x)
            c.close_input()
            assert c.drain()["audio"].shape == (4 * HOP,)  # (L - hop) // hop + 1 frames
    assert not daemon._eng.state["h"].requires_grad


# --- bit packing and protocol against bvsc_tpu -----------------------------------------


@pytest.fixture(params=["native", "numpy"])
def port_bitpack(request, monkeypatch):
    """The port's bitpack on its native path, or forced onto numpy."""
    if request.param == "native":
        if TB._load_native() is None:
            pytest.skip("no C toolchain")
    else:
        monkeypatch.setattr(TB, "_lib", None)
        monkeypatch.setattr(TB, "_tried", True)
    return TB


@pytest.mark.parametrize("bits", [0, 1, 7, 35, 64, "vbr"])
def test_bitpack_bytes_equal_jax(port_bitpack, bits):
    frames, z = 50, 64
    rng = np.random.default_rng(19)
    codes = rng.integers(0, 2, size=(frames, z)).astype(np.float32)
    k = rng.integers(0, z + 1, size=frames).astype(np.float32) if bits == "vbr" else bits
    kk = np.broadcast_to(np.asarray(k), (frames,))
    codes[np.arange(z)[None, :] >= kk[:, None]] = 0.5
    payload = port_bitpack.pack_codes(codes, k)
    assert payload == JB.pack_codes(codes, k)
    assert len(payload) == port_bitpack.payload_nbytes(k, frames, z) == (int(kk.sum()) + 7) // 8
    back = port_bitpack.unpack_codes(payload, k, frames, z)
    np.testing.assert_array_equal(back, codes)
    np.testing.assert_array_equal(back, JB.unpack_codes(payload, k, frames, z))
    if len(payload):
        with pytest.raises(ValueError, match="too short"):
            port_bitpack.unpack_codes(payload[:-1], k, frames, z)


def test_bitpack_builds_into_the_port(tmp_path):
    """The native library is built from the port's own C source, into the
    port's build directory."""
    if TB._load_native() is None:
        pytest.skip("no C toolchain")
    assert TB._SRC.endswith("bvsc_tpu_torch/native/bitpack.c")
    assert TB._load_native()._name.startswith(TB.BUILD_DIR)


def test_protocol_bytes_equal_jax():
    rng = np.random.default_rng(20)
    codes = rng.integers(0, 2, size=(3, 12)).astype(np.float32)
    codes[:, 7:] = 0.5
    audio = rng.standard_normal(300).astype(np.float32)
    pairs = [
        (P.pack_hello(P.MODE_RESYNTH, 3000.0), JP.pack_hello(JP.MODE_RESYNTH, 3000.0)),
        (P.pack_hello(P.MODE_DECODE, None), JP.pack_hello(JP.MODE_DECODE, None)),
        (P.pack_hello(P.MODE_ENCODE, 600.0, flags=P.FLAG_ENTROPY, entropy_block=4),
         JP.pack_hello(JP.MODE_ENCODE, 600.0, flags=JP.FLAG_ENTROPY, entropy_block=4)),
        (P.pack_opened(7, 12, 256), JP.pack_opened(7, 12, 256)),
        (P.pack_codes_msg(codes, 7), JP.pack_codes_msg(codes, 7)),
        (P.pack_audio(audio), JP.pack_audio(audio)),
        (P.pack_u16(513), JP.pack_u16(513)), (P.pack_f32(5512.5), JP.pack_f32(5512.5)),
    ]
    for got, ref in pairs:
        assert got == ref
    assert {k: v for k, v in vars(P).items() if k.startswith(("MSG_", "MODE_", "FLAG_"))} == {
        k: v for k, v in vars(JP).items() if k.startswith(("MSG_", "MODE_", "FLAG_"))}
    assert P.MAX_PAYLOAD == JP.MAX_PAYLOAD and P.MAGIC == JP.MAGIC and P.VERSION == JP.VERSION
    got, bits = P.unpack_codes_msg(JP.pack_codes_msg(codes, 7), 12)
    np.testing.assert_array_equal(got, codes)
    assert bits == 7
    assert P.unpack_hello(JP.pack_hello(JP.MODE_DECODE, None)) == (P.MODE_DECODE, None, 0, 8)
    with pytest.raises(P.ProtocolError, match="too short"):
        P.unpack_codes_msg(JP.pack_codes_msg(codes, 7)[:-1], 12)


def test_audio_chunking_roundtrip():
    x = np.random.default_rng(21).standard_normal(P.MAX_AUDIO_SAMPLES * 2 + 17).astype(np.float32)
    chunks = list(P.iter_audio_chunks(x))
    assert all(c.size <= P.MAX_AUDIO_SAMPLES for c in chunks)
    assert all(len(P.pack_audio(c)) <= P.MAX_PAYLOAD[P.MSG_AUDIO] for c in chunks)
    np.testing.assert_array_equal(
        np.concatenate([P.unpack_audio(P.pack_audio(c)) for c in chunks]), x)
    assert [c.size for c in P.iter_audio_chunks(np.zeros(0))] == [0]
