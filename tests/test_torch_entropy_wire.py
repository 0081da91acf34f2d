"""The BVSP entropy wire option on the port: ``bvsc_tpu_torch.serve.
entropy_wire`` byte for byte ``bvsc_tpu``'s (integer counts, so payloads are
identical), and the port's daemon (device='cpu', the small codec of
tests/test_torch_codec.py) serving ``FLAG_ENTROPY`` streams.

The wire carries the same information either way, so the ground truth is a
direct engine run (as in tests/test_torch_daemon.py): through the port's
client, ``bvsc_tpu``'s Python client and the native C client's
``encode-ent`` / ``decode-ent`` modes, the codes and audio must be bitwise
that run's.  Then the protocol cases of tests/test_entropy_wire.py: the
rate-switch flush, resynthesis refused, ``CODES_ENT`` without negotiation
refused, and a corrupt payload killing its stream but not the daemon.
Every socket has a deadline.
"""

import socket
import struct

import numpy as np
import pytest
import torch

from bvsc_tpu.serve import client as JC
from bvsc_tpu.serve import entropy_wire as JW
from bvsc_tpu_torch.serve import client as TC
from bvsc_tpu_torch.serve import entropy_wire as TW
from bvsc_tpu_torch.serve import protocol as P
from bvsc_tpu_torch.serve.daemon import CodecDaemon
from bvsc_tpu_torch.serve.engine import ServingEngine
from test_torch_codec import _port_codec, trees  # noqa: F401
from test_torch_daemon import (BITRATE, HOP, TIMEOUT, _frames, _noise, _parse_bvspf, needs_cc,
                               solo_decode_run, solo_engine_run)

torch.set_num_threads(1)

CLIENTS = {"jax_client": JC.CodecClient, "port_client": TC.CodecClient}
BLOCK = 4


@pytest.fixture(scope="module")
def codec(trees):  # noqa: F811
    return _port_codec(trees)


@pytest.fixture()
def daemon(codec):
    d = CodecDaemon(codec, port=0, max_streams=4)
    d.start()
    yield d
    d.close()


def _k(codec, bitrate=BITRATE) -> int:
    return int(np.ceil(codec.bits_per_frame(bitrate)))


def _blocks(seed: int, z: int):
    """A chained block sequence: varying lengths, a change of k, a
    zero-bit block and biased positions."""
    rng = np.random.default_rng(seed)
    p = np.linspace(0.02, 0.9, z)
    out = []
    for blk in range(12):
        n = int(rng.integers(1, 9))
        k = 0 if blk == 5 else (z if blk < 3 else int(rng.integers(1, z + 1)))
        codes = np.full((n, z), 0.5, np.float32)
        codes[:, :k] = (rng.random((n, k)) < p[:k]).astype(np.float32)
        out.append((codes, k))
    return out


# --- the coder against bvsc_tpu's ------------------------------------------------------


@pytest.fixture(params=["native", "numpy"])
def rans_path(request, monkeypatch):
    from bvsc_tpu_torch.ops import rans as TR

    if request.param == "native":
        if TR._load_native() is None:
            pytest.skip("no C toolchain")
    else:
        monkeypatch.setattr(TR, "_lib", None)
        monkeypatch.setattr(TR, "_tried", True)
    return request.param


@pytest.mark.parametrize("z", [12, 64])
def test_coder_payloads_equal_jax(rans_path, z):
    """Over a chained block sequence with a change of k, every payload is
    byte for byte bvsc_tpu's, and each package decodes the other's."""
    blocks = _blocks(z, z)
    enc, jenc = TW.AdaptiveCodesCoder(z), JW.AdaptiveCodesCoder(z)
    dec, jdec = TW.AdaptiveCodesCoder(z), JW.AdaptiveCodesCoder(z)
    for codes, k in blocks:
        body = enc.encode_block(codes, k)
        assert body == jenc.encode_block(codes, k)
        if k == 0:
            assert body == b""
        np.testing.assert_array_equal(dec.decode_block(body, codes.shape[0], k), codes)
        np.testing.assert_array_equal(jdec.decode_block(body, codes.shape[0], k), codes)
    np.testing.assert_array_equal(enc.model.c0, jenc.model.c0)
    np.testing.assert_array_equal(enc.model.c1, jenc.model.c1)


def test_coder_state_chaining_and_corruption():
    z = 12
    enc, dec = TW.AdaptiveCodesCoder(z), TW.AdaptiveCodesCoder(z)
    bodies = [(enc.encode_block(c, k), c, k) for c, k in _blocks(1, z)]
    for body, codes, k in bodies:
        np.testing.assert_array_equal(dec.decode_block(body, codes.shape[0], k), codes)
    body, codes, k = bodies[-1]
    try:  # a fresh coder (the wrong state) must not decode a later block silently
        assert not np.array_equal(TW.AdaptiveCodesCoder(z).decode_block(body, codes.shape[0], k),
                                  codes)
    except ValueError:
        pass
    enc2, dec2 = TW.AdaptiveCodesCoder(z), TW.AdaptiveCodesCoder(z)
    body = enc2.encode_block(np.zeros((8, z), np.float32), 7)
    with pytest.raises(ValueError):
        dec2.decode_block(body[:-1] + bytes([body[-1] ^ 0xFF]), 8, 7)
    with pytest.raises(ValueError, match="nonempty payload"):
        TW.AdaptiveCodesCoder(z).decode_block(b"\0", 3, 0)


def test_model_counts_equal_jax():
    """The probability model is integer arithmetic: a replayed bit sequence
    gives bvsc_tpu's probabilities and counts, halving included."""
    bits = (np.random.default_rng(7).random((1500, 6)) < 0.2).astype(np.uint8)
    m, jm = TW.AdaptiveBitModel(6), JW.AdaptiveBitModel(6)
    for row in bits:
        np.testing.assert_array_equal(m.probs_q16(6), jm.probs_q16(6))
        m.update(row, 6)
        jm.update(row, 6)
    np.testing.assert_array_equal(m.c0, jm.c0)
    assert m.c0.max() < 1024 and m.c1.max() < 1024  # halving bounds the counts


# --- the daemon's entropy wire against direct engine runs, per client --------------------


@pytest.mark.parametrize("client", CLIENTS)
def test_encode_entropy_codes_bit_exact(codec, daemon, client):
    """12 frames at block 4: three CODES_ENT_OUT messages (the last by the
    drain's flush), codes bitwise a direct engine run's."""
    x = _noise(50, 768 + HOP * 9)
    codes_ref, _ = solo_engine_run(codec, x, BITRATE)
    with CLIENTS[client]("127.0.0.1", daemon.port, mode="encode", bitrate=BITRATE,
                         timeout=TIMEOUT, entropy=True, entropy_block=BLOCK) as c:
        c.send_audio(x)
        c.close_input()
        out = c.drain()
        stats = dict(c.entropy_stats)
    assert codes_ref.shape[0] == 12
    np.testing.assert_array_equal(out["codes"], codes_ref)
    assert out["bits"] == [_k(codec)] * 3
    assert stats["raw_payload_bytes"] == 3 * ((BLOCK * _k(codec) + 7) // 8)
    assert stats["wire_payload_bytes"] > 0


@pytest.mark.parametrize("client", CLIENTS)
def test_decode_entropy_matches_engine(codec, daemon, client):
    """Entropy-coded blocks interleaved with LOST reports (which carry no
    bits and must not desync the coder): audio bitwise a direct engine run
    and the raw wire's."""
    z = codec.conf.z_dim
    frames = _frames(51, 14, z, lost=(4, 5, 9))
    wav_ref = solo_decode_run(codec, frames, conceal_bitrate=BITRATE)

    def run(entropy):
        with CLIENTS[client]("127.0.0.1", daemon.port, mode="decode", bitrate=BITRATE,
                             timeout=TIMEOUT, entropy=entropy) as c:
            pend = []
            for codes, lost in frames:
                if not lost:
                    pend.append(codes)
                    continue
                if pend:  # keep arrival order around the loss report
                    c.send_codes(np.stack(pend), bits=z)
                    pend = []
                c.send_lost(1)
            c.send_codes(np.stack(pend), bits=z)
            c.close_input()
            return c.drain()["audio"]

    np.testing.assert_array_equal(run(True), wav_ref)
    np.testing.assert_array_equal(run(False), wav_ref)


@needs_cc
def test_native_client_encode_ent_matches_engine(codec, daemon):
    """The C client's encode-ent output is the daemon's CODES_ENT_OUT frames
    verbatim: each body byte for byte the port's and bvsc_tpu's coder on the
    same block partition, and the decoded codes bitwise the engine's."""
    from bvsc_tpu.serve.native_client import run_native_client

    x = _noise(52, 768 + HOP * 12)
    codes_ref, _ = solo_engine_run(codec, x, BITRATE)
    proc = run_native_client("127.0.0.1", daemon.port, "encode-ent", BITRATE,
                             x.astype("<f4").tobytes(), timeout=TIMEOUT)
    assert proc.returncode == 0, proc.stderr.decode()
    msgs = _parse_bvspf(proc.stdout)
    assert msgs and all(t == P.MSG_CODES_ENT_OUT for t, _ in msgs)
    z = codec.conf.z_dim
    dec, enc, jenc = TW.AdaptiveCodesCoder(z), TW.AdaptiveCodesCoder(z), JW.AdaptiveCodesCoder(z)
    got = []
    for _, payload in msgs:
        frames, bits, body = P.unpack_codes_ent_msg(payload)
        codes = dec.decode_block(body, frames, bits)
        assert body == enc.encode_block(codes, bits) == jenc.encode_block(codes, bits)
        got.append(codes)
    assert [P.unpack_codes_ent_msg(p)[0] for _, p in msgs] == [8] * (len(msgs) - 1) + [
        codes_ref.shape[0] - 8 * (len(msgs) - 1)]  # the default block, then the remainder
    np.testing.assert_array_equal(np.concatenate(got), codes_ref)


@needs_cc
def test_native_client_decode_ent_matches_engine(codec, daemon):
    from bvsc_tpu.serve.native_client import run_native_client

    z = codec.conf.z_dim
    frames = _frames(53, 10, z, lost=(3, 4))
    wav_ref = solo_decode_run(codec, frames)
    coder, blob = TW.AdaptiveCodesCoder(z), b""
    for codes, lost in frames:
        if lost:
            payload, t = P.pack_u16(1), P.MSG_LOST
        else:
            payload = P.pack_codes_ent_msg(coder.encode_block(codes[None], z), 1, z)
            t = P.MSG_CODES_ENT
        blob += struct.pack("<BI", t, len(payload)) + payload
    proc = run_native_client("127.0.0.1", daemon.port, "decode-ent", None, blob, timeout=TIMEOUT)
    assert proc.returncode == 0, proc.stderr.decode()
    np.testing.assert_array_equal(np.frombuffer(proc.stdout, "<f4"), wav_ref)


# --- protocol cases ---------------------------------------------------------------------


def test_encode_entropy_rate_switch_flushes(codec, daemon):
    """A mid-stream SET_BITRATE flushes the pending sub-block, so every
    message carries one bits value; codes bitwise a direct engine run with
    the same frame-aligned switch."""
    x1 = _noise(54, 768 + HOP * 3)  # 4 frames: one full block
    x2 = _noise(55, HOP * 3)  # 3 frames, + 2 from the flush
    b2 = 900
    eng = ServingEngine(codec, max_streams=4)
    sid = eng.open_stream(BITRATE)
    eng.push(sid, x1)
    cs = [eng.tick()[sid][0] for _ in range(4)]
    eng.set_bitrate(sid, b2)
    eng.push(sid, x2)
    eng.begin_flush(sid)
    while (out := eng.tick()):
        cs.append(out[sid][0])
    codes_ref = np.stack(cs)
    with TC.CodecClient("127.0.0.1", daemon.port, mode="encode", bitrate=BITRATE,
                        timeout=TIMEOUT, entropy=True, entropy_block=BLOCK) as c:
        c.send_audio(x1)
        kind, (codes1, bits1) = c.recv()  # the first full block
        assert kind == "codes" and bits1 == _k(codec) and codes1.shape[0] == BLOCK
        c.set_bitrate(b2)
        c.send_audio(x2)
        c.close_input()
        out = c.drain()
    np.testing.assert_array_equal(np.concatenate([codes1, out["codes"]]), codes_ref)
    assert out["bits"] == [_k(codec, b2)] * 2  # 5 frames after the switch: 4 + 1 (flush)


def test_opened_echoes_entropy_flag(daemon):
    with socket.create_connection(("127.0.0.1", daemon.port), timeout=TIMEOUT) as s:
        P.write_msg(s, P.MSG_HELLO, P.pack_hello(P.MODE_ENCODE, BITRATE, flags=P.FLAG_ENTROPY,
                                                 entropy_block=3))
        msg = P.read_msg(s)
        assert msg is not None and msg[0] == P.MSG_OPENED
        assert P.unpack_opened(msg[1])[3] == P.FLAG_ENTROPY
    with socket.create_connection(("127.0.0.1", daemon.port), timeout=TIMEOUT) as s:
        P.write_msg(s, P.MSG_HELLO, P.pack_hello(P.MODE_ENCODE, BITRATE))
        msg = P.read_msg(s)
        assert msg is not None and P.unpack_opened(msg[1])[3] == 0


def test_entropy_rejected_for_resynth(daemon):
    for client in CLIENTS.values():
        with pytest.raises(ValueError):
            client("127.0.0.1", daemon.port, mode="resynth", bitrate=BITRATE, entropy=True)
    with socket.create_connection(("127.0.0.1", daemon.port), timeout=TIMEOUT) as s:
        P.write_msg(s, P.MSG_HELLO, P.pack_hello(P.MODE_RESYNTH, BITRATE, flags=P.FLAG_ENTROPY))
        msg = P.read_msg(s)
        assert msg is not None and msg[0] == P.MSG_ERROR and b"encode/decode" in msg[1]


def test_codes_ent_without_negotiation_rejected(daemon):
    with socket.create_connection(("127.0.0.1", daemon.port), timeout=TIMEOUT) as s:
        P.write_msg(s, P.MSG_HELLO, P.pack_hello(P.MODE_DECODE, None))
        msg = P.read_msg(s)
        assert msg is not None and msg[0] == P.MSG_OPENED
        P.write_msg(s, P.MSG_CODES_ENT, P.pack_codes_ent_msg(b"\0\0\0\0", 1, 4))
        msg = P.read_msg(s)
        assert msg is not None and msg[0] == P.MSG_ERROR and b"without negotiated" in msg[1]


@pytest.mark.parametrize("payload", [b"\xff\xff\xff\xff\xff", b"\x00\x80", "too_many_bits"])
def test_corrupt_entropy_payload_kills_stream_not_daemon(codec, daemon, payload):
    z = codec.conf.z_dim
    msg_body = (P.pack_codes_ent_msg(b"\0\0\x80\0", 1, z + 1) if payload == "too_many_bits"
                else P.pack_codes_ent_msg(payload, 3, 7))
    with socket.create_connection(("127.0.0.1", daemon.port), timeout=TIMEOUT) as s:
        P.write_msg(s, P.MSG_HELLO, P.pack_hello(P.MODE_DECODE, None, flags=P.FLAG_ENTROPY))
        msg = P.read_msg(s)
        assert msg is not None and msg[0] == P.MSG_OPENED
        P.write_msg(s, P.MSG_CODES_ENT, msg_body)
        msg = P.read_msg(s)
        assert msg is not None and msg[0] == P.MSG_ERROR
        assert P.read_msg(s) is None  # the stream is closed
    frames = _frames(56, 3, z)
    wav_ref = solo_decode_run(codec, frames)
    with TC.CodecClient("127.0.0.1", daemon.port, mode="decode", bitrate=None,
                        timeout=TIMEOUT, entropy=True) as c:
        for codes, _ in frames:
            c.send_codes(codes[None, :], bits=z)
        c.close_input()
        np.testing.assert_array_equal(c.drain()["audio"], wav_ref)
