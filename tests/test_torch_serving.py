"""The port's serving engines (bvsc_tpu_torch.serve.engine, device='cpu')
against the port's streaming classes and against bvsc_tpu.serve.engine, on
the weights of tests/test_torch_codec.py: a small BVRNN (h 48, z 12, 80
mels) and the full-width vocoder (seeded across packages; within the port
the trained one, ``chkpts_npz/``, whose output follows its mel).

* Within the port, one engine slot against a dedicated B = 1
  ``FusedPacketCodec`` / ``StreamingEncoder`` / ``StreamingDecoder``: codes
  bitwise, audio to 1e-5 (the overlap-add sums in another order; the
  reference's own bound); in fast mode audio to 7e-2 (the reference's fast
  streaming bound).
* Against the JAX package, one run of each engine at max_streams = 4 on the
  same seeded weights: codes bitwise, audio to 1e-4 abs and SNR > 40 dB
  (the cross-package bound of tests/test_torch_codec.py).
"""

import os

import numpy as np
import pytest
import torch

from bvsc_tpu.eval.metrics import snr_db
from bvsc_tpu.serve import engine as JE
from bvsc_tpu_torch import BVRNNCodecModel
from bvsc_tpu_torch import streaming as S
from bvsc_tpu_torch.config import CodecConfig, VocoderConfig
from bvsc_tpu_torch.convert import bvrnn_params_from_jax
from bvsc_tpu_torch.serve.engine import (DecodeEngine, EngineStateLost, ServingEngine,
                                         _SampleQueue)
from test_torch_codec import SMALL, _jax_codec, _port_codec, trees  # noqa: F401

torch.set_num_threads(1)

HOP = 256
NEED = 768  # samples before a stream's first frame
STREAM_TOL = 1e-5
FAST_TOL = 7e-2
CROSS_TOL = 1e-4
VOC_NPZ = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "chkpts_npz", "bvsc_vocoder_demo_cl_ft_g_step600_f16.npz")


def _trained(trees, **kwargs):  # noqa: F811
    return BVRNNCodecModel(config=CodecConfig(**SMALL), bvrnn_params=bvrnn_params_from_jax(trees[1]),
                           vocoder_chkpt_path=VOC_NPZ, device="cpu", **kwargs)


@pytest.fixture(scope="module")
def codec(trees):  # noqa: F811
    return _trained(trees)


def _noise(seed: int, n: int, scale: float = 0.3) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal(n) * scale).astype(np.float32)


def _drain(eng, sid):
    """Tick until ``sid`` stops advancing: (codes (T, z), wav (T * hop,))."""
    cs, ws = [], []
    while True:
        out = eng.tick()
        if sid not in out:
            break
        cs.append(out[sid][0])
        ws.append(out[sid][1])
    return np.stack(cs), np.concatenate(ws)


def _packet_codec(codec, x, bitrate, flush=True, switch=None):
    """x through a B = 1 FusedPacketCodec, flushed: (codes, wav); with
    ``switch=(k, bps)`` the bitrate changes after k steps."""
    fpc = S.FusedPacketCodec(codec, batch=1, bitrate=bitrate)
    codes, step = [], fpc._step

    def recording(chunk):
        if switch is not None and len(codes) == switch[0]:
            fpc.bits[:] = codec.bits_per_frame(switch[1])
        out = step(chunk)
        codes.append(out[0][0].numpy())
        return out

    fpc._step = recording
    outs = [fpc.process(x[None])] + ([fpc.flush()] if flush else [])
    wav = torch.cat(outs, 1)[0].numpy()
    return np.stack(codes)[: wav.size // HOP], wav


def test_slot_equals_streaming_encoder(codec):
    """Without a flush an engine slot emits a StreamingEncoder's codes and a
    FusedPacketCodec's audio, frame for frame."""
    x = _noise(1, NEED + 12 * HOP + 50)
    eng = ServingEngine(codec, max_streams=4)
    sid = eng.open_stream(3000)
    eng.push(sid, x)
    codes, wav = _drain(eng, sid)
    ref_codes = S.StreamingEncoder(codec, batch=1, bitrate=3000).feed(x[None])[0].numpy()
    np.testing.assert_array_equal(codes, ref_codes)
    _, ref_wav = _packet_codec(codec, x, 3000, flush=False)
    assert wav.shape == ref_wav.shape == (13 * HOP,)
    assert np.abs(wav - ref_wav).max() <= STREAM_TOL


@pytest.mark.parametrize("extra", [0, 100], ids=["hop_multiple", "remainder"])
def test_flush_equals_packet_codec(codec, extra):
    """begin_flush drains through the one-shot right reflect padding:
    engine output == FusedPacketCodec process() + flush()."""
    x = _noise(2, NEED + 4 * HOP + extra)
    ref_codes, ref_wav = _packet_codec(codec, x, 3000)
    eng = ServingEngine(codec, max_streams=4)
    sid = eng.open_stream(3000)
    eng.push(sid, x)
    assert eng.begin_flush(sid)
    assert eng.begin_flush(sid)  # idempotent
    with pytest.raises(ValueError, match="flushing"):
        eng.push(sid, x[:10])
    codes, wav = _drain(eng, sid)
    assert wav.shape == ref_wav.shape == ((len(x) - HOP) // HOP * HOP + HOP,)
    np.testing.assert_array_equal(codes, ref_codes)
    assert np.abs(wav - ref_wav).max() <= STREAM_TOL


def test_concurrent_streams_independent(codec):
    """Streams at different bitrates, opened at different ticks, equal
    their solo runs; the later one's stages start at its own first tick."""
    xa, xb = _noise(3, NEED + 6 * HOP), _noise(4, NEED + 5 * HOP + 30, 0.2)

    def solo(x, bitrate):
        eng = ServingEngine(codec, max_streams=4)
        sid = eng.open_stream(bitrate)
        eng.push(sid, x)
        eng.begin_flush(sid)
        return _drain(eng, sid)

    eng = ServingEngine(codec, max_streams=4)
    sa = eng.open_stream(3000)
    eng.push(sa, xa)
    eng.begin_flush(sa)
    got = {sa: ([], [])}
    for t in range(40):
        if t == 3:
            sb = eng.open_stream(600)  # 7 of 12 bits: masked midpoints
            eng.push(sb, xb)
            eng.begin_flush(sb)
            got[sb] = ([], [])
        out = eng.tick()
        if not out and t > 3:
            break
        for sid, (c, w) in out.items():
            got[sid][0].append(c)
            got[sid][1].append(w)
    for sid, x, bitrate in ((sa, xa, 3000), (sb, xb, 600)):
        ref_codes, ref_wav = solo(x, bitrate)
        np.testing.assert_array_equal(np.stack(got[sid][0]), ref_codes)
        assert np.abs(np.concatenate(got[sid][1]) - ref_wav).max() <= STREAM_TOL


def test_slot_reuse_resets_state(codec):
    x = _noise(5, NEED + 3 * HOP)
    eng = ServingEngine(codec, max_streams=4)
    sid = eng.open_stream(3000)
    others = [eng.open_stream(3000) for _ in range(3)]  # exhaust the free list
    for o in others:
        eng.push(o, _noise(6 + o, NEED + 5 * HOP))
    eng.push(sid, x)
    first = _drain(eng, sid)
    eng.close_stream(sid)
    sid2 = eng.open_stream(3000)  # FIFO free list -> the same slot back
    assert sid2 == sid
    for leaf in (eng.state["h"], eng.state["window"], eng.state["voc"]["conv_pre"],
                 *[st["ctx"] for st in eng.state["voc"]["stages"]],
                 *[st["fed"] for st in eng.state["voc"]["stages"]]):
        assert not leaf[sid].any()
    eng.push(sid2, x)
    second = _drain(eng, sid2)
    np.testing.assert_array_equal(first[0], second[0])
    np.testing.assert_array_equal(first[1], second[1])


def test_mid_stream_bitrate_switch(codec):
    x = _noise(7, NEED + 6 * HOP)
    eng = ServingEngine(codec, max_streams=4)
    sid = eng.open_stream(300)  # 3 bits a frame, then 9
    eng.push(sid, x)
    eng.begin_flush(sid)
    cs, ws = [], []
    for _ in range(3):
        c, w = eng.tick()[sid]
        cs.append(c)
        ws.append(w)
    eng.set_bitrate(sid, 800)
    codes, wav = _drain(eng, sid)
    codes, wav = np.concatenate([np.stack(cs), codes]), np.concatenate(ws + [wav])
    ref_codes, ref_wav = _packet_codec(codec, x, 300, switch=(3, 800))
    np.testing.assert_array_equal(codes, ref_codes)
    assert np.abs(wav - ref_wav).max() <= STREAM_TOL
    assert (codes[:3, 3:] == 0.5).all() and (codes[3:, 9:] == 0.5).all()
    assert (codes[3:, 3:9] != 0.5).all()


def test_engine_overflow(codec):
    eng = ServingEngine(codec, max_streams=2)
    eng.open_stream(3000)
    eng.open_stream(3000)
    with pytest.raises(RuntimeError, match="no free"):
        eng.open_stream(3000)
    eng.close_stream(0)
    with pytest.raises(RuntimeError, match="not open"):
        eng.close_stream(0)


def test_sample_queue_chunked_fifo(rng):
    """_SampleQueue is an exact FIFO across arbitrary push/pop splits."""
    data = rng.standard_normal(10_000).astype(np.float32)
    q = _SampleQueue()
    i = 0
    while i < data.size:
        n = int(rng.integers(1, 700))
        q.push(data[i: i + n])
        i += n
    q.push(np.zeros(0, np.float32))  # empty push is a no-op
    out = []
    while len(q):
        out.append(q.pop(min(int(rng.integers(1, 900)), len(q))))
    np.testing.assert_array_equal(np.concatenate(out), data)
    with pytest.raises(ValueError):
        q.pop(1)


def test_flush_too_short_stream_is_noop(codec):
    """A stream whose whole input can never fill the first frame drains to
    nothing (like a one-shot call on an input too short to frame)."""
    eng = ServingEngine(codec, max_streams=2)
    sid = eng.open_stream(3000)
    eng.push(sid, np.zeros(100, np.float32))
    assert not eng.begin_flush(sid)
    assert not eng.has_frame(sid)
    assert eng.tick() == {}


def test_engine_state_lost_recovery(codec):
    """A failed tick raises EngineStateLost with zeroed state rebuilt, and
    the engine then serves a new stream exactly as a fresh engine."""
    x = _noise(8, NEED + 2 * HOP)
    ref = ServingEngine(codec, max_streams=4)
    sid = ref.open_stream(3000)
    ref.push(sid, x)
    ref_codes, ref_wav = _drain(ref, sid)

    eng = ServingEngine(codec, max_streams=4)
    sid = eng.open_stream(3000)
    eng.push(sid, x)
    eng.tick()
    calls = {"n": 0}

    def failing(*a, **k):
        calls["n"] += 1
        raise RuntimeError("simulated device failure")

    eng._tick_call = failing
    with pytest.raises(EngineStateLost):
        eng.tick()
    assert calls["n"] == 1 and not eng._started.any()
    assert not eng.state["h"].any() and not eng.state["voc"]["stages"][0]["fed"].any()
    del eng._tick_call
    eng.close_stream(sid)
    sid2 = eng.open_stream(3000)
    eng.push(sid2, x)
    codes, wav = _drain(eng, sid2)
    np.testing.assert_array_equal(codes, ref_codes)
    np.testing.assert_array_equal(wav, ref_wav)


def test_decode_engine_matches_streaming_decoder(codec):
    """One DecodeEngine slot == a dedicated StreamingDecoder fed frame by
    frame with the same losses; the slot before its first loss is bitwise
    a clean run's; push_lost conceals with no gap; reuse starts fresh."""
    n, z = 12, SMALL["z_dim"]
    rng = np.random.default_rng(9)
    codes_a = (rng.uniform(size=(n, z)) > 0.5).astype(np.float32)
    codes_b = (rng.uniform(size=(n, z)) > 0.5).astype(np.float32)
    lost_a = np.zeros(n, np.float32)
    lost_a[[4, 8, 9]] = 1.0

    def run(lost):
        eng = DecodeEngine(codec, max_streams=4)
        sa, sb = eng.open_stream(conceal_bitrate=600), eng.open_stream()
        eng.push(sa, codes_a, lost=lost)
        eng.push(sb, codes_b)
        out = [eng.tick() for _ in range(n)]
        assert eng.tick() == {}
        return eng, sa, np.concatenate([o[sa] for o in out]), np.concatenate([o[sb] for o in out])

    eng, sa, wav_a, wav_b = run(lost_a)
    _, _, clean_a, _ = run(None)
    assert wav_a.shape == (n * HOP,)
    np.testing.assert_array_equal(wav_a[: 4 * HOP], clean_a[: 4 * HOP])
    assert np.abs(wav_a[4 * HOP:] - clean_a[4 * HOP:]).max() > 0

    dec = S.StreamingDecoder(codec, batch=1, conceal_bitrate=600)
    ref_a = torch.cat([dec.feed(codes_a[None, t: t + 1], lost=lost_a[None, t: t + 1])
                       for t in range(n)], 1)[0].numpy()
    assert np.abs(wav_a - ref_a).max() <= STREAM_TOL
    ref_b = S.StreamingDecoder(codec, batch=1).feed(codes_b[None])[0].numpy()
    assert np.abs(wav_b - ref_b).max() <= STREAM_TOL

    eng.close_stream(sa)
    eng.open_stream(), eng.open_stream()  # the never-used slots first (FIFO)
    sc = eng.open_stream()
    assert sc == sa
    eng.push(sc, codes_b[:2])
    eng.push_lost(sc, 2)
    eng.push(sc, codes_b[4:6])
    assert eng.queued(sc) == 6 and eng.has_frame(sc)
    got = np.concatenate([eng.tick()[sc] for _ in range(6)])
    dec = S.StreamingDecoder(codec, batch=1)
    ref_c = torch.cat([dec.feed(codes_b[None, :2]), dec.conceal(2),
                       dec.feed(codes_b[None, 4:6])], 1)[0].numpy()
    assert got.shape == (6 * HOP,)
    assert np.abs(got - ref_c).max() <= STREAM_TOL


def test_decode_engine_rejects_mismatched_lost(codec):
    eng = DecodeEngine(codec, max_streams=2)
    sid = eng.open_stream()
    with pytest.raises(ValueError, match="lost shape"):
        eng.push(sid, np.zeros((3, SMALL["z_dim"]), np.float32), lost=np.zeros(2))


def test_fast_slot_equals_packet_codec(trees):  # noqa: F811
    """precision='default': an engine slot against a B = 1 FusedPacketCodec
    of the same mode within the fast streaming bound (both batches run the
    fused cell under 'auto' here: 4 and 1 slots are under 32)."""
    fast = _trained(trees, precision="default")
    x = _noise(10, NEED + 6 * HOP + 70)
    _, ref_wav = _packet_codec(fast, x, 3000)
    eng = ServingEngine(fast, max_streams=4)
    sid = eng.open_stream(3000)
    eng.push(sid, x)
    eng.begin_flush(sid)
    _, wav = _drain(eng, sid)
    assert wav.shape == ref_wav.shape
    assert np.abs(wav - ref_wav).max() <= FAST_TOL


def test_engine_respects_config_winsize():
    """The rolling window comes from conf.winsize, not a fixed 1024: one
    slot at winsize 64 equals a dedicated StreamingCodec."""
    voc = VocoderConfig(num_mels=8, upsample_rates=(4, 2), upsample_kernel_sizes=(8, 4),
                        upsample_initial_channel=16, resblock_kernel_sizes=(3, 5),
                        resblock_dilation_sizes=((1, 3, 5), (1, 3, 5)),
                        layers_sym=(False, False), layers_antialias=(False, False))
    conf = CodecConfig(num_mels=8, h_dim=32, z_dim=12, hopsize=8, winsize=64, mel_pad_left=16,
                       var_bit=True, vocoder_config=voc)
    small = BVRNNCodecModel(config=conf, seed=5, length_bucket=4, device="cpu")
    x = _noise(11, (64 - 16) + 8 * 6)
    eng = ServingEngine(small, max_streams=2)
    assert eng.state["window"].shape == (2, 64)
    sid = eng.open_stream(500)
    eng.push(sid, x)
    _, wav = _drain(eng, sid)
    ref = S.StreamingCodec(small, batch=1, bitrate=500).process(x[None])[0].numpy()
    assert wav.shape[0] > 0
    assert np.abs(wav - ref[: wav.shape[0]]).max() <= STREAM_TOL


@pytest.mark.parametrize("cls", [ServingEngine, DecodeEngine], ids=lambda c: c.__name__)
def test_mesh_raises(codec, cls):
    """``mesh=`` takes a ``parallel.mesh.Mesh`` whose devices divide the
    slots (sharded engines: tests/test_torch_parallel_serving.py)."""
    from bvsc_tpu_torch.parallel.mesh import make_mesh

    with pytest.raises(TypeError, match="Mesh"):
        cls(codec, max_streams=4, mesh=object())
    with pytest.raises(ValueError, match="divide evenly"):
        cls(codec, max_streams=4, mesh=make_mesh(devices=["cpu"] * 3))


def test_devices_and_outputs(codec):
    """A CPU codec's engines keep their state on the CPU and return numpy
    arrays; the default max_streams is the reference's 128."""
    import inspect

    for cls in (ServingEngine, DecodeEngine):
        assert inspect.signature(cls).parameters["max_streams"].default == 128
    eng = ServingEngine(codec, max_streams=2)
    sid = eng.open_stream(3000)
    eng.push(sid, _noise(12, NEED))
    codes, wav = eng.tick()[sid]
    assert isinstance(codes, np.ndarray) and codes.shape == (SMALL["z_dim"],)
    assert isinstance(wav, np.ndarray) and wav.shape == (HOP,) and wav.dtype == np.float32
    assert eng.state["voc"]["stages"][0]["fed"].device.type == "cpu"
    assert eng.state["voc"]["stages"][0]["fed"].dtype == torch.int32


# --- against bvsc_tpu.serve.engine ------------------------------------------------

SCHEDULE = [(0, 3000.0, NEED + 6 * HOP + 100), (2, 600.0, NEED + 4 * HOP)]
DECODE_LOST = [[3, 4], [1, 6, 7]]


def _serve_schedule(eng):
    """Two streams opened at ticks 0 and 2 at their bitrates, each flushed:
    {stream: (codes, wav)}."""
    got, sids, t = {}, {}, 0
    while True:
        for i, (t0, bitrate, n) in enumerate(SCHEDULE):
            if t == t0:
                sids[i] = eng.open_stream(bitrate)
                eng.push(sids[i], _noise(20 + i, n))
                eng.begin_flush(sids[i])
                got[i] = ([], [])
        out = eng.tick()
        if not out and t >= SCHEDULE[-1][0]:
            break
        for i, sid in sids.items():
            if sid in out:
                got[i][0].append(np.asarray(out[sid][0]))
                got[i][1].append(np.asarray(out[sid][1]))
        t += 1
    return {i: (np.stack(c), np.concatenate(w)) for i, (c, w) in got.items()}


def _decode_schedule(eng):
    """Two decode streams with losses, one concealed at 600 bps (7 of 12
    bits): {stream: wav}."""
    n, z = 10, SMALL["z_dim"]
    out = {}
    sids = [eng.open_stream(conceal_bitrate=600), eng.open_stream()]
    for i, sid in enumerate(sids):
        codes = (np.random.default_rng(30 + i).uniform(size=(n, z)) > 0.5).astype(np.float32)
        lost = np.zeros(n, np.float32)
        lost[DECODE_LOST[i]] = 1.0
        eng.push(sid, codes, lost=lost)
    ticks = [eng.tick() for _ in range(n)]
    for i, sid in enumerate(sids):
        out[i] = np.concatenate([np.asarray(t[sid]) for t in ticks])
    return out


@pytest.fixture(scope="module")
def jax_runs(trees):  # noqa: F811
    jc = _jax_codec(trees)
    return {"serve": _serve_schedule(JE.ServingEngine(jc, max_streams=4)),
            "decode": _decode_schedule(JE.DecodeEngine(jc, max_streams=4))}


@pytest.fixture(scope="module")
def port_codec(trees):  # noqa: F811
    return _port_codec(trees)


def _close(got, ref):
    assert got.shape == ref.shape and np.isfinite(got).all()
    assert snr_db(ref, got) > 40.0
    np.testing.assert_allclose(got, ref, atol=CROSS_TOL)


def test_serving_engine_matches_jax(port_codec, jax_runs):
    got = _serve_schedule(ServingEngine(port_codec, max_streams=4))
    for i, (ref_codes, ref_wav) in jax_runs["serve"].items():
        np.testing.assert_array_equal(got[i][0], ref_codes)
        _close(got[i][1], ref_wav)


def test_decode_engine_matches_jax(port_codec, jax_runs):
    got = _decode_schedule(DecodeEngine(port_codec, max_streams=4))
    for i, ref in jax_runs["decode"].items():
        _close(got[i], ref)
