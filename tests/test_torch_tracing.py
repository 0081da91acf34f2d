"""The port's spans and counters (``bvsc_tpu_torch.utils.tracing``) on the
CPU: where the codec's and the engines' spans sit and how they nest, the
counters exact on a hand-made schedule, every span mirrored as a ``bvsc.*``
range while a profile records and no range entered without one, and nothing
recorded inside a trace (``torch.export``).  A tiny seeded codec (hop 16,
h 32, z 12, four vocoder stages at widths and kernel sizes the kernel path
covers, ``ops.amp_resblock.F32_SHAPES``) keeps it fast."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from bvsc_tpu_torch import BVRNNCodecModel
from bvsc_tpu_torch.config import CodecConfig, VocoderConfig
from bvsc_tpu_torch.parallel.mesh import make_mesh
from bvsc_tpu_torch.serve import export as E
from bvsc_tpu_torch.serve.engine import DecodeEngine, EngineStateLost, ServingEngine
from bvsc_tpu_torch.utils import tracing

torch.set_num_threads(1)

VOC = dict(num_mels=8, upsample_rates=(2, 2, 2, 2), upsample_kernel_sizes=(4, 4, 4, 4),
           upsample_initial_channel=128, resblock_kernel_sizes=(3, 7),
           resblock_dilation_sizes=((1, 3, 5), (1, 3, 5)), layers_sym=(False,) * 4,
           layers_antialias=(False,) * 4)
CONF = dict(num_mels=8, h_dim=32, z_dim=12, hopsize=16, winsize=64, mel_pad_left=24,
            var_bit=True)
HOP, NEED, Z, STAGES = 16, 40, 12, 4  # NEED: samples before a stream's first frame
TICK_PARTS = ("gather", "copy", "issue", "wait")


def _codec(use_pallas: bool = True) -> BVRNNCodecModel:
    return BVRNNCodecModel(config=CodecConfig(**CONF, vocoder_config=VocoderConfig(**VOC)),
                           length_bucket=4, device="cpu", use_pallas=use_pallas)


@pytest.fixture(scope="module")
def codecs():
    return {"kernel": _codec(True), "direct": _codec(False)}


@pytest.fixture(autouse=True)
def clean():
    tracing.reset()
    yield
    tracing.reset()


def _noise(seed: int, shape) -> np.ndarray:
    return (0.3 * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _counts() -> dict:
    return {name: s["count"] for name, s in tracing.snapshot()["spans"].items()}


def _ranges(prof) -> list[tuple[float, float, str, str]]:
    """The profile's ``bvsc.*`` user annotations as (start, end, span name,
    number or ''), in start order."""
    import os
    import tempfile

    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    out = []
    for e in events:
        name = str(e.get("name", ""))
        if e.get("ph") == "X" and e.get("cat") == "user_annotation" and name.startswith("bvsc."):
            span, _, arg = name[len("bvsc."):].partition("#")
            out.append((float(e["ts"]), float(e["ts"]) + float(e["dur"]), span, arg))
    return sorted(out)


def _inside(child, parent) -> bool:
    return parent[0] <= child[0] and child[1] <= parent[1]


def _children(ranges, parent, name):
    return [r for r in ranges if r[2] == name and _inside(r, parent)]


# -- the registry ----------------------------------------------------------------


def test_tracing_records_spans_and_counters():
    tracing.count("c")
    tracing.count("c", 4)
    assert tracing.durations("never") == []
    for _ in range(tracing.RING + 10):
        with tracing.span("s"):
            pass
    ring = tracing.durations("s")
    assert len(ring) == tracing.RING and all(0 <= d < 1.0 for d in ring)
    tracing.count("amp_resblock.launches", 7)
    snap = tracing.snapshot()
    s = snap["spans"]["s"]
    assert s == {"count": tracing.RING + 10, "total_s": s["total_s"]}
    assert s["total_s"] >= sum(ring)
    assert snap["counters"]["c"] == 5 and snap["counters"]["amp_resblock.launches"] == 7
    tracing.reset()
    assert tracing.snapshot() == {"spans": {}, "counters": {}}


@pytest.mark.parametrize("flag", ["is_compiling", "is_exporting"])
def test_tracing_records_nothing_inside_a_trace(monkeypatch, flag):
    monkeypatch.setattr(torch.compiler, flag, lambda: True)
    with tracing.span("s"):
        tracing.count("c")
    snap = tracing.snapshot()
    assert snap["spans"] == {} and "c" not in snap["counters"]


# -- the codec's layers ------------------------------------------------------------

# (public method, the path, the spans each call records inside its own)
CALLS = [("call", "kernel", {"mel": 1, "bvrnn.scan": 1, "vocoder": 1, "vocoder.stage": STAGES}),
         ("call_unfused", "kernel", {"mel": 1, "bvrnn.scan": 2, "vocoder": 1,
                                     "vocoder.stage": STAGES}),
         ("call", "direct", {"mel": 1, "bvrnn.scan": 1, "vocoder": 1, "vocoder.stage": STAGES}),
         ("encode", "kernel", {"mel": 1, "bvrnn.scan": 1}),
         ("decode", "kernel", {"bvrnn.scan": 1, "vocoder": 1, "vocoder.stage": STAGES}),
         ("decode_lost", "direct", {"bvrnn.lost_read": 1, "bvrnn.scan": 1, "vocoder": 1,
                                    "vocoder.stage": STAGES})]


def _public_call(codec, method: str, x: np.ndarray):
    """(the codec's span, the real frames x rows it counts) of one call."""
    B, L = x.shape
    frames = codec.frontend.num_frames(L)
    if method.startswith("call"):
        codec(x, 3000.0, fused=method == "call")
        return "codec.call", B * frames
    if method == "encode":
        codec.encode(x, 3000.0)
        return "codec.encode", B * frames
    codes = np.full((B, frames, Z), 0.5, np.float32)
    lost = None if method == "decode" else np.tile(np.arange(frames) % 3 == 0, (B, 1))
    codec.decode(codes, L, lost=lost)
    return "codec.decode", B * frames


@pytest.mark.parametrize("method,path,inner", CALLS, ids=[f"{m}-{p}" for m, p, _ in CALLS])
def test_tracing_codec_call_spans_nest(codecs, method, path, inner):
    """One public call records its span around its layers' (the vocoder's
    around its stages') and counts its frames once, each child's range
    inside its parent's on the profiler's clock, the call's range numbered
    by its span's count (the second call: 2)."""
    x = _noise(1, (2, 400))
    _public_call(codecs[path], method, x)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        outer, frames = _public_call(codecs[path], method, x)
    assert _counts() == {outer: 2, **{name: 2 * n for name, n in inner.items()}}
    assert tracing.snapshot()["counters"]["codec.frames"] == 2 * frames
    ranges = _ranges(prof)
    (top,) = [r for r in ranges if r[2] == outer]
    assert top[3] == "2"
    assert sorted(r[2] for r in ranges if r is not top) == sorted(
        name for name, n in inner.items() for _ in range(n))
    for name, n in inner.items():
        assert len(_children(ranges, top, name)) == n, name
    for voc in _children(ranges, top, "vocoder"):
        assert len(_children(ranges, voc, "vocoder.stage")) == STAGES


# -- the serving engines -----------------------------------------------------------


def _serve_schedule(eng) -> dict:
    """Three open streams, of which two start on the first tick and one
    advances again on the second; a third tick advances none.  The counters
    they must give."""
    sids = [eng.open_stream(3000.0) for _ in range(3)]
    for sid, n in zip(sids, (NEED + HOP, NEED, 10)):
        eng.push(sid, _noise(sid, n))
    assert [len(eng.tick()) for _ in range(3)] == [2, 1, 0]
    B, blocks = eng.B, len(eng._blocks)
    per_tick = B * HOP * 4 + B * 4 + B  # chunk, bits (float32), active (bool)
    return {"frames": 3, "slots_open": 6, "starts": 2,
            "h2d_copies": 2 * 3 * blocks + 2, "h2d_bytes": 2 * per_tick + 2 * 64 * 4}


def _decode_schedule(eng) -> dict:
    """As :func:`_serve_schedule` for the decoder: lost flags (0, 1) on one
    stream, (1,) on another, nothing queued on a third."""
    sids = [eng.open_stream() for _ in range(3)]
    eng.push(sids[0], np.full((2, Z), 0.5, np.float32), lost=np.array([0, 1]))
    eng.push(sids[1], np.ones((1, Z), np.float32), lost=np.array([1]))
    assert [len(eng.tick()) for _ in range(3)] == [2, 1, 0]
    B, blocks = eng.B, len(eng._blocks)
    per_tick = B * Z * 4 + B * 4 + B * 4 + B  # codes, lost, cbits, active
    return {"frames": 3, "slots_open": 6, "concealed": 2,
            "h2d_copies": 2 * 4 * blocks, "h2d_bytes": 2 * per_tick}


ENGINES = {"serve": (ServingEngine, _serve_schedule), "decode": (DecodeEngine, _decode_schedule)}


@pytest.mark.parametrize("blocks", [1, 2])
@pytest.mark.parametrize("kind", list(ENGINES))
def test_tracing_engine_counters_exact(codecs, kind, blocks):
    cls, schedule = ENGINES[kind]
    mesh = make_mesh(devices=["cpu"] * blocks) if blocks > 1 else None
    eng = cls(codecs["kernel"], max_streams=4, mesh=mesh)
    tracing.reset()  # the engine's warm tick is not a tick
    want = schedule(eng)
    snap = tracing.snapshot()
    assert {k: snap["counters"].get(f"{kind}.{k}", 0) for k in want} == want
    assert snap["spans"][f"{kind}.tick"]["count"] == 2  # the ticks that advanced a stream


@pytest.mark.parametrize("kind", list(ENGINES))
def test_tracing_engine_tick_spans(codecs, kind):
    """Each tick that advances a stream records one tick span and one of
    each part, which cover most of it; the tick that advances none records
    nothing."""
    cls, schedule = ENGINES[kind]
    eng = cls(codecs["kernel"], max_streams=4)
    tracing.reset()
    schedule(eng)
    spans = tracing.snapshot()["spans"]
    assert {p: spans[f"{kind}.{p}"]["count"] for p in ("tick",) + TICK_PARTS} == dict.fromkeys(
        ("tick",) + TICK_PARTS, 2)
    parts = sum(spans[f"{kind}.{p}"]["total_s"] for p in TICK_PARTS)
    assert 0.85 * spans[f"{kind}.tick"]["total_s"] <= parts <= spans[f"{kind}.tick"]["total_s"]
    for _ in range(3):  # idle ticks
        assert eng.tick() == {}
    assert tracing.snapshot()["spans"] == spans


@pytest.mark.parametrize("kind", list(ENGINES))
def test_tracing_profile_nests_the_tick_ranges(codecs, kind):
    """Under a CPU profile each tick is a ``bvsc.<kind>.tick#<n>`` range
    (n: the tick span's count once it ends) holding its four parts in order,
    and the device step's layers inside its ``issue``."""
    cls, schedule = ENGINES[kind]
    eng = cls(codecs["kernel"], max_streams=4)
    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        schedule(eng)
    ranges = _ranges(prof)
    ticks = [r for r in ranges if r[2] == f"{kind}.tick"]
    assert [r[3] for r in ticks] == ["1", "2"]
    layers = ["bvrnn.scan", "vocoder"] + (["mel"] if kind == "serve" else ["bvrnn.lost_read"])
    for tick in ticks:
        parts = [_children(ranges, tick, f"{kind}.{p}") for p in TICK_PARTS]
        assert [len(p) for p in parts] == [1] * 4
        assert all(a[0][1] <= b[0][0] for a, b in zip(parts, parts[1:]))  # in order
        issue = parts[2][0]
        assert all(len(_children(ranges, issue, name)) == 1 for name in layers)
        assert len(_children(ranges, issue, "vocoder.stage")) == STAGES


@pytest.mark.parametrize("kind", list(ENGINES))
def test_tracing_failed_tick_is_numbered(codecs, kind, monkeypatch):
    """A tick whose step fails records its tick span, so the next tick's
    range takes the next number."""
    cls, schedule = ENGINES[kind]
    eng = cls(codecs["kernel"], max_streams=4)
    tracing.reset()

    def fail(*args, **kwargs):
        raise RuntimeError("device lost")

    sid = eng.open_stream(3000.0) if kind == "serve" else eng.open_stream()
    if kind == "serve":
        eng.push(sid, _noise(5, NEED))
    else:
        eng.push(sid, np.full((1, Z), 0.5, np.float32), lost=np.array([0]))
    monkeypatch.setattr(eng, "_tick_call", fail)
    with pytest.raises(EngineStateLost):
        eng.tick()
    spans = tracing.snapshot()["spans"]
    assert spans[f"{kind}.tick"]["count"] == 1 and f"{kind}.wait" not in spans
    assert f"{kind}.frames" not in tracing.snapshot()["counters"]


def test_tracing_enters_no_range_without_a_profile(codecs, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a profiler range entered with no profile active")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd, "_record_function_with_args_enter", refuse)
    codecs["kernel"](_noise(2, (1, 200)), 3000.0)
    eng = ServingEngine(codecs["kernel"], max_streams=2)
    eng.push(eng.open_stream(3000.0), _noise(3, NEED))
    assert len(eng.tick()) == 1
    assert _counts()["serve.tick"] == 1 and _counts()["codec.call"] == 1


def test_tracing_export_records_nothing(codecs, tmp_path):
    """Exporting a bundle (one-shot, packet and engine programs) traces the
    layers' spans and counters but records none of them."""
    codecs["kernel"](_noise(4, (1, 200)), 3000.0)
    before = tracing.snapshot()
    E.export_serving_bundle(codecs["kernel"], str(tmp_path / "b.bvscx"), lengths=(256,),
                            engine_batch=2)
    assert tracing.snapshot() == before
