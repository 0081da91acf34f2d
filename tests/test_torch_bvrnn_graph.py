"""The BVRNN scan's chunk graphs (``models.bvrnn._ChunkGraph``) on the card,
at full width and the offline cells' batches: replays bitwise the eager loop,
captured once a key, outputs owned by their call, frames counted.  Card
only (``gpu``; each test skips without one).  The file imports no JAX, so
that on the card it runs without ``tests/conftest.py``:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_bvrnn_graph.py

The chunk plumbing itself is held to the loop on the CPU in
``tests/test_torch_bvrnn.py``.
"""

import pytest
import torch

from bvsc_tpu_torch.convert import to_torch
from bvsc_tpu_torch.models import bvrnn as tb
from bvsc_tpu_torch.utils import tracing

FRAMES = 576  # a 6-s clip's length bucket
REAL = 516  # its real frames; the codes of the rest are 0.5
# the offline cells' scans, and a small batch's fused cell ('auto' below
# FUSED_AUTO_MAX_B): (batch, precision, var_bit)
CELLS = {"b256-highest": (256, "highest", True), "b512-default": (512, "default", False),
         "b4-highest-fused": (4, "highest", True)}


@pytest.fixture(scope="module")
def prepared():
    """Per cell, (config, ScanParams) of full-width seeded weights (80 mels,
    h 1024, z 64) on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = {}
    for name, (_, precision, var_bit) in CELLS.items():
        cfg = tb.BVRNNConfig(var_bit=var_bit, precision=precision, fused_cell="auto")
        params = to_torch(tb.init_bvrnn_params(0, cfg), "cuda")
        out[name] = (cfg, tb.prepare(params, cfg))
    return out


def _fresh(prepared, cell):
    """The cell's config and its weights with an empty graph cache."""
    cfg, sp = prepared[cell]
    return cfg, tb.ScanParams(sp.std, sp.fused)


def _inputs(cell, seed):
    """(mel, bits a frame or None, frame_valid, h0) of a seeded call."""
    B, _, var_bit = CELLS[cell]
    g = torch.Generator().manual_seed(seed)
    y = torch.randn(B, FRAMES, 80, generator=g) * 2.0
    bits = None
    if var_bit:
        bits = torch.randint(16, 65, (B, 1), generator=g).float().expand(B, FRAMES).cuda()
    valid = (torch.arange(FRAMES) < REAL).float().expand(B, FRAMES).cuda()
    return y.cuda(), bits, valid, torch.zeros(B, 1024, device="cuda")


def _counters():
    c = tracing.snapshot()["counters"]
    return c.get("bvrnn.graph_captures", 0), c.get("bvrnn.graph_frames", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("cell", list(CELLS))
def test_graph_is_the_eager_scan(prepared, monkeypatch, cell):
    """encode_decode's codes, mel and final state, encode's states and
    decode's mel and state: the graph replays bitwise the eager loop."""
    cfg, sp = _fresh(prepared, cell)
    y, bits, valid, h0 = _inputs(cell, 1)

    def calls():
        codes, mel, h = tb.encode_decode(sp, cfg, y, bits, h0, frame_valid=valid)
        enc = tb.encode(sp, cfg, y, bits, h0)
        dec = tb.decode(sp, cfg, codes, h0)
        torch.cuda.synchronize()
        return (codes, mel, h) + enc + dec

    tracing.reset()
    with torch.no_grad():
        got = calls()
        captures, frames = _counters()
        monkeypatch.setattr(tb, "_chunk_graph", lambda *a: None)
        ref = calls()
    assert captures == 3  # encode_decode, encode (with states), decode
    assert frames == 3 * FRAMES * CELLS[cell][0]
    for name, g, r in zip(["codes", "mel", "h", "enc codes", "enc states", "dec mel", "dec h"],
                          got, ref):
        assert g.shape == r.shape and torch.equal(g, r), name


@pytest.mark.gpu
@pytest.mark.parametrize("cell", list(CELLS))
def test_graph_captured_once_and_frames_counted(prepared, cell):
    """A second call captures nothing new; each call counts its whole
    bucketed scan, frames x rows."""
    cfg, sp = _fresh(prepared, cell)
    B = CELLS[cell][0]
    tracing.reset()
    with torch.no_grad():
        for i in range(3):
            y, bits, valid, h0 = _inputs(cell, 10 + i)
            tb.encode_decode(sp, cfg, y, bits, h0, frame_valid=valid)
            assert _counters() == (1, (i + 1) * FRAMES * B)


@pytest.mark.gpu
def test_flipped_tf32_flag_captures_anew(prepared):
    """A float32 product captured without TF32 is not replayed with the flag
    on: the flipped flag gets a graph of its own, and the old one serves
    again once it is restored."""
    cell = "b256-highest"
    cfg, sp = _fresh(prepared, cell)
    y, bits, valid, h0 = _inputs(cell, 2)
    mm = torch.backends.cuda.matmul
    was = mm.allow_tf32
    tracing.reset()
    try:
        with torch.no_grad():
            mm.allow_tf32 = False
            tb.encode_decode(sp, cfg, y, bits, h0, frame_valid=valid)
            mm.allow_tf32 = True
            tb.encode_decode(sp, cfg, y, bits, h0, frame_valid=valid)
            assert _counters()[0] == 2
            mm.allow_tf32 = False
            tb.encode_decode(sp, cfg, y, bits, h0, frame_valid=valid)
            assert _counters()[0] == 2
    finally:
        mm.allow_tf32 = was
    assert len(sp.graphs) == 2


@pytest.mark.gpu
@pytest.mark.parametrize("cell", list(CELLS))
def test_earlier_outputs_survive_later_calls(prepared, cell):
    """Every tensor a call returns is its own: an earlier call's codes, mel
    and state are unchanged after two later calls on other inputs."""
    cfg, sp = _fresh(prepared, cell)
    y, bits, valid, h0 = _inputs(cell, 3)
    with torch.no_grad():
        first = tb.encode_decode(sp, cfg, y, bits, h0, frame_valid=valid)
        kept = [t.clone() for t in first]
        for seed in (4, 5):
            y, bits, valid, h0 = _inputs(cell, seed)
            later = tb.encode_decode(sp, cfg, y, bits, h0, frame_valid=valid)
        torch.cuda.synchronize()
    assert not torch.equal(later[1], kept[1])  # the later calls did other work
    for name, t, k in zip(["codes", "mel", "h"], first, kept):
        assert torch.equal(t, k), name


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["b4-highest-fused", "b256-highest"])
def test_graph_on_a_device_not_current(monkeypatch, cell):
    """A scan on cuda:1 while cuda:0 is the current device captures and
    replays on cuda:1: codes, mel and state bitwise the loop's there."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    B, precision, var_bit = CELLS[cell]
    cfg = tb.BVRNNConfig(var_bit=var_bit, precision=precision, fused_cell="auto")
    sp = tb.prepare(to_torch(tb.init_bvrnn_params(0, cfg), "cuda:1"), cfg)
    args = [None if t is None else t.to("cuda:1") for t in _inputs(cell, 6)]
    y, bits, valid, h0 = args
    tracing.reset()
    with torch.no_grad(), torch.cuda.device(0):
        got = tb.encode_decode(sp, cfg, y, bits, h0, frame_valid=valid)
        captures, frames = _counters()
        monkeypatch.setattr(tb, "_chunk_graph", lambda *a: None)
        ref = tb.encode_decode(sp, cfg, y, bits, h0, frame_valid=valid)
        torch.cuda.synchronize(1)
    assert (captures, frames) == (1, FRAMES * B)
    for name, g, r in zip(["codes", "mel", "h"], got, ref):
        assert g.device == torch.device("cuda:1") and torch.equal(g, r), name
