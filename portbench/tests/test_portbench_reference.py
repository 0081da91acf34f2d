"""The plain reference against ``bvsc_tpu_torch``'s CPU path on the same
seeded weights, at small BVRNN widths (h 48, z 12) and the full vocoder:
one-shot calls, a 128-slot tick stream replayed as one-shot calls, and
concealed decoding; and a lower precision that fails the comparison.
``pytest portbench/tests``."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench import run as bench
from portbench.lib import program, seeds
from portbench.lib.speech import speech
from portbench.lib.weights import make_weights
from portbench.reference import bvrnn_codec as R
from portbench.reference.compare import Judge, code_gap

CELL = "varbit-f32.offline-b256"
FS, HOP = 22050, 256


def limits(cell=CELL) -> dict:
    return {k: v["limit"] for k, v in bench.cell_spec(cell)["limits"]["limits"].items()}


@pytest.fixture(scope="module")
def small():
    spec = bench.cell_spec(CELL)
    conf = spec["conf"]
    conf["codec"].update(h_dim=48, z_dim=12)
    bv, voc = make_weights(conf["codec"], 2**31 + 21, "cpu")
    x = speech(seeds.generator(9, "t", "cpu"), 3, 9000, FS, "cpu")
    return conf, bv, voc, x


def _bits(rows):
    return np.array([3, 7, 12][:rows])


def test_portbench_reference_one_shot_matches_the_program(small):
    conf, bv, voc, x = small
    codec = program.build_codec(conf, bv, voc, "cpu")
    holder = {}
    frames = 1 + (x.shape[1] - HOP) // HOP
    with program.capture_scan(holder):
        y = codec(x, np.repeat((_bits(3) * FS / HOP)[:, None], frames, 1))
    codes, _ = holder["scan"]
    pad = 16384
    items = [{"x": x[r], "pad_to": pad, "bits": int(b), "codes": codes[r], "y": y[r]}
             for r, b in enumerate(_bits(3))]
    judge = Judge(conf, bv, voc, "cpu")
    judge.encode_items(items)
    got, lim = judge.numbers(), limits()
    assert all(got[k] <= lim[k] for k in lim), (got, lim)
    # run free, the reference takes the program's decisions
    fe = R.Frontend(conf["codec"], "cpu")
    mel = fe(torch.nn.functional.pad(x, (0, pad - x.shape[1])))
    bits = torch.as_tensor(_bits(3), dtype=torch.float32)[:, None].expand(3, mel.shape[1])
    mask = R.bit_mask(bits, 12)
    mask[:, frames:] = 0
    _, free, _ = R.encode_decode(bv, mel, mask)
    assert (free == codes).float().mean() > 0.99


def test_portbench_reference_replays_a_128_slot_tick_stream(small):
    conf, bv, voc, x = small
    m = program.import_program()
    codec = program.build_codec(conf, bv, voc, "cpu")
    eng = m["engine"].ServingEngine(codec, max_streams=128)
    lengths = [9000, 6000, 4100]
    outs = {}
    for r, (L, b) in enumerate(zip(lengths, _bits(3))):
        sid = eng.open_stream(b * FS / HOP)
        eng.push(sid, x[r, :L].numpy())
        eng.begin_flush(sid)
        outs[sid] = (r, L, int(b), [])
    while any(eng.has_frame(s) for s in outs):
        for sid, res in eng.tick().items():
            outs[sid][3].append(res)
    items = []
    for r, L, b, res in outs.values():
        assert len(res) == 1 + (L - HOP) // HOP
        items.append({"x": x[r, :L], "pad_to": L, "bits": b,
                      "codes": np.stack([c for c, _ in res]),
                      "y": np.concatenate([w for _, w in res])})
    judge = Judge(conf, bv, voc, "cpu")
    judge.encode_items(items)
    got, lim = judge.numbers(), limits("varbit-f32.serve128")
    assert all(got[k] <= lim[k] for k in lim), (got, lim)


def test_portbench_reference_conceals_as_decode_plc(small):
    conf, bv, voc, _ = small
    codec = program.build_codec(conf, bv, voc, "cpu")
    rng = np.random.default_rng(3)
    T, bits = 60, [5, 12]
    codes = (rng.random((2, T, 12)) < 0.5).astype(np.float32)
    for r, b in enumerate(bits):
        codes[r, :, b:] = 0.5
    lost = np.zeros((2, T), np.float32)
    lost[0, 10:13] = lost[1, 30:40] = lost[1, 50] = 1
    y = codec.decode(codes, T * HOP, lost=lost,
                     conceal_bitrate=np.repeat(np.array(bits)[:, None] * FS / HOP, T, 1))
    items = [{"codes": codes[r], "lost": lost[r], "conceal_bits": bits[r], "y": y[r]}
             for r in range(2)]
    judge = Judge(conf, bv, voc, "cpu")
    judge.decode_items(items)
    got, lim = judge.numbers(), limits("varbit-f32.decode128-loss10")
    assert set(got) == {"wave_err"} and got["wave_err"] <= lim["wave_err"], (got, lim)
    # the concealment matters: decoding the lost frames as received moves the audio
    plain = codec.decode(codes, T * HOP)
    assert (plain - y).abs().max() > 100 * lim["wave_err"]


def test_portbench_lower_precision_fails_the_comparison(small):
    conf, bv, voc, x = small
    codec = program.build_codec(conf, bv, voc, "cpu", precision="default")
    holder = {}
    frames = 1 + (x.shape[1] - HOP) // HOP
    with program.capture_scan(holder):
        y = codec(x, np.repeat((_bits(3) * FS / HOP)[:, None], frames, 1))
    codes = holder["scan"][0]
    items = [{"x": x[r], "pad_to": 16384, "bits": int(b), "codes": codes[r], "y": y[r]}
             for r, b in enumerate(_bits(3))]
    judge = Judge(conf, bv, voc, "cpu")
    judge.encode_items(items)
    got, lim = judge.numbers(), limits()
    assert any(got[k] > lim[k] for k in lim), (got, lim)


def test_portbench_code_gap_reads_faults_as_one():
    probs = torch.tensor([[0.9, 0.2, 0.6, 0.5]])
    mask = torch.tensor([[1.0, 1.0, 1.0, 0.0]])
    assert code_gap(probs, torch.tensor([[1.0, 0.0, 1.0, 0.5]]), mask) == 0.0
    assert code_gap(probs, torch.tensor([[1.0, 0.0, 0.0, 0.5]]), mask) == pytest.approx(0.1)
    assert code_gap(probs, torch.tensor([[1.0, 0.5, 1.0, 0.5]]), mask) == 1.0
    assert code_gap(probs, torch.tensor([[1.0, 0.0, 1.0, 1.0]]), mask) == 1.0


@pytest.mark.parametrize("kind", ["tf32", "bf16", "fp8"])
def test_portbench_rounding_keeps_its_mantissa(kind):
    x = torch.tensor([1 + 2**-12, 3.0, -1.0 / 3])
    bits = {"tf32": 10, "bf16": 7, "fp8": 3}[kind]
    got = R.round_to(x, kind)
    assert torch.all((got - x).abs() <= x.abs() * 2.0 ** -(bits + 1))
    assert got[1] == 3.0
