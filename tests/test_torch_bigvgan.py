"""The published BigVGAN as the codec's vocoder, on the CPU, against the
benchmark's plain reference (``portbench/reference/bigvgan.py``, which
imports nothing of the port and no JAX).

The configuration is the benchmark's ``varbit-bigvgan-f32`` (the published
rates 4-4-2-2-2-2, kernels 8-8-4-4-4-4, k 3/7/11 and d 1/3/5, every
padding symmetric and every activation anti-aliased) at a small size: a
BVRNN of h 48, z 12 and ``upsample_initial_channel`` 64 (stages 32 -> 1
channels), on the benchmark's seeded weights (``portbench/lib/weights.py``).

Gates, and why:

* the generator within 1e-5 of the output's peak: both sides compute in
  float32 with the same operations, so only the order of float32 sums and
  the taps' last ulp (the reference derives them in float64) differ;
* the codec: codes equal (both run the same float32 closed loop from the
  same weights), the waveform within 1e-4 of its peak (the codec gate of
  the JAX package against upstream, ROADMAP.md);
* the tail: the codec's waveform within 1e-5 of the reference's peak when
  the reference vocodes the first ceil(L / hop) decoded frames (float32
  reorderings only), while vocoding the whole length bucket moves the
  clip's last 26 frames by more than 1e-3 of it and nothing 40 frames or
  more before its end by 1e-5 (the generator looks ahead ~37 frames, by
  more than 1e-5 of the peak ~21);
* a causal configuration's output bitwise what vocoding the whole bucket
  gives (its samples before L do not depend on later frames);
* the counters exact: they count shapes.
"""

from __future__ import annotations

import copy
import json
import os

import numpy as np
import pytest
import torch

from bvsc_tpu_torch import streaming as S
from bvsc_tpu_torch.codec import SCALING, BVRNNCodecModel, _decode_impl, _forward_impl
from bvsc_tpu_torch.config import CodecConfig, load_config
from bvsc_tpu_torch.models import vocoder as TV
from bvsc_tpu_torch.ops import resample as TR
from bvsc_tpu_torch.serve import engine as E
from bvsc_tpu_torch.utils import tracing
from portbench.lib import program, seeds
from portbench.lib.speech import speech
from portbench.lib.weights import make_weights
from portbench.reference import bigvgan as RV, bvrnn_codec as R, compare_bigvgan

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FS, HOP, BUCKET = 22050, 256, 64
F32 = {"mel": "f32", "bvrnn": "f32", "vocoder": "f32"}
GEN_TOL = 1e-5
WAVE_TOL = 1e-4
TAIL_TOL = 1e-5
TAIL_MOVE = 1e-3
TAIL = 26  # the clip's last frames, which the bucket's padding frames move
REACH = 40  # frames back from the clip's end past which they move nothing


def bench_conf(name: str) -> dict:
    with open(os.path.join(ROOT, "portbench", "configs", f"{name}.json")) as f:
        return json.load(f)


def small(name: str = "varbit-bigvgan-f32") -> dict:
    """The configuration's codec section at h 48, z 12; BigVGAN at 64
    initial channels."""
    codec = copy.deepcopy(bench_conf(name)["codec"])
    codec.update(h_dim=48, z_dim=12)
    if name == "varbit-bigvgan-f32":
        codec["vocoder_config"]["upsample_initial_channel"] = 64
    return codec


@pytest.fixture(scope="module")
def bigvgan():
    codec = small()
    bv, voc = make_weights(codec, 2**31 + 28, "cpu")
    return codec, bv, voc


def build(codec: dict, bv: dict, voc: dict, **kw) -> BVRNNCodecModel:
    kw.setdefault("use_pallas", False)
    return BVRNNCodecModel(config=CodecConfig.from_dict(codec), bvrnn_params=bv,
                           vocoder_params=voc, device="cpu", length_bucket=BUCKET, **kw)


def inputs(rows: int, length: int, seed: int = 5):
    """(speech (rows, length), bits a frame a row, the codec's bitrate)."""
    x = speech(seeds.generator(seed, "speech", "cpu"), rows, length, FS, "cpu")
    bits = np.array([3, 12, 7, 9][:rows])
    frames = 1 + (length - HOP) // HOP
    return x, bits, np.repeat((bits * FS / HOP)[:, None], frames, 1)


def test_generator_matches_reference(bigvgan):
    codec, _, voc = bigvgan
    vcfg = CodecConfig.from_dict(codec).vocoder_config
    mel = torch.randn(2, 80, 8, generator=torch.Generator().manual_seed(1)) - 5
    with torch.no_grad(), R.exact_float32():
        got = TV.generator_apply(voc, vcfg, mel)[:, 0] / SCALING
        ref = RV.vocoder(voc, codec["vocoder_config"], mel, 8 * HOP)
    assert got.shape == ref.shape == (2, 8 * HOP)
    peak = float(ref.abs().max())
    assert peak > 0.05  # a signal, not silence
    assert float((got - ref).abs().max()) <= GEN_TOL * peak


@pytest.mark.parametrize("use_pallas", [None, False])
def test_codec_matches_reference(bigvgan, use_pallas):
    """__call__ (use_pallas None resolves to the direct path) against the
    reference run free: codes equal, waveform within the codec gate."""
    codec, bv, voc = bigvgan
    model = build(codec, bv, voc, use_pallas=use_pallas)
    assert model.use_pallas is False and model.weights.direct
    x, bits, rate = inputs(2, 9000)
    holder = {}
    with program.capture_scan(holder):
        y = model(x, rate)
    items = [{"x": x[r], "pad_to": BUCKET * HOP, "bits": int(bits[r])} for r in range(2)]
    compare_bigvgan.encode(F32, bv, voc, codec, items, "cpu")
    for r, it in enumerate(items):
        n = it["codes"].shape[0]
        assert torch.equal(holder["scan"][0][r, :n].float(), it["codes"])
        peak = float(it["y"].abs().max())
        assert float((y[r] - it["y"]).abs().max()) <= WAVE_TOL * peak


@pytest.mark.parametrize("call", ["call", "decode"])
def test_tail_vocodes_the_clip_frames_only(bigvgan, call):
    """The codec's waveform is the reference's from ceil(L / hop) frames;
    the whole bucket's would move the clip's last frames."""
    codec, bv, voc = bigvgan
    model = build(codec, bv, voc)
    L = 72 * HOP + 77  # 73 frames vocoded of a 128-frame bucket
    x, bits, rate = inputs(2, L, seed=6)
    holder = {}
    with torch.no_grad(), program.capture_scan(holder):
        y = model(x, rate)
    codes = holder["scan"][0]
    n = 1 + (L - HOP) // HOP
    if call == "decode":
        y = model.decode(codes[:, :n], L)
    judge = compare_bigvgan.Judge({"codec": codec, "reference_arith": F32}, bv, voc, "cpu")
    Lp = 2 * BUCKET * HOP
    judge.encode_items([{"x": x[r], "pad_to": Lp, "bits": int(bits[r]),
                         "codes": codes[r, :n], "y": y[r]} for r in range(2)])
    assert judge.numbers()["wave_err"] <= TAIL_TOL
    # vocoding the whole bucket, then cutting to L
    with torch.no_grad():
        xp = torch.nn.functional.pad(x, (0, Lp - L))
        whole = _forward_impl(model.weights, xp, model._frame_bits(rate, 2, L, Lp, n), n, Lp)
    move = (whole[:, :L] - y).abs().amax(0)
    peak = float(y.abs().max())
    assert float(move[(L // HOP - TAIL) * HOP:].max()) > TAIL_MOVE * peak
    assert float(move[: (L // HOP - REACH) * HOP].max()) <= TAIL_TOL * peak


@pytest.mark.parametrize("use_pallas", [True, False])
def test_causal_output_unchanged(use_pallas):
    """varbit-f32 (causal BigVGAN-tiny) on K1's plain version and on the
    direct path: __call__ and decode bitwise what vocoding the whole length
    bucket and cutting to L gives."""
    codec = small("varbit-f32")
    bv, voc = make_weights(codec, 11, "cpu")
    model = build(codec, bv, voc, use_pallas=use_pallas)
    L = 20 * HOP + 31
    x, _, rate = inputs(2, L)
    Lp = BUCKET * HOP
    n = 1 + (L - HOP) // HOP
    with torch.no_grad():
        y = model(x, rate)
        xp = torch.nn.functional.pad(x, (0, Lp - L))
        ref = _forward_impl(model.weights, xp, model._frame_bits(rate, 2, L, Lp, n), n, Lp)
        assert torch.equal(y, ref[:, :L])
        codes = model.encode(x, rate)
        pad = torch.nn.functional.pad(codes, (0, 0, 0, BUCKET - n), value=0.5)
        assert torch.equal(model.decode(codes, L), _decode_impl(model.weights, pad, Lp)[:, :L])


def test_aa_spans_and_elements(bigvgan):
    """One call: 6 stages x 18 + 1 anti-aliased activations, and their
    elements rows x sum of C x T, on the ceil(L / hop) frames vocoded."""
    codec, bv, voc = bigvgan
    model = build(codec, bv, voc)
    L = 30 * HOP + 5
    x, _, rate = inputs(2, L)
    tracing.reset()
    with torch.no_grad():
        model(x, rate)
    snap = tracing.snapshot()
    v = codec["vocoder_config"]
    assert snap["spans"]["vocoder.aa"]["count"] == 6 * 18 + 1
    frames = -(-L // HOP)
    c, rate_, per_frame = v["upsample_initial_channel"], 1, 0
    for u in v["upsample_rates"]:
        c //= 2
        rate_ *= u
        per_frame += 2 * 9 * c * rate_  # 3 blocks x 3 dilations x 2 activations
    per_frame += c * rate_  # activation_post
    assert snap["counters"]["vocoder.aa_elements"] == 2 * frames * per_frame


def test_resample_taps_stay_on_the_device():
    """Activation1d's taps are made once per (device, dtype) and reused:
    the same tensor across calls, bitwise the float32 filter."""
    x = torch.randn(2, 4, 50)
    act = TR.Activation1d(torch.sin)
    act(x)
    n = len(TR._device_taps)
    up = TR._depthwise(act.upsample.filter, x)
    TR.Activation1d(torch.sin)(x)  # a new instance, as the vocoder makes one an activation
    assert len(TR._device_taps) == n
    again = TR._depthwise(act.upsample.filter, x)
    assert again.data_ptr() == up.data_ptr() and up.shape == (4, 1, 12)
    assert torch.equal(up[0], torch.from_numpy(act.upsample.filter[0]))
    wide = TR._depthwise(act.upsample.filter, x.double())
    assert wide.dtype == torch.float64 and wide.data_ptr() != up.data_ptr()


@pytest.mark.parametrize("make", [
    lambda c: E.ServingEngine(c, max_streams=2),
    lambda c: E.DecodeEngine(c, max_streams=2),
    lambda c: S.FusedPacketCodec(c),
    lambda c: S.StreamingDecoder(c),
    lambda c: S.StreamingCodec(c),
], ids=["ServingEngine", "DecodeEngine", "FusedPacketCodec", "StreamingDecoder",
        "StreamingCodec"])
def test_streaming_refused_at_construction(bigvgan, make):
    codec, bv, voc = bigvgan
    with pytest.raises(ValueError, match="causal"):
        make(build(codec, bv, voc))


def test_shipped_toml_is_the_benchmark_configuration():
    got = load_config(os.path.join(ROOT, "configs", "varbitrate_bigvgan.toml"))
    assert got == CodecConfig.from_dict(bench_conf("varbit-bigvgan-f32")["codec"])
    assert not got.vocoder_config.causal and got.vocoder_config.upsample_initial_channel == 1536
