"""The port's streaming runtime (bvsc_tpu_torch.streaming, device='cpu')
against bvsc_tpu.streaming and against the port's own one-shot paths, on
the weights of tests/test_torch_codec.py: a small BVRNN (h 48, z 12, 80
mels) and the full-width vocoder (seeded across packages; within the port
the trained one, ``chkpts_npz/``, whose output follows its mel where the
seeded one's hardly does).

* Against the JAX package (one packet-codec run and one encoder chunk size,
  since the JAX stream step compiles once per chunk shape): codes bitwise,
  waveforms to 1e-4 abs and SNR > 40 dB (the cross-package bound of
  tests/test_torch_codec.py).
* Within the port, streaming against one-shot: the streaming vocoder over
  chunk patterns and the decoders to 1e-5 (the overlap-add sums in another
  order: the reference's own bound), the encoders' codes bitwise; in fast
  mode to 7e-2 (the reference's fast-serving streaming bound).  A frame
  whose analysis window reaches past the input's end reads the reflected
  tail in a stream and the length bucket's zeros one-shot, so the codes are
  held on every frame where the input length is a multiple of the bucket
  and on all but the last two elsewhere.
"""

import os

import numpy as np
import pytest
import torch

from bvsc_tpu import streaming as JS
from bvsc_tpu.eval.metrics import snr_db
from bvsc_tpu_torch import BVRNNCodecModel
from bvsc_tpu_torch import streaming as S
from bvsc_tpu_torch.config import CodecConfig
from bvsc_tpu_torch.convert import bvrnn_params_from_jax
from bvsc_tpu_torch.models import vocoder as voc_mod
from test_torch_codec import BUCKET, SMALL, _jax_codec, _port_codec, trees  # noqa: F401

torch.set_num_threads(1)

HOP = 256
L_BUCKET = 3 * BUCKET * HOP  # a multiple of the length bucket: 48 frames
L_RAGGED = 20 * HOP + 100
TAIL_FRAMES = 2  # frames whose window reaches past the input's end
STREAM_TOL = 1e-5  # streaming against one-shot within the port
FAST_TOL = 7e-2  # the reference's fast-serving streaming bound
CROSS_TOL = 1e-4  # port against bvsc_tpu (tests/test_torch_codec.py)


VOC_NPZ = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "chkpts_npz", "bvsc_vocoder_demo_cl_ft_g_step600_f16.npz")


@pytest.fixture(scope="module")
def port(trees):  # noqa: F811
    """The port's codec on the JAX side's weights."""
    return _port_codec(trees)


def _trained(trees, **kwargs):  # noqa: F811
    return BVRNNCodecModel(config=CodecConfig(**SMALL), bvrnn_params=bvrnn_params_from_jax(trees[1]),
                           vocoder_chkpt_path=VOC_NPZ, length_bucket=BUCKET, device="cpu",
                           **kwargs)


@pytest.fixture(scope="module")
def codec(trees):  # noqa: F811
    return _trained(trees)


@pytest.fixture(scope="module")
def fast(trees):  # noqa: F811
    return _trained(trees, precision="default")


@pytest.fixture(scope="module")
def x():
    return (np.random.default_rng(21).standard_normal((1, L_BUCKET)) * 0.3).astype(np.float32)


def _packets(fc, x, hop=HOP):
    """``x`` through a packet codec in hop-sized packets, the remainder,
    then ``flush()``; returns the waveform and the codes of every step."""
    codes, step = [], fc._step

    def recording(chunk):
        out = step(chunk)
        codes.append(np.asarray(out[0]))
        return out

    fc._step = recording
    L = x.shape[1]
    outs = [fc.process(x[:, i: i + hop]) for i in range(0, L - hop + 1, hop)]
    if L % hop:
        outs.append(fc.process(x[:, L - L % hop:]))
    outs.append(fc.flush())
    wav = np.concatenate([np.asarray(o) for o in outs], 1)
    # flush() may step past the last frame it emits: keep the emitted frames' codes
    return wav, np.stack(codes, 1)[:, : wav.shape[1] // hop]


def _encode_stream(enc, x, chunk):
    outs = [enc.feed(x[:, i: i + chunk]) for i in range(0, x.shape[1], chunk)]
    return np.concatenate([np.asarray(o) for o in outs + [enc.flush()]], 1)


@pytest.fixture(scope="module")
def jax_side(trees, x):  # noqa: F811
    """The JAX package's one-shot resynthesis and codes, one packet-codec
    run and one encoder run (chunks of 256)."""
    jc = _jax_codec(trees)
    wav, codes = _packets(JS.FusedPacketCodec(jc, batch=1, bitrate=3000), x)
    return {"oneshot": np.asarray(jc(x, 3000)), "encode": np.asarray(jc.encode(x, 3000)),
            "packet": wav, "packet_codes": codes,
            "encoder": _encode_stream(JS.StreamingEncoder(jc, batch=1, bitrate=3000), x, HOP)}


def _close(got, ref, tol=CROSS_TOL):
    assert got.shape == ref.shape and np.isfinite(got).all()
    assert snr_db(ref, got) > 40.0
    np.testing.assert_allclose(got, ref, atol=tol)


@pytest.mark.parametrize("ref", ["packet", "oneshot"])
def test_packet_codec_matches_jax(port, x, jax_side, ref):
    wav, codes = _packets(S.FusedPacketCodec(port, batch=1, bitrate=3000), x)
    np.testing.assert_array_equal(codes, jax_side["packet_codes" if ref == "packet" else "encode"])
    _close(wav, jax_side[ref])


@pytest.mark.parametrize("ref", ["encoder", "encode"])
def test_encoder_matches_jax(port, x, jax_side, ref):
    codes = _encode_stream(S.StreamingEncoder(port, batch=1, bitrate=3000), x, HOP)
    np.testing.assert_array_equal(codes, jax_side[ref])


@pytest.mark.parametrize("chunks", [[24], [1] * 24, [3, 5, 7, 9], [10, 14]],
                         ids=["whole", "frames", "rising", "halves"])
def test_stream_vocoder_equals_oneshot(codec, chunks):
    cfg = codec.conf.vocoder_config
    # log-mel-like frames: the trained vocoder's inputs lie around -11..2
    mel = torch.from_numpy(2 * np.random.default_rng(22).standard_normal((2, 80, 24)).astype(
        np.float32) - 4)
    ref = voc_mod.generator_apply_kernel(codec.vocoder_params, codec.kernel_blocks, cfg, mel,
                                         24 * HOP)
    state, outs, t = S.generator_stream_init(cfg, 2, "cpu"), [], 0
    for n in chunks:
        state, y = S.generator_stream_step(codec.weights.vocoder, state, mel[..., t: t + n])
        outs.append(y)
        t += n
    got = torch.cat(outs, -1)
    assert got.shape == (2, 1, 24 * HOP) and got.device.type == "cpu"
    assert (ref[0] - ref[1]).abs().max() > 1e3 * STREAM_TOL  # the output follows the mel
    assert (got - ref).abs().max().item() <= STREAM_TOL


def test_stage_state_after_a_step(codec):
    """Each stage carries the last CTX samples of its input and counts what
    its stream fed it, saturating at CTX."""
    cfg = codec.conf.vocoder_config
    ctx = S.stage_context(cfg)
    assert ctx == 120
    state = S.generator_stream_init(cfg, 1, "cpu")
    mel = torch.zeros(1, 80, 1)
    fed = []
    for _ in range(3):
        state, _ = S.generator_stream_step(codec.weights.vocoder, state, mel)
        fed.append([int(st["fed"]) for st in state["stages"]])
        assert [st["ctx"].shape[-1] for st in state["stages"]] == [ctx] * 4
    assert fed == [[8, 64, 120, 120], [16, 120, 120, 120], [24, 120, 120, 120]]


@pytest.mark.parametrize("length", [L_BUCKET, L_RAGGED], ids=["bucket", "ragged"])
@pytest.mark.parametrize("chunk", [256, 768, 1000, 4096])
def test_encoder_equals_encode(codec, x, chunk, length):
    xs = x[:, :length]
    ref = codec.encode(xs, 3000).numpy()
    codes = _encode_stream(S.StreamingEncoder(codec, batch=1, bitrate=3000), xs, chunk)
    assert codes.shape == ref.shape
    inside = ref.shape[1] if length % (BUCKET * HOP) == 0 else ref.shape[1] - TAIL_FRAMES
    np.testing.assert_array_equal(codes[:, :inside], ref[:, :inside])


def test_first_frame_latency(codec, x):
    """The first code frame appears once 768 samples (34.8 ms) arrived."""
    enc = S.StreamingEncoder(codec, batch=1, bitrate=3000)
    assert enc.feed(x[:, :767]).shape[1] == 0
    assert enc.feed(x[:, 767:768]).shape[1] == 1


@pytest.mark.parametrize("length", [L_BUCKET, L_RAGGED], ids=["bucket", "ragged"])
def test_packet_codec_equals_oneshot(codec, x, length):
    xs = x[:, :length]
    ref = codec(xs, 3000).numpy()
    wav, codes = _packets(S.FusedPacketCodec(codec, batch=1, bitrate=3000), xs)
    n = codes.shape[1]
    assert n == codec.frontend.num_frames(length) and wav.shape == (1, n * HOP)
    inside = n if length % (BUCKET * HOP) == 0 else n - TAIL_FRAMES
    np.testing.assert_array_equal(codes[:, :inside], codec.encode(xs, 3000).numpy()[:, :inside])
    np.testing.assert_allclose(wav[:, : inside * HOP], ref[:, : inside * HOP], atol=STREAM_TOL)


def test_streaming_codec_equals_oneshot(codec, x):
    sc = S.StreamingCodec(codec, batch=1, bitrate=3000)
    outs = [sc.process(x[:, i: i + 1024]) for i in range(0, x.shape[1], 1024)]
    wav = torch.cat(outs + [sc.flush()], 1).numpy()
    ref = codec(x, 3000, fused=False).numpy()
    np.testing.assert_allclose(wav[:, : ref.shape[1]], ref, atol=STREAM_TOL)


@pytest.fixture(scope="module")
def codes2(codec):
    """Codes of a seeded two-stream input."""
    x2 = (np.random.default_rng(23).standard_normal((2, 12 * HOP)) * 0.3).astype(np.float32)
    return codec.encode(x2, 3000)


def test_decoder_frame_by_frame(codec, codes2):
    B, T = codes2.shape[:2]
    whole = S.StreamingDecoder(codec, batch=B).feed(codes2)
    dec = S.StreamingDecoder(codec, batch=B)
    parts = torch.cat([dec.feed(codes2[:, t: t + 1]) for t in range(T)], 1)
    assert parts.shape == (B, T * HOP)
    assert (parts - whole).abs().max().item() <= STREAM_TOL
    ref = codec.decode(codes2, T * HOP)
    assert (whole - ref).abs().max().item() <= STREAM_TOL


@pytest.mark.parametrize("conceal_bitrate", [None, 1000.0, [1000.0, 3000.0]],
                         ids=["all_bits", "scalar", "per_stream"])
def test_decoder_concealment_equals_decode_lost(codec, codes2, conceal_bitrate):
    """feed(lost=) and conceal() against decode(lost=, conceal_bitrate=)."""
    B, T = codes2.shape[:2]
    lost = np.zeros((B, T), np.float32)
    lost[0, 3:6] = 1.0
    lost[1, [2, 9]] = 1.0
    cbps = None if conceal_bitrate is None else np.broadcast_to(
        np.asarray(conceal_bitrate, np.float64)[..., None], (B, T))
    ref = codec.decode(codes2, T * HOP, lost=lost, conceal_bitrate=cbps)
    dec = S.StreamingDecoder(codec, batch=B, conceal_bitrate=conceal_bitrate)
    got = torch.cat([dec.feed(codes2[:, t: t + 1], lost=lost[:, t: t + 1]) for t in range(T)], 1)
    assert (got - ref).abs().max().item() <= STREAM_TOL
    # conceal(): every stream lost frames 4 and 5
    lost_all = np.zeros((B, T), np.float32)
    lost_all[:, 4:6] = 1.0
    ref = codec.decode(codes2, T * HOP, lost=lost_all, conceal_bitrate=cbps)
    dec = S.StreamingDecoder(codec, batch=B, conceal_bitrate=conceal_bitrate)
    got = torch.cat([dec.feed(codes2[:, :4]), dec.conceal(2), dec.feed(codes2[:, 6:])], 1)
    assert (got - ref).abs().max().item() <= STREAM_TOL


def test_fast_mode_equals_fast_offline(fast, x):
    """precision='default': the packet codec and the decoder run the fast
    offline path's numerics (bf16 products, K1-bf16's plain version)."""
    assert S.voc_compute_dtype(fast) == torch.bfloat16
    assert S.voc_state_dtype(fast) == torch.float32
    ref = fast(x, 3000).numpy()
    wav, _ = _packets(S.FusedPacketCodec(fast, batch=1, bitrate=3000), x)
    assert np.abs(wav - ref).max() <= FAST_TOL
    codes = fast.encode(x, 3000)
    wav = S.StreamingDecoder(fast, batch=1).feed(codes)
    assert (wav - fast.decode(codes, x.shape[1])).abs().max().item() <= FAST_TOL


@pytest.mark.parametrize("field", [{"layers_sym": (True, False, False, False)},
                                   {"pre_sym": True},
                                   {"layers_antialias": (True, False, False, False)},
                                   {"antialias_post": True}])
def test_noncausal_configs_raise(field):
    cfg = CodecConfig().vocoder_config
    with pytest.raises(ValueError, match="causal|anti-aliased"):
        S.generator_stream_init(cfg.__class__(**{**cfg.__dict__, **field}), 1, "cpu")


def test_devices(codec, x):
    """A CPU codec's streams stay on the CPU; the default device raises
    without a card."""
    assert S.FusedPacketCodec(codec).process(x[:, :1024]).device.type == "cpu"
    assert S.StreamingEncoder(codec).feed(x[:, :1024]).device.type == "cpu"
    assert S.StreamingDecoder(codec).voc_state["conv_pre"].device.type == "cpu"
    if torch.cuda.is_available():
        pytest.skip("a card is present; the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        S.generator_stream_init(CodecConfig().vocoder_config, 1)
