"""The bf16 storage dtype (``BVRNNCodecModel(dtype=bfloat16)``) on the CPU:
against ``bvsc_tpu`` with ``dtype=jnp.bfloat16`` on the same numpy-seeded
weights, and within the port on every serving path.

The BVRNN is the small config of tests/test_torch_codec.py (h 48, z 12, 80
mels); the vocoder is full width, seeded across packages and the trained
``chkpts_npz`` one within the port (its output follows its mel).

* **One step from shared state** (the parity gate).  A bf16 closed loop is
  chaotic: any change in rounding order grows into another trajectory
  within a few frames (the reference against itself with 1 % of its weights
  moved by one bf16 step keeps 92.0 % of its active code bits, ROADMAP.md's
  watch list).  So each port step starts from the reference's own state:
  the JAX package's scan runs frame by frame (T = 1) for
  :data:`STEP_FRAMES` frames, and from its state before every frame the
  port runs the same step (teacher forcing: the JAX state is fed each
  frame).  Per cell (standard, fused, int8) and step (``encode_with_state``,
  ``encode_decode``, ``decode``, ``decode_plc`` in ``'expect'`` and
  ``'map'``): the encoder's probabilities, the decoded mel and the next state
  within :data:`ULPS` bf16 ulps of the tensor's largest magnitude (an
  element that comes out of a cancellation, as the GRU's update can, is
  small against the operands whose rounding it carries); codes equal,
  except where the reference's encoder output lies within one ulp of 0.5
  (counted, printed).  Measured on this CPU: 0 ulps and no exception (the
  port's bf16 ops round where XLA's do, its sigmoid included); at full
  width against the bf16 golden (:func:`test_golden_steps`) the next state
  is 1 ulp off in 105 of 5 120 elements (the CPU's float32 products sum in
  another order than XLA's).
* **Whole sequences** against the reference's bf16 codec (its default direct
  vocoder path, the one that runs on a CPU): shapes, dtypes (codes bf16,
  waveform float32), code values and the bitrate mask, finiteness; the code
  agreement and the decoded-mel gap are printed, and held no tighter than
  the reference's own self-sensitivity (92.0 %).
* **Vocoder**: the direct path against ``generator_apply`` on bf16
  parameters and a bf16 mel, within one bf16 ulp of the largest output.
* **Inside the port**: streaming against one-shot, the engines against the
  streaming classes, a bundle against its live codec (and its ``vocode``
  program, where the reference raises), TP / SP / PP against one device,
  ``.bvsc`` files and the daemon's wire.  Codes bitwise, as in float32;
  waveforms bitwise where the same ops run in the same order, else within
  :data:`AUDIO_TOL`: a stream's overlap-add, a batch's or a shard's sums
  round to bf16 in another order than the one-shot call's, and the
  vocoder carries one ulp there to a few of its output.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bvsc_tpu.codec import BVRNNCodecModel as JCodec
from bvsc_tpu.models import bvrnn as jb
from bvsc_tpu.models import vocoder as JV
from bvsc_tpu.ops import quant as jq
from bvsc_tpu_torch import BVRNNCodecModel, CodecConfig
from bvsc_tpu_torch import streaming as S
from bvsc_tpu_torch.cli.codec_cli import read_bvsc, write_bvsc
from bvsc_tpu_torch.codec import _generator_impl
from bvsc_tpu_torch.convert import bvrnn_params_from_jax, load_bvrnn_npz, vocoder_params_from_jax
from bvsc_tpu_torch.entropy import PriorEntropyCoder
from bvsc_tpu_torch.models import bvrnn as B
from bvsc_tpu_torch.models import vocoder as V
from bvsc_tpu_torch.ops import quant as Q
from bvsc_tpu_torch.serve import client as TC
from bvsc_tpu_torch.serve.daemon import CodecDaemon
from bvsc_tpu_torch.serve.engine import DecodeEngine, ServingEngine
from bvsc_tpu_torch.serve.export import ServingBundle, export_serving_bundle
from test_torch_codec import SMALL, trees  # noqa: F401
from torch_parallel_ranks import spawn

torch.set_num_threads(1)

BF16 = torch.bfloat16
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOC_NPZ = os.path.join(REPO, "chkpts_npz", "bvsc_vocoder_demo_cl_ft_g_step600_f16.npz")
H, Z, X = SMALL["h_dim"], SMALL["z_dim"], 80
STEP_FRAMES = 36  # teacher-forced frames of each step check
# in bf16 ulps of the reference tensor's largest magnitude: a product's
# one-ulp flip carried through the GRU update's rounded ops (measured 0 at
# the small config, 1 at full width on this CPU, 2 on the card)
ULPS = 4
SELF_AGREEMENT = 0.92  # the reference's bf16 against itself with 1 % of its weights moved
# in-port waveforms whose bf16 sums round in another order (measured on
# this CPU: 3.9e-4 streaming against one-shot, 1.2e-4 SP, 0 elsewhere)
AUDIO_TOL = 2e-3
L, BATCH, BUCKET = 3000, 2, 16  # 11 frames in the 4 096-sample bucket
BITRATE = 600  # 7 of 12 bits a frame: the last 5 are masked to 0.5
HOP = 256


def ulp(v) -> np.ndarray:
    """One bf16 ulp at each value's magnitude (zero counts as the least
    normal's)."""
    v = np.maximum(np.abs(np.asarray(v, np.float64)), 2.0 ** -126)
    return 2.0 ** (np.floor(np.log2(v)) - 7)


def ulps(got, ref) -> float:
    """The largest gap, in bf16 ulps of ``ref``'s largest magnitude."""
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape
    return float(np.abs(got - ref).max() / ulp(np.abs(ref).max())) if ref.size else 0.0


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _bf16_tree(tree):
    return jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), tree)


def _noise(seed: int, shape, scale: float = 0.3) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


# ---------------------------------------------------------------------------
# One step from the reference's state
# ---------------------------------------------------------------------------

CELLS = ("standard", "fused", "int8")
STEPS = ("encode", "encode_decode", "decode", "plc_expect", "plc_map")


@pytest.fixture(scope="module")
def step_inputs(trees):  # noqa: F811
    """Both packages' bf16 params per cell, and the frames: log-mels,
    bits/frame, codes and lost flags (every third frame)."""
    _, btree, _ = trees
    jp, tp = _bf16_tree(btree), bvrnn_params_from_jax(btree, BF16)
    params = {"standard": (jp, tp), "fused": (jp, tp),
              "int8": (jq.quantize_bvrnn_params(jp), Q.quantize_bvrnn_params(tp))}
    rng = np.random.default_rng(30)
    y = (rng.standard_normal((BATCH, STEP_FRAMES, X)) * 2.0 - 4.0).astype(np.float32)
    bits = rng.integers(1, Z + 1, (BATCH, STEP_FRAMES)).astype(np.float32)
    codes = rng.integers(0, 2, (BATCH, STEP_FRAMES, Z)).astype(np.float32)
    lost = (np.arange(STEP_FRAMES) % 3 == 1)[None].repeat(BATCH, 0).astype(np.float32)
    return params, y, bits, codes, lost


def _cfgs(cell):
    fused = cell == "fused"
    return (jb.BVRNNConfig(x_dim=X, h_dim=H, z_dim=Z, dtype=jnp.bfloat16, fused_cell=fused),
            B.BVRNNConfig(x_dim=X, h_dim=H, z_dim=Z, dtype=BF16, fused_cell=fused))


def _jax_enc(p, cfg, y, h):
    """The reference's encoder probabilities from state h (its step's enc
    part, before rounding)."""
    prec = cfg.precision
    phi_x = jb.phi_x_apply(p, jb._normalize(p, y.astype(cfg.dtype)), prec)
    if cfg.fused_cell:
        fp = jb._fuse_inference_params(p, cfg)
        e1h = jb._fused_h_combo(fp, h, prec)[0]
        a = jax.nn.elu(jnp.matmul(phi_x, fp["w_enc1_x"], precision=prec) + e1h + fp["b_enc1"])
        a = jax.nn.elu(jb._dense(fp["enc2"], a, prec))
        return jax.nn.sigmoid(jb._dense(fp["enc3"], a, prec))
    return jb.enc_apply(p, jnp.concatenate([phi_x, h], -1), prec)


def _jax_step(kind, p, cfg, y, bits, z, lost, h):
    """One reference step (a T = 1 scan): (codes or None, mel or None, h)."""
    if kind == "encode":
        c, h = jb.encode_with_state(p, cfg, y, bits, h)
        return c, None, h
    if kind == "encode_decode":
        return jb.encode_decode(p, cfg, y, bits, h)
    if kind == "decode":
        mel, h = jb.decode(p, cfg, z, h)
        return None, mel, h
    mel, h = jb.decode_plc(p, cfg, z, lost, h, None, mode=kind.removeprefix("plc_"))
    return None, mel, h


def _port_step(kind, p, cfg, y, bits, z, lost, h):
    if kind == "encode":
        c, h = B.encode_with_state(p, cfg, y, bits, h)
        return c, None, h
    if kind == "encode_decode":
        return B.encode_decode(p, cfg, y, bits, h)
    if kind == "decode":
        mel, h = B.decode(p, cfg, z, h)
        return None, mel, h
    mel, h = B.decode_plc(p, cfg, z, lost, h, None, mode=kind.removeprefix("plc_"))
    return None, mel, h


@pytest.mark.parametrize("kind", STEPS)
@pytest.mark.parametrize("cell", CELLS)
def test_step_from_reference_state(step_inputs, cell, kind):
    params, y, bits, codes, lost = step_inputs
    jp, tp = params[cell]
    jcfg, tcfg = _cfgs(cell)
    jstep = jax.jit(lambda h, y, b, z, lo: _jax_step(kind, jp, jcfg, y, b, z, lo, h))
    jenc = jax.jit(lambda h, y: _jax_enc(jp, jcfg, y, h))
    h = jnp.zeros((BATCH, H), jnp.bfloat16)
    worst = {"h": 0.0, "mel": 0.0, "enc": 0.0}
    exceptions = 0
    for t in range(STEP_FRAMES):
        args = (y[:, t:t + 1], bits[:, t:t + 1], codes[:, t:t + 1], lost[:, t:t + 1])
        jc, jmel, jh = jstep(h, *args)
        tc, tmel, th = _port_step(kind, tp, tcfg, *(torch.from_numpy(a) for a in args),
                                  torch.from_numpy(_np(h)).to(BF16))
        assert th.dtype == BF16
        worst["h"] = max(worst["h"], ulps(th, jh))
        if jmel is not None:
            assert tmel.dtype == BF16
            worst["mel"] = max(worst["mel"], ulps(tmel, jmel))
        if jc is not None:
            assert tc.dtype == BF16
            jenc_t = _np(jenc(h, jnp.asarray(y[:, t])))
            tenc_t = B.enc_from_states(tp, tcfg, torch.from_numpy(y[:, t:t + 1]),
                                       torch.from_numpy(_np(h))[:, None])[:, 0]
            worst["enc"] = max(worst["enc"], ulps(tenc_t, jenc_t))
            differ = _np(tc)[:, 0] != _np(jc)[:, 0]
            near_half = np.abs(jenc_t - 0.5) <= ulp(0.5)
            assert not (differ & ~near_half).any(), t
            exceptions += int(differ.sum())
        h = jh  # teacher forcing: the reference's own next state
    print(f"{cell} {kind}: worst ulps {worst}, codes differing near 0.5: {exceptions}")
    assert max(worst.values()) <= ULPS, worst


# ---------------------------------------------------------------------------
# Whole sequences, codec construction and the vocoder
# ---------------------------------------------------------------------------


def _port(trees, **kwargs):  # noqa: F811
    _, btree, vtree = trees
    return BVRNNCodecModel(config=CodecConfig(**SMALL), bvrnn_params=bvrnn_params_from_jax(btree),
                           vocoder_params=vocoder_params_from_jax(vtree), length_bucket=BUCKET,
                           device="cpu", dtype=BF16, **kwargs)


@pytest.fixture(scope="module")
def jcodec(trees):  # noqa: F811
    jconf, btree, vtree = trees
    return JCodec(config=jconf, bvrnn_params=_bf16_tree(btree), vocoder_params=_bf16_tree(vtree),
                  length_bucket=BUCKET, dtype=jnp.bfloat16)


@pytest.fixture(scope="module")
def x():
    return _noise(11, (BATCH, L))


@pytest.mark.parametrize("path", ["direct", "kernel"])
def test_whole_sequences_against_reference(trees, jcodec, x, path):  # noqa: F811
    codec = _port(trees, use_pallas=path == "kernel")
    assert codec.dtype == BF16 and codec.use_pallas == (path == "kernel")
    jcodes = _np(jcodec.encode(x, BITRATE))
    codes = codec.encode(x, BITRATE)
    assert codes.dtype == BF16 and tuple(codes.shape) == jcodes.shape
    c = _np(codes)
    assert set(np.unique(c)) <= {0.0, 0.5, 1.0}
    k = int(codec.bits_per_frame(BITRATE))
    assert (c[..., k:] == 0.5).all() and set(np.unique(c[..., :k])) <= {0.0, 1.0}
    agreement = float((c[..., :k] == jcodes[..., :k]).mean())
    mel_gap = np.abs(_np(codec.decode_to_mel(codes)) - _np(jcodec.decode_to_mel(jcodes))).max()
    lost = (np.random.default_rng(3).random((BATCH, c.shape[1])) < 0.2).astype(np.float32)
    outs = {"call": codec(x, BITRATE), "decode": codec.decode(codes, L),
            "plc": codec.decode(codes, L, lost=lost)}
    for name, y in outs.items():
        assert y.dtype == torch.float32 and tuple(y.shape) == (BATCH, L), name
        assert torch.isfinite(y).all(), name
    print(f"{path}: code agreement {agreement:.4f}, decoded-mel gap {mel_gap:.3g}")
    assert agreement >= SELF_AGREEMENT


def test_direct_path_decode_matches_reference(trees, jcodec, x):  # noqa: F811
    """The direct path's decode of the reference's codes against the
    reference's: the same bf16 ops, rounded in the same places (measured
    bitwise on this CPU; held to :data:`AUDIO_TOL`, since another CPU's
    float32 products may sum in another order)."""
    codec = _port(trees, use_pallas=False)
    jcodes = _np(jcodec.encode(x, BITRATE))
    got, ref = codec.decode(jcodes, L).numpy(), np.asarray(jcodec.decode(jcodes, L))
    print(f"direct decode against the reference: max gap {np.abs(got - ref).max():.3g}")
    assert np.abs(got - ref).max() <= AUDIO_TOL


@pytest.mark.parametrize("approx", [False, True], ids=["exact", "approx_snake"])
def test_direct_vocoder_matches_generator_apply(trees, approx):  # noqa: F811
    """The direct path under bf16 storage (conv_pre, upsamplers, conv_post,
    act_post and tanh in bf16; the snakes' exp of the bf16 parameters)
    against the reference's ``generator_apply`` on bf16 parameters and a
    bf16 mel: within one bf16 ulp of its largest output."""
    jconf, _, vtree = trees
    vcfg = jconf.vocoder_config
    mel = (np.random.default_rng(7).standard_normal((2, 80, 20)) * 1.5 - 4.0).astype(np.float32)
    ref = _np(JV.generator_apply(_bf16_tree(vtree), vcfg, jnp.asarray(mel, jnp.bfloat16), None,
                                 precision=jax.lax.Precision.HIGHEST, approx_snake=approx))
    params = V.prepare_direct_params(vocoder_params_from_jax(vtree, BF16),
                                     CodecConfig().vocoder_config, BF16)
    got = V.generator_apply(params, CodecConfig().vocoder_config,
                            torch.from_numpy(mel).to(BF16), None, approx_snake=approx)
    assert got.dtype == BF16
    gap = np.abs(_np(got) - ref)
    print(f"direct vocoder: max {gap.max():.3g}, {(gap > 0).mean():.2%} of samples differ")
    assert gap.max() <= ulp(np.abs(ref).max())


# ---------------------------------------------------------------------------
# Inside the port
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def codec(trees):  # noqa: F811
    _, btree, _ = trees
    return BVRNNCodecModel(config=CodecConfig(**SMALL), bvrnn_params=bvrnn_params_from_jax(btree),
                           vocoder_chkpt_path=VOC_NPZ, length_bucket=BUCKET, device="cpu",
                           dtype="bfloat16")


@pytest.fixture(scope="module")
def one_shot(codec, x):
    """The one-shot calls every in-port path is held to."""
    codes = codec.encode(x, BITRATE)
    return {"codes": codes, "call": codec(x, BITRATE), "decode": codec.decode(codes, L)}


def _inside(n_frames: int) -> int:
    """Frames whose analysis window lies inside an input of L samples (the
    last two read the stream's reflected tail, the bucket's zeros
    one-shot)."""
    return min(n_frames, (L - 768) // HOP + 1)


def test_weights_and_state_in_bf16(codec):
    leaves = []

    def walk(t):
        if isinstance(t, dict):
            [walk(v) for v in t.values()]
        elif isinstance(t, list):
            [walk(v) for v in t]
        else:
            leaves.append(t)

    walk(codec.bvrnn_params)
    walk(codec.vocoder_params)
    assert {t.dtype for t in leaves} == {BF16}
    assert codec._h0(3).dtype == BF16 and codec.bvrnn_cfg.dtype == BF16
    assert S.voc_state_dtype(codec) == BF16
    state = S.vocoder_state(codec, 2)
    assert state["stages"][0]["ctx"].dtype == BF16 and state["stages"][0]["ctx"].shape[-1] >= 120


def test_streaming_matches_one_shot(codec, x, one_shot):
    n = _inside(one_shot["codes"].shape[1])
    enc = S.StreamingEncoder(codec, BATCH, BITRATE)
    got = torch.cat([enc.feed(x[:, i: i + 1000]) for i in range(0, L, 1000)] + [enc.flush()], 1)
    assert got.dtype == torch.float32  # feed's codes: float32 (ROADMAP.md, Decided)
    torch.testing.assert_close(got[:, :n], one_shot["codes"][:, :n].float(), rtol=0, atol=0)
    fpc = S.FusedPacketCodec(codec, BATCH, BITRATE)
    wav = torch.cat([fpc.process(x[:, i: i + HOP]) for i in range(0, L, HOP)] + [fpc.flush()], 1)
    dec = S.StreamingDecoder(codec, BATCH)
    dwav = torch.cat([dec.feed(one_shot["codes"][:, t: t + 1])
                      for t in range(one_shot["codes"].shape[1])], 1)
    m = n * HOP
    gaps = {"packet": (wav[:, :m] - one_shot["call"][:, :m]).abs().max().item(),
            "decoder": (dwav[:, :m] - one_shot["decode"][:, :m]).abs().max().item()}
    print(f"streaming against one-shot: {gaps}")
    assert max(gaps.values()) <= AUDIO_TOL


def test_engines_match_streaming_classes(codec, x):
    eng = ServingEngine(codec, max_streams=2)
    assert eng.state["h"].dtype == BF16
    sid = eng.open_stream(BITRATE)
    eng.push(sid, x[0])
    eng.begin_flush(sid)
    codes, wav = [], []
    while (out := eng.tick()) and sid in out:
        codes.append(out[sid][0])
        wav.append(out[sid][1])
    fpc = S.FusedPacketCodec(codec, 1, BITRATE)
    ref_codes, step = [], fpc._step

    def recording(chunk):
        out = step(chunk)
        ref_codes.append(out[0][0].float().numpy())
        return out

    fpc._step = recording
    ref = torch.cat([fpc.process(x[:1, i: i + HOP]) for i in range(0, L, HOP)] + [fpc.flush()], 1)
    n = len(wav)
    np.testing.assert_array_equal(np.stack(codes), np.stack(ref_codes)[:n])
    gap = np.abs(np.concatenate(wav) - ref[0, : n * HOP].numpy()).max()
    deng = DecodeEngine(codec, max_streams=2)
    assert deng.state["h"].dtype == BF16
    dsid = deng.open_stream()
    frames = np.stack(codes)
    deng.push(dsid, frames)
    dwav = np.concatenate([deng.tick()[dsid] for _ in range(len(frames))])
    sdec = S.StreamingDecoder(codec, 1)
    dref = torch.cat([sdec.feed(frames[None, t: t + 1]) for t in range(len(frames))], 1)[0]
    dgap = np.abs(dwav - dref.numpy()).max()
    print(f"engines against the streaming classes: serving {gap:.3g}, decode {dgap:.3g}")
    assert max(gap, dgap) <= AUDIO_TOL


@pytest.fixture(scope="module")
def bundle(codec, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("bf16bundle") / "codec.bvscx")
    meta = export_serving_bundle(codec, path, batch=BATCH, lengths=(L,), engine_batch=2)
    return meta, ServingBundle(path, device="cpu")


def test_bundle_matches_live(codec, x, one_shot, bundle):
    meta, b = bundle
    assert meta["serving"]["dtype"] == "bfloat16" and b.dtype == BF16
    stored = {k.split("/")[0]: set() for k, _, _ in meta["weights"]["tensors"]}
    for k, _, d in meta["weights"]["tensors"]:
        stored[k.split("/")[0]].add(d)
    # the BVRNN's and the vocoder's weights in bf16; the mel frontend's
    # constants and the kernels' packed blocks (float32 widened, exactly)
    assert stored["scan"] == stored["vocoder"] == {"bfloat16"}, stored
    assert [d for k, _, d in meta["packet"]["state"] if k == "h"] == ["bfloat16"]
    codes = b.encode(x, BITRATE)
    assert codes.dtype == BF16
    torch.testing.assert_close(codes, one_shot["codes"], rtol=0, atol=0)
    torch.testing.assert_close(b(x, BITRATE), one_shot["call"], rtol=0, atol=0)
    torch.testing.assert_close(b.decode(codes, L), one_shot["decode"], rtol=0, atol=0)
    mel = torch.from_numpy(_noise(5, (BATCH, 80, b._bucket(L)["frames"]), 1.0) - 4.0)
    Lp = b._bucket(L)["length"]
    with torch.no_grad():
        live = _generator_impl(codec.weights, mel.to(BF16), Lp)
    torch.testing.assert_close(b.vocode(mel), live, rtol=0, atol=0)


def test_reference_vocode_program_raises(jcodec):
    """The reference's ``vocode`` program under bf16 storage (its default
    f32 vocoder segment: no cast) meets a float32 mel with bf16 weights in
    its first conv: TypeError.  The port's casts the mel
    (:func:`test_bundle_matches_live`)."""
    from bvsc_tpu.codec import _voc_cast

    vp, mel = _voc_cast(jcodec.vocoder_params, jnp.zeros((1, 80, 4), jnp.float32),
                        jcodec.voc_dtype)
    with pytest.raises(TypeError, match="same dtypes"):
        JV.generator_apply(vp, jcodec.conf.vocoder_config, mel, 1024,
                           precision=jcodec.bvrnn_cfg.precision)


def test_bundle_engines_match_live(codec, x, bundle):
    _, b = bundle
    outs = []
    for eng in (ServingEngine(codec, max_streams=2), b.serving_engine()):
        sid = eng.open_stream(BITRATE)
        eng.push(sid, x[1])
        eng.begin_flush(sid)
        run = []
        while (out := eng.tick()) and sid in out:
            run.append(np.concatenate(out[sid]))
        outs.append(np.stack(run))
    np.testing.assert_array_equal(outs[1], outs[0])


def test_parallel_paths_match_one_device(trees, tmp_path_factory):  # noqa: F811
    """TP (2 ranks), SP (2 shards) and PP (2 stages) under bf16 storage
    against one device: codes bitwise, the rest within bf16 noise."""
    _, btree, vtree = trees
    vcfg = CodecConfig().vocoder_config
    rng = np.random.default_rng(40)
    z = rng.integers(0, 2, (2, 8, Z)).astype(np.float32)
    y = (rng.standard_normal((2, 8, X)) - 5.0).astype(np.float32)
    bits = rng.integers(1, Z + 1, (2, 8)).astype(np.float32)
    h0 = np.zeros((2, H), np.float32)
    cfg_kw = {"x_dim": X, "h_dim": H, "z_dim": Z, "dtype": BF16}
    cfg = B.BVRNNConfig(**cfg_kw)
    params = bvrnn_params_from_jax(btree, BF16)
    with torch.no_grad():
        mel1, h1 = B.decode(params, cfg, torch.from_numpy(z), torch.from_numpy(h0))
        codes1, _ = B.encode_with_state(params, cfg, torch.from_numpy(y), torch.from_numpy(bits),
                                        torch.from_numpy(h0))
    tp = spawn(2, tmp_path_factory.mktemp("tp"), "tp", "1d", bvrnn_params_from_jax(btree),
               cfg_kw, z, y, bits, h0)[0]
    np.testing.assert_array_equal(tp["codes"], _np(codes1))
    tp_gap = max(np.abs(tp["mel"] - _np(mel1)).max(), np.abs(tp["h"] - _np(h1)).max())

    voc = vocoder_params_from_jax(vtree)
    mel = (rng.standard_normal((2, 80, 16)) - 4.0).astype(np.float32)
    with torch.no_grad():
        vb = vocoder_params_from_jax(vtree, BF16)
        ref = V.generator_apply_kernel(vb, V.prepare_kernel_params(vb, vcfg), vcfg,
                                       torch.from_numpy(mel).to(BF16), 16 * vcfg.total_upsample)
    sp = spawn(2, tmp_path_factory.mktemp("sp"), "sp", "1d", voc, vcfg, mel,
               {"dtype": BF16})[0]
    sp_gap = np.abs(sp - _np(ref)).max()

    mel_mb = (rng.standard_normal((2, 2, 8, X)) - 5.0).astype(np.float32)
    bits_mb = rng.integers(1, Z + 1, (2, 2, 8)).astype(np.float32)
    pp = spawn(2, tmp_path_factory.mktemp("pp"), "pp", "1d", bvrnn_params_from_jax(btree),
               cfg_kw, voc, vcfg, mel_mb, bits_mb)[0]
    with torch.no_grad():
        c0, m0, _ = B.encode_decode(params, cfg, torch.from_numpy(mel_mb[0]),
                                    torch.from_numpy(bits_mb[0]), torch.zeros(2, H))
        w0 = V.generator_apply_kernel(vb, V.prepare_kernel_params(vb, vcfg), vcfg,
                                      m0.transpose(1, 2).contiguous(), 8 * vcfg.total_upsample)
    np.testing.assert_array_equal(pp["codes"][0], _np(c0))
    pp_gap = np.abs(pp["wav"][0] - _np(w0)).max()
    print(f"parallel against one device: TP {tp_gap:.3g}, SP {sp_gap:.3g}, PP {pp_gap:.3g}")
    assert pp_gap == 0.0  # the same ops on the same rows
    assert max(tp_gap, sp_gap) <= AUDIO_TOL


@pytest.mark.parametrize("entropy", [False, True], ids=["raw", "prior"])
def test_bvsc_round_trip(codec, one_shot, tmp_path, entropy):
    """A bf16 codec's codes through a ``.bvsc`` file (version 1 raw, version
    3 against the prior, run on the stored weights widened exactly) come
    back bitwise, and decode to the same waveform."""
    codes = one_shot["codes"][0]
    bits = int(codec.bits_per_frame(BITRATE))
    factory = (lambda: PriorEntropyCoder(codec.bvrnn_params, codec.bvrnn_cfg)) if entropy else None
    path = str(tmp_path / "x.bvsc")
    write_bvsc(path, codes.float().numpy(), bits, codec.conf.fs,
               coder=factory() if entropy else None)
    back, got_bits, fs = read_bvsc(path, factory)
    np.testing.assert_array_equal(back, codes.float().numpy())
    assert got_bits == bits and fs == codec.conf.fs
    torch.testing.assert_close(codec.decode(back[None], L), codec.decode(codes[None], L),
                               rtol=0, atol=0)
    if entropy:  # the coder takes the bf16 tensor itself too
        assert factory().encode(codes, bits) == factory().encode(codes.float().numpy(), bits)


def test_daemon_wire(codec, x):
    """Encoding and resynthesis over the daemon's wire, bitwise a direct
    ServingEngine run of the same bf16 codec."""
    audio = x[0, : 768 + HOP * 6]
    eng = ServingEngine(codec, max_streams=2)
    sid = eng.open_stream(BITRATE)
    eng.push(sid, audio)
    eng.begin_flush(sid)
    ref_codes, ref_wav = [], []
    while (out := eng.tick()) and sid in out:
        ref_codes.append(out[sid][0])
        ref_wav.append(out[sid][1])
    d = CodecDaemon(codec, port=0, max_streams=2)
    d.start()
    try:
        with TC.CodecClient("127.0.0.1", d.port, mode="encode", bitrate=BITRATE,
                            timeout=60) as c:
            c.send_audio(audio)
            c.close_input()
            np.testing.assert_array_equal(c.drain()["codes"], np.stack(ref_codes))
        with TC.CodecClient("127.0.0.1", d.port, mode="resynth", bitrate=BITRATE,
                            timeout=60) as c:
            c.send_audio(audio)
            c.close_input()
            np.testing.assert_array_equal(c.drain()["audio"], np.concatenate(ref_wav))
    finally:
        d.close()


GOLDEN_BF16 = os.path.join(REPO, "chkpts_npz", "golden_demo_stim15_3kbps_bf16.npz")
BVRNN_NPZ = os.path.join(REPO, "chkpts", "bvsc_bvrnn_demo_augfull_step1800_f16.npz")


def test_golden_steps():
    """The trained BVRNN at full width (h 1024, z 64) in bf16, one step from
    each of the bf16 golden's states (``tools/write_goldens.py --dtype
    bf16``): the next state and the encoder's probabilities within
    :data:`ULPS`, the transmitted codes equal but within one ulp of 0.5.
    The closed loop over the whole demo is printed beside the golden's
    codes, with no gate (the chaos above)."""
    with np.load(GOLDEN_BF16) as z:
        g = {k: z[k] for k in z.files}

    def bits16(a):
        return torch.from_numpy(a.astype(np.uint16).view(np.int16)).view(BF16)

    conf = CodecConfig()
    cfg = B.BVRNNConfig(x_dim=conf.num_mels, h_dim=conf.h_dim, z_dim=conf.z_dim, dtype=BF16)
    params = B.prepare(load_bvrnn_npz(BVRNN_NPZ, BF16), cfg)
    h, mel = bits16(g["step_h"]), torch.from_numpy(g["step_mel"])[:, None]
    k = int(round(float(g["bitrate"]) * conf.hopsize / conf.fs))
    bits = torch.full((h.shape[0], 1), float(k))
    codes, h_next = B.encode_with_state(params, cfg, mel, bits, h)
    enc = B.enc_from_states(params, cfg, mel, h[:, None])[:, 0]
    ref_enc = bits16(g["step_enc"]).float().numpy()
    differ = _np(codes)[:, 0, :k] != np.round(ref_enc[:, :k])
    near_half = np.abs(ref_enc[:, :k] - 0.5) <= ulp(0.5)
    gaps = {"h": ulps(h_next, bits16(g["step_h_next"])), "enc": ulps(enc, ref_enc)}
    print(f"golden steps {g['step_frames'].tolist()}: ulps {gaps}, codes differing near 0.5: "
          f"{int(differ.sum())}")
    assert not (differ & ~near_half).any()
    assert max(gaps.values()) <= ULPS
