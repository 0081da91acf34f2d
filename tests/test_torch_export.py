"""AOT serving bundles of the port (bvsc_tpu_torch.serve.export, device='cpu')
on the codec of tests/test_torch_codec.py: a small BVRNN (h 48, z 12, 80
mels) and the full-width seeded vocoder, at the 4 096-sample bucket.

* The bundle against the live port: codes bitwise (encode, a VBR schedule,
  the engines' ticks); audio within 1e-6 (the reference's bound; on the
  CPU the programs run the live path's kernels, so it is bitwise in
  practice).
* The bundle against ``bvsc_tpu``'s live codec on the same seeded weights:
  codes bitwise, audio 1e-4 and SNR > 40 dB (the cross-package bound of
  tests/test_torch_codec.py).  JAX's own export is not run (the reference
  marks it slow).
* The serving host runs no model code: with the port's model entry points
  made to raise, a freshly loaded bundle still serves.
"""

import json
import zipfile

import numpy as np
import pytest
import torch

from bvsc_tpu.eval.metrics import snr_db
from bvsc_tpu_torch import streaming as S
from bvsc_tpu_torch.codec import BVRNNCodecModel
from bvsc_tpu_torch.models import bvrnn as bvrnn_mod
from bvsc_tpu_torch.models import vocoder as voc_mod
from bvsc_tpu_torch.serve import export as E
from bvsc_tpu_torch.serve import client as TC
from bvsc_tpu_torch.serve.daemon import CodecDaemon
from bvsc_tpu_torch.serve.engine import DecodeEngine, ServingEngine
from test_torch_codec import _jax_codec, _port_codec, trees  # noqa: F401

torch.set_num_threads(1)

L = 3000  # samples of a test input: the 4 096-sample bucket (16 frames), 11 frames
LENGTHS = (4096,)
TOL = 1e-6
CROSS_TOL = 1e-4
HOP = 256
SLOTS = 4
TIMEOUT = 60
WIRE_BITRATE = 600  # 7 bits/frame of z_dim 12: the wire's first-k packing drops 5


def _noise(seed: int, shape, scale: float = 0.3) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _max_gap(a, b) -> float:
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    assert a.shape == b.shape
    return (a - b).abs().max().item() if a.numel() else 0.0


@pytest.fixture(scope="module")
def codec(trees):  # noqa: F811
    return _port_codec(trees)


@pytest.fixture(scope="module")
def fast(trees):  # noqa: F811
    return _port_codec(trees, precision="default")


@pytest.fixture(scope="module")
def bundle_path(codec, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("bundle") / "parity.bvscx")
    E.export_serving_bundle(codec, path, batch=1, lengths=LENGTHS, engine_batch=SLOTS)
    return path


@pytest.fixture(scope="module")
def bundle(bundle_path):
    return E.ServingBundle(bundle_path, device="cpu")


@pytest.fixture(scope="module")
def fast_bundle(fast, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("bundle") / "fast.bvscx")
    E.export_serving_bundle(fast, path, batch=1, lengths=LENGTHS)
    return E.ServingBundle(path, device="cpu")


@pytest.fixture(scope="module")
def any_batch(codec, tmp_path_factory):
    """One-shot programs only, with a symbolic batch."""
    path = str(tmp_path_factory.mktemp("bundle") / "any.bvscx")
    E.export_serving_bundle(codec, path, batch=None, lengths=LENGTHS, packet=False)
    return E.ServingBundle(path, device="cpu")


@pytest.fixture(scope="module")
def x():
    return _noise(1, (1, L))


@pytest.fixture(scope="module")
def vbr(codec):
    n = codec.frontend.num_frames(L)
    return np.random.default_rng(2).choice([1000.0, 2000.0, 3000.0, 5512.5], size=n)


# --- the bundle against the live port ------------------------------------------------


def test_manifest_and_weights(codec, fast, bundle, fast_bundle):
    m = bundle.meta
    assert m["format"] == E.FORMAT == "bvsc-serve-torch-1"
    assert m["traced_on"] == "cpu" and m["batch"] == 1
    assert m["serving"]["precision"] == "highest"
    assert fast_bundle.meta["serving"] == {"precision": "default", "voc_compute_dtype": "bfloat16",
                                           "voc_dtype": "f32", "fused_cell": "auto",
                                           "quantize": None, "use_pallas": True,
                                           "approx_snake": False, "dtype": "float32"}
    assert [b["length"] for b in m["buckets"]] == list(LENGTHS)
    assert m["packet"]["batch"] == 1 and m["engine"]["batch"] == SLOTS
    # the weights are stored once, as the programs read them: dtypes kept
    for b, c in ((bundle, codec), (fast_bundle, fast)):
        items = E._flatten(c.weights.tree())
        assert len(b.weights) == len(items)
        for t, (_, ref) in zip(b.weights, items):
            assert t.dtype == ref.dtype and torch.equal(t, ref)
    assert {t.dtype for t in fast_bundle.weights} == {torch.float32, torch.bfloat16}
    # no program carries a weight of its own
    assert max(m["program_bytes"].values()) < sum(t.numel() * 4 for t in bundle.weights)


def test_encode_and_vbr_bitwise(codec, bundle, x, vbr):
    for bitrate in (3000, vbr):
        got = bundle.encode(x, bitrate)
        assert torch.equal(got, codec.encode(x, bitrate))
    assert torch.equal(bundle.encode(x[0], 3000), codec.encode(x[0], 3000))


def test_decode_forward_vocode_match_live(codec, bundle, x):
    codes = codec.encode(x, 3000)
    assert _max_gap(bundle.decode(codes, L), codec.decode(codes, L)) <= TOL
    assert _max_gap(bundle.decode(codes[0], L), codec.decode(codes[0], L)) <= TOL
    assert _max_gap(bundle(x, 3000), codec(x, 3000)) <= TOL
    assert _max_gap(bundle.forward(x[0], 3000), codec(x[0], 3000)) <= TOL
    mel = codec.decode_to_mel(codes)
    T = mel.shape[-1]
    live = voc_mod.generator_apply_kernel(codec.vocoder_params, codec.kernel_blocks,
                                          codec.conf.vocoder_config, mel, T * HOP)[:, 0]
    assert _max_gap(bundle.vocode(mel), live) <= TOL
    assert bundle.vocode(mel[0], 1000).shape == (1000,)


def test_packet_codec_matches_live(codec, bundle, x):
    live = S.FusedPacketCodec(codec, batch=1, bitrate=3000)
    exp = bundle.packet_codec(bitrate=3000)
    outs = {"live": [], "exp": []}
    for i in range(0, L, 777):
        outs["live"].append(live.process(x[:, i: i + 777]))
        outs["exp"].append(exp.process(x[:, i: i + 777]))
    outs["live"].append(live.flush())
    outs["exp"].append(exp.flush())
    a, b = torch.cat(outs["exp"], 1), torch.cat(outs["live"], 1)
    assert a.shape[1] > 0 and _max_gap(a, b) <= TOL


def test_packet_decoder_with_losses_matches_live(codec, bundle, x):
    codes = codec.encode(x, 3000)
    T = codes.shape[1]
    lost = np.zeros((1, T), np.float32)
    lost[0, [2, 5, 6, 7, T - 1]] = 1
    live = S.StreamingDecoder(codec, batch=1, conceal_bitrate=1500)
    exp = bundle.packet_decoder(conceal_bitrate=1500)
    ref = torch.cat([live.feed(codes[:, t: t + 1], lost=lost[:, t: t + 1]) for t in range(T)]
                    + [live.conceal(2)], 1)
    got = torch.cat([exp.feed(codes, lost), exp.conceal(2)], 1)
    assert got.shape == (1, (T + 2) * HOP)
    assert _max_gap(got, ref) <= TOL


def _schedule(eng):
    """Three streams through an engine: two from the first tick, one opened
    three ticks later at another bitrate, which switches mid-stream.
    Returns {stream: (codes, wav)}."""
    inputs = {0: (_noise(10, 768 + HOP * 9), 3000.0), 1: (_noise(11, 768 + HOP * 6), 1000.0),
              2: (_noise(12, 768 + HOP * 7), 5512.5)}
    sids, out, tick = {}, {i: ([], []) for i in inputs}, 0
    while True:
        if tick in (0, 3):
            for i in (0, 1) if tick == 0 else (2,):
                sids[i] = eng.open_stream(inputs[i][1])
                eng.push(sids[i], inputs[i][0])
                eng.begin_flush(sids[i])
        if tick == 5:
            eng.set_bitrate(sids[2], 2000.0)
        res = eng.tick()
        tick += 1
        if not res and tick > 3:
            return {i: (np.stack(c), np.concatenate(w)) for i, (c, w) in out.items()}
        for i, sid in sids.items():
            if sid in res:
                out[i][0].append(res[sid][0])
                out[i][1].append(res[sid][1])


def _decode_schedule(eng, codes):
    sids = [eng.open_stream(), eng.open_stream(conceal_bitrate=1500)]
    lost = [np.zeros(codes.shape[1], bool), np.isin(np.arange(codes.shape[1]), [1, 4, 5])]
    for sid, flags in zip(sids, lost):
        eng.push(sid, codes[0].numpy(), lost=flags)
    eng.push_lost(sids[1], 2)
    out = {sid: [] for sid in sids}
    while res := eng.tick():
        for sid, wav in res.items():
            out[sid].append(wav)
    return [np.concatenate(out[sid]) for sid in sids]


def test_bundle_engines_match_live(codec, bundle, x):
    live, exp = _schedule(ServingEngine(codec, max_streams=SLOTS)), _schedule(
        bundle.serving_engine())
    for i in live:
        np.testing.assert_array_equal(exp[i][0], live[i][0])
        assert _max_gap(exp[i][1], live[i][1]) <= TOL
    codes = codec.encode(x, 3000)
    live = _decode_schedule(DecodeEngine(codec, max_streams=SLOTS), codes)
    exp = _decode_schedule(bundle.decode_engine(), codes)
    for a, b in zip(exp, live):
        assert a.shape == b.shape and _max_gap(a, b) <= TOL


def test_daemon_serves_a_bundle(bundle, x):
    """Resynthesis, encoding and decoding with losses over the wire, each
    bitwise a direct run of the bundle's engines."""
    audio = _noise(20, 768 + HOP * 5)
    eng = bundle.serving_engine()
    sid = eng.open_stream(WIRE_BITRATE)
    eng.push(sid, audio)
    eng.begin_flush(sid)
    ref_codes, ref_wav = [], []
    while res := eng.tick():
        ref_codes.append(res[sid][0])
        ref_wav.append(res[sid][1])
    ref_codes, ref_wav = np.stack(ref_codes), np.concatenate(ref_wav)
    with pytest.raises(ValueError, match="stream slots"):
        CodecDaemon(bundle, max_streams=SLOTS + 1)
    d = CodecDaemon(bundle, port=0)
    d.start()
    try:
        assert d._eng.B == d._dec.B == SLOTS
        with TC.CodecClient("127.0.0.1", d.port, mode="resynth", bitrate=WIRE_BITRATE,
                            timeout=TIMEOUT) as c:
            c.send_audio(audio)
            c.close_input()
            np.testing.assert_array_equal(c.drain()["audio"], ref_wav)
        with TC.CodecClient("127.0.0.1", d.port, mode="encode", bitrate=WIRE_BITRATE,
                            timeout=TIMEOUT) as c:
            c.send_audio(audio)
            c.close_input()
            np.testing.assert_array_equal(c.drain()["codes"], ref_codes)
        ref = _decode_schedule(bundle.decode_engine(), torch.as_tensor(ref_codes)[None])[0]
        with TC.CodecClient("127.0.0.1", d.port, mode="decode", bitrate=None,
                            timeout=TIMEOUT) as c:
            c.send_codes(ref_codes, int(np.ceil(bundle.bits_per_frame(WIRE_BITRATE))))
            c.close_input()
            np.testing.assert_array_equal(c.drain()["audio"], ref)
    finally:
        d.close()


def test_programs_call_the_kernel_ops(bundle):
    """Every program that vocodes calls the residual-stack op of the
    bundle's mode, 12 times a call (the loaded programs: the tests above
    ran them)."""
    for name in ("forward_4096", "decode_4096", "vocode_4096", "packet_step",
                 "packet_decode_step", "engine_tick", "engine_decode_tick"):
        graph = bundle._program(f"programs/{name}.pt2").graph
        ops = [str(n.target) for n in graph.nodes if n.op == "call_function"
               and str(n.target).startswith("bvsc_torch.amp_resblock")]
        assert ops == ["bvsc_torch.amp_resblock_f32.default"] * 12, name


# --- against bvsc_tpu's live codec ---------------------------------------------------


def test_bundle_matches_jax(trees, bundle, x, vbr):  # noqa: F811
    jc = _jax_codec(trees)
    for bitrate in (3000, vbr):
        np.testing.assert_array_equal(bundle.encode(x, bitrate).numpy(),
                                      np.asarray(jc.encode(x, bitrate)))
    for got, ref in ((bundle(x, 3000), jc(x, 3000)),
                     (bundle.decode(np.asarray(jc.encode(x, 3000)), L),
                      jc.decode(jc.encode(x, 3000), L))):
        got, ref = got.numpy(), np.asarray(ref)
        assert got.shape == ref.shape and np.isfinite(got).all()
        assert snr_db(ref, got) > 40.0
        np.testing.assert_allclose(got, ref, atol=CROSS_TOL)


# --- fast serving, symbolic batch ------------------------------------------------------


def test_fast_bundle_matches_live(fast, fast_bundle, x):
    assert bvrnn_mod._use_fused(fast.bvrnn_cfg, 1)  # the fused cell at batch 1
    assert torch.equal(fast_bundle.encode(x, 3000), fast.encode(x, 3000))
    assert _max_gap(fast_bundle(x, 3000), fast(x, 3000)) <= TOL
    live, exp = S.FusedPacketCodec(fast, batch=1), fast_bundle.packet_codec()
    a = torch.cat([exp.process(x), exp.flush()], 1)
    b = torch.cat([live.process(x), live.flush()], 1)
    assert _max_gap(a, b) <= TOL


@pytest.mark.parametrize("batch", [1, 3])
def test_symbolic_batch(codec, any_batch, batch):
    assert any_batch.batch is None
    xb = _noise(30 + batch, (batch, L))
    assert torch.equal(any_batch.encode(xb, 3000), codec.encode(xb, 3000))
    assert _max_gap(any_batch(xb, 3000), codec(xb, 3000)) <= TOL


def test_symbolic_batch_refuses_auto(fast, tmp_path):
    with pytest.raises(ValueError, match="fused_cell"):
        E.export_serving_bundle(fast, str(tmp_path / "x.bvscx"), batch=None, lengths=LENGTHS)
    assert not (tmp_path / "x.bvscx").exists()


@pytest.mark.parametrize("cell", [False, True])
def test_decode_plc_traced_form_is_bitwise(trees, cell):  # noqa: F811
    codec = _port_codec(trees, fused_cell=cell)
    codes = codec.encode(_noise(40, (3, L)), 3000)
    B, T = codes.shape[:2]
    lost = torch.zeros(B, T)
    lost[0, [3, 4, 9]] = 1
    lost[2, T - 1] = 1
    h0 = torch.zeros(B, codec.conf.h_dim)
    cbits = torch.full((B, T), 20.0)
    for mode in ("expect", "map"):
        live = bvrnn_mod.decode_plc(codec.scan_params, codec.bvrnn_cfg, codes, lost, h0, cbits,
                                    mode)
        traced = bvrnn_mod.decode_plc(codec.scan_params, codec.bvrnn_cfg, codes, lost, h0, cbits,
                                      mode, every_step=True)
        assert all(torch.equal(a, b) for a, b in zip(live, traced))


# --- errors ----------------------------------------------------------------------


def _rewrite(src: str, dst: str, meta=None, drop=()):
    """A copy of bundle ``src`` with its manifest replaced or members dropped."""
    with zipfile.ZipFile(src) as zin, zipfile.ZipFile(dst, "w") as zout:
        for name in zin.namelist():
            if name in drop:
                continue
            data = zin.read(name)
            if name == "meta.json" and meta is not None:
                data = meta if isinstance(meta, bytes) else json.dumps(meta).encode()
            zout.writestr(name, data)
    return dst


MALFORMED = {
    "not_a_zip": lambda src, dst, m: open(dst, "wb").write(b"BVSC not a zip") and dst,
    "no_manifest": lambda src, dst, m: _rewrite(src, dst, drop=("meta.json",)),
    "garbled_manifest": lambda src, dst, m: _rewrite(src, dst, meta=b"{not json"),
    "manifest_not_a_dict": lambda src, dst, m: _rewrite(src, dst, meta=[1, 2]),
    "no_config": lambda src, dst, m: _rewrite(src, dst, meta={k: v for k, v in m.items()
                                                              if k != "config"}),
    "no_weights": lambda src, dst, m: _rewrite(src, dst, drop=(E.WEIGHTS,)),
    "no_program": lambda src, dst, m: _rewrite(src, dst, drop=("programs/engine_tick.pt2",)),
    "unknown_format": lambda src, dst, m: _rewrite(src, dst, meta={**m, "format": "x"}),
    "weight_dtype": lambda src, dst, m: _rewrite(src, dst, meta={**m, "weights": {
        **m["weights"], "tensors": [[k, s, "int8"] for k, s, _ in m["weights"]["tensors"]]}}),
}


@pytest.mark.parametrize("case", MALFORMED)
def test_malformed_bundle_is_a_value_error(bundle, tmp_path, case):
    path = MALFORMED[case](bundle.path, str(tmp_path / f"{case}.bvscx"), bundle.meta)
    with pytest.raises(ValueError, match="bvscx|format"):
        E.ServingBundle(path, device="cpu")


def test_bvsc_tpu_bundle_is_refused_by_name(bundle, tmp_path):
    path = _rewrite(bundle.path, str(tmp_path / "jax.bvscx"),
                    meta={**bundle.meta, "format": "bvsc-serve-1"})
    with pytest.raises(ValueError, match=r"bvsc_tpu\.serve\.ServingBundle"):
        E.ServingBundle(path, device="cpu")


def test_shape_errors(bundle, any_batch):
    with pytest.raises(ValueError, match="bucket"):
        bundle.encode(np.zeros((1, 5000), np.float32), 3000)
    with pytest.raises(ValueError, match="bucket"):
        bundle.decode(np.full((1, 40, 12), 0.5, np.float32), 40 * HOP)
    with pytest.raises(ValueError, match="batch"):
        bundle.encode(np.zeros((2, 1024), np.float32), 3000)
    with pytest.raises(ValueError, match="batch"):
        bundle.forward(np.zeros((3, 1024), np.float32), 3000)
    with pytest.raises(ValueError, match="per-frame bitrate"):
        bundle.encode(np.zeros((1, 1024), np.float32), np.full(7, 3000.0))
    for make in (any_batch.packet_codec, any_batch.packet_decoder):
        with pytest.raises(ValueError, match="packet"):
            make()
    for make in (any_batch.serving_engine, any_batch.decode_engine):
        with pytest.raises(ValueError, match="engine"):
            make()
    with pytest.raises(ValueError, match="engine"):
        CodecDaemon(any_batch)


def test_no_default_device_without_a_card(bundle):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        E.ServingBundle(bundle.path)


def test_storage_keeps_dtypes(tmp_path):
    items = [("a/0", torch.arange(-5, 5, dtype=torch.int8).reshape(2, 5)),
             ("a/1", torch.randn(3, 4).to(torch.bfloat16)), ("b", torch.randn(7))]
    path = tmp_path / "w.zip"
    with zipfile.ZipFile(path, "w") as zf:
        zf.writestr(E.WEIGHTS, E._weights_npz(items))
    spec = {"file": E.WEIGHTS, "tensors": [[k, list(t.shape), E._dtype_name(t.dtype)]
                                           for k, t in items]}
    with zipfile.ZipFile(path) as zf:
        got = E._load_weights(zf, spec, torch.device("cpu"))
    for t, (_, ref) in zip(got, items):
        assert t.dtype == ref.dtype and torch.equal(t, ref)
    assert E._unflatten(items)["a"][1] is items[1][1]


# --- the serving host runs no model code ---------------------------------------------


def test_serving_runs_no_model_code(codec, bundle_path, x, monkeypatch):
    codes = codec.encode(x, 3000)
    want = {"encode": codec.encode(x, 3000), "forward": codec(x, 3000)}

    def refuse(*args, **kwargs):
        raise AssertionError("model code ran at serve time")

    for mod, names in ((bvrnn_mod, ("encode", "encode_with_state", "encode_decode", "decode",
                                    "decode_plc", "prior_apply", "prepare", "_scan", "_advance")),
                       (voc_mod, ("generator_apply", "generator_apply_kernel",
                                  "prepare_kernel_params", "_apply")),
                       (S, ("generator_stream_step", "_fused_packet_step",
                            "_packet_decode_step", "_vocode_step"))):
        for name in names:
            monkeypatch.setattr(mod, name, refuse)
    b = E.ServingBundle(bundle_path, device="cpu")
    assert torch.equal(b.encode(x, 3000), want["encode"])
    assert _max_gap(b(x, 3000), want["forward"]) <= TOL
    assert b.decode(codes, L).shape == (1, L)
    pc = b.packet_codec()
    assert pc.process(x).shape[1] > 0
    assert b.packet_decoder().feed(codes, np.ones(codes.shape[:2])).shape == (1, codes.shape[1] * HOP)
    eng = b.serving_engine()
    sid = eng.open_stream(3000)
    eng.push(sid, x[0])
    assert sid in eng.tick()
    with pytest.raises(AssertionError, match="model code"):
        BVRNNCodecModel.encode(codec, x, 3000)  # the patch is live
