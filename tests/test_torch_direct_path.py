"""The codec's direct vocoder path (``BVRNNCodecModel(use_pallas=False)``:
the generator as convs and elementwise torch, with ``approx_snake`` and the
bf16 vocoder segment) against ``bvsc_tpu``'s default codec, whose
``use_pallas=None`` is that path, on the weights of
``tests/test_torch_codec.py`` (a small BVRNN, h 48 / z 12, and the
full-width vocoder, seeded across packages), on the CPU.

* Knob resolution: precision x use_pallas x approx_snake x voc_dtype
  resolves to ``bvsc_tpu``'s (use_pallas, approx_snake, voc_dtype) or its
  error, except where the port's None keeps the kernels (asserted as such).
* Parity: codes bitwise, waveform SNR > 40 dB, the vocoder within 1e-4.
* Fast (approx_snake + bf16 segment): code agreement > 0.97 with parity
  (the small-config bound of tests/test_torch_fast_serving.py), ``decode``
  within 2e-2 of ``bvsc_tpu``'s fast codec and of the port's parity
  ``decode`` (the reference's fast-serving contract).
* Streaming, serving and bundles on the direct path: the packet codec and
  the decoder against the offline calls (1e-5 at parity, 7e-2 fast: the
  reference's streaming bounds; the measured gap is printed), an engine
  slot against a B = 1 packet codec (bitwise in a 1-slot engine; codes
  bitwise and 1e-5 in a 2-slot one), a bundle bitwise its live codec.
* ``tests/test_cli.py``'s TINY_TOML (two dilations a resblock, which the
  kernels do not cover) builds a codec on the direct path that matches
  ``bvsc_tpu``'s at parity, and refuses ``use_pallas=True``.
"""

import ast
import itertools
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from bvsc_tpu.codec import BVRNNCodecModel as JCodec
from bvsc_tpu.codec import SCALING
from bvsc_tpu.config import load_config as j_load_config
from bvsc_tpu.eval.metrics import snr_db
from bvsc_tpu.models import vocoder as JV
from bvsc_tpu_torch import BVRNNCodecModel
from bvsc_tpu_torch import streaming as S
from bvsc_tpu_torch.config import load_config
from bvsc_tpu_torch.convert import bvrnn_params_from_jax, vocoder_params_from_jax
from bvsc_tpu_torch.serve.engine import ServingEngine
from bvsc_tpu_torch.serve.export import ServingBundle, export_serving_bundle
from test_torch_codec import BUCKET, _jax_codec, _port_codec, trees  # noqa: F401

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
L, B = 6615, 2
HOP = 256
VOC_TOL = 1e-4
FAST_TOL = 2e-2  # the reference's fast-serving waveform contract
STREAM_TOL = 1e-5  # streaming against one-shot at parity (overlap-add sums)
STREAM_FAST_TOL = 7e-2  # the reference's fast streaming bound
AGREE_MIN = 0.97


@pytest.fixture(scope="module")
def x():
    return (np.random.default_rng(11).standard_normal((B, L)) * 0.3).astype(np.float32)


# --- knob resolution --------------------------------------------------------------------------


def _triple(make):
    try:
        c = make()
    except (ValueError, TypeError, NotImplementedError) as e:
        return type(e).__name__
    return (bool(c.use_pallas), bool(c.approx_snake), c.voc_dtype)


KNOBS = list(itertools.product(["highest", "default"], [None, True, False], [None, True, False],
                               [None, "f32", "bf16"]))


@pytest.mark.parametrize("precision,use_pallas,approx,voc_dtype", KNOBS)
def test_knobs_resolve_as_bvsc_tpu(trees, precision, use_pallas, approx, voc_dtype):  # noqa: F811
    kw = dict(precision=precision, use_pallas=use_pallas, approx_snake=approx,
              voc_dtype=voc_dtype)
    got = _triple(lambda: _port_codec(trees, **kw))
    if use_pallas is None and not approx and voc_dtype is None:
        # the port's one departure: its None runs the kernels where they
        # cover the config, as the reference's use_pallas=True does
        assert got == _triple(lambda: _jax_codec(trees, **{**kw, "use_pallas": True}))
        assert got == (True, False, "f32")
    else:
        assert got == _triple(lambda: _jax_codec(trees, **kw))


# --- the offline codec --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_parity(trees, x):  # noqa: F811
    jc = _jax_codec(trees)
    assert not jc.use_pallas and not jc.approx_snake and jc.voc_dtype == "f32"
    codes = np.asarray(jc.encode(x, 3000))
    return {"codes": codes, "decode": np.asarray(jc.decode(codes, L)),
            "forward": np.asarray(jc(x, 3000)), "mel": np.asarray(jc.decode_to_mel(codes))}


@pytest.fixture(scope="module")
def direct(trees):  # noqa: F811
    return _port_codec(trees, use_pallas=False)


@pytest.fixture(scope="module")
def direct_fast(trees):  # noqa: F811
    return _port_codec(trees, use_pallas=False, precision="default")


def test_direct_parity_matches_bvsc_tpu(direct, jax_parity, x):
    codes = direct.encode(x, 3000).numpy()
    np.testing.assert_array_equal(codes, jax_parity["codes"])
    for got, ref in ((direct.decode(codes, L), jax_parity["decode"]),
                     (direct(x, 3000), jax_parity["forward"])):
        got = got.numpy()
        assert got.shape == ref.shape and np.isfinite(got).all()
        assert snr_db(ref, got) > 40.0


def test_direct_vocoder_within_gate(trees, direct, jax_parity):  # noqa: F811
    """The direct path's vocoder on bvsc_tpu's decoded mel within 1e-4 of
    bvsc_tpu's generator at HIGHEST."""
    jconf, _, vtree = trees
    mel = jax_parity["mel"]
    n = mel.shape[-1] * HOP
    ref = np.asarray(JV.generator_apply(jax.tree.map(jnp.asarray, vtree), jconf.vocoder_config,
                                        jnp.asarray(mel), n,
                                        precision=jax.lax.Precision.HIGHEST))[:, 0] / SCALING
    got = direct._vocode(torch.tensor(mel), n).numpy()
    assert np.abs(got - ref).max() <= VOC_TOL


def test_direct_parity_is_the_kernel_paths_plain(trees, direct, x):  # noqa: F811
    """On the CPU the kernels take their plain versions, which the causal
    float32 direct path is, bit for bit."""
    k1 = _port_codec(trees)
    assert k1.use_pallas and not direct.use_pallas
    assert torch.equal(direct(x, 3000), k1(x, 3000))


def test_direct_fast_within_contract(trees, direct, direct_fast, jax_parity, x):  # noqa: F811
    assert (direct_fast.approx_snake, direct_fast.voc_dtype) == (True, "bf16")
    assert direct_fast.weights.vocoder["conv_pre"]["w"].dtype == torch.bfloat16
    codes = direct_fast.encode(x, 3000).numpy()
    assert set(np.unique(codes)) <= {0.0, 0.5, 1.0}
    assert (codes == jax_parity["codes"]).mean() > AGREE_MIN
    pc = jax_parity["codes"]
    got = direct_fast.decode(pc, L)
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    jfast = _jax_codec(trees, precision="default")
    assert jfast.approx_snake and jfast.voc_dtype == "bf16"
    ref = np.asarray(jfast.decode(pc, L))
    gaps = {"bvsc_tpu fast": np.abs(got.numpy() - ref).max(),
            "port parity": (got - direct.decode(pc, L)).abs().max().item()}
    print("fast decode gaps", gaps)
    assert max(gaps.values()) <= FAST_TOL


# --- streaming, serving, bundles -------------------------------------------------------------


def _packets(fc, x):
    outs = [fc.process(x[:, i: i + HOP]) for i in range(0, x.shape[1], HOP)]
    outs.append(fc.flush())
    return torch.cat(outs, 1)


@pytest.mark.parametrize("mode", ["parity", "fast"])
def test_direct_stream_equals_offline(direct, direct_fast, x, mode):
    """The packet codec (the frames whose window lies inside the input) and
    the decoder against the same codec's offline calls; the stream state is
    bf16 in fast mode.  Prints the measured gaps."""
    codec = direct if mode == "parity" else direct_fast
    tol = STREAM_TOL if mode == "parity" else STREAM_FAST_TOL
    assert S.voc_state_dtype(codec) == (torch.float32 if mode == "parity" else torch.bfloat16)
    x1 = x[:1]
    inside = (L - HOP) // HOP * HOP - 2 * HOP
    wav = _packets(S.FusedPacketCodec(codec, batch=1, bitrate=3000), x1)
    gap_pc = (wav[:, :inside] - codec(x1, 3000)[:, :inside]).abs().max().item()
    codes = codec.encode(x1, 3000)
    dec = S.StreamingDecoder(codec, batch=1)
    wav = torch.cat([dec.feed(codes[:, t: t + 1]) for t in range(codes.shape[1])], 1)
    gap_dec = (wav - codec.decode(codes, codes.shape[1] * HOP)).abs().max().item()
    print(f"{mode} stream gaps: packet codec {gap_pc:.3e}, decoder {gap_dec:.3e}")
    assert gap_pc <= tol and gap_dec <= tol


@pytest.mark.parametrize("mode", ["parity", "fast"])
@pytest.mark.parametrize("slots", [1, 2])
def test_direct_slot_equals_packet_codec(direct, direct_fast, x, mode, slots):
    """One slot of an engine on the direct path, flushed, against a B = 1
    FusedPacketCodec of the same codec: a 1-slot engine bitwise; in a
    2-slot one the codes bitwise and the audio within 1e-5 (the products
    sum over the engine's rows, as on the kernel path)."""
    codec = direct if mode == "parity" else direct_fast
    x1 = x[0, : 20 * HOP + 70]
    fc = S.FusedPacketCodec(codec, batch=1, bitrate=3000)
    ref_codes, step = [], fc._step

    def recording(chunk):
        out = step(chunk)
        ref_codes.append(out[0][0].numpy())
        return out

    fc._step = recording
    ref = torch.cat([fc.process(x1[None]), fc.flush()], 1)[0].numpy()
    eng = ServingEngine(codec, max_streams=slots)
    sid = eng.open_stream(3000)
    eng.push(sid, x1)
    eng.begin_flush(sid)
    codes, wav = [], []
    while (out := eng.tick()):
        codes.append(out[sid][0])
        wav.append(out[sid][1])
    wav = np.concatenate(wav)
    assert wav.shape == ref.shape
    np.testing.assert_array_equal(np.stack(codes), np.stack(ref_codes)[: len(codes)])
    if slots == 1:
        np.testing.assert_array_equal(wav, ref)
    assert np.abs(wav - ref).max() <= STREAM_TOL


def test_direct_bundle_equals_live(direct_fast, x, tmp_path):
    """A bundle of the fast direct codec: the manifest names the path, the
    one-shot programs and the packet codec bitwise the live codec's."""
    path = str(tmp_path / "direct.bvscx")
    n = BUCKET * HOP
    meta = export_serving_bundle(direct_fast, path, batch=1, lengths=(n,))
    assert {k: meta["serving"][k] for k in ("use_pallas", "approx_snake", "voc_dtype")} == {
        "use_pallas": False, "approx_snake": True, "voc_dtype": "bf16"}
    assert all(dtype == "bfloat16" for _, _, dtype in meta["packet"]["state"]
               if "/voc/" in f"/{_}/" and "fed" not in _)
    b = ServingBundle(path, device="cpu")
    assert (b.use_pallas, b.approx_snake, b.voc_dtype) == (False, True, "bf16")
    x1 = x[:1, :n]
    assert torch.equal(b(x1, 3000), direct_fast(x1, 3000))
    codes = direct_fast.encode(x1, 3000)
    assert torch.equal(b.encode(x1, 3000), codes)
    assert torch.equal(b.decode(codes, n), direct_fast.decode(codes, n))
    x1 = x1[:, : 12 * HOP]
    live = _packets(S.FusedPacketCodec(direct_fast, batch=1, bitrate=3000), x1)
    assert torch.equal(_packets(b.packet_codec(3000), x1), live)


def test_bundle_without_path_loads_as_kernels(direct_fast, tmp_path):
    """A manifest without the path's keys (written before they existed)
    reads as the kernel path's."""
    import json
    import zipfile

    src, dst = str(tmp_path / "a.bvscx"), str(tmp_path / "b.bvscx")
    k1 = BVRNNCodecModel(config=direct_fast.conf, bvrnn_params=direct_fast.bvrnn_params,
                         vocoder_params=direct_fast.vocoder_params, precision="default",
                         device="cpu")
    assert export_serving_bundle(k1, src, lengths=(), packet=False)["serving"]["use_pallas"]
    with zipfile.ZipFile(src) as zin, zipfile.ZipFile(dst, "w") as zout:
        for item in zin.namelist():
            data = zin.read(item)
            if item == "meta.json":
                meta = json.loads(data)
                for k in ("use_pallas", "approx_snake"):
                    del meta["serving"][k]
                data = json.dumps(meta).encode()
            zout.writestr(item, data)
    b = ServingBundle(dst, device="cpu")
    assert (b.use_pallas, b.approx_snake, b.voc_dtype) == (True, False, "f32")


# --- a config the kernels do not cover ----------------------------------------------------------


def _tiny_toml(tmp_path) -> str:
    with open(os.path.join(REPO, "tests", "test_cli.py")) as f:
        for node in ast.parse(f.read()).body:
            if isinstance(node, ast.Assign) and getattr(node.targets[0], "id", "") == "TINY_TOML":
                text = ast.literal_eval(node.value)
    assert "resblock_dilation_sizes = [[1, 3]]" in text
    path = tmp_path / "tiny.toml"
    path.write_text(text)
    return str(path)


def test_two_dilation_config_runs_direct(tmp_path):
    """TINY_TOML's [[1, 3]] builds a port codec on the direct path that
    matches bvsc_tpu's (codes bitwise, SNR > 40 dB, 1e-4), and the kernel
    path refuses it."""
    toml = _tiny_toml(tmp_path)
    jc = JCodec(toml, length_bucket=4)
    port = BVRNNCodecModel(toml, bvrnn_params=bvrnn_params_from_jax(
        jax.tree.map(np.asarray, jc.bvrnn_params)), vocoder_params=vocoder_params_from_jax(
        jax.tree.map(np.asarray, jc.vocoder_params)), length_bucket=4, device="cpu")
    assert (port.use_pallas, port.approx_snake, port.voc_dtype) == (False, False, "f32")
    conf = load_config(toml)
    assert conf.vocoder_config.resblock_dilation_sizes == ((1, 3),)
    x = (np.random.default_rng(3).standard_normal((2, 3000)) * 0.3).astype(np.float32)
    codes = port.encode(x, 500).numpy()
    np.testing.assert_array_equal(codes, np.asarray(jc.encode(x, 500)))
    got, ref = port(x, 500).numpy(), np.asarray(jc(x, 500))
    assert snr_db(ref, got) > 40.0 and np.abs(got - ref).max() <= VOC_TOL
    with pytest.raises(ValueError, match="use_pallas"):
        BVRNNCodecModel(toml, use_pallas=True, device="cpu")
    assert j_load_config(toml).vocoder_config.resblock_dilation_sizes == ((1, 3),)


def test_daemon_serves_the_direct_path(direct_fast, x):
    """A CodecDaemon on the fast direct codec: one resynthesis client's
    audio bitwise a 4-slot engine's solo run (the daemon's tick)."""
    from bvsc_tpu_torch.serve.client import CodecClient
    from bvsc_tpu_torch.serve.daemon import CodecDaemon

    x1 = x[0, : 12 * HOP]
    eng = ServingEngine(direct_fast, max_streams=4)
    sid = eng.open_stream(3000)
    eng.push(sid, x1)
    eng.begin_flush(sid)
    ref = []
    while (out := eng.tick()):
        ref.append(out[sid][1])
    ref = np.concatenate(ref)
    d = CodecDaemon(direct_fast, port=0, max_streams=4)
    d.start()
    try:
        with CodecClient("127.0.0.1", d.port, mode="resynth", bitrate=3000, timeout=60) as c:
            c.send_audio(x1)
            c.close_input()
            audio = c.drain()["audio"]
    finally:
        d.close()
    np.testing.assert_array_equal(audio, ref[: audio.shape[0]])
    assert audio.shape == x1.shape
