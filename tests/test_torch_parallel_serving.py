"""The port's serving engines with ``mesh=`` (single controller, slots split
over the mesh's devices) on ``devices=["cpu", "cpu"]``, against the same
engines unsharded and against ``bvsc_tpu``'s engines sharded over a 2-device
data mesh (``tests/conftest.py``'s virtual CPU devices); and the bundle
engines, whose tick programs carry a symbolic slot count, over the same mesh.

Gates (``__graft_entry__.py``'s dry run): codes bitwise, audio within 1e-5
of the unsharded engine (a block sums its products over its own rows) and of
``bvsc_tpu``'s sharded engine, the bundle engines within 1e-4; the decode
engine with a concealed frame.  A tiny codec (hop 8, h 32, z 12) keeps it
fast; its weights are the JAX package's init, moved across with
``bvsc_tpu_torch.convert``.
"""

import jax
import numpy as np
import pytest
import torch

from bvsc_tpu.codec import BVRNNCodecModel as JCodec
from bvsc_tpu.config import CodecConfig as JCodecConfig
from bvsc_tpu.config import VocoderConfig as JVocoderConfig
from bvsc_tpu.models import bvrnn as jb
from bvsc_tpu.parallel.mesh import make_mesh as jax_make_mesh
from bvsc_tpu.serve import engine as JE
from bvsc_tpu_torch import BVRNNCodecModel
from bvsc_tpu_torch.config import CodecConfig, VocoderConfig
from bvsc_tpu_torch.convert import bvrnn_params_from_jax, vocoder_params_from_jax
from bvsc_tpu_torch.parallel.mesh import make_mesh
from bvsc_tpu_torch.serve import export as E
from bvsc_tpu_torch.serve.engine import DecodeEngine, ServingEngine

torch.set_num_threads(1)

SLOTS = 4
TOL = 1e-5
BUNDLE_TOL = 1e-4
BITRATES = (30000.0, 16000.0, 5000.0)  # 11, 6 and 2 of 12 bits a frame

VOC = dict(num_mels=8, upsample_rates=(4, 2), upsample_kernel_sizes=(8, 4),
           upsample_initial_channel=16, resblock_kernel_sizes=(3, 5),
           resblock_dilation_sizes=((1, 3, 5), (1, 3, 5)),
           layers_sym=(False, False), layers_antialias=(False, False))
CONF = dict(num_mels=8, h_dim=32, z_dim=12, hopsize=8, winsize=64, mel_pad_left=16, var_bit=True)


@pytest.fixture(scope="module")
def trees():
    """The JAX config and the numpy weight trees both packages' codecs are
    built from: per-channel snake parameters and the vocoder's conv weights
    redrawn from a numpy seed at 1 / sqrt(fan-in), so that the audio follows
    the mel (at the JAX init's 0.01 it is the biases' alone)."""
    from test_torch_amp_resblock import perturbed_generator_params

    jconf = JCodecConfig(**CONF, vocoder_config=JVocoderConfig(**VOC))
    bcfg = jb.BVRNNConfig(x_dim=8, h_dim=CONF["h_dim"], z_dim=CONF["z_dim"])
    rng = np.random.default_rng(5)
    mean_std = (rng.standard_normal(8) * 0.5 - 4.0, np.abs(rng.standard_normal(8)) + 1.0)
    btree = jax.tree.map(np.asarray, jb.init_bvrnn_params(jax.random.key(5), bcfg, mean_std))
    vtree = perturbed_generator_params(jconf.vocoder_config, seed=5)
    for conv in jax.tree.leaves(vtree, is_leaf=lambda t: isinstance(t, dict) and "w" in t):
        if isinstance(conv, dict) and "w" in conv:
            w = conv["w"]
            conv["w"] = (rng.standard_normal(w.shape) / np.sqrt(w[0].size)).astype(np.float32)
    vtree["conv_post"]["w"] *= 0.1  # audio within about +-1
    return jconf, btree, vtree


@pytest.fixture(scope="module")
def codec(trees):
    _, btree, vtree = trees
    conf = CodecConfig(**CONF, vocoder_config=VocoderConfig(**VOC))
    return BVRNNCodecModel(config=conf, bvrnn_params=bvrnn_params_from_jax(btree),
                           vocoder_params=vocoder_params_from_jax(vtree), length_bucket=4,
                           device="cpu")


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(devices=["cpu", "cpu"])


def _audio(i: int, n: int) -> np.ndarray:
    return (np.random.default_rng(i).standard_normal(n) * 0.3).astype(np.float32)


def run_encode(eng):
    """Three streams (slots 0, 1 in the first block, 2 in the second),
    flushed: {stream: (codes, wav)}."""
    sids, out = {}, {}
    for i, bps in enumerate(BITRATES):
        sids[i] = eng.open_stream(bps)
        eng.push(sids[i], _audio(i, 48 + (6 + 2 * i) * 8 + 3))
        eng.begin_flush(sids[i])
        out[i] = ([], [])
    while res := eng.tick():
        for i, sid in sids.items():
            if sid in res:
                out[i][0].append(res[sid][0])
                out[i][1].append(res[sid][1])
    return {i: (np.stack(c), np.concatenate(w)) for i, (c, w) in out.items()}


def run_decode(eng):
    """Three decode streams, the second losing frames 1 and 3 (concealed at
    500 bps), the third starting a tick late: {stream: wav}."""
    rng = np.random.default_rng(7)
    codes = [rng.integers(0, 2, (6, 12)).astype(np.float32) for _ in range(3)]
    sids = [eng.open_stream(), eng.open_stream(conceal_bitrate=500)]
    eng.push(sids[0], codes[0])
    eng.push(sids[1], codes[1], lost=np.isin(np.arange(6), [1, 3]))
    out = {sid: [] for sid in sids}
    first = eng.tick()
    sids.append(eng.open_stream())
    eng.push(sids[2], codes[2])
    out[sids[2]] = []
    for res in [first, *iter(eng.tick, {})]:
        for sid, wav in res.items():
            out[sid].append(wav)
    return [np.concatenate(out[sid]) for sid in sids]


def _check_encode(got, ref, tol):
    for i in ref:
        np.testing.assert_array_equal(got[i][0], ref[i][0])
        assert got[i][1].shape == ref[i][1].shape
        assert np.abs(got[i][1] - ref[i][1]).max() <= tol


@pytest.fixture(scope="module")
def jax_runs(trees):
    """``bvsc_tpu``'s engines with ``mesh=`` over 2 virtual CPU devices, on
    the same weights and schedules."""
    jconf, btree, vtree = trees
    jc = JCodec(config=jconf, bvrnn_params=jax.tree.map(jax.numpy.asarray, btree),
                vocoder_params=jax.tree.map(jax.numpy.asarray, vtree), length_bucket=4)
    jmesh = jax_make_mesh(2)
    return {"serve": run_encode(JE.ServingEngine(jc, max_streams=SLOTS, mesh=jmesh)),
            "decode": run_decode(JE.DecodeEngine(jc, max_streams=SLOTS, mesh=jmesh))}


def _check_decode(got, ref, tol):
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        assert a.shape == b.shape and np.isfinite(a).all()
        assert np.abs(a - b).max() <= tol


def test_serving_engine_sharded(codec, mesh):
    eng = ServingEngine(codec, max_streams=SLOTS, mesh=mesh)
    assert len(eng.states) == 2 and eng.states[1]["h"].shape == (SLOTS // 2, 32)
    _check_encode(run_encode(eng), run_encode(ServingEngine(codec, max_streams=SLOTS)), TOL)


def test_decode_engine_sharded(codec, mesh):
    ref = run_decode(DecodeEngine(codec, max_streams=SLOTS))
    got = run_decode(DecodeEngine(codec, max_streams=SLOTS, mesh=mesh))
    _check_decode(got, ref, TOL)


def test_serving_engine_sharded_matches_jax(codec, mesh, jax_runs):
    _check_encode(run_encode(ServingEngine(codec, max_streams=SLOTS, mesh=mesh)),
                  jax_runs["serve"], TOL)


def test_decode_engine_sharded_matches_jax(codec, mesh, jax_runs):
    """With the concealed frames of the second stream."""
    _check_decode(run_decode(DecodeEngine(codec, max_streams=SLOTS, mesh=mesh)),
                  jax_runs["decode"], TOL)


def test_sharded_state_and_recovery(codec, mesh):
    """A sharded engine has one state a block and no single ``state``; a
    failed tick rebuilds every block's zeroed state."""
    from bvsc_tpu_torch.serve.engine import EngineStateLost

    eng = ServingEngine(codec, max_streams=SLOTS, mesh=mesh)
    with pytest.raises(AttributeError, match="states"):
        eng.state
    for bps in BITRATES:
        eng.push(eng.open_stream(bps), _audio(0, 200))
    eng.tick()
    assert eng.states[1]["h"].abs().sum() > 0

    def failing(*args):
        raise RuntimeError("simulated device failure")

    eng._tick_call = failing
    with pytest.raises(EngineStateLost):
        eng.tick()
    assert all(not st["h"].any() for st in eng.states)


@pytest.fixture(scope="module")
def bundle(codec, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("bundle") / "engines.bvscx")
    E.export_serving_bundle(codec, path, batch=1, lengths=(128,), packet=False,
                            engine_batch=SLOTS)
    return E.ServingBundle(path, device="cpu")


def test_bundle_engines_sharded(codec, mesh, bundle):
    assert bundle.meta["engine"]["slots"] == [1, E.MAX_BATCH]
    ref = run_encode(ServingEngine(codec, max_streams=SLOTS))
    _check_encode(run_encode(bundle.serving_engine(mesh=mesh)), ref, BUNDLE_TOL)
    ref = run_decode(DecodeEngine(codec, max_streams=SLOTS))
    _check_decode(run_decode(bundle.decode_engine(mesh=mesh)), ref, BUNDLE_TOL)


def test_bundle_engines_sharded_match_jax(mesh, bundle, jax_runs):
    _check_encode(run_encode(bundle.serving_engine(mesh=mesh)), jax_runs["serve"], BUNDLE_TOL)
    _check_decode(run_decode(bundle.decode_engine(mesh=mesh)), jax_runs["decode"], BUNDLE_TOL)


def test_bundle_engine_sharded_matches_live_sharded(codec, mesh, bundle):
    """Over the same mesh, the bundle's programs on a block of slots are
    the live engine's step on that block: bitwise."""
    live = run_encode(ServingEngine(codec, max_streams=SLOTS, mesh=mesh))
    _check_encode(run_encode(bundle.serving_engine(mesh=mesh)), live, 0.0)


def test_bundle_block_outside_traced_slots(codec, tmp_path):
    """With ``fused_cell='auto'`` the programs serve only slot counts on
    the side of the cell threshold they were traced on: a block outside
    that range is refused."""
    auto = BVRNNCodecModel(config=codec.conf, bvrnn_params=codec.bvrnn_params,
                           vocoder_params=codec.vocoder_params, length_bucket=4,
                           fused_cell="auto", device="cpu")
    path = str(tmp_path / "auto.bvscx")
    E.export_serving_bundle(auto, path, batch=1, lengths=(128,), packet=False,
                            engine_batch=SLOTS)
    b = E.ServingBundle(path, device="cpu")
    assert b.meta["engine"]["slots"] == [1, 31]
    b.serving_engine(mesh=make_mesh(devices=["cpu"] * SLOTS))  # blocks of 1 slot
    b.meta["engine"]["slots"] = [2, 31]  # as if traced for 2 or more
    with pytest.raises(ValueError, match="slots"):
        b.serving_engine(mesh=make_mesh(devices=["cpu"] * SLOTS))


def test_dryrun_multichip():
    """The dry run of every parallel path on 2 gloo ranks on the CPU (its
    engine checks run in this process over the same 2 devices)."""
    from bvsc_tpu_torch.parallel.dryrun import GATES, dryrun_multichip

    out = dryrun_multichip(2, "cpu", timeout_s=240)
    assert out["tp_codes_equal"]
    for key, gate in (("dp_err", "dp"), ("gan_err", "dp"), ("tp_err", "tp"), ("sp_err", "sp"),
                      ("pp_err", "pp"), ("decode_serve_err", "serve"),
                      ("serve_encode_err", "serve"), ("bundle_serve_err", "bundle")):
        assert out[key] <= GATES[gate], key


def test_daemon_engines_take_the_mesh(codec, mesh):
    """``CodecDaemon(mesh=)`` builds both engines over the mesh's devices."""
    from bvsc_tpu_torch.serve.daemon import CodecDaemon

    d = CodecDaemon(codec, max_streams=SLOTS, mesh=mesh)
    assert len(d._eng.states) == len(d._dec.states) == 2
