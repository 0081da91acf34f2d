"""Port BVRNN (bvsc_tpu_torch.models.bvrnn) against bvsc_tpu.models.bvrnn at
the small config of tests/test_bvrnn.py, on the same weights and inputs.
Codes must agree bit for bit; hidden states and mel to 2e-5."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from bvsc_tpu.models import bvrnn as jb
from bvsc_tpu_torch.convert import bvrnn_params_from_jax
from bvsc_tpu_torch.models import bvrnn as tb
from bvsc_tpu_torch.utils import tracing

torch.set_num_threads(1)

X_DIM, H_DIM, Z_DIM = 16, 48, 12
T, B = 25, 3
TOL = 2e-5


@pytest.fixture(scope="module")
def cfgs():
    return (jb.BVRNNConfig(x_dim=X_DIM, h_dim=H_DIM, z_dim=Z_DIM, var_bit=True),
            tb.BVRNNConfig(x_dim=X_DIM, h_dim=H_DIM, z_dim=Z_DIM, var_bit=True))


@pytest.fixture(scope="module")
def params(cfgs):
    mean_std = (
        np.random.default_rng(1).standard_normal(X_DIM) * 0.1,
        np.abs(np.random.default_rng(2).standard_normal(X_DIM)) + 0.5,
    )
    jp = jb.init_bvrnn_params(jax.random.key(0), cfgs[0], mean_std)
    tree = jax.tree.map(np.asarray, jp)
    return jp, bvrnn_params_from_jax(tree)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(7)
    y = rng.standard_normal((B, T, X_DIM)).astype(np.float32)
    bits = rng.integers(1, Z_DIM + 1, size=(B, T)).astype(np.float32)  # per-frame VBR
    valid = np.ones((B, T), np.float32)
    valid[:, T - 6 :] = 0.0  # a padded tail, forced to 0.5 codes
    valid[1, T - 9 :] = 0.0
    return y, bits, valid


def _j(x):
    return jnp.asarray(x)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def test_encode(cfgs, params, data):
    y, bits, _ = data
    z, h_seq = jb.encode(params[0], cfgs[0], _j(y), _j(bits), jnp.zeros((B, H_DIM)))
    tz, th = tb.encode(params[1], cfgs[1], _t(y), _t(bits), torch.zeros(B, H_DIM))
    np.testing.assert_array_equal(tz.numpy(), np.asarray(z))
    np.testing.assert_allclose(th.numpy(), np.asarray(h_seq), atol=TOL)
    assert set(np.unique(tz.numpy())) <= {0.0, 0.5, 1.0}


def test_encode_with_state(cfgs, params, data):
    y, bits, _ = data
    h0 = np.random.default_rng(5).standard_normal((B, H_DIM)).astype(np.float32) * 0.1
    z, h = jb.encode_with_state(params[0], cfgs[0], _j(y), _j(bits), _j(h0))
    tz, th = tb.encode_with_state(params[1], cfgs[1], _t(y), _t(bits), _t(h0))
    np.testing.assert_array_equal(tz.numpy(), np.asarray(z))
    np.testing.assert_allclose(th.numpy(), np.asarray(h), atol=TOL)


def test_encode_decode_frame_valid(cfgs, params, data):
    y, bits, valid = data
    z, mel, h = jb.encode_decode(params[0], cfgs[0], _j(y), _j(bits),
                                 jnp.zeros((B, H_DIM)), frame_valid=_j(valid))
    tz, tmel, th = tb.encode_decode(params[1], cfgs[1], _t(y), _t(bits),
                                    torch.zeros(B, H_DIM), frame_valid=_t(valid))
    np.testing.assert_array_equal(tz.numpy(), np.asarray(z))
    assert np.all(tz.numpy()[valid == 0] == 0.5)
    np.testing.assert_allclose(tmel.numpy(), np.asarray(mel), atol=TOL)
    np.testing.assert_allclose(th.numpy(), np.asarray(h), atol=TOL)


def test_decode(cfgs, params):
    rng = np.random.default_rng(3)
    z = rng.integers(0, 2, size=(B, T, Z_DIM)).astype(np.float32)
    z[:, :, Z_DIM // 2 :] = 0.5  # masked bits
    mel, h = jb.decode(params[0], cfgs[0], _j(z), jnp.zeros((B, H_DIM)))
    tmel, th = tb.decode(params[1], cfgs[1], _t(z), torch.zeros(B, H_DIM))
    np.testing.assert_allclose(tmel.numpy(), np.asarray(mel), atol=TOL)
    np.testing.assert_allclose(th.numpy(), np.asarray(h), atol=TOL)


def test_decode_follows_encode_state(cfgs, params, data):
    """Closed-loop state sync within the port: decode of the emitted codes
    reproduces the encoder's decoded trajectory."""
    y, bits, _ = data
    tz, tmel, th = tb.encode_decode(params[1], cfgs[1], _t(y), _t(bits), torch.zeros(B, H_DIM))
    dmel, dh = tb.decode(params[1], cfgs[1], tz, torch.zeros(B, H_DIM))
    np.testing.assert_array_equal(dmel.numpy(), tmel.numpy())
    np.testing.assert_array_equal(dh.numpy(), th.numpy())


def test_gru_step_and_bit_mask(params, data):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((B, 2 * H_DIM)).astype(np.float32)
    h = rng.standard_normal((B, H_DIM)).astype(np.float32)
    ref = jb.gru_step(params[0]["gru"], _j(x), _j(h), jax.lax.Precision.HIGHEST)
    got = tb.gru_step(params[1]["gru"], _t(x), _t(h))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL)
    bits = data[1]
    np.testing.assert_array_equal(
        tb.bit_mask_from_bitrate(_t(bits), Z_DIM).numpy(),
        np.asarray(jb.bit_mask_from_bitrate(_j(bits), Z_DIM)),
    )


def test_round_half_to_even():
    """jnp.round and torch.round both round half to even."""
    v = np.array([0.5, 1.5, 2.5, -0.5, 0.49999997], np.float32)
    np.testing.assert_array_equal(torch.round(_t(v)).numpy(), np.asarray(jnp.round(_j(v))))


def test_init_shapes_match_jax(cfgs):
    jp = jb.init_bvrnn_params(jax.random.key(0), cfgs[0])
    tp = tb.init_bvrnn_params(0, cfgs[1])
    jshapes = jax.tree.map(lambda a: tuple(a.shape), jp)
    tshapes = jax.tree.map(lambda a: tuple(a.shape), tp)
    assert tshapes == jshapes


# ---------------------------------------------------------------------------
# Chunked scans (models.bvrnn._frames): whole chunks of CHUNK frames through
# the chunk runner, the rest through the loop.  The card's runner replays a
# CUDA graph (tests/test_torch_bvrnn_graph.py); here an eager runner that,
# like the graph, reads each chunk from buffers of its own.
# ---------------------------------------------------------------------------


def _eager_runner(cache, key, step, h, xs):
    def run(h, xs):
        return tb._loop(step, h.clone(), [x.clone(memory_format=torch.contiguous_format)
                                          for x in xs])
    return run


def _graph_frames():
    return tracing.snapshot()["counters"].get("bvrnn.graph_frames", 0)


def _chunk_inputs(frames, seed=11):
    rng = np.random.default_rng(seed)
    y = _t(rng.standard_normal((B, frames, X_DIM)).astype(np.float32))
    bits = _t(rng.integers(1, Z_DIM + 1, size=(B, frames)).astype(np.float32))
    valid = np.ones((B, frames), np.float32)
    valid[:, frames - 7 :] = 0.0  # a padded tail, forced to 0.5 codes
    valid[1, frames - 70 :] = 0.0  # across a chunk's edge
    z = rng.integers(0, 2, size=(B, frames, Z_DIM)).astype(np.float32)
    z[:, :, Z_DIM // 2 :] = 0.5  # masked bits
    h0 = _t(rng.standard_normal((B, H_DIM)).astype(np.float32) * 0.1)
    return y, bits, _t(valid), _t(z), h0


_CHUNK_CALLS = {
    "encode_decode": lambda sp, cfg, y, bits, valid, z, h0: tb.encode_decode(
        sp, cfg, y, bits, h0, frame_valid=valid),
    "encode": lambda sp, cfg, y, bits, valid, z, h0: tb.encode(sp, cfg, y, bits, h0),
    "decode": lambda sp, cfg, y, bits, valid, z, h0: tb.decode(sp, cfg, z, h0),
}


@pytest.mark.parametrize("fused", [False, True], ids=["standard", "fused"])
@pytest.mark.parametrize("frames", [64, 576, 577])
@pytest.mark.parametrize("call", list(_CHUNK_CALLS))
def test_chunked_scan_is_the_loop(params, monkeypatch, call, frames, fused):
    """Every output of a chunked scan is bitwise the loop's, the remainder
    of T modulo CHUNK included, and the chunks cover the whole chunks."""
    cfg = tb.BVRNNConfig(x_dim=X_DIM, h_dim=H_DIM, z_dim=Z_DIM, var_bit=True, fused_cell=fused)
    sp = tb.prepare(params[1], cfg)
    args = _chunk_inputs(frames)
    with torch.no_grad():
        ref = _CHUNK_CALLS[call](sp, cfg, *args)
        tracing.reset()
        monkeypatch.setattr(tb, "_chunk_graph", _eager_runner)
        got = _CHUNK_CALLS[call](sp, cfg, *args)
    assert _graph_frames() == frames // tb.CHUNK * tb.CHUNK * B
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g.shape == r.shape and torch.equal(g, r)


def _bypass_case(case, params):
    """(a call that must run the loop alone, the weights it reads)."""
    cfg = tb.BVRNNConfig(x_dim=X_DIM, h_dim=H_DIM, z_dim=Z_DIM, var_bit=True)
    sp = tb.prepare(params[1], cfg)
    y, bits, valid, z, h0 = _chunk_inputs(2 * tb.CHUNK)
    if case == "one_frame":  # a stream engine's step
        return lambda: tb.encode_decode(sp, cfg, y[:, :1], bits[:, :1], h0, valid[:, :1])
    if case == "traced":  # a serving bundle's program
        traced = tb.ScanParams(sp.std, sp.fused, traced=True)
        return lambda: tb.encode_decode(traced, cfg, y, bits, h0, frame_valid=valid)
    if case == "statics":  # a host value a step
        def step(h, x_t, add):
            return h + x_t if add else h, (h,)
        statics = [{"add": t % 2 == 0} for t in range(z.shape[1])]
        return lambda: tb._frames(step, h0[:, :Z_DIM], [z], False, statics,
                                  cache=sp.graphs, key=("probe",))
    if case == "grad":  # the trainers
        def call():
            with torch.enable_grad():
                return tb.decode(sp, cfg, z, h0)
        return call
    if case in ("compiling", "exporting"):  # torch.compile / torch.export tracing the scan
        return lambda: tb.encode_decode(sp, cfg, y, bits, h0, frame_valid=valid)
    if case == "raw_tree":  # prepared anew each call
        return lambda: tb.encode_decode(params[1], cfg, y, bits, h0, frame_valid=valid)
    if case == "decode_plc":  # reads the loss flags on the host
        lost = torch.zeros(B, z.shape[1])
        lost[0, 5:9] = 1.0
        return lambda: tb.decode_plc(sp, cfg, z, lost, h0)
    raise ValueError(case)


@pytest.mark.parametrize("case", ["one_frame", "traced", "statics", "grad", "raw_tree",
                                  "decode_plc", "compiling", "exporting"])
def test_chunk_runner_bypassed(params, monkeypatch, case):
    """A scan of one frame, a traced scan, one with a host value a step,
    one with gradients on, one of a raw tree, the concealing decode and a
    scan that torch.compile or torch.export traces never ask for a chunk
    runner, and count no chunk frame."""
    asked = []

    def runner(cache, key, step, h, xs):
        asked.append(key)
        return _eager_runner(cache, key, step, h, xs)

    call = _bypass_case(case, params)
    tracing.reset()
    monkeypatch.setattr(tb, "_chunk_graph", runner)
    if case in ("compiling", "exporting"):
        monkeypatch.setattr(torch.compiler, "is_" + case, lambda: True)
    with torch.no_grad():
        call()
    counters = tracing.snapshot()["counters"]
    assert asked == []
    assert counters.get("bvrnn.graph_frames", 0) == 0
    assert counters.get("bvrnn.graph_captures", 0) == 0
