"""The port's fused recurrent cell (bvsc_tpu_torch.models.bvrnn, cfg.fused_cell)
against the JAX package's, at the small config (h 48, z 12) on the same
weights and inputs: the fused weights to 1e-6, and every fused scan at
'highest' against JAX's fused cell at HIGHEST, codes bit-exact and mel and
h to 2e-5.  Within the port, fused decode of the fused codes reproduces
encode_decode's mel and final state bit for bit (the closed-loop state
sync), at both precisions; quantized weights are refused."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from bvsc_tpu.models import bvrnn as jb
from bvsc_tpu.ops import quant as jq
from bvsc_tpu_torch.convert import bvrnn_params_from_jax
from bvsc_tpu_torch.models import bvrnn as tb
from bvsc_tpu_torch.ops import quant as tq

torch.set_num_threads(1)

X_DIM, H_DIM, Z_DIM = 16, 48, 12
T, B = 25, 3
TOL = 2e-5  # the BVRNN gate of the port (ROADMAP.md), float32 sums in another order
FUSE_TOL = 1e-6  # the fused weights: concatenations exact, w_fold/b_fold one product


@pytest.fixture(scope="module")
def cfgs():
    j = jb.BVRNNConfig(x_dim=X_DIM, h_dim=H_DIM, z_dim=Z_DIM, var_bit=True,
                       precision=jax.lax.Precision.HIGHEST, fused_cell=True)
    t = tb.BVRNNConfig(x_dim=X_DIM, h_dim=H_DIM, z_dim=Z_DIM, var_bit=True,
                       precision="highest", fused_cell=True)
    return j, t


@pytest.fixture(scope="module")
def params(cfgs):
    mean_std = (
        np.random.default_rng(1).standard_normal(X_DIM) * 0.1,
        np.abs(np.random.default_rng(2).standard_normal(X_DIM)) + 0.5,
    )
    jp = jb.init_bvrnn_params(jax.random.key(0), cfgs[0], mean_std)
    return jp, bvrnn_params_from_jax(jax.tree.map(np.asarray, jp))


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(7)
    y = rng.standard_normal((B, T, X_DIM)).astype(np.float32)
    bits = rng.integers(1, Z_DIM + 1, size=(B, T)).astype(np.float32)
    valid = np.ones((B, T), np.float32)
    valid[:, T - 6 :] = 0.0
    valid[1, T - 9 :] = 0.0
    h0 = np.random.default_rng(5).standard_normal((B, H_DIM)).astype(np.float32) * 0.1
    return y, bits, valid, h0


def _j(x):
    return jnp.asarray(x)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def test_fuse_inference_params_match_jax(cfgs, params):
    ref = jb._fuse_inference_params(params[0], cfgs[0])
    got = tb._fuse_inference_params(params[1], cfgs[1])
    rleaves, rdef = jax.tree.flatten(jax.tree.map(np.asarray, ref))
    gleaves, gdef = jax.tree.flatten(jax.tree.map(lambda t: t.numpy(), got))
    assert gdef == rdef
    for g, r in zip(gleaves, rleaves):
        assert g.shape == r.shape and g.dtype == np.float32
        np.testing.assert_allclose(g, r, atol=FUSE_TOL)


def test_fused_encode(cfgs, params, data):
    y, bits, _, _ = data
    z, h_seq = jb.encode(params[0], cfgs[0], _j(y), _j(bits), jnp.zeros((B, H_DIM)))
    tz, th = tb.encode(params[1], cfgs[1], _t(y), _t(bits), torch.zeros(B, H_DIM))
    np.testing.assert_array_equal(tz.numpy(), np.asarray(z))
    np.testing.assert_allclose(th.numpy(), np.asarray(h_seq), atol=TOL)


def test_fused_encode_with_state(cfgs, params, data):
    y, bits, _, h0 = data
    z, h = jb.encode_with_state(params[0], cfgs[0], _j(y), _j(bits), _j(h0))
    tz, th = tb.encode_with_state(params[1], cfgs[1], _t(y), _t(bits), _t(h0))
    np.testing.assert_array_equal(tz.numpy(), np.asarray(z))
    np.testing.assert_allclose(th.numpy(), np.asarray(h), atol=TOL)


def test_fused_encode_decode(cfgs, params, data):
    y, bits, valid, _ = data
    z, mel, h = jb.encode_decode(params[0], cfgs[0], _j(y), _j(bits), jnp.zeros((B, H_DIM)),
                                 frame_valid=_j(valid))
    tz, tmel, th = tb.encode_decode(params[1], cfgs[1], _t(y), _t(bits), torch.zeros(B, H_DIM),
                                    frame_valid=_t(valid))
    np.testing.assert_array_equal(tz.numpy(), np.asarray(z))
    assert np.all(tz.numpy()[valid == 0] == 0.5)
    np.testing.assert_allclose(tmel.numpy(), np.asarray(mel), atol=TOL)
    np.testing.assert_allclose(th.numpy(), np.asarray(h), atol=TOL)


def test_fused_decode(cfgs, params):
    rng = np.random.default_rng(3)
    z = rng.integers(0, 2, size=(B, T, Z_DIM)).astype(np.float32)
    z[:, :, Z_DIM // 2 :] = 0.5
    mel, h = jb.decode(params[0], cfgs[0], _j(z), jnp.zeros((B, H_DIM)))
    tmel, th = tb.decode(params[1], cfgs[1], _t(z), torch.zeros(B, H_DIM))
    np.testing.assert_allclose(tmel.numpy(), np.asarray(mel), atol=TOL)
    np.testing.assert_allclose(th.numpy(), np.asarray(h), atol=TOL)


@pytest.mark.parametrize("precision", ["highest", "default"])
def test_fused_decode_follows_encode_state(cfgs, params, data, precision):
    """Fused decode of the fused codes equals encode_decode's mel and final
    h bit for bit, from weights prepared once (as the codec does)."""
    y, bits, valid, _ = data
    cfg = dataclasses.replace(cfgs[1], precision=precision)
    sp = tb.prepare(params[1], cfg)
    z, mel, h = tb.encode_decode(sp, cfg, _t(y), _t(bits), torch.zeros(B, H_DIM),
                                 frame_valid=_t(valid))
    dmel, dh = tb.decode(sp, cfg, z, torch.zeros(B, H_DIM))
    assert torch.equal(dmel, mel)
    assert torch.equal(dh, h)


def test_fused_cell_refuses_quantized_weights(cfgs, params, data):
    y, bits, _, _ = data
    qparams = tq.quantize_bvrnn_params(params[1])
    with pytest.raises(TypeError, match="quantized"):
        tb.encode(qparams, cfgs[1], _t(y), _t(bits), torch.zeros(B, H_DIM))
    with pytest.raises(TypeError, match="quantized"):
        jb._fuse_inference_params(jq.quantize_bvrnn_params(params[0]), cfgs[0])


@pytest.mark.parametrize("batch", [1, 31, 32, 64])
def test_auto_picks_fused_below_threshold(cfgs, batch):
    auto = dataclasses.replace(cfgs[1], fused_cell="auto")
    jauto = dataclasses.replace(cfgs[0], fused_cell="auto")
    assert tb.FUSED_AUTO_MAX_B == jb.FUSED_AUTO_MAX_B
    assert tb._use_fused(auto, batch) == jb._use_fused(jauto, batch) == (batch < 32)
