"""Weight-only int8 BVRNN weights (bvsc_tpu_torch.ops.quant) against the
JAX package's ops.quant, and the codec's quantize= knob at 'highest'
against bvsc_tpu's codec with the same knob on the same weights and input:
codes bit-exact, decoded mel to 2e-5."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from bvsc_tpu.codec import BVRNNCodecModel as JCodec
from bvsc_tpu.config import CodecConfig as JCodecConfig
from bvsc_tpu.models import bvrnn as jb
from bvsc_tpu.ops import quant as jq
from bvsc_tpu_torch import BVRNNCodecModel, CodecConfig
from bvsc_tpu_torch.convert import bvrnn_params_from_jax, vocoder_params_from_jax
from bvsc_tpu_torch.models import bvrnn as tb
from bvsc_tpu_torch.ops import quant as tq
from test_torch_amp_resblock import perturbed_generator_params

torch.set_num_threads(1)

SMALL = dict(h_dim=48, z_dim=12)
L, B = 6615, 2  # 0.3 s at 22.05 kHz
BUCKET = 16
MEL_TOL = 2e-5  # the BVRNN gate of the port (ROADMAP.md)
SCALE_TOL = 1e-7  # max|w| / 127 in float32 on both sides
MATMUL_TOL = 1e-5  # float32 sums of K = 64 terms of size ~1, in another order


def test_quantize_dense_matches_jax():
    w = np.random.default_rng(0).standard_normal((64, 48)).astype(np.float32)
    w[:, 5] = 0.0  # an all-zero channel takes the 1e-12 floor
    ref = jq.quantize_dense(jnp.asarray(w))
    got = tq.quantize_dense(torch.from_numpy(w))
    assert got["q"].dtype == torch.int8 and got["scale"].dtype == torch.float32
    np.testing.assert_array_equal(got["q"].numpy(), np.asarray(ref["q"]))
    np.testing.assert_allclose(got["scale"].numpy(), np.asarray(ref["scale"]), rtol=0, atol=SCALE_TOL)


@pytest.mark.parametrize("precision", ["highest", "default"])
def test_dequant_matmul_matches_jax(precision):
    """At 'highest' against JAX's HIGHEST product; at 'default' against the
    bf16-rounded x times the (exact) int8 values, which is what the TPU's
    single pass computes (JAX's DEFAULT on this CPU computes float32)."""
    rng = np.random.default_rng(1)
    w = rng.standard_normal((64, 48)).astype(np.float32)
    x = rng.standard_normal((4, 64)).astype(np.float32)
    p = tq.quantize_dense(torch.from_numpy(w))
    got = tq.dequant_matmul(torch.from_numpy(x), p, precision).numpy()
    jp = jq.quantize_dense(jnp.asarray(w))
    xr = x if precision == "highest" else np.asarray(jnp.asarray(x).astype(jnp.bfloat16), np.float32)
    ref = np.asarray(jq.dequant_matmul(jnp.asarray(xr), jp, precision=jax.lax.Precision.HIGHEST))
    np.testing.assert_allclose(got, ref, atol=MATMUL_TOL)


def test_quantized_trees_match_jax():
    cfg = jb.BVRNNConfig(x_dim=16, h_dim=48, z_dim=12)
    jp = jax.tree.map(np.asarray, jb.init_bvrnn_params(jax.random.key(0), cfg))
    tp = bvrnn_params_from_jax(jp)
    for jfn, tfn in ((jq.quantize_bvrnn_params, tq.quantize_bvrnn_params),
                     (jq.quantize_bvrnn_params_mixed, tq.quantize_bvrnn_params_mixed)):
        ref = jax.tree.map(np.asarray, jfn(jax.tree.map(jnp.asarray, jp)))
        got = jax.tree.map(lambda t: t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy(),
                           tfn(tp))
        assert jax.tree.structure(got) == jax.tree.structure(ref)
        for g, r in zip(jax.tree.leaves(got), jax.tree.leaves(ref)):
            np.testing.assert_allclose(g, np.asarray(r, np.float32), rtol=0, atol=SCALE_TOL)
    assert tb.is_quantized(tq.quantize_bvrnn_params(tp))
    assert not tb.is_quantized(tp)


@pytest.fixture(scope="module")
def weights():
    bcfg = jb.BVRNNConfig(x_dim=80, h_dim=SMALL["h_dim"], z_dim=SMALL["z_dim"])
    mean_std = (np.random.default_rng(1).standard_normal(80) * 0.5 - 4.0,
                np.abs(np.random.default_rng(2).standard_normal(80)) + 1.0)
    btree = jax.tree.map(np.asarray, jb.init_bvrnn_params(jax.random.key(0), bcfg, mean_std))
    vtree = perturbed_generator_params(JCodecConfig(**SMALL).vocoder_config, seed=3)
    return btree, vtree


@pytest.mark.parametrize("mode", ["int8", "int8_mixed"])
def test_codec_quantize_matches_jax(weights, mode):
    btree, vtree = weights
    jc = JCodec(config=JCodecConfig(**SMALL), bvrnn_params=jax.tree.map(jnp.asarray, btree),
                vocoder_params=jax.tree.map(jnp.asarray, vtree), length_bucket=BUCKET,
                quantize=mode)
    tc = BVRNNCodecModel(config=CodecConfig(**SMALL), bvrnn_params=bvrnn_params_from_jax(btree),
                         vocoder_params=vocoder_params_from_jax(vtree), length_bucket=BUCKET,
                         quantize=mode, device="cpu")
    assert tc.quantize == mode and tc.fused_cell is False and jc.fused_cell is False
    x = (np.random.default_rng(11).standard_normal((B, L)) * 0.3).astype(np.float32)
    codes = np.asarray(jc.encode(x, 3000))
    np.testing.assert_array_equal(tc.encode(x, 3000).numpy(), codes)
    np.testing.assert_allclose(tc.decode_to_mel(codes).numpy(), np.asarray(jc.decode_to_mel(codes)),
                               atol=MEL_TOL)
