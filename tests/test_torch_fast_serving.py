"""The port's fast-serving mode (bvsc_tpu_torch.BVRNNCodecModel with
precision='default', fused_cell=, quantize=) against bvsc_tpu.

* The knobs resolve as bvsc_tpu.BVRNNCodecModel(..., use_pallas=True)
  resolves them where the port runs the kernels (use_pallas=True, and the
  port's default None unless approx_snake=True or a voc_dtype is passed),
  and raise where it raises; the port's None with those knobs resolves as
  bvsc_tpu's use_pallas=False (tests/test_torch_direct_path.py holds the
  whole table).
* On the CPU the port at 'default' runs the plain bf16 versions.  JAX's
  Precision.DEFAULT on this CPU computes float32, so these are the
  reference's contract checks, not bit checks: decode of the same codes
  within 2e-2 of bvsc_tpu's parity codec (tests/test_codec.py's fast-serving
  bound), encode codes agreeing > 0.97 (tests/test_quant.py's small-config
  bound), and, within the port, __call__ within 5e-4 of
  decode(encode(x)) (tests/test_bvrnn_fused.py's bound).
"""

import itertools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from bvsc_tpu.codec import BVRNNCodecModel as JCodec
from bvsc_tpu.config import CodecConfig as JCodecConfig
from bvsc_tpu.models import bvrnn as jb
from bvsc_tpu_torch import BVRNNCodecModel, CodecConfig
from bvsc_tpu_torch.convert import bvrnn_params_from_jax, vocoder_params_from_jax
from bvsc_tpu_torch.models import bvrnn as tb
from test_torch_amp_resblock import perturbed_generator_params

torch.set_num_threads(1)

SMALL = dict(h_dim=48, z_dim=12)
L, B = 6615, 2  # 0.3 s at 22.05 kHz
BUCKET = 16
WAVE_TOL = 2e-2  # the reference's fast-serving waveform contract
AGREE_MIN = 0.97  # the reference's small-config code agreement bound
CALL_TOL = 5e-4  # one-scan resynthesis against decode(encode(x)), fast mode


@pytest.fixture(scope="module")
def weights():
    bcfg = jb.BVRNNConfig(x_dim=80, h_dim=SMALL["h_dim"], z_dim=SMALL["z_dim"])
    mean_std = (np.random.default_rng(1).standard_normal(80) * 0.5 - 4.0,
                np.abs(np.random.default_rng(2).standard_normal(80)) + 1.0)
    btree = jax.tree.map(np.asarray, jb.init_bvrnn_params(jax.random.key(0), bcfg, mean_std))
    vtree = perturbed_generator_params(JCodecConfig(**SMALL).vocoder_config, seed=3)
    return btree, vtree


def _jax(weights, **kw):
    btree, vtree = weights
    return JCodec(config=JCodecConfig(**SMALL), bvrnn_params=jax.tree.map(jnp.asarray, btree),
                  vocoder_params=jax.tree.map(jnp.asarray, vtree), length_bucket=BUCKET, **kw)


def _port(weights, **kw):
    btree, vtree = weights
    return BVRNNCodecModel(config=CodecConfig(**SMALL), bvrnn_params=bvrnn_params_from_jax(btree),
                           vocoder_params=vocoder_params_from_jax(vtree), length_bucket=BUCKET,
                           device="cpu", **kw)


def _resolved(make):
    """What a constructor resolves the knobs to, or the error it raises."""
    try:
        c = make()
    except (ValueError, TypeError) as e:
        return type(e).__name__
    fast = c.precision in ("default", jax.lax.Precision.DEFAULT)
    return (fast, c.fused_cell, c.bvrnn_cfg.fused_cell, c.approx_snake, c.voc_dtype,
            tb.is_quantized(c.bvrnn_params) if isinstance(c, BVRNNCodecModel)
            else jb.is_quantized(c.bvrnn_params))


KNOBS = list(itertools.product(
    ["highest", "default"],            # precision
    [None, True, False, "auto"],       # fused_cell
    [None, "int8", "int8_mixed"],      # quantize
    [(None, None), (True, None), (False, None), (None, "bf16"), (None, "f32")],  # approx_snake, voc_dtype
)) + [
    ("default", "yes", None, (None, None)),
    ("default", None, "int4", (None, None)),
    ("highest", None, None, (None, "f16")),
    ("fast", None, None, (None, None)),  # anything but 'highest' is 'default'
]


@pytest.mark.parametrize("precision,fused_cell,quantize,snake_dtype", KNOBS)
def test_knobs_resolve_as_jax_kernel_path(weights, precision, fused_cell, quantize, snake_dtype):
    approx_snake, voc_dtype = snake_dtype
    kw = dict(precision=precision, fused_cell=fused_cell, quantize=quantize,
              approx_snake=approx_snake, voc_dtype=voc_dtype)
    ref = _resolved(lambda: _jax(weights, use_pallas=True, **kw))
    assert _resolved(lambda: _port(weights, use_pallas=True, **kw)) == ref
    if approx_snake or voc_dtype is not None:
        ref = _resolved(lambda: _jax(weights, use_pallas=False, **kw))
    assert _resolved(lambda: _port(weights, **kw)) == ref


def test_use_pallas_false_runs_the_direct_path(weights):
    codec = _port(weights, precision="default", use_pallas=False)
    ref = _jax(weights, precision="default", use_pallas=False)
    assert (codec.use_pallas, codec.approx_snake, codec.voc_dtype) == (False, True, "bf16")
    assert (ref.approx_snake, ref.voc_dtype) == (True, "bf16")
    assert codec.kernel_blocks is None and codec.weights.direct


def test_fast_mode_leaves_tf32_flags(weights):
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    try:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        _port(weights, precision="default")
        assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
        _port(weights)
        assert not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


@pytest.fixture(scope="module")
def x():
    return (np.random.default_rng(11).standard_normal((B, L)) * 0.3).astype(np.float32)


@pytest.fixture(scope="module")
def parity(weights):
    return _jax(weights)


FORMS = {"auto": {}, "unfused": {"fused_cell": False}, "int8": {"quantize": "int8"},
         "int8_mixed": {"quantize": "int8_mixed"}}


@pytest.mark.parametrize("form", sorted(FORMS))
def test_fast_decode_within_contract(weights, parity, x, form):
    codes = np.asarray(parity.encode(x, 3000))
    ref = np.asarray(parity.decode(codes, L))
    got = _port(weights, precision="default", **FORMS[form]).decode(codes, L).numpy()
    assert got.shape == ref.shape and np.isfinite(got).all()
    assert np.abs(got - ref).max() <= WAVE_TOL


@pytest.mark.parametrize("form", sorted(FORMS))
def test_fast_codes_agree_with_parity(weights, parity, x, form):
    ref = np.asarray(parity.encode(x, 3000))
    got = _port(weights, precision="default", **FORMS[form]).encode(x, 3000).numpy()
    assert set(np.unique(got)) <= {0.0, 0.5, 1.0}
    assert (got == ref).mean() > AGREE_MIN


@pytest.mark.parametrize("form", sorted(FORMS))
def test_fast_call_matches_decode_of_encode(weights, x, form):
    codec = _port(weights, precision="default", **FORMS[form])
    one = codec(x, 3000).numpy()
    two = codec.decode(codec.encode(x, 3000), L).numpy()
    assert one.shape == two.shape == (B, L)
    assert np.abs(one - two).max() <= CALL_TOL


@pytest.mark.parametrize("form", sorted(FORMS))
def test_codes_from_own_states_are_the_codes(weights, x, form):
    """codes_from_states, given a model's own encode states, gives back its
    codes (what the smoke's chaos-free agreement rests on)."""
    codec = _port(weights, precision="default", **FORMS[form])
    xt = torch.from_numpy(x)
    Lp = codec._pad_length(L)
    mel = codec._mel(torch.nn.functional.pad(xt, (0, Lp - L)))
    bits = codec._frame_bits(3000, B, L, Lp, codec.frontend.num_frames(L))
    codes, h_seq = tb.encode(codec.scan_params, codec.bvrnn_cfg, mel, bits, codec._h0(B))
    again = tb.codes_from_states(codec.scan_params, codec.bvrnn_cfg, mel, bits, h_seq)
    assert torch.equal(again, codes)
