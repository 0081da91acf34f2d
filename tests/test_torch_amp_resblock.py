"""The AMP-resblock kernel's plain and tiled versions
(bvsc_tpu_torch.ops.amp_resblock) against the JAX package: the Pallas
kernel ``resblock_stack_folded`` in interpret mode (float32) and the direct
``_amp_block`` stack, at stages 0 and 3 at full channel width with T over
several tiles; and, in both modes, a streaming stage's carried context
(``ctx``) and per-row stream start (``start``) in the plain and tiled
versions.  The CUDA kernel itself is compared with the plain version on the
card (``gpu`` marker; skipped without one)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from bvsc_tpu.config import CodecConfig as JCodecConfig
from bvsc_tpu.models import vocoder as JV
from bvsc_tpu.ops import pallas_voc as PV
from bvsc_tpu_torch.config import CodecConfig
from bvsc_tpu_torch.convert import to_torch, vocoder_params_from_jax
from bvsc_tpu_torch.device import set_parity_mode
from bvsc_tpu_torch.models.vocoder import prepare_kernel_params
from bvsc_tpu_torch.ops import amp_resblock as AR
from bvsc_tpu_torch.utils import tracing

torch.set_num_threads(1)

HIGH = jax.lax.Precision.HIGHEST
TOL = 2e-5
STAGE_T = {0: 700, 3: 3000}  # several tiles (and JAX grid blocks) per stage
MODES = {"f32": torch.float32, "bf16": torch.bfloat16}
# Tiled against plain: float32 sums in another order; in bf16 mode that can
# flip a bf16 rounding of a conv operand (tests/test_torch_amp_resblock_bf16.py)
STREAM_TOL = {"f32": TOL, "bf16": 5e-5}
CTX = 120  # the largest halo of a stage's blocks: what a streaming stage carries
STREAM_T = 40  # new samples of a streaming step


def perturbed_generator_params(vcfg, seed=1):
    """JAX generator init with per-channel snake parameters drawn from a
    numpy seed, so every channel's alpha and beta differ."""
    tree = jax.tree.map(np.asarray, JV.init_generator_params(
        jax.random.key(seed), vcfg, weight_norm=False))
    rng = np.random.default_rng(seed)
    for block in tree["resblocks"] + [{"acts": [tree["act_post"]]}]:
        for act in block["acts"]:
            act["alpha"] = (rng.standard_normal(act["alpha"].shape) * 0.3).astype(np.float32)
            act["beta"] = (rng.standard_normal(act["beta"].shape) * 0.3).astype(np.float32)
    return tree


@pytest.fixture(scope="module")
def vcfg():
    return JCodecConfig().vocoder_config


@pytest.fixture(scope="module")
def params(vcfg):
    tree = perturbed_generator_params(vcfg)
    port = vocoder_params_from_jax(tree)
    return tree, prepare_kernel_params(port, CodecConfig().vocoder_config)


def _jax_direct(tree, vcfg, stage, x):
    num_k = len(vcfg.resblock_kernel_sizes)
    xs = None
    for j, (ksz, dils) in enumerate(zip(vcfg.resblock_kernel_sizes, vcfg.resblock_dilation_sizes)):
        out = JV._amp_block(jnp.asarray(x), tree["resblocks"][stage * num_k + j], vcfg,
                            ksz, dils, False, False, precision=HIGH)
        xs = out if xs is None else xs + out
    return np.asarray(xs / num_k)


@pytest.fixture(scope="module")
def refs(vcfg, params):
    """Per stage: input, JAX Pallas (interpret, f32) and JAX direct outputs."""
    tree = params[0]
    kb = PV.prepare_resblock_kernel_params(tree, vcfg)
    out = {}
    for stage, T in STAGE_T.items():
        C = vcfg.upsample_initial_channel // (2 ** (stage + 1))
        x = (np.random.default_rng(stage).standard_normal((2, C, T)) * 0.3).astype(np.float32)
        pallas = np.asarray(PV.resblock_stack_folded(
            jnp.asarray(x), kb, vcfg, stage, block_len=128,
            compute_dtype=jnp.float32, interpret=True))
        out[stage] = (x, pallas, _jax_direct(tree, vcfg, stage, x))
    return out


@pytest.mark.parametrize("ref", ["pallas", "direct"])
@pytest.mark.parametrize("impl", ["plain", "tiled"])
@pytest.mark.parametrize("stage", sorted(STAGE_T))
def test_stack_matches_jax(params, refs, stage, impl, ref):
    x, pallas, direct = refs[stage]
    stage_blocks = params[1][stage]
    assert x.shape[-1] > 2 * AR.tile_for(x.shape[1])  # spans several tiles
    fn = AR.amp_stack_plain if impl == "plain" else AR.amp_stack_tiled
    got = fn(torch.from_numpy(x), stage_blocks).numpy()
    np.testing.assert_allclose(got, pallas if ref == "pallas" else direct, atol=TOL)


@pytest.mark.parametrize("stage", [0, 3])
def test_start_mask_bias_only(vcfg, params, stage):
    """Zero input, large biases: everything the block outputs is bias-driven.
    A bias that leaked into the pre-history (t < 0) would change the first
    halo's worth of samples."""
    tree = jax.tree.map(np.copy, params[0])
    rng = np.random.default_rng(10 + stage)
    num_k = len(vcfg.resblock_kernel_sizes)
    for block in tree["resblocks"][stage * num_k : (stage + 1) * num_k]:
        for conv in block["convs1"] + block["convs2"]:
            conv["b"] = rng.uniform(-1, 1, conv["b"].shape).astype(np.float32)
    stage_blocks = prepare_kernel_params(vocoder_params_from_jax(tree),
                                         CodecConfig().vocoder_config)[stage]
    C = vcfg.upsample_initial_channel // (2 ** (stage + 1))
    H = max(AR.halo(rb.kernel_size, rb.dilations) for rb in stage_blocks)
    x = np.zeros((1, C, 3 * H + AR.tile_for(C)), np.float32)
    ref = _jax_direct(tree, vcfg, stage, x)
    assert np.abs(ref[..., :H]).max() > 0.1
    xt = torch.from_numpy(x)
    np.testing.assert_allclose(AR.amp_stack_plain(xt, stage_blocks).numpy(), ref, atol=TOL)
    np.testing.assert_allclose(AR.amp_stack_tiled(xt, stage_blocks).numpy(), ref, atol=TOL)


def _launches(name: str = "amp_resblock.launches") -> int:
    """A kernel's launches so far (its ``utils.tracing`` counter)."""
    return tracing.snapshot()["counters"].get(name, 0)


def test_wrapper_on_cpu_takes_plain_and_counts_nothing(params, refs):
    x, _, direct = refs[3]
    before = _launches()
    got = AR.amp_stack(torch.from_numpy(x), params[1][3]).numpy()
    assert _launches() == before
    np.testing.assert_allclose(got, direct, atol=TOL)


def test_wrapper_has_no_fallback_for_other_devices(params):
    x = torch.empty(1, 8, 64, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        AR.amp_resblock(x, params[1][3][0])


def test_halo_tile_and_shared_memory(params):
    """H = (k - 1) * (sum(d) + 3): 24, 72, 120 for k = 3, 7, 11; at every
    stage of the full config and both float32 tiles, the kernel's three
    float32 windows of C x (H + tile) fit one thread block's shared memory
    (the rest of its layout is its build's: ``test_torch_amp_resblock_f32``
    asks it on the card)."""
    assert [AR.halo(k, (1, 3, 5)) for k in (3, 7, 11)] == [24, 72, 120]
    for stage_blocks in params[1]:
        for rb in stage_blocks:
            C = rb.channels
            for tile in (AR.tile_for(C), AR.tile_for(C) // 2):
                assert 3 * 4 * C * (AR.halo(rb.kernel_size, rb.dilations) + tile) <= AR.SMEM_LIMIT


def _seeded(shape, seed):
    return torch.from_numpy((0.3 * np.random.default_rng(seed).standard_normal(shape)).astype(
        np.float32))


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("stage", [0, 3])
def test_stream_tiled_matches_plain(params, stage, mode):
    """``amp_block_tiled`` with ``ctx`` and ``start`` against
    ``amp_block_plain`` with them, at several tiles, for rows whose stream
    began at the step (0), inside the context (50) and before it (400)."""
    blocks = params[1][stage]
    C = blocks[0].channels
    x = _seeded((3, C, CTX + STREAM_T), 30 + stage)
    start = torch.tensor([0, 50, 400], dtype=torch.int32)
    ref = AR.amp_stack_plain(x, blocks, MODES[mode], ctx=CTX, start=start)
    assert ref.shape == (3, C, STREAM_T)
    for tile in (AR.MIN_TILE, 64, AR.tile_for(C, MODES[mode])):
        got = AR.amp_stack_tiled(x, blocks, MODES[mode], tile=tile, ctx=CTX, start=start)
        assert (got - ref).abs().max().item() <= STREAM_TOL[mode], tile


@pytest.mark.parametrize("impl", ["plain", "tiled"])
@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("stage", [0, 3])
def test_stream_stage_equals_oneshot_columns(params, stage, mode, impl):
    """A stage run on [context | new samples], ``start`` the samples its
    stream fed before, equals the same columns of the one-shot stage bit for
    bit; context from before the stream began (stale values here) is masked
    away."""
    blocks = params[1][stage]
    C = blocks[0].channels
    fn = AR.amp_stack_plain if impl == "plain" else AR.amp_stack_tiled
    full = _seeded((2, C, 600), 40 + stage)
    one = fn(full, blocks, MODES[mode])
    for fed in (0, 50, 300):
        window = full[..., max(fed - CTX, 0): fed + STREAM_T]
        stale = torch.full((2, C, CTX - window.shape[-1] + STREAM_T), 7.0)
        window = torch.cat([stale, window], -1)
        got = fn(window, blocks, MODES[mode], ctx=CTX, start=torch.full((2,), fed, dtype=torch.int32))
        assert torch.equal(got, one[..., fed: fed + STREAM_T]), fed


@pytest.mark.parametrize("impl", ["plain", "tiled"])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_offline_call_is_a_stream_from_its_start(params, mode, impl):
    """``ctx=0, start=None``, the offline call, equals the same stage as a
    stream from its start (any context masked away, ``start`` 0) and with
    ``start`` given as zeros, bit for bit."""
    blocks = params[1][3]
    fn = AR.amp_stack_plain if impl == "plain" else AR.amp_stack_tiled
    x = _seeded((2, 8, 300), 50)
    ref = fn(x, blocks, MODES[mode], ctx=0, start=None)
    zeros = torch.zeros(2, dtype=torch.int32)
    assert torch.equal(fn(x, blocks, MODES[mode], ctx=0, start=zeros), ref)
    window = torch.cat([torch.full((2, 8, CTX), -3.0), x], -1)
    assert torch.equal(fn(window, blocks, MODES[mode], ctx=CTX, start=zeros), ref)


@pytest.mark.gpu
@pytest.mark.parametrize("stage", [0, 1, 2, 3])
def test_kernel_matches_plain_on_card(params, stage):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    set_parity_mode()
    stage_blocks = prepare_kernel_params(to_torch(params[0], "cuda"),
                                         CodecConfig().vocoder_config)[stage]
    C = stage_blocks[0].channels
    x = torch.randn(2, C, 3 * AR.tile_for(C) + 17, generator=torch.Generator().manual_seed(0))
    x = (0.3 * x).cuda()
    before = _launches()
    got = AR.amp_stack(x, stage_blocks)
    torch.cuda.synchronize()
    assert _launches() == before + len(stage_blocks)
    ref = AR.amp_stack_plain(x, stage_blocks)
    assert (got - ref).abs().max().item() <= 1e-4


def _op_args(params, mode, B=2, T=STREAM_T, ctx=CTX, seed=50):
    """The mode's op arguments for stage 3's first block on a seeded window
    of ``ctx`` context and ``T`` new samples, with per-row starts."""
    rb = params[1][3][0]
    x = torch.from_numpy(
        (np.random.default_rng(seed).standard_normal((B, rb.channels, ctx + T)) * 0.3)
        .astype(np.float32))
    start = torch.tensor([0, 3 * ctx][:B], dtype=torch.int32)
    t = rb.op_tensors(mode)
    return (x, t["w1"], t["b1"], t["w2"], t["b2"], t["alpha"], t["inv_beta"], start,
            rb.kernel_size, list(rb.dilations), ctx, 0)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_op_fake_matches_real_output(params, mode):
    """The op's fake function gives the real output's shape and dtype, with a
    concrete and with a symbolic batch (what torch.export traces)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.fx.experimental.symbolic_shapes import ShapeEnv

    op = AR.OPS[MODES[mode]]
    args = _op_args(params, MODES[mode])
    real = op(*args)
    assert real.shape == (2, args[0].shape[1], STREAM_T) and real.dtype == torch.float32
    with FakeTensorMode(shape_env=ShapeEnv()) as fm:
        fake_args = [fm.from_tensor(a) if isinstance(a, torch.Tensor) else a for a in args]
        fake = op(*fake_args)
    assert tuple(fake.shape) == tuple(real.shape) and fake.dtype == real.dtype

    class Stage(torch.nn.Module):
        def forward(self, x, start):
            return op(x, *args[1:7], start, *args[8:])

    batch = torch.export.Dim("batch", min=1, max=64)
    ep = torch.export.export(Stage(), (args[0], args[7]),
                             dynamic_shapes=({0: batch}, {0: batch}))
    assert [n for n in ep.graph.nodes if n.op == "call_function"][0].target == op._opoverload
    x3 = torch.cat([args[0], args[0][:1]])
    start3 = torch.tensor([0, 3 * CTX, 7], dtype=torch.int32)
    assert torch.equal(ep.module()(x3, start3), op(x3, *args[1:7], start3, *args[8:]))


@pytest.mark.parametrize("mode", sorted(MODES))
def test_op_opcheck_and_plain(params, mode):
    """``torch.library.opcheck`` on the op's CPU implementation (schema,
    fake function, dispatch), which is bitwise the plain block of the raw
    params; the wrapper's CPU route is the op."""
    dtype = MODES[mode]
    args = _op_args(params, dtype)
    torch.library.opcheck(AR.OPS[dtype], args)
    rb = params[1][3][0]
    x, start = args[0], args[7]
    plain = AR.amp_block_plain(x, rb.block, rb.kernel_size, rb.dilations, dtype, CTX, start)
    assert torch.equal(AR.OPS[dtype](*args), plain)
    assert torch.equal(AR.amp_resblock(x, rb, dtype, ctx=CTX, start=start), plain)
    # the same op from its slim form (what a serving bundle's programs hold)
    slim = rb.for_mode(dtype, rb.op_tensors(dtype))
    assert slim.block is None and slim.w1 is None
    assert torch.equal(AR.amp_resblock(x, slim, dtype, ctx=CTX, start=start), plain)
