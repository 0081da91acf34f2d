"""The AMP-resblock kernel's bf16 mode (bvsc_tpu_torch.ops.amp_resblock with
compute_dtype=bfloat16): its plain and tiled versions against the JAX
Pallas kernel in its own bf16 mode (``resblock_stack_folded(...,
compute_dtype=bfloat16, interpret=True)``), at stages 0 and 3 at full
channel width with T over several of the bf16 kernel's tiles; the start
mask; the packed GEMM weights; and the wrapper's dispatch on dtype and
device.  The CUDA kernel itself is compared with the plain version on the
card (``gpu`` marker; skipped without one)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from bvsc_tpu.config import CodecConfig as JCodecConfig
from bvsc_tpu.ops import pallas_voc as PV
from bvsc_tpu_torch.config import CodecConfig
from bvsc_tpu_torch.convert import to_torch, vocoder_params_from_jax
from bvsc_tpu_torch.models.vocoder import prepare_kernel_params
from bvsc_tpu_torch.ops import amp_resblock as AR
from bvsc_tpu_torch.utils import tracing
from test_torch_amp_resblock import perturbed_generator_params
from test_torch_amp_resblock_f32 import random_block

torch.set_num_threads(1)

BF16 = torch.bfloat16
# Port against the JAX kernel, both in bf16 mode.  The bf16 products are
# exact in float32, so only the order of the float32 sums differs (~1e-7
# relative); where a conv output lies that close to a bf16 rounding
# boundary, the next conv's operand rounds the other way in one of the two,
# which moves the outputs near it by ~1e-5.  Measured: 3.3e-5 (plain) and
# 3.8e-5 (tiled) at stage 0, T = 700, against a 2.7e-4 gap between the JAX
# kernel's bf16 and float32 modes.  Each stage's error must also stay under
# a quarter of that stage's measured bf16-float32 gap, so the test tells a
# port that rounds where JAX rounds from one that is merely near float32.
TOL = 5e-5
GAP_SHARE = 0.25
STAGE_T = {0: 700, 3: 5000}  # several full bf16 tiles each (128 and 1024 samples)
# At the shortest tile the wrapper can pick (AR.MIN_TILE), every stage:
# seven tiles, each window mostly halo (up to 120 samples at k = 11).
SHORT_T = 7 * 32 - 5


@pytest.fixture(scope="module")
def vcfg():
    return JCodecConfig().vocoder_config


@pytest.fixture(scope="module")
def params(vcfg):
    tree = perturbed_generator_params(vcfg)
    return tree, prepare_kernel_params(vocoder_params_from_jax(tree), CodecConfig().vocoder_config)


def _pallas(tree, vcfg, stage, x, compute_dtype):
    kb = PV.prepare_resblock_kernel_params(tree, vcfg)
    return np.asarray(PV.resblock_stack_folded(
        jnp.asarray(x), kb, vcfg, stage, block_len=128, compute_dtype=compute_dtype,
        interpret=True))


@pytest.fixture(scope="module")
def refs(vcfg, params):
    """Per stage: input, the JAX Pallas kernel in bf16 mode, and the gap
    between its bf16 and float32 modes."""
    out = {}
    for stage, T in STAGE_T.items():
        C = vcfg.upsample_initial_channel // (2 ** (stage + 1))
        x = (np.random.default_rng(stage).standard_normal((2, C, T)) * 0.3).astype(np.float32)
        bf16 = _pallas(params[0], vcfg, stage, x, jnp.bfloat16)
        f32 = _pallas(params[0], vcfg, stage, x, jnp.float32)
        out[stage] = (x, bf16, np.abs(bf16 - f32).max())
    return out


@pytest.mark.parametrize("impl", ["plain", "tiled"])
@pytest.mark.parametrize("stage", sorted(STAGE_T))
def test_bf16_stack_matches_jax_kernel(params, refs, stage, impl):
    x, ref, gap = refs[stage]
    assert x.shape[-1] > 2 * AR.tile_for(x.shape[1], BF16)  # spans several tiles
    fn = AR.amp_stack_plain if impl == "plain" else AR.amp_stack_tiled
    got = fn(torch.from_numpy(x), params[1][stage], BF16).numpy()
    err = np.abs(got - ref).max()
    assert err <= TOL, err
    assert err <= GAP_SHARE * gap, (err, gap)


@pytest.mark.parametrize("stage", [0, 3])
def test_bf16_start_mask_bias_only(vcfg, params, stage):
    """Zero input, large biases: everything the block outputs is
    bias-driven, and a bias that leaked into the pre-history (t < 0) would
    change the first halo's worth of samples."""
    tree = jax.tree.map(np.copy, params[0])
    rng = np.random.default_rng(20 + stage)
    num_k = len(vcfg.resblock_kernel_sizes)
    for block in tree["resblocks"][stage * num_k : (stage + 1) * num_k]:
        for conv in block["convs1"] + block["convs2"]:
            conv["b"] = rng.uniform(-1, 1, conv["b"].shape).astype(np.float32)
    blocks = prepare_kernel_params(vocoder_params_from_jax(tree), CodecConfig().vocoder_config)[stage]
    C = blocks[0].channels
    H = max(AR.halo(rb.kernel_size, rb.dilations) for rb in blocks)
    x = np.zeros((1, C, 3 * H + AR.tile_for(C, BF16)), np.float32)
    ref = _pallas(tree, vcfg, stage, x, jnp.bfloat16)
    assert np.abs(ref[..., :H]).max() > 0.1
    xt = torch.from_numpy(x)
    np.testing.assert_allclose(AR.amp_stack_plain(xt, blocks, BF16).numpy(), ref, atol=TOL)
    np.testing.assert_allclose(AR.amp_stack_tiled(xt, blocks, BF16).numpy(), ref, atol=TOL)
    np.testing.assert_allclose(AR.amp_stack_tiled(xt, blocks, BF16, tile=AR.MIN_TILE).numpy(),
                               ref, atol=TOL)


def test_packed_weights_layout(params):
    """Row co, column tap * C + ci of the packed weights is
    bf16(w[co, ci, tap]); the columns past C * k are 0 (K padded to 16)."""
    for stage_blocks in params[1]:
        for rb in stage_blocks:
            C, k = rb.channels, rb.kernel_size
            for w, wk in ((rb.w1, rb.wk1), (rb.w2, rb.wk2)):
                assert wk.dtype == BF16 and wk.shape == (3, C, -(-C * k // 16) * 16)
                ref = w.permute(0, 1, 3, 2).reshape(3, C, k * C).to(BF16)
                assert torch.equal(wk[..., : k * C], ref)
                assert not wk[..., k * C :].any()


def test_wrapper_dispatch_on_cpu(params, refs):
    """A CPU tensor takes the plain version of the mode asked for and
    counts no launch; the modes give different results; other dtypes and
    devices raise."""
    x, _, _ = refs[3]
    xt = torch.from_numpy(x)
    stage = params[1][3]
    before = tracing.snapshot()["counters"]
    got = AR.amp_stack(xt, stage, BF16)
    assert all(tracing.snapshot()["counters"].get(name, 0) == before.get(name, 0)
               for name in ("amp_resblock.launches", "amp_resblock.launches_bf16"))
    assert torch.equal(got, AR.amp_stack_plain(xt, stage, BF16))
    assert not torch.equal(got, AR.amp_stack(xt, stage))
    with pytest.raises(ValueError, match="compute_dtype"):
        AR.amp_resblock(xt, stage[0], torch.float16)
    with pytest.raises(ValueError, match="cuda or cpu"):
        AR.amp_resblock(torch.empty(1, 8, 64, device="meta"), stage[0], BF16)


def test_bf16_tile_and_shared_memory(params):
    """Every stage of the full config takes the bf16 kernel, at tiles that
    are multiples of 16 (the kernel's m16 tiles; it refuses others): the
    full tile and whatever the rule picks for 1-64 rows on 132 SMs, never
    below MIN_TILE.  The shared memory those tiles take is the kernel
    build's to report (``test_bf16_shared_memory_fits``, on the card)."""
    for stage_blocks in params[1]:
        for rb in stage_blocks:
            C = rb.channels
            assert {(C, rb.kernel_size, d) for d in rb.dilations} <= set(AR.BF16_SHAPES)
            tiles = {AR.tile_for(C, BF16, B, T, 132) for B in (1, 2, 4, 8, 64)
                     for T in (100, 2056, 16456, 32914, 65830)}
            assert AR.tile_for(C, BF16) in tiles
            assert all(t % 16 == 0 and AR.MIN_TILE <= t <= AR.tile_for(C, BF16) for t in tiles)


@pytest.mark.parametrize("C, k, dils", [(24, 3, (1, 3, 5)), (16, 5, (1, 3, 5)),
                                        (16, 3, (1, 2, 5))])
def test_check_refuses_shapes_outside_bf16_shapes(C, k, dils):
    rb = AR.prepare_resblock(random_block(C, k), k, dils)
    with pytest.raises(ValueError, match="BF16_SHAPES"):
        AR._check(torch.zeros(1, C, 64), rb, BF16)


def test_check_refuses_bf16_tile_off_the_m16_grid():
    rb = AR.prepare_resblock(random_block(16, 7), 7, (1, 3, 5))
    AR._check(torch.zeros(2, 16, 100), rb, BF16)
    with pytest.raises(ValueError, match="multiple of 16"):
        AR._check(torch.zeros(2, 16, 100), rb, BF16, tile=40)


@pytest.mark.parametrize("stage", [0, 1, 2, 3])
def test_bf16_tiled_at_short_tile_matches_jax(vcfg, params, stage):
    """The bf16 kernel's algorithm at the shortest tile the wrapper can
    pick, whose windows are mostly recomputed halo, against the JAX kernel
    in its bf16 mode."""
    C = vcfg.upsample_initial_channel // (2 ** (stage + 1))
    x = (np.random.default_rng(40 + stage).standard_normal((2, C, SHORT_T)) * 0.3).astype(np.float32)
    ref = _pallas(params[0], vcfg, stage, x, jnp.bfloat16)
    got = AR.amp_stack_tiled(torch.from_numpy(x), params[1][stage], BF16, tile=AR.MIN_TILE).numpy()
    assert np.abs(got - ref).max() <= TOL


@pytest.mark.gpu
@pytest.mark.parametrize("stage", [0, 1, 2, 3])
def test_bf16_shared_memory_fits(params, stage):
    """The bf16 kernel's build owns its shared-memory layout: at every stage
    of the full config, at the full tile and the shortest, what it reports
    fits one thread block, and grows with the tile; an SM holds at least as
    many blocks at the full tile as ``tile_for`` counts on."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    for rb in params[1][stage]:
        full = AR.tile_for(rb.channels, BF16)
        small, big = (AR.bf16_plan(rb, t)["smem_bytes"] for t in (AR.MIN_TILE, full))
        assert small < big <= AR.SMEM_LIMIT
        assert AR.smem_bytes(rb, BF16) == big
        assert AR.bf16_plan(rb)["blocks_per_sm"] >= AR.BF16_BLOCKS_PER_SM[rb.channels]


@pytest.mark.gpu
@pytest.mark.parametrize("stage", [0, 1, 2, 3])
def test_bf16_kernel_matches_plain_on_card(params, stage):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    blocks = prepare_kernel_params(to_torch(params[0], "cuda"),
                                   CodecConfig().vocoder_config)[stage]
    C = blocks[0].channels
    x = torch.randn(2, C, 3 * AR.tile_for(C, BF16) + 17, generator=torch.Generator().manual_seed(0))
    x = (0.3 * x).cuda()
    before = AR.amp_resblock.launches_bf16
    got = AR.amp_stack(x, blocks, BF16)
    torch.cuda.synchronize()
    assert AR.amp_resblock.launches_bf16 == before + len(blocks)
    ref = AR.amp_stack_plain(x, blocks, BF16)
    assert (got - ref).abs().max().item() <= 1e-3
