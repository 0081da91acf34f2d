"""The AMP-resblock kernels with bf16 activations in and out (the bf16
storage dtype: bvsc_tpu_torch.ops.amp_resblock on a bf16 ``x``), in both
modes: their plain and tiled versions against the JAX Pallas kernel on a
bf16 input (``resblock_stack_folded(x_bf16, ..., interpret=True)``, whose
``out_dtype`` is the input's), at stages 0 and 3 at full channel width;
the widen-compute-round-once rule; the stage average's bf16 order; the ops'
types; and, on a card (``gpu`` marker; skipped without one), each kernel
against its plain version.

Tolerance: one bf16 ulp of the stage's largest output (``ulp``: 2 **
(floor(log2 |v|) - 7)), the same gate as on the card.  A bf16 output is the
float32 result rounded once, and the float32 results of two implementations
differ by their sums' order (in bf16 mode also where a conv's operand
rounds the other way: ~4e-5 at these sizes with float32 I/O,
``tests/test_torch_amp_resblock_bf16.py``), so a sample near a rounding
boundary moves by one ulp of itself, and the bf16 stage average can carry
that into its sums; measured on the CPU: at most one ulp of the largest
output at stage 0 (bf16 mode, ~1 % of the samples differ), 0 at stage 3.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from bvsc_tpu.config import CodecConfig as JCodecConfig
from bvsc_tpu.ops import pallas_voc as PV
from bvsc_tpu_torch.config import CodecConfig
from bvsc_tpu_torch.convert import to_torch, vocoder_params_from_jax
from bvsc_tpu_torch.models.vocoder import prepare_kernel_params
from bvsc_tpu_torch.ops import amp_resblock as AR
from test_torch_amp_resblock import perturbed_generator_params

torch.set_num_threads(1)

BF16 = torch.bfloat16
STAGE_T = {0: 300, 3: 2100}  # several tiles of either mode
MODES = {"f32": (torch.float32, jnp.float32), "bf16": (BF16, jnp.bfloat16)}


def ulp(v: np.ndarray) -> np.ndarray:
    """One bf16 ulp at each value's magnitude (zero counts as the least
    normal's)."""
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(v), 2.0 ** -126))) - 7)


def bf16_values(x: np.ndarray) -> np.ndarray:
    return torch.from_numpy(x).to(BF16).float().numpy()


@pytest.fixture(scope="module")
def vcfg():
    return JCodecConfig().vocoder_config


@pytest.fixture(scope="module")
def params(vcfg):
    """The JAX tree rounded to bf16 (as the bf16 storage dtype stores it),
    and the port's blocks packed from the port's bf16 tree."""
    tree = perturbed_generator_params(vcfg)
    jax_tree = {"resblocks": [
        {k: [{n: bf16_values(v) for n, v in d.items()} for d in b[k]] for k in b}
        for b in tree["resblocks"]]}
    port = vocoder_params_from_jax(tree, BF16)
    return jax_tree, prepare_kernel_params(port, CodecConfig().vocoder_config)


@pytest.fixture(scope="module")
def refs(vcfg, params):
    """Per (stage, mode): the bf16 input and the JAX kernel's bf16 output
    on it, as float32 values."""
    out = {}
    kb = PV.prepare_resblock_kernel_params(params[0], vcfg)
    for stage, T in STAGE_T.items():
        C = vcfg.upsample_initial_channel // (2 ** (stage + 1))
        x = bf16_values((np.random.default_rng(stage).standard_normal((2, C, T)) * 0.5)
                        .astype(np.float32))
        for mode, (_, jdtype) in MODES.items():
            y = PV.resblock_stack_folded(jnp.asarray(x, jnp.bfloat16), kb, vcfg, stage,
                                         block_len=128, compute_dtype=jdtype, interpret=True)
            assert y.dtype == jnp.bfloat16
            out[stage, mode] = (x, np.asarray(y.astype(jnp.float32)))
    return out


@pytest.mark.parametrize("impl", ["plain", "tiled"])
@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("stage", sorted(STAGE_T))
def test_bf16io_stack_matches_jax_kernel(params, refs, stage, mode, impl):
    x, ref = refs[stage, mode]
    compute = MODES[mode][0]
    assert x.shape[-1] > 2 * AR.tile_for(x.shape[1], compute)  # spans several tiles
    fn = AR.amp_stack_plain if impl == "plain" else AR.amp_stack_tiled
    got = fn(torch.from_numpy(x).to(BF16), params[1][stage], compute)
    assert got.dtype == BF16 and got.shape == x.shape
    gap = np.abs(got.float().numpy() - ref)
    scale = ulp(np.abs(ref).max())
    print(f"stage {stage} {mode} {impl}: max {gap.max():.3g} against one ulp of the largest "
          f"output, {scale:.3g}; {(gap > 0).mean():.2%} of samples differ")
    assert gap.max() <= scale


@pytest.mark.parametrize("mode", sorted(MODES))
def test_bf16io_is_widen_compute_round_once(params, mode):
    """Each form on a bf16 input is its float32 form on the widened input,
    rounded once to bf16: bitwise."""
    compute = MODES[mode][0]
    rb = params[1][3][2]
    x = torch.randn(2, rb.channels, 500, generator=torch.Generator().manual_seed(3)).to(BF16)
    for got, wide in (
            (AR.amp_block_plain(x, rb.block, rb.kernel_size, rb.dilations, compute),
             AR.amp_block_plain(x.float(), rb.block, rb.kernel_size, rb.dilations, compute)),
            (AR.amp_block_tiled(x, rb, compute), AR.amp_block_tiled(x.float(), rb, compute)),
            (AR.amp_resblock(x, rb, compute), AR.amp_resblock(x.float(), rb, compute))):
        assert got.dtype == BF16
        torch.testing.assert_close(got, wide.to(BF16), rtol=0, atol=0)


def test_bf16io_stage_average_in_bf16_order(params):
    """A bf16 stage averages as the reference does: (o0 + o1) + o2, then
    / 3, each rounded to bf16 (not one rounding of the float32 mean)."""
    blocks = params[1][3]
    x = torch.randn(1, blocks[0].channels, 400, generator=torch.Generator().manual_seed(4))
    x = x.to(BF16)
    outs = [AR.amp_block_plain(x, rb.block, rb.kernel_size, rb.dilations) for rb in blocks]
    r = lambda v: v.to(BF16).float()  # noqa: E731
    want = r(r(r(outs[0].float() + outs[1].float()) + outs[2].float()) / 3)
    got = AR.amp_stack_plain(x, blocks)
    torch.testing.assert_close(got.float(), want, rtol=0, atol=0)
    once = r(sum(o.float() for o in outs) / 3)
    assert not torch.equal(got.float(), once)  # the order is visible at this size


def test_bf16io_op_and_checks(params):
    """The custom ops keep a bf16 input's type (CPU implementation and fake
    function); the argument check takes bf16 and float32 and refuses
    others; the launch counters name each (mode, activation type)."""
    rb = params[1][0][0]
    x = torch.randn(1, rb.channels, 64, generator=torch.Generator().manual_seed(5)).to(BF16)
    for compute in (torch.float32, BF16):
        t = rb.op_tensors(compute)
        args = (x, t["w1"], t["b1"], t["w2"], t["b2"], t["alpha"], t["inv_beta"], None,
                rb.kernel_size, list(rb.dilations), 0, 0)
        assert AR.OPS[compute](*args).dtype == BF16
        with torch._subclasses.fake_tensor.FakeTensorMode() as mode:
            fake = AR.OPS[compute](*(mode.from_tensor(a) if isinstance(a, torch.Tensor) else a
                                     for a in args))
        assert fake.dtype == BF16 and tuple(fake.shape) == tuple(x.shape)
        AR._check(x, rb, compute)
        with pytest.raises(ValueError, match="float32 or bf16"):
            AR._check(x.half(), rb, compute)
    assert AR.COUNTERS == ("launches", "launches_bf16", "launches_io_bf16",
                           "launches_bf16_io_bf16")
    AR.reset_launches()
    assert set(AR.read_launches().values()) == {0}


@pytest.mark.gpu
@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("stage", [0, 1, 2, 3])
def test_bf16io_kernel_matches_plain_on_card(params, stage, mode):
    """Each kernel reads and writes bf16 itself (one launch a block, counted
    under its own counter) and stays within one bf16 ulp of the plain
    version's largest output."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    compute = MODES[mode][0]
    tree = vocoder_params_from_jax(perturbed_generator_params(JCodecConfig().vocoder_config), BF16)
    blocks = prepare_kernel_params(to_torch(tree, "cuda", dtype=BF16),
                                   CodecConfig().vocoder_config)[stage]
    C = blocks[0].channels
    x = torch.randn(2, C, 3 * AR.tile_for(C, compute) + 17,
                    generator=torch.Generator().manual_seed(0)).to(BF16).cuda()
    AR.reset_launches()
    got = AR.amp_stack(x, blocks, compute)
    torch.cuda.synchronize()
    counter = "launches_io_bf16" if mode == "f32" else "launches_bf16_io_bf16"
    assert AR.read_launches()[counter] == len(blocks)
    ref = AR.amp_stack_plain(x, blocks, compute)
    assert got.dtype == BF16
    scale = ulp(np.array([ref.float().abs().max().item()]))[0]
    assert (got.float() - ref.float()).abs().max().item() <= scale
