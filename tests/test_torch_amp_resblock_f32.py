"""The float32 AMP-resblock kernel's host side (bvsc_tpu_torch.ops.amp_resblock):
the packed weight layout it reads, the (C, k, d) it is compiled for, the
wrapper's refusal of any other shape, the tile it picks, and the tiled
version at the halved tile.  The kernel itself runs only on the card
(``chip_smoke.py``, and the ``gpu`` test here, which asks its build for its
shared memory); ``test_torch_amp_resblock.py`` holds the tiled version at
the full tile, which computes each conv through the packed weights, against
the JAX Pallas kernel."""

import os

import numpy as np
import pytest
import torch

from bvsc_tpu_torch.benchmarks import seeded_vocoder
from bvsc_tpu_torch.config import load_config
from bvsc_tpu_torch.convert import to_torch
from bvsc_tpu_torch.models.vocoder import prepare_kernel_params
from bvsc_tpu_torch.ops import amp_resblock as AR

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = ("varbitrate.toml", "fixed64.toml")


@pytest.fixture(scope="module")
def stages():
    vcfg = load_config(os.path.join(REPO, "configs", CONFIGS[0])).vocoder_config
    return prepare_kernel_params(to_torch(seeded_vocoder(vcfg, 0)), vcfg)


def random_block(C: int, k: int, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)

    def conv():
        return {"w": torch.from_numpy(rng.standard_normal((C, C, k)).astype(np.float32)),
                "b": torch.from_numpy(rng.standard_normal(C).astype(np.float32))}

    def act():
        return {key: torch.from_numpy(0.3 * rng.standard_normal(C).astype(np.float32))
                for key in ("alpha", "beta")}

    return {"convs1": [conv() for _ in range(3)], "convs2": [conv() for _ in range(3)],
            "acts": [act() for _ in range(6)]}


@pytest.mark.parametrize("stage", [0, 1, 2, 3])
def test_pack_f32_round_trips(stages, stage):
    """wf[j, c_in, tap, c_out] = w[j, c_out, c_in, tap], for both convs of
    every unit, and the packing inverts."""
    for rb in stages[stage]:
        for w, wf in ((rb.w1, rb.wf1), (rb.w2, rb.wf2)):
            C, k = rb.channels, rb.kernel_size
            assert wf.shape == (3, C, k, C) and wf.is_contiguous() and wf.dtype == torch.float32
            assert torch.equal(wf.permute(0, 3, 1, 2), w)
            rng = np.random.default_rng(stage)
            for j, co, ci, tap in zip(rng.integers(0, 3, 20), rng.integers(0, C, 20),
                                      rng.integers(0, C, 20), rng.integers(0, k, 20)):
                assert wf[j, ci, tap, co] == w[j, co, ci, tap]


@pytest.mark.parametrize("config", CONFIGS)
def test_f32_shapes_cover_shipped_configs(config):
    vcfg = load_config(os.path.join(REPO, "configs", config)).vocoder_config
    for i in range(len(vcfg.upsample_rates)):
        C = vcfg.upsample_initial_channel // 2 ** (i + 1)
        for k, dils in zip(vcfg.resblock_kernel_sizes, vcfg.resblock_dilation_sizes):
            for d in dils:
                assert (C, k, d) in AR.F32_SHAPES


@pytest.mark.parametrize("C, k, dils", [(24, 3, (1, 3, 5)), (16, 5, (1, 3, 5)),
                                        (16, 3, (1, 2, 5))])
def test_check_refuses_shapes_outside_f32_shapes(C, k, dils):
    rb = AR.prepare_resblock(random_block(C, k), k, dils)
    x = torch.zeros(1, C, 64)
    with pytest.raises(ValueError, match="F32_SHAPES"):
        AR._check(x, rb, torch.float32)


def test_check_takes_a_shipped_shape():
    rb = AR.prepare_resblock(random_block(16, 7), 7, (1, 3, 5))
    AR._check(torch.zeros(2, 16, 100), rb, torch.float32)


# Samples of each stage's input in a 65 536-sample call (the main path's).
STAGE_T = (2056, 16456, 32914, 65830)
H100_SMS = 132


@pytest.mark.parametrize("B, tiles, bf16_tiles", [
    (4, (64, 256, 512, 1024), (64, 256, 512, 1024)),
    (1, (64, 128, 256, 512), (32, 128, 128, 256)),
    (8, (128, 256, 512, 1024), (128, 256, 512, 1024))])
def test_tile_fills_the_card(stages, B, tiles, bf16_tiles):
    """8192 / C samples a block in both modes.  float32 halves it once where
    that grid would leave some of 132 SMs without a block: a B = 4 call
    halves at stage 0 alone (68 blocks of 128 -> 132 of 64), B = 1
    everywhere, B = 8 nowhere.  bf16 halves it while the halved grid still
    fits in one wave (132 blocks, 264 at C <= 16, where an SM holds two):
    the same at B = 4 and 8; B = 1's stage 0 down to 32 (65 blocks) and
    stages 2-3 twice (258 blocks)."""
    for stage, (T, tile, tile16) in enumerate(zip(STAGE_T, tiles, bf16_tiles)):
        C = stages[stage][0].channels
        assert AR.tile_for(C) == AR.tile_for(C, torch.bfloat16) == 8192 // C
        assert AR.tile_for(C, torch.float32, B, T, H100_SMS) == tile
        full = B * -(-T // (8192 // C))
        assert (full >= H100_SMS) == (tile == 8192 // C)
        assert AR.tile_for(C, torch.bfloat16, B, T, H100_SMS) == tile16
        blocks, wave = B * -(-T // tile16), H100_SMS * AR.BF16_BLOCKS_PER_SM[C]
        assert blocks >= wave or tile16 == AR.MIN_TILE or B * -(-T // (tile16 // 2)) > wave
        if B == 4:
            assert blocks >= H100_SMS


@pytest.mark.parametrize("stage", [0, 1, 2, 3])
def test_tiled_at_half_tile_matches_plain(stages, stage):
    """The kernel's algorithm at the halved tile, whose halo is the largest
    share of each window, against the plain stack over several tiles."""
    blocks = stages[stage]
    C = blocks[0].channels
    tile = AR.tile_for(C) // 2
    x = 0.3 * torch.randn(2, C, 3 * tile + 17, generator=torch.Generator().manual_seed(stage))
    got = AR.amp_stack_tiled(x, blocks, tile=tile)
    np.testing.assert_allclose(got.numpy(), AR.amp_stack_plain(x, blocks).numpy(), atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("stage", [0, 1, 2, 3])
def test_f32_shared_memory_fits(stage):
    """The kernel's build owns its shared-memory layout: at every stage of
    the full config and both tiles the wrapper can pick, what it reports
    fits one thread block, and grows with the tile."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    vcfg = load_config(os.path.join(REPO, "configs", CONFIGS[0])).vocoder_config
    blocks = prepare_kernel_params(to_torch(seeded_vocoder(vcfg, 0), "cuda"), vcfg)[stage]
    for rb in blocks:
        full = AR.tile_for(rb.channels)
        small, big = (AR.f32_plan(rb, t)["smem_bytes"] for t in (full // 2, full))
        assert small < big <= AR.SMEM_LIMIT
        assert AR.smem_bytes(rb) == big
