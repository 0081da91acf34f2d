"""The matrix-unit probes' plain versions (bvsc_tpu_torch.ops.dot_probe)
against the Pallas kernels of ``benchmarks/probe_roofline.py`` in interpret
mode: the chain kernel ``mk_kernel(M)`` and the gridded ``k2``.  That
script runs its benchmarks when imported, so only its imports, its
constants ``L``, ``REPS`` and ``NG``, its two kernels and ``k2``'s
BlockSpecs are compiled from its source.  The CUDA kernels themselves are
compared with the plain versions on the card (``gpu`` marker; skipped
without one)."""

import ast
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from bvsc_tpu_torch.benchmarks import probe_roofline as PR
from bvsc_tpu_torch.ops import dot_probe as DP
from bvsc_tpu_torch.utils import tracing

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROBE = os.path.join(REPO, "benchmarks", "probe_roofline.py")
N_CHAIN = 256  # columns of x in the chain tests (the probe: 1024)
GRID = 4  # grid steps of the gridded test (the probe: 64)
# The chain: each of its 64 float32 additions rounds at up to 2^-24 of
# |acc|, and XLA and torch round differently; both versions lie ~8e-7 of
# max |out| from the float64 sum, on opposite sides (measured 1.2e-6 to
# 1.5e-6 apart, relative to max |out|).
CHAIN_RTOL = 3e-6
# One product, K = 128 in float32 (measured ~1.5e-5).
GRIDDED_TOL = 1e-4
# The gridded kernel's schedule: grids of one block, a few blocks and one
# block per H100 SM; shapes that fill tiles exactly, cut them at both edges,
# cut one row and 8 columns into new tiles, and fit inside one tile.
SCHEDULE_GRIDS = (1, 7, 132)
SCHEDULE_SHAPES = ((128, 4 * 512), (200, 1000), (129, 4104), (40, 8))
TILE_M = 128  # output tile rows: one slab of w
TILE_NS = (64, 128)  # output tile columns the kernel's build may take
# The chain kernel's schedule: the probe's three shapes, and shapes that cut
# its 64-row tiles and its column tiles, by one row and 8 columns, or fit
# inside one tile; products that are and are not multiples of those in
# flight.
H100_SMS = 132
CHAIN_SHAPES = ((128, 1024), (256, 1024), (512, 1024), (40, 200), (65, 1032), (1, 8))
CHAIN_RAGGED_REPS = (1, 3, 5, 19)  # 19: a pass of the kernel's loop and 3 more


@pytest.fixture(scope="module")
def probe():
    """Namespace with the probe's imports, L/REPS/NG, mk_kernel and k2, and
    the in_specs/out_specs expressions of k2's pallas_call."""
    tree = ast.parse(open(PROBE).read(), PROBE)
    keep = []
    for node in tree.body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            keep.append(node)
        elif isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id in ("L", "REPS", "NG") for t in node.targets):
            keep.append(node)
        elif isinstance(node, ast.FunctionDef) and node.name in ("mk_kernel", "k2"):
            keep.append(node)
    ns = {}
    exec(compile(ast.Module(body=keep, type_ignores=[]), PROBE, "exec"), ns)
    call = next(n for n in ast.walk(tree) if isinstance(n, ast.Call)
                and getattr(n.func, "attr", "") == "pallas_call"
                and any(k.arg == "grid" for k in n.keywords))
    specs = {k.arg: k.value for k in call.keywords if k.arg in ("in_specs", "out_specs")}
    ns["specs"] = {name: eval(compile(ast.Expression(expr), PROBE, "eval"), ns)
                   for name, expr in specs.items()}
    return ns


def _bf16(rng, shape):
    """(torch bf16, the same values as a jax bf16 array)."""
    t = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(torch.bfloat16)
    return t, jnp.asarray(t.float().numpy(), jnp.bfloat16)


def test_probe_constants(probe):
    assert (probe["L"], probe["REPS"], probe["NG"]) == (PR.L, DP.REPS, PR.NG)


@pytest.mark.parametrize("M", [16, 48])
def test_dot_chain_plain_matches_pallas(probe, M):
    rng = np.random.default_rng(M)
    (w, wj), (x, xj) = _bf16(rng, (M, DP.K)), _bf16(rng, (DP.K, N_CHAIN))
    ref = np.asarray(pl.pallas_call(
        probe["mk_kernel"](M), out_shape=jax.ShapeDtypeStruct((M, N_CHAIN), jnp.float32),
        interpret=True)(wj, xj))
    got = DP.dot_chain_plain(w, x).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=CHAIN_RTOL * np.abs(ref).max())


@pytest.mark.parametrize("M", [16, 48])
def test_dot_chain_tiled_matches_pallas(probe, M):
    rng = np.random.default_rng(M)
    (w, wj), (x, xj) = _bf16(rng, (M, DP.K)), _bf16(rng, (DP.K, N_CHAIN))
    ref = np.asarray(pl.pallas_call(
        probe["mk_kernel"](M), out_shape=jax.ShapeDtypeStruct((M, N_CHAIN), jnp.float32),
        interpret=True)(wj, xj))
    got = DP.dot_chain_tiled(w, x, DP.chain_plan(M, N_CHAIN, H100_SMS)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=CHAIN_RTOL * np.abs(ref).max())


@pytest.mark.parametrize("tile_n", DP.CHAIN_TILE_NS)
@pytest.mark.parametrize("M", [16, 48])
def test_dot_chain_tiled_matches_plain(M, tile_n):
    rng = np.random.default_rng(M + tile_n)
    (w, _), (x, _) = _bf16(rng, (M, DP.K)), _bf16(rng, (DP.K, N_CHAIN))
    plan = {**DP.chain_plan(M, N_CHAIN, H100_SMS), "tile_n": tile_n}
    plan["grid"] = -(-M // plan["tile_m"]) * -(-N_CHAIN // tile_n)
    ref = DP.dot_chain_plain(w, x)
    got = DP.dot_chain_tiled(w, x, plan)
    assert (got - ref).abs().max().item() <= CHAIN_RTOL * ref.abs().max().item()


@pytest.mark.parametrize("M,N", CHAIN_SHAPES)
def test_dot_chain_tiled_writes_every_element_once(M, N):
    rng = np.random.default_rng(M + N)
    (w, _), (x, _) = _bf16(rng, (M, DP.K)), _bf16(rng, (DP.K, N))
    writes = torch.zeros(M, N, dtype=torch.int32)
    out = DP.dot_chain_tiled(w, x, DP.chain_plan(M, N, H100_SMS), reps=2, writes=writes)
    assert torch.equal(writes, torch.ones_like(writes))
    assert not out.isnan().any()


@pytest.mark.parametrize("reps", CHAIN_RAGGED_REPS)
@pytest.mark.parametrize("M,N", [(40, 200), (65, 1032), (1, 8)])
def test_dot_chain_tiled_products_not_a_multiple_in_flight(M, N, reps):
    plan = DP.chain_plan(M, N, H100_SMS)
    assert reps % plan["in_flight"]
    rng = np.random.default_rng(reps)
    (w, _), (x, _) = _bf16(rng, (M, DP.K)), _bf16(rng, (DP.K, N))
    ref = DP.dot_chain_plain(w, x, reps)
    got = DP.dot_chain_tiled(w, x, plan, reps)
    assert (got - ref).abs().max().item() <= CHAIN_RTOL * ref.abs().max().item()


@pytest.mark.parametrize("M", [128, 256, 512])
def test_chain_plan_fills_the_card(M):
    """128 blocks of 64 x (16 M / 128), one on each of 128 of 132 SMs."""
    plan = DP.chain_plan(M, 1024, H100_SMS)
    assert plan["tile_n"] == 16 * M // 128 and plan["tile_m"] == 64
    assert 128 <= plan["grid"] <= H100_SMS
    assert plan["smem_bytes"] == plan["tile_n"] * DP.K * 2


@pytest.mark.parametrize("M,N", [(0, 1024), (128, 0), (128, 12), (-1, 8)])
def test_chain_plan_refuses_what_the_kernel_refuses(M, N):
    with pytest.raises(ValueError, match="N % 8"):
        DP.chain_plan(M, N, H100_SMS)


def test_gridded_dot_plain_matches_pallas(probe):
    rng = np.random.default_rng(7)
    N = GRID * PR.TILE_N
    (w, wj), (x, xj) = _bf16(rng, (128, DP.K)), _bf16(rng, (DP.K, N))
    ref = np.asarray(pl.pallas_call(
        probe["k2"], grid=(GRID,), **probe["specs"],
        out_shape=jax.ShapeDtypeStruct((128, N), jnp.float32), interpret=True)(wj, xj))
    got = DP.gridded_dot_plain(w, x).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=GRIDDED_TOL)


@pytest.mark.parametrize("tile_n", TILE_NS)
@pytest.mark.parametrize("M,N", SCHEDULE_SHAPES)
def test_gridded_tiled_writes_every_element_once(M, N, tile_n):
    rng = np.random.default_rng(M + N)
    (w, _), (x, _) = _bf16(rng, (M, DP.K)), _bf16(rng, (DP.K, N))
    writes = torch.zeros(M, N, dtype=torch.int32)
    out = DP.gridded_dot_tiled(w, x, {"tile_m": TILE_M, "tile_n": tile_n, "grid": 7}, writes)
    assert torch.equal(writes, torch.ones_like(writes))
    assert not out.isnan().any()


@pytest.mark.parametrize("tile_n", TILE_NS)
@pytest.mark.parametrize("M,N", SCHEDULE_SHAPES)
@pytest.mark.parametrize("grid", SCHEDULE_GRIDS)
def test_gridded_tiled_matches_plain(M, N, grid, tile_n):
    rng = np.random.default_rng(grid * 1000 + M)
    (w, _), (x, _) = _bf16(rng, (M, DP.K)), _bf16(rng, (DP.K, N))
    got = DP.gridded_dot_tiled(w, x, {"tile_m": TILE_M, "tile_n": tile_n, "grid": grid})
    assert (got - DP.gridded_dot_plain(w, x)).abs().max().item() <= GRIDDED_TOL


@pytest.mark.parametrize("tile_n", TILE_NS)
def test_gridded_tiled_matches_pallas(probe, tile_n):
    rng = np.random.default_rng(7)
    N = GRID * PR.TILE_N
    (w, wj), (x, xj) = _bf16(rng, (128, DP.K)), _bf16(rng, (DP.K, N))
    ref = np.asarray(pl.pallas_call(
        probe["k2"], grid=(GRID,), **probe["specs"],
        out_shape=jax.ShapeDtypeStruct((128, N), jnp.float32), interpret=True)(wj, xj))
    got = DP.gridded_dot_tiled(w, x, {"tile_m": TILE_M, "tile_n": tile_n, "grid": 3}).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=GRIDDED_TOL)


def test_wrappers_on_cpu_take_plain_and_count_nothing():
    rng = np.random.default_rng(3)
    (w, _), (x, _) = _bf16(rng, (32, DP.K)), _bf16(rng, (DP.K, 64))
    def launches():
        counters = tracing.snapshot()["counters"]
        return [counters.get(f"{name}.launches", 0) for name in ("dot_chain", "gridded_dot")]

    before = launches()
    assert torch.equal(DP.dot_chain(w, x), DP.dot_chain_plain(w, x))
    assert torch.equal(DP.gridded_dot(w, x), DP.gridded_dot_plain(w, x))
    assert launches() == before


def test_wrappers_have_no_fallback_for_other_devices():
    w = torch.empty(16, DP.K, dtype=torch.bfloat16, device="meta")
    x = torch.empty(DP.K, 64, dtype=torch.bfloat16, device="meta")
    for fn in (DP.dot_chain, DP.gridded_dot):
        with pytest.raises(ValueError, match="cuda or cpu"):
            fn(w, x)


def test_bounds_of_the_probe_shapes():
    """Least times on an H100 (989 TFLOP/s bf16, 3.35 TB/s): the chain is
    bound by operations, the gridded product by its bytes."""
    assert [round(PR.chain_flops(M) / 989e12 * 1e6, 1) for M in PR.CHAIN_M] == [2.2, 4.3, 8.7]
    n = PR.NG * PR.TILE_N
    nbytes = 2 * 128 * DP.K + 2 * DP.K * n + 4 * 128 * n
    assert round(nbytes / 1e6, 1) == 25.2 and round(PR.gridded_flops() / 1e9, 2) == 1.07
    assert nbytes / 3.35e12 > PR.gridded_flops() / 989e12


def _on_card(M, N, seed=0):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(seed)
    return _bf16(rng, (M, DP.K))[0].cuda(), _bf16(rng, (DP.K, N))[0].cuda()


@pytest.mark.gpu
@pytest.mark.parametrize("reps", [*CHAIN_RAGGED_REPS, DP.REPS])
@pytest.mark.parametrize("M,N", CHAIN_SHAPES)
def test_dot_chain_on_card(M, N, reps):
    w, x = _on_card(M, N)
    got = DP.dot_chain(w, x, reps)
    ref = DP.dot_chain_plain(w, x, reps)
    assert (got - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert DP.dot_chain_plan(M, N) == DP.chain_plan(M, N, sms)


@pytest.mark.gpu
@pytest.mark.parametrize("M,N", [(128, 32768), *SCHEDULE_SHAPES])
def test_gridded_dot_on_card(M, N):
    w, x = _on_card(M, N)
    got = DP.gridded_dot(w, x)
    assert (got - DP.gridded_dot_plain(w, x)).abs().max().item() <= GRIDDED_TOL
    # One block on each SM, or one on each tile where there are fewer.
    plan = DP.gridded_plan(M, N)
    assert plan["tile_m"] == TILE_M and plan["tile_n"] in TILE_NS
    tiles = -(-M // TILE_M) * -(-N // plan["tile_n"])
    assert plan["grid"] == min(tiles, torch.cuda.get_device_properties(0).multi_processor_count)
