"""The persistent-GRU kernel's plain and tiled versions
(bvsc_tpu_torch.ops.persistent_gru) against the JAX probe
``benchmarks/probe_persistent_gru.py``: its Pallas kernel
``persistent_kernel`` in interpret mode, bf16 and int8 (``dequant``), and
its XLA scans A-C, at H = 64 and T = 16 (the probe's module globals, which
its functions read at trace time).  The CUDA kernel itself is compared with
the plain version on the card (``gpu`` marker; skipped without one)."""

import functools
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from bvsc_tpu_torch.ops import persistent_gru as PG
from bvsc_tpu_torch.utils import tracing

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROBE = os.path.join(REPO, "benchmarks", "probe_persistent_gru.py")
H, T = 64, 16
STEPS = (1, T)
# One step from the same bf16 or int8 operands: products are exact in
# float32 in both versions, only the summation order differs (measured
# 2.4e-7 bf16, 2.0e-6 int8, whose unscaled gate sums reach several hundred).
TOL = 1e-5
# Over T steps a 1-ulp gap in a float32 gate sum can flip one bf16 rounding
# of h (a step of 2^-8 |h|, up to ~4e-3 here), which the next steps carry
# through weights of ~0.1 (measured at T = 16: 2.8e-4 bf16, 1.2e-7 int8).
TOL_FEEDBACK = 2e-3


def tol(steps):
    return TOL if steps == 1 else TOL_FEEDBACK


@pytest.fixture(scope="module")
def probe():
    """The JAX probe, imported from its file with H and T cut to size.  Its
    import sets jax's compilation cache directory, which is restored."""
    old = jax.config.jax_compilation_cache_dir
    spec = importlib.util.spec_from_file_location("jax_probe_persistent_gru", PROBE)
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        jax.config.update("jax_compilation_cache_dir", old)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mod, "H", H)
        mp.setattr(mod, "T", T)
        yield mod


@pytest.fixture(scope="module")
def inputs():
    """float32 weights and state from a numpy seed, at the probe's layout."""
    rng = np.random.default_rng(5)
    return {
        "w_ih": (rng.standard_normal((2 * H, 3 * H)) * 0.1).astype(np.float32),
        "w_hh": (rng.standard_normal((H, 3 * H)) * 0.1).astype(np.float32),
        "b_ih": (rng.standard_normal((1, 3 * H)) * 0.05).astype(np.float32),
        "b_hh": (rng.standard_normal((1, 3 * H)) * 0.05).astype(np.float32),
        "xc": (rng.standard_normal((PG.LANES, H)) * 0.5).astype(np.float32),
        "h0": rng.standard_normal((PG.LANES, H)).astype(np.float32),
    }


def _weights(inputs, dequant):
    """(numpy weights for JAX, torch weights for the port): bf16, or the
    probe's int8 quantisation without its scale."""
    if dequant:
        wi, wh = PG.quantize(inputs["w_ih"])[0], PG.quantize(inputs["w_hh"])[0]
        return (wi.numpy(), wh.numpy()), (wi, wh)
    wi = torch.from_numpy(inputs["w_ih"]).to(torch.bfloat16)
    wh = torch.from_numpy(inputs["w_hh"]).to(torch.bfloat16)
    return (jnp.asarray(wi.float().numpy(), jnp.bfloat16),
            jnp.asarray(wh.float().numpy(), jnp.bfloat16)), (wi, wh)


def _rest(inputs):
    return [torch.from_numpy(inputs[k]) for k in ("b_ih", "b_hh", "xc", "h0")]


@pytest.fixture(scope="module")
def pallas_out(probe, inputs):
    """The Pallas kernel in interpret mode, for each (dequant, steps)."""
    out = {}
    for dequant in (False, True):
        (wi, wh), _ = _weights(inputs, dequant)
        for steps in STEPS:
            # a new partial for each T: jax caches the trace by function
            kern = functools.partial(probe.persistent_kernel, dequant=dequant)
            call = pl.pallas_call(kern, out_shape=jax.ShapeDtypeStruct((probe.LANES, H), jnp.float32),
                                  interpret=True)
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(probe, "T", steps)
                out[dequant, steps] = np.asarray(
                    call(wi, wh, *(inputs[k] for k in ("b_ih", "b_hh", "xc", "h0"))))
    return out


@pytest.mark.parametrize("steps", STEPS)
@pytest.mark.parametrize("dequant", [False, True], ids=["bf16", "int8"])
def test_plain_matches_pallas(inputs, pallas_out, dequant, steps):
    _, (wi, wh) = _weights(inputs, dequant)
    got = PG.persistent_gru_plain(wi, wh, *_rest(inputs), steps, dequant=dequant).numpy()
    np.testing.assert_allclose(got, pallas_out[dequant, steps], rtol=0, atol=tol(steps))


@pytest.mark.parametrize("n_sm", [132, 12, 8], ids=["U1", "U6-ragged", "U8"])
@pytest.mark.parametrize("steps", STEPS)
@pytest.mark.parametrize("dequant", [False, True], ids=["bf16", "int8"])
def test_partitioned_matches_pallas(inputs, pallas_out, dequant, steps, n_sm):
    """The kernel's column gather and tiles (:func:`persistent_gru_tiled`),
    for the plans of cards with n_sm SMs."""
    kp = PG.plan(H, n_sm, dequant)
    assert kp.blocks <= n_sm and kp.units <= PG.MAX_UNITS
    _, (wi, wh) = _weights(inputs, dequant)
    got = PG.persistent_gru_tiled(wi, wh, *_rest(inputs), steps, kp.units,
                                  dequant=dequant).numpy()
    np.testing.assert_allclose(got, pallas_out[dequant, steps], rtol=0, atol=tol(steps))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_scan_matches_probe(probe, inputs, dtype):
    """Variants A and B, at batch 1 as the probe runs them."""
    w = [inputs[k] for k in ("w_ih", "w_hh", "b_ih", "b_hh")]
    ref = np.asarray(probe.scan_fn(*w, inputs["xc"][:1], inputs["h0"][:1],
                                   dot_dtype=getattr(jnp, dtype)))
    got = PG.scan(*(torch.from_numpy(a) for a in w), torch.from_numpy(inputs["xc"][:1]),
                  torch.from_numpy(inputs["h0"][:1]), T, getattr(torch, dtype)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL)


def test_quantize_matches_probe_exactly(probe, inputs):
    for key in ("w_ih", "w_hh"):
        q_ref, s_ref = probe.quantize(inputs[key])
        q, s = PG.quantize(inputs[key])
        assert q.dtype == torch.int8 and s.dtype == torch.float32
        np.testing.assert_array_equal(q.numpy(), np.asarray(q_ref))
        np.testing.assert_array_equal(s.numpy(), np.asarray(s_ref))


def test_scan_int8_matches_probe(probe, inputs):
    """Variant C: int8 weights with their scale."""
    (wi_q, wi_s), (wh_q, wh_s) = PG.quantize(inputs["w_ih"]), PG.quantize(inputs["w_hh"])
    b = [inputs[k] for k in ("b_ih", "b_hh")]
    ref = np.asarray(probe.scan_int8(wi_q.numpy(), wi_s.numpy(), wh_q.numpy(), wh_s.numpy(), *b,
                                     inputs["xc"][:1], inputs["h0"][:1]))
    got = PG.scan_int8(wi_q, wi_s, wh_q, wh_s, *(torch.from_numpy(a) for a in b),
                       torch.from_numpy(inputs["xc"][:1]), torch.from_numpy(inputs["h0"][:1]),
                       T).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL)


def test_plan_fits_an_h100():
    """H = 1024 on 132 SMs: 128 blocks of 8 units and 24 warps of 8
    k-steps (16 over W_ih's 2H, 8 over W_hh's H), the same plan for both
    weight types (int8 is widened as it is staged into registers); shared
    memory holds x (8 rows of 2H + 8 bf16) and the 24 warps' 24 x 8 partial
    sums.  A 114-SM card would need 9 units a block, more than an m16 tile
    of [r | z] holds."""
    assert PG.plan(1024, 132) == (8, 128, 32_896 + 18_432, 768, 8, 32_768 + 128)
    assert PG.plan(1024, 132, dequant=True) == PG.plan(1024, 132)
    assert PG.plan(1024, 114).units == 9 > PG.MAX_UNITS
    assert PG.IH_WARPS * PG.KSTEPS * 16 == 2 * PG.MAX_H and PG.HH_WARPS * PG.KSTEPS * 16 == PG.MAX_H
    with pytest.raises(ValueError, match="units"):
        PG.check_shape(1024, PG.plan(1024, 114).units)
    for bad in (1056, 2048, 96):
        with pytest.raises(ValueError, match="H % 64"):
            PG.check_shape(bad, 8)


@pytest.mark.parametrize("n_sm", [132, 12, 7, 8])
@pytest.mark.parametrize("H_", [64, 1024])
def test_every_unit_written_by_one_block(H_, n_sm):
    """The blocks' units cover h once each, the last block ragged where
    the units do not divide H."""
    units = PG.plan(H_, n_sm).units
    owned = PG.block_units(H_, units)
    assert len(owned) == PG.plan(H_, n_sm).blocks
    counts = np.bincount(np.concatenate([list(r) for r in owned]), minlength=H_)
    assert counts.shape == (H_,) and (counts == 1).all()
    assert all(len(r) == units for r in owned[:-1]) and 1 <= len(owned[-1]) <= units


@pytest.mark.parametrize("units", [8, 6, 3, 1], ids=["U8", "U6-ragged", "U3-ragged", "U1"])
@pytest.mark.parametrize("steps", STEPS)
@pytest.mark.parametrize("dequant", [False, True], ids=["bf16", "int8"])
def test_tiled_matches_plain(inputs, dequant, steps, units):
    """The kernel's schedule against the plain steps: only the order of
    the float32 sums differs."""
    _, (wi, wh) = _weights(inputs, dequant)
    rest = _rest(inputs)
    got = PG.persistent_gru_tiled(wi, wh, *rest, steps, units, dequant=dequant)
    assert torch.isfinite(got).all()
    ref = PG.persistent_gru_plain(wi, wh, *rest, steps, dequant=dequant)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=tol(steps))


def test_tiled_row_tiles_hold_the_gates():
    """Row tile layout over the stacked contraction: [r | z] in rows 0-15,
    [n | 0] in rows 16-31, and zero rows past the block's units."""
    Hs = 32
    rng = np.random.default_rng(0)
    w = torch.from_numpy(rng.standard_normal((3 * Hs, 3 * Hs)).astype(np.float32))
    j = torch.tensor([5, 6, 7])
    a = PG._row_tiles(w, Hs, j)
    assert a.shape == (4 * PG.MAX_UNITS, 3 * Hs)
    assert torch.equal(a[1], w[:, 6]) and torch.equal(a[9], w[:, Hs + 6])
    assert torch.equal(a[17], w[:, 2 * Hs + 6])
    for lo in (3, 11, 19):
        assert not a[lo:lo + 5].any()
    assert not a[24:].any()


def test_tiled_refuses_what_the_kernel_refuses(inputs):
    _, (wi, wh) = _weights(inputs, False)
    with pytest.raises(ValueError, match="units"):
        PG.persistent_gru_tiled(wi, wh, *_rest(inputs), 1, PG.MAX_UNITS + 1)
    with pytest.raises(ValueError, match="H % 64"):
        PG.persistent_gru_tiled(wi[:96, :144], wh[:48, :144], *(t[..., :144] for t in _rest(inputs)[:2]),
                                *(t[..., :48] for t in _rest(inputs)[2:]), 1, 8)


def _launches() -> int:
    """K2's launches so far (its ``utils.tracing`` counter)."""
    return tracing.snapshot()["counters"].get("persistent_gru.launches", 0)


def test_wrapper_on_cpu_takes_plain_and_counts_nothing(inputs, pallas_out):
    _, (wi, wh) = _weights(inputs, False)
    before = _launches()
    got = PG.persistent_gru(wi, wh, *_rest(inputs), 1).numpy()
    assert _launches() == before
    np.testing.assert_allclose(got, pallas_out[False, 1], rtol=0, atol=TOL)


def test_wrapper_rejects_bad_input(inputs):
    _, (wi, wh) = _weights(inputs, False)
    rest = _rest(inputs)
    with pytest.raises(ValueError, match="int8"):
        PG.persistent_gru(wi, wh, *rest, T, dequant=True)
    with pytest.raises(ValueError, match="steps"):
        PG.persistent_gru(wi, wh, *rest, 0)
    with pytest.raises(ValueError, match="wh"):
        PG.persistent_gru(wi, wh[:-1], *rest, T)
    meta = [t.to("meta") for t in (wi, wh, *rest)]
    with pytest.raises(ValueError, match="cuda or cpu"):
        PG.persistent_gru(*meta, T)


@pytest.mark.gpu
@pytest.mark.parametrize("dequant", [False, True], ids=["bf16", "int8"])
def test_kernel_matches_plain_on_card(inputs, dequant):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    _, (wi, wh) = _weights(inputs, dequant)
    args = [t.cuda() for t in (wi, wh, *_rest(inputs))]
    before = _launches()
    for steps in STEPS:
        got = PG.persistent_gru(*args, steps, dequant=dequant)
        torch.cuda.synchronize()
        ref = PG.persistent_gru_plain(*args, steps, dequant=dequant)
        assert (got - ref).abs().max().item() <= tol(steps)
    assert _launches() == before + len(STEPS)
