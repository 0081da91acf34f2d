"""The anti-aliased activation kernel's host side
(``bvsc_tpu_torch.ops.resample``: the op ``bvsc_torch::antialias_act``,
its launcher ``activation1d_kernel``, ``csrc/antialias_act.cu``) and the
vocoder's dispatch to it (``models.vocoder.antialiased``).

The kernel runs only on a card.  Here a numpy emulation of its index
arithmetic (the clamped staged window, the two polyphase halves of the up
taps, the clamped activated pairs at the row's ends, the stride-2
decimation over them, tile by tile) is held to the plain ``Activation1d``
within 1e-6 of the output's peak (float32 sums in another order than
torch's convs), at the kernel's tile and at an 8-sample tile that puts
tile edges everywhere, and to the JAX package's ``Activation1d`` around
its own snake; the taps it is handed are checked bitwise; and the routing:
CPU calls take the plain chain, the op's CPU implementation and gradient
are the plain chain's, torch.export and torch.compile record the op, and
the causal configurations never reach ``antialiased``.  The ``gpu`` tests
hold the kernel to the plain chain on the card at every stage shape of
the BigVGAN cell, its bf16 form to its float32 one, and check that
gradients, bf16 and compiled calls launch it.
"""

from __future__ import annotations

import copy
import json
import os

import numpy as np
import pytest
import torch

from bvsc_tpu_torch.codec import BVRNNCodecModel
from bvsc_tpu_torch.config import CodecConfig, VocoderConfig
from bvsc_tpu_torch.models import vocoder as TV
from bvsc_tpu_torch.ops import resample as TR
from bvsc_tpu_torch.ops.snake import apply_activation, linear_params, prepare_act
from bvsc_tpu_torch.serve.export import export_serving_bundle
from bvsc_tpu_torch.utils import tracing
from portbench.lib.weights import make_weights

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EMU_TOL = 1e-6  # of the output's peak: float32 sums in another order
CARD_TOL = 2e-6  # of the output's peak, kernel against cuDNN's order
SMALL_TILE = 8
KERNEL_TILE = 1016  # csrc/antialias_act.cu's kTile
BIGVGAN_STAGES = ((768, 4), (384, 16), (192, 32), (96, 64), (48, 128), (24, 256))  # (C, hop / T)
CELL_FRAMES = 517  # frames the BigVGAN cell vocodes a clip


def plain(x: torch.Tensor, p: dict, kind: str, logscale: bool, approx: bool) -> torch.Tensor:
    return TR.Activation1d(lambda v: apply_activation(v, p, kind=kind, logscale=logscale,
                                                      approx=approx))(x)


def _sin_sq(v: np.ndarray, approx: bool) -> np.ndarray:
    f = np.float32
    if not approx:
        s = np.sin(v)
        return s * s
    r = v - f(3.14159265358979) * np.rint(v * f(1.0 / 3.14159265358979))
    r2 = r * r
    s = r + (r * r2) * (f(-1.6666654611e-1) + r2 * (f(8.3321608736e-3)
                                                   + r2 * f(-1.9515295891e-4)))
    return s * s


def emulate(x: np.ndarray, alpha: np.ndarray, inv_beta: np.ndarray, approx: bool,
            tile: int) -> np.ndarray:
    """The kernel's arithmetic in float32 numpy, block by block: rows of
    (B, C, T) ``x``, tiles of ``tile`` outputs (a multiple of 4), each
    staging x[t0 - 8, t0 + n + 8) clamped; an interior tile of a row whose
    length is a multiple of 4 reads its pairs' neighbours unclamped (the
    vectorised path), any other tile clamps every pair to the row."""
    B, C, T = x.shape
    taps = TR.kernel_taps()
    f, g = taps[:12], taps[12:]
    rows = x.reshape(B * C, T)
    al = np.tile(alpha, B)[:, None]
    ib = np.tile(inv_beta, B)[:, None]
    y = np.empty_like(rows)
    for t0 in range(0, T, tile):
        n = min(tile, T - t0)
        xw = rows[:, np.clip(t0 - 8 + np.arange(n + 16), 0, T - 1)]  # the staged window
        p = np.arange(n + 6)
        j = t0 - 3 + p
        interior = T % 4 == 0 and t0 >= 8 and t0 + tile + 8 <= T
        jc = j if interior else np.clip(j, 0, T - 1)
        o = p + 2 if interior else jc - t0 + 5  # x[jc - 3 .. jc + 3] is xw[o .. o + 6]
        u0 = np.zeros((B * C, n + 6), np.float32)
        u1 = np.zeros_like(u0)
        for m in range(6):
            u0 = u0 + f[2 * m + 1] * xw[:, o + 5 - m]
            u1 = u1 + f[2 * m] * xw[:, o + 6 - m]
        u0, u1 = 2 * u0, 2 * u1
        u1 = np.where(j < 0, u0, u1)
        u0 = np.where(j > T - 1, u1, u0)
        ev, od = (u + ib * _sin_sq(u * al, approx) for u in (u0, u1))
        i = np.arange(n)
        acc = g[0] * od[:, i]
        for m in range(1, 6):
            acc = acc + g[2 * m - 1] * ev[:, i + m]
            acc = acc + g[2 * m] * od[:, i + m]
        y[:, t0:t0 + n] = acc + g[11] * ev[:, i + 6]
    return y.reshape(B, C, T)


def snake_params(C: int, kind: str, seed: int = 0) -> dict:
    """Stored log-scale parameters, N(0, 0.3) as the benchmark seeds them."""
    rng = np.random.default_rng(seed)
    keys = ("alpha", "beta") if kind == "snakebeta" else ("alpha",)
    return {k: torch.from_numpy((0.3 * rng.standard_normal(C)).astype(np.float32)) for k in keys}


@pytest.mark.parametrize("approx", [False, True], ids=["sinf", "approx"])
@pytest.mark.parametrize("prepared", [False, True], ids=["stored", "prepared"])
@pytest.mark.parametrize("kind", ["snake", "snakebeta"])
@pytest.mark.parametrize("C", [1, 24])
@pytest.mark.parametrize("T", [1, 2, 5, 11, 12, 13, 517, 2068, 4133])
def test_emulated_kernel_matches_plain(T, C, kind, prepared, approx):
    stored = snake_params(C, kind, seed=T + C)
    p = prepare_act(stored, kind=kind, logscale=True) if prepared else stored
    x = torch.randn(2, C, T, generator=torch.Generator().manual_seed(T * C))
    ref = plain(x, p, kind, True, approx).numpy()
    alpha, inv_beta = (t.numpy() for t in linear_params(p, kind=kind, logscale=True))
    peak = float(np.abs(ref).max())
    for tile in (KERNEL_TILE, SMALL_TILE):
        got = emulate(x.numpy(), alpha, inv_beta, approx, tile)
        assert got.shape == ref.shape
        assert float(np.abs(got - ref).max()) <= EMU_TOL * peak, tile


@pytest.mark.parametrize("kind", ["snake", "snakebeta"])
def test_linear_params_are_the_stored_snakes(kind):
    """Stored parameters' linear form is the reference's Snake / SnakeBeta,
    bitwise: x + 1 / (exp(log beta) + eps) * sin^2(x * exp(log alpha)),
    each step rounded once (beta = alpha for Snake); prepared ones pass
    through."""
    stored = snake_params(24, kind, seed=3)
    x = torch.randn(2, 24, 50)
    alpha = torch.exp(stored["alpha"])[None, :, None]
    beta = torch.exp(stored["beta"])[None, :, None] if kind == "snakebeta" else alpha
    want = x + (1.0 / (beta + 1e-9)) * torch.square(torch.sin(x * alpha))
    assert torch.equal(apply_activation(x, stored, kind=kind, logscale=True), want)
    prepared = prepare_act(stored, kind=kind, logscale=True)
    assert all(a is b for a, b in zip(linear_params(prepared, kind=kind, logscale=True),
                                      (prepared["alpha"], prepared["inv_beta"])))


def test_kernel_taps_are_the_filters_bitwise():
    taps = TR.kernel_taps()
    filt = TR.kaiser_sinc_filter1d(0.25, 0.3, 12).ravel()
    assert taps.dtype == np.float32 and taps.shape == (24,)
    assert taps[:12].tobytes() == filt.tobytes() == TR.UpSample1d(2, 12).filter.tobytes()
    assert taps[12:].tobytes() == filt.tobytes() == TR.DownSample1d(2, 12).lowpass.filter.tobytes()
    assert bytes(TR._taps_arg()) == taps.tobytes()


def test_cpu_bf16_and_gradients_take_the_plain_chain():
    """On the CPU, float32, bf16 and gradient-wanting calls are the plain
    chain, bitwise, and launch nothing; the launcher refuses a CPU tensor,
    and ``activation1d`` a device that is neither CPU nor CUDA."""
    x = torch.randn(2, 4, 30)
    p = snake_params(4, "snakebeta", seed=2)
    cfg = VocoderConfig(activation="snakebeta", snake_logscale=True)
    tracing.reset()
    with torch.no_grad():
        for v in (x, x.bfloat16()):
            assert torch.equal(TV.antialiased(v, p, cfg), plain(v, p, "snakebeta", True, False))
    xg = x.clone().requires_grad_()
    pg = {k: v.clone().requires_grad_() for k, v in p.items()}
    y = TV.antialiased(xg, pg, cfg)
    assert type(y.grad_fn).__name__ == "ConvolutionBackward0"  # the chain's last conv
    y.sum().backward()
    assert xg.grad is not None and all(v.grad is not None for v in pg.values())
    assert tracing.snapshot()["counters"].get("vocoder.aa_kernel", 0) == 0
    with pytest.raises(ValueError, match="CUDA"):
        TR.activation1d_kernel(x, torch.ones(4), torch.ones(4))
    with pytest.raises(ValueError, match="cuda or cpu"):
        TR.activation1d(x.to("meta"), torch.ones(4), torch.ones(4))


# JAX's float32 exp and sin may differ from torch's by an ulp; at sin
# arguments up to ~6 that is a few ulp of the output, as in
# test_torch_vocoder_variants.py's test_resample_matches_jax
JAX_TOL = 1e-6  # of max(1, the output's peak)


@pytest.mark.parametrize("approx", [False, True], ids=["sinf", "approx"])
@pytest.mark.parametrize("kind", ["snake", "snakebeta"])
@pytest.mark.parametrize("T", [1, 2, 5, 13, KERNEL_TILE - 1, KERNEL_TILE, KERNEL_TILE + 1,
                               2 * KERNEL_TILE + 8, 3 * KERNEL_TILE + 8])
def test_emulated_kernel_matches_jax(T, kind, approx):
    """The emulated kernel, at its own tile, against the JAX package's
    ``Activation1d`` around its Snake / SnakeBeta on the same input and
    stored log-scale parameters: short rows, rows around one tile, and
    rows whose middle tiles take the vectorised path (2 x 1016 + 8 and
    3 x 1016 + 8 samples); its linear parameters are JAX's own (exp, then
    1 / (beta + eps), in float32)."""
    import jax  # here, so that the card's host, which has no JAX, imports the module
    import jax.numpy as jnp
    from bvsc_tpu.ops import resample as JR
    from bvsc_tpu.ops import snake as JS

    C = 3
    stored = {k: v.numpy() for k, v in snake_params(C, kind, seed=T).items()}
    x = (np.random.default_rng(T).standard_normal((2, C, T)) * 2).astype(np.float32)
    jp = jax.tree.map(jnp.asarray, stored)
    act = JS.snake if kind == "snake" else JS.snake_beta
    ref = np.asarray(JR.Activation1d(lambda v: act(v, jp, logscale=True, approx=approx))(
        jnp.asarray(x)))
    alpha = np.asarray(jnp.exp(jp["alpha"]))
    beta = alpha if kind == "snake" else np.asarray(jnp.exp(jp["beta"]))
    inv_beta = np.asarray(1.0 / (jnp.asarray(beta) + 1e-9))
    got = emulate(x, alpha, inv_beta, approx, KERNEL_TILE)
    assert got.shape == ref.shape
    assert float(np.abs(got - ref).max()) <= JAX_TOL * max(1.0, float(np.abs(ref).max()))


@pytest.mark.parametrize("approx", [False, True], ids=["sinf", "approx"])
def test_op_cpu_implementation_and_gradient_are_the_plain_chain(approx):
    """The op on CPU tensors is the plain chain, bitwise; its gradient (the
    plain chain's, recomputed) is bitwise autograd's through the plain
    chain, for the input and for stored parameters behind it, and passes
    gradcheck in float64."""
    C, T = 4, 37
    stored = {k: v.double().requires_grad_() for k, v in snake_params(C, "snakebeta").items()}
    x = torch.randn(2, C, T, dtype=torch.float64, requires_grad=True)
    alpha, inv_beta = linear_params(stored, kind="snakebeta", logscale=True)
    y = TR.OP(x, alpha, inv_beta, approx)
    ref = TR.plain_act(x, alpha, inv_beta, approx)
    assert torch.equal(y, ref)
    g = torch.randn_like(y)
    leaves = [x, *stored.values()]
    got = torch.autograd.grad(y, leaves, g, retain_graph=True)
    want = torch.autograd.grad(ref, leaves, g)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    a, b = (t.detach().requires_grad_() for t in (alpha, inv_beta))
    assert torch.autograd.gradcheck(lambda *t: TR.OP(*t, approx), (x, a, b))


class _Antialiased(torch.nn.Module):
    def forward(self, x, alpha, beta):
        cfg = VocoderConfig(activation="snakebeta", snake_logscale=True)
        return TV.antialiased(x, {"alpha": alpha, "beta": beta}, cfg)


def _ops(graph) -> list[str]:
    return [str(n.target) for n in graph.nodes if n.op == "call_function"
            and str(n.target).startswith("bvsc_torch.")]


def test_export_and_compile_record_the_op():
    """torch.export and torch.compile trace ``antialiased`` to one call of
    the op (which launches the kernel on a card), with no filter taps baked
    into the program, and the traced programs compute the eager result."""
    p = snake_params(4, "snakebeta", seed=4)
    args = (torch.randn(2, 4, 40), p["alpha"], p["beta"])
    want = _Antialiased()(*args)
    ep = torch.export.export(_Antialiased(), args)
    assert _ops(ep.graph) == ["bvsc_torch.antialias_act.default"]
    assert not ep.constants and not ep.state_dict
    assert torch.equal(ep.module()(*args), want)
    graphs = []

    def backend(gm, example_inputs):
        graphs.append(gm.graph)
        return gm.forward

    torch._dynamo.reset()
    got = torch.compile(_Antialiased(), backend=backend, fullgraph=True)(*args)
    assert [_ops(g) for g in graphs] == [["bvsc_torch.antialias_act.default"]]
    assert torch.equal(got, want)


def test_lookahead_codec_does_not_export(tmp_path):
    """A serving bundle's programs hold the length bucket's frames, where
    the live codec vocodes only a clip's own: a BigVGAN codec is refused
    by name, before any trace."""
    codec = copy.deepcopy(json.load(open(os.path.join(
        ROOT, "portbench", "configs", "varbit-bigvgan-f32.json")))["codec"])
    codec.update(h_dim=48, z_dim=12)
    codec["vocoder_config"]["upsample_initial_channel"] = 64
    bv, voc = make_weights(codec, 5, "cpu")
    model = BVRNNCodecModel(config=CodecConfig.from_dict(codec), bvrnn_params=bv,
                            vocoder_params=voc, device="cpu", use_pallas=False)
    with pytest.raises(ValueError, match="looks ahead"):
        export_serving_bundle(model, str(tmp_path / "b.bvscx"), lengths=(4096,), packet=False)
    assert not (tmp_path / "b.bvscx").exists()


def small_codec(name: str, use_pallas) -> BVRNNCodecModel:
    with open(os.path.join(ROOT, "portbench", "configs", f"{name}.json")) as f:
        codec = copy.deepcopy(json.load(f)["codec"])
    codec.update(h_dim=48, z_dim=12)
    bv, voc = make_weights(codec, 7, "cpu")
    return BVRNNCodecModel(config=CodecConfig.from_dict(codec), bvrnn_params=bv,
                           vocoder_params=voc, device="cpu", use_pallas=use_pallas)


@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("name", ["varbit-f32", "fixed64-bf16"])
def test_causal_configs_never_reach_antialiased(name, use_pallas):
    """The causal configurations (every cell but the BigVGAN one) call no
    anti-aliased activation, so neither route of it, on any device."""
    model = small_codec(name, use_pallas)
    x = torch.randn(2, 20 * 256 + 31, generator=torch.Generator().manual_seed(1))
    tracing.reset()
    with torch.no_grad():
        model(x, 3000.0)
    snap = tracing.snapshot()
    assert "vocoder.aa" not in snap["spans"]
    assert snap["counters"].get("vocoder.aa_kernel", 0) == 0
    assert snap["counters"].get("vocoder.aa_elements", 0) == 0


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        yield torch.device("cuda")


def _stage_cases():
    cases = [(C, CELL_FRAMES * r) for C, r in BIGVGAN_STAGES]
    cases += [(24, 1), (24, 2), (24, 5), (48, 1023), (48, 1025), (96, 4133)]  # ragged, < halo
    return cases


def _launches() -> int:
    return tracing.snapshot()["counters"].get("vocoder.aa_kernel", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("approx", [False, True], ids=["sinf", "approx"])
@pytest.mark.parametrize("C,T", _stage_cases())
def test_kernel_matches_plain_on_the_card(card, C, T, approx):
    """Kernel against the plain chain on the card (TF32 off), B = 2, at
    every stage shape of the BigVGAN cell and at ragged and short rows,
    with stored and prepared SnakeBeta parameters; each launch counted in
    ``vocoder.aa_kernel``."""
    stored = {k: v.to(card) for k, v in snake_params(C, "snakebeta", seed=C + T).items()}
    x = torch.randn(2, C, T, generator=torch.Generator().manual_seed(T), device="cpu").to(card)
    for p in (stored, prepare_act(stored, kind="snakebeta", logscale=True)):
        ref = plain(x, p, "snakebeta", True, approx)
        before = _launches()
        got = TR.activation1d_kernel(x, *linear_params(p, kind="snakebeta", logscale=True),
                                     approx)
        torch.cuda.synchronize()
        assert _launches() == before + 1
        peak = float(ref.abs().max())
        assert float((got - ref).abs().max()) <= CARD_TOL * peak


@pytest.mark.gpu
@pytest.mark.parametrize("approx", [False, True], ids=["sinf", "approx"])
@pytest.mark.parametrize("C,T", [(768, CELL_FRAMES * 4), (24, CELL_FRAMES * 256), (48, 1025),
                                 (24, 5)])
def test_bf16_kernel_is_the_float32_one_rounded(card, C, T, approx):
    """bf16 activations: the bf16 build's output is bitwise the float32
    build's on the widened input, rounded once to bf16 (the same float32
    arithmetic), so within half a bf16 ulp of it; and no further from that
    float32 result than the plain chain in bf16 (which rounds each pass)."""
    stored = {k: v.to(card).bfloat16() for k, v in snake_params(C, "snakebeta", seed=T).items()}
    x = torch.randn(2, C, T, generator=torch.Generator().manual_seed(C), device="cpu")
    x = x.to(card).bfloat16()
    alpha, inv_beta = linear_params(stored, kind="snakebeta", logscale=True)
    assert alpha.dtype == torch.bfloat16
    before = _launches()
    got = TR.activation1d_kernel(x, alpha, inv_beta, approx)
    f32 = TR.activation1d_kernel(x.float(), alpha, inv_beta, approx)
    assert _launches() == before + 2
    assert got.dtype == torch.bfloat16 and torch.equal(got, f32.bfloat16())
    chain = plain(x, stored, "snakebeta", True, approx)
    assert chain.dtype == torch.bfloat16
    assert float((got.float() - f32).abs().max()) <= float((chain.float() - f32).abs().max())


@pytest.mark.gpu
def test_kernel_routing_on_the_card(card):
    """A strided input is made contiguous; a call that wants a gradient
    launches the kernel through the op, whose gradient is the plain
    chain's; a bf16 call and a compiled one launch it too; the counter
    ``vocoder.aa_kernel`` counts every launch."""
    C, T = 48, 700
    cfg = VocoderConfig(activation="snakebeta", snake_logscale=True)
    p = {k: v.to(card) for k, v in snake_params(C, "snakebeta").items()}
    wide = torch.randn(2, T, C, device=card)
    x = wide.transpose(1, 2)
    assert not x.is_contiguous()
    tracing.reset()
    with torch.no_grad():
        got = TV.antialiased(x, p, cfg)
        ref = plain(x.contiguous(), p, "snakebeta", True, False)
    assert float((got - ref).abs().max()) <= CARD_TOL * float(ref.abs().max())
    assert _launches() == 1
    xg = x.detach().clone().requires_grad_()
    pg = {k: v.clone().requires_grad_() for k, v in p.items()}
    y = TV.antialiased(xg, pg, cfg)
    assert _launches() == 2
    assert float((y.detach() - ref).abs().max()) <= CARD_TOL * float(ref.abs().max())
    g = torch.randn_like(y)
    got = torch.autograd.grad(y, [xg, *pg.values()], g)
    want = torch.autograd.grad(plain(xg, pg, "snakebeta", True, False), [xg, *pg.values()], g)
    for a, b in zip(got, want):
        assert float((a - b).abs().max()) <= CARD_TOL * float(b.abs().max())
    with torch.no_grad():
        assert TV.antialiased(x.bfloat16(), p, cfg).dtype == torch.bfloat16
    assert _launches() == 3
    torch._dynamo.reset()
    compiled = torch.compile(_Antialiased(), backend="aot_eager", fullgraph=True)
    with torch.no_grad():
        got = compiled(x, p["alpha"], p["beta"])
    assert _launches() == 4
    assert float((got - ref).abs().max()) <= CARD_TOL * float(ref.abs().max())
@pytest.mark.gpu
def test_kernel_layouts_agree_bitwise_on_the_card(card):
    """Rows 4 bytes off a 16-byte boundary (loaded 4 floats a thread), and
    a view trimmed along T as the generator hands each stage's input (read
    in place, rows longer than T), give the bits of the same values laid
    out contiguously."""
    C, T = 96, CELL_FRAMES * 4
    alpha, inv_beta = linear_params(
        {k: v.to(card) for k, v in snake_params(C, "snakebeta").items()},
        kind="snakebeta", logscale=True)
    off = torch.randn(2 * C * T + 1, device=card)[1:].view(2, C, T)
    assert off.is_contiguous() and off.data_ptr() % 16 == 4
    trimmed = torch.randn(2, C, T + 4, device=card)[..., 2:-2]
    assert trimmed.stride(1) == T + 4 and trimmed.data_ptr() % 16 == 8
    for approx in (False, True):
        for x in (off, trimmed):
            got = TR.activation1d_kernel(x, alpha, inv_beta, approx)
            assert torch.equal(got, TR.activation1d_kernel(x.clone(), alpha, inv_beta, approx))
