"""Snake activations (port of ``bvsc_tpu/ops/snake.py``):

    Snake:     x + (1/(alpha + eps)) * sin^2(alpha * x)
    SnakeBeta: x + (1/(beta  + eps)) * sin^2(alpha * x)

with per-channel alpha (and beta), optionally stored in log scale, and
eps = 1e-9; ``lrelu`` is a leaky ReLU of slope 0.1.  ``approx=True`` takes
:func:`sin_sq_approx`, the polynomial sin^2 of the fast-serving mode, in
place of ``sin``.  Every function computes in its input's dtype (float32,
or bf16 on the direct vocoder's bf16 segment).

:func:`prepare_act` turns one activation's stored parameters into the
linear-scale alpha and 1 / (beta + eps) that :func:`snake_linear` reads,
computed on the host in float64 and rounded once, so that they are the same
on every device (``ops.amp_resblock.snake_params`` does the same for the
kernels' packed blocks).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

EPS = 1e-9
LRELU_SLOPE = 0.1
ACTIVATIONS = ("snake", "snakebeta", "lrelu")

# sin(r) odd polynomial on [-pi/2, pi/2] (Cephes sinf coefficients), the
# JAX package's constants
_PI = 3.14159265358979
_INV_PI = 1.0 / _PI
_S1, _S2, _S3 = -1.6666654611e-1, 8.3321608736e-3, -1.9515295891e-4


def sin_sq_approx(u: torch.Tensor) -> torch.Tensor:
    """Polynomial sin^2(u): r = u - pi * round(u / pi) lies in [-pi/2, pi/2]
    (sin^2 has period pi), then the odd degree-7 sin polynomial, squared.
    ``torch.round`` rounds half to even, as ``jnp.round`` does.  Max |error|
    against float64 sin^2 is below 2e-4 over |u| < 300."""
    r = u - _PI * torch.round(u * _INV_PI)
    r2 = r * r
    s = r + r * r2 * (_S1 + r2 * (_S2 + r2 * _S3))
    return s * s


def _sin_sq(u: torch.Tensor, approx: bool) -> torch.Tensor:
    return sin_sq_approx(u) if approx else torch.square(torch.sin(u))


def linear_params(p: dict, *, kind: str, logscale: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """One snake's (C,) ``alpha`` and ``inv_beta`` as :func:`snake_linear`
    reads them: prepared parameters as they are, stored ones computed on
    their device, differentiably, in their dtype: ``exp`` in log scale,
    then 1 / (beta + eps) (alpha for plain Snake)."""
    if "inv_beta" in p:
        return p["alpha"], p["inv_beta"]
    alpha = torch.exp(p["alpha"]) if logscale else p["alpha"]
    if kind == "snake":
        return alpha, 1.0 / (alpha + EPS)
    beta = torch.exp(p["beta"]) if logscale else p["beta"]
    return alpha, 1.0 / (beta + EPS)


def snake_linear(x: torch.Tensor, alpha: torch.Tensor, inv_beta: torch.Tensor,
                 approx: bool = False) -> torch.Tensor:
    """Snake or SnakeBeta from linear (C,) parameters (:func:`linear_params`,
    :func:`prepare_act`): ``x + inv_beta * sin^2(alpha * x)``."""
    return x + inv_beta[None, :, None] * _sin_sq(x * alpha[None, :, None], approx)


def snake(x: torch.Tensor, p: dict, *, logscale: bool, approx: bool = False) -> torch.Tensor:
    """x: (B, C, T); p['alpha']: (C,)."""
    return snake_linear(x, *linear_params(p, kind="snake", logscale=logscale), approx)


def snake_beta(x: torch.Tensor, p: dict, *, logscale: bool, approx: bool = False) -> torch.Tensor:
    """x: (B, C, T); p['alpha'], p['beta']: (C,)."""
    return snake_linear(x, *linear_params(p, kind="snakebeta", logscale=logscale), approx)


def leaky_relu(x: torch.Tensor, slope: float = LRELU_SLOPE) -> torch.Tensor:
    return F.leaky_relu(x, slope)


def apply_activation(x: torch.Tensor, p: dict, *, kind: str, logscale: bool,
                     approx: bool = False) -> torch.Tensor:
    """The activation ``kind`` on its stored or prepared parameters
    (:func:`linear_params`, then :func:`snake_linear`), on the tensors'
    device, differentiable in them."""
    if kind == "lrelu":
        return leaky_relu(x)
    if kind not in ACTIVATIONS:
        raise NotImplementedError(f"activation {kind!r}")
    return snake_linear(x, *linear_params(p, kind=kind, logscale=logscale), approx)


def init_snake_params(channels: int, *, beta: bool, logscale: bool) -> dict:
    """Log scale starts at zeros (exp() = 1), linear scale at ones, as numpy
    float32 arrays."""
    init = np.zeros if logscale else np.ones
    p = {"alpha": init(channels, np.float32)}
    if beta:
        p["beta"] = init(channels, np.float32)
    return p


def prepare_act(p: dict, *, kind: str, logscale: bool, dtype: torch.dtype | None = None) -> dict:
    """One snake's stored parameters as ``{'alpha', 'inv_beta'}`` in linear
    scale, 1 / (beta + eps) (1 / (alpha + eps) for plain snake), computed on
    the host in float64 and rounded once to ``dtype`` (default the
    parameters' own), on the parameters' device.  ``lrelu`` has none to
    prepare: ``p`` comes back as it is."""
    if kind == "lrelu" or "inv_beta" in p:
        return p
    dev = p["alpha"].device
    dtype = dtype or p["alpha"].dtype

    def host64(key):
        v = p[key].detach().to("cpu", torch.float64)
        return torch.exp(v) if logscale else v

    alpha = host64("alpha")
    denom = host64("beta") if kind == "snakebeta" else alpha
    return {"alpha": alpha.to(dev, dtype), "inv_beta": (1.0 / (denom + EPS)).to(dev, dtype)}
