"""SnakeBeta activation (port of ``bvsc_tpu/ops/snake.py``, exact form):

    x + (1/(beta + eps)) * sin^2(alpha * x)

with per-channel alpha and beta, optionally stored in log scale, and
eps = 1e-9.  Plain Snake (no shipped config uses it) and the polynomial
``sin_sq_approx`` of the fast-serving mode are not ported yet.
"""

from __future__ import annotations

import torch

EPS = 1e-9


def snake_beta(x: torch.Tensor, p: dict, *, logscale: bool) -> torch.Tensor:
    """x: (B, C, T); p['alpha'], p['beta']: (C,)."""
    alpha = p["alpha"][None, :, None]
    beta = p["beta"][None, :, None]
    if logscale:
        alpha = torch.exp(alpha)
        beta = torch.exp(beta)
    return x + (1.0 / (beta + EPS)) * torch.square(torch.sin(x * alpha))
