"""Global-norm clipping then Adam or AdamW, as ``optax`` computes them.

The JAX package's trainers chain ``optax.clip_by_global_norm`` with
``optax.adam`` (BVRNN, learning rate ``lr * lr_decay ** count``) or
``optax.adamw(weight_decay=0.01)`` (GAN, learning rate set per epoch).
torch's own pieces differ from these: ``clip_grad_norm_`` divides by
``norm + 1e-6`` and ``torch.optim.AdamW`` decays the weights before the
Adam step.  :class:`ClippedAdam` is optax's arithmetic, in its order:

* clip: with n = sqrt(sum of every gradient's squares), a gradient becomes
  ``(g / n) * max_norm`` unless ``n < max_norm``;
* moments: ``mu = (1 - b1) g + b1 mu``, ``nu = (1 - b2) g^2 + b2 nu``;
  with ``k`` the updates made so far plus one, ``u = (mu / (1 - b1^k)) /
  (sqrt(nu / (1 - b2^k)) + eps)``;
* AdamW adds ``weight_decay * p`` to ``u``;
* ``p = p + (-lr) * u``, ``lr`` taken at ``k - 1``.

The tensors are updated in place with ``torch._foreach`` ops (one launch a
list on the card).  The clip reads its condition on the host: one
synchronisation a step.
"""

from __future__ import annotations

import numpy as np
import torch


class ClippedAdam:
    """Clip by global norm, then Adam (``weight_decay=0``) or AdamW, over a
    fixed list of parameter tensors."""

    def __init__(self, params: list[torch.Tensor], *, lr: float, b1: float, b2: float,
                 max_norm: float, eps: float = 1e-8, weight_decay: float = 0.0,
                 lr_decay: float = 1.0):
        self.params = list(params)
        self.lr, self.lr_decay = float(lr), float(lr_decay)
        self.b1, self.b2, self.eps = float(b1), float(b2), float(eps)
        self.max_norm, self.weight_decay = float(max_norm), float(weight_decay)
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    def lr_at(self, count: int) -> float:
        """The learning rate of update ``count`` (0 first), in float32 as
        optax's ``exponential_decay`` computes it."""
        if self.lr_decay == 1.0:
            return float(np.float32(self.lr))
        return float(np.float32(self.lr) * np.power(np.float32(self.lr_decay), np.float32(count)))

    @staticmethod
    def global_norm(grads: list[torch.Tensor]) -> torch.Tensor:
        """sqrt of the sum of every tensor's squares (``optax.global_norm``);
        None entries count as zeros."""
        return torch.stack(torch._foreach_norm([g for g in grads if g is not None])
                           ).square().sum().sqrt()

    @torch.no_grad()
    def step(self, grads: list[torch.Tensor]) -> torch.Tensor:
        """One update from ``grads`` (one per parameter, None for none);
        returns the global norm before clipping."""
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(self.params, grads)]
        norm = self.global_norm(grads)
        if not float(norm) < self.max_norm:
            grads = torch._foreach_div(grads, norm)
            torch._foreach_mul_(grads, self.max_norm)
        torch._foreach_mul_(self.mu, self.b1)
        torch._foreach_add_(self.mu, torch._foreach_mul(grads, 1.0 - self.b1))
        sq = torch._foreach_mul(grads, grads)
        torch._foreach_mul_(sq, 1.0 - self.b2)
        torch._foreach_mul_(self.nu, self.b2)
        torch._foreach_add_(self.nu, sq)
        lr = self.lr_at(self.count)
        self.count += 1
        bc1 = float(np.float32(1.0) - np.float32(self.b1) ** np.float32(self.count))
        bc2 = float(np.float32(1.0) - np.float32(self.b2) ** np.float32(self.count))
        den = torch._foreach_div(self.nu, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        upd = torch._foreach_div(self.mu, bc1)
        torch._foreach_div_(upd, den)
        if self.weight_decay:
            torch._foreach_add_(upd, torch._foreach_mul(self.params, self.weight_decay))
        torch._foreach_mul_(upd, -lr)
        torch._foreach_add_(self.params, upd)
        return norm

    def state_dict(self, names: list[str]) -> dict:
        """The update count, the learning rate and both moments by the
        parameters' ``names``."""
        return {"count": self.count, "lr": self.lr, "mu": dict(zip(names, self.mu)),
                "nu": dict(zip(names, self.nu))}

    def load_state_dict(self, state: dict, names: list[str]) -> None:
        if set(state["mu"]) != set(names):
            raise ValueError("optimizer state does not match the model's parameters")
        self.count, self.lr = int(state["count"]), float(state["lr"])
        with torch.no_grad():
            for n, mu, nu in zip(names, self.mu, self.nu):
                mu.copy_(state["mu"][n])
                nu.copy_(state["nu"][n])
