"""Optimizer of the port's trainer (the port of
``mmlrec_tpu/train/optimizers.py``): Adam only, written as optax's update.

Functional over a dict of tensors, in optax's order
(``optax.scale_by_adam`` then ``scale_by_learning_rate``, then
``apply_updates``), so that a state moves across from the JAX package and
both sides take the same f32 steps:

    mu = (1 - b1) * g + b1 * mu;   nu = (1 - b2) * g**2 + b2 * nu
    mu_hat = mu / (1 - b1**t);     nu_hat = nu / (1 - b2**t)
    p = p + (mu_hat / (sqrt(nu_hat) + eps)) * -lr

The other optimizers of the JAX package (sgd, adagrad, rmsprop) are not
ported: the two-phase step is SparseAdam, and the dense-table fit is
ROADMAP A3.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import torch


class AdamState(NamedTuple):
    count: torch.Tensor  # int32 scalar
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]


class Adam:
    """``optax.adam(lr, b1, b2, eps)`` over a dict of tensors."""

    def __init__(self, lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.lr, self.b1, self.b2, self.eps = float(lr), float(b1), float(b2), float(eps)

    def init(self, params: Dict[str, torch.Tensor]) -> AdamState:
        device = next(iter(params.values())).device
        return AdamState(
            count=torch.zeros((), dtype=torch.int32, device=device),
            mu={k: torch.zeros_like(p) for k, p in params.items()},
            nu={k: torch.zeros_like(p) for k, p in params.items()},
        )

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
             state: AdamState) -> AdamState:
        """Update ``params`` in place from ``grads``; returns the new state."""
        b1, b2, eps, lr = self.b1, self.b2, self.eps, self.lr
        count = state.count + 1
        t = count.to(torch.float32)
        c1 = 1.0 - b1 ** t
        c2 = 1.0 - b2 ** t
        mu, nu = {}, {}
        for k, p in params.items():
            g = grads[k]
            mu[k] = (1.0 - b1) * g + b1 * state.mu[k]
            nu[k] = (1.0 - b2) * (g * g) + b2 * state.nu[k]
            update = (mu[k] / c1) / (torch.sqrt(nu[k] / c2) + eps)
            p.add_(update * -lr)
        return AdamState(count=count, mu=mu, nu=nu)


def get_optimizer(name: str, lr: float) -> Adam:
    """Reference _get_optim (model/basemodel.py:569-584), Adam only."""
    if (name or "").lower() != "adam":
        raise NotImplementedError(
            f"optimizer {name!r} is not ported yet (ROADMAP A3); the two-phase "
            "step implements SparseAdam")
    return Adam(lr, b1=0.9, b2=0.999, eps=1e-8)
