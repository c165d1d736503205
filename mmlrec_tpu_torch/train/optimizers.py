"""Optimizers of the port's trainer (the port of
``mmlrec_tpu/train/optimizers.py``): adam, adagrad, rmsprop and sgd, each
written as optax's update.

Functional over a dict of tensors, in optax's order (the ``scale_by_*``
transform, then ``scale_by_learning_rate``, then ``apply_updates``), so
that a state moves across from the JAX package and both sides take the same
f32 steps.  With ``g`` the gradient and ``p`` the parameter:

    adam     mu = (1 - b1) * g + b1 * mu;  nu = (1 - b2) * g**2 + b2 * nu
             p += ((mu / (1 - b1**t)) / (sqrt(nu / (1 - b2**t)) + eps)) * -lr
    adagrad  s = g**2 + s;  p += (where(s > 0, rsqrt(s + eps), 0) * g) * -lr
    rmsprop  nu = (1 - decay) * g**2 + decay * nu;  p += (rsqrt(nu + eps) * g) * -lr
    sgd      p += g * -lr

The defaults are the reference's torch defaults, as the JAX factory sets
them: adam betas (0.9, 0.999), eps 1e-8; adagrad initial accumulator 0.0,
eps 1e-10; rmsprop decay 0.99, eps 1e-8 (inside the root, as optax has it).

Every state is a NamedTuple whose tensor-dict fields carry optax's names
(``mu``, ``nu``, ``sum_of_squares``), so ``convert.load_jax_train_state``
fills any of them from an optax state by name.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import torch

Tensors = Dict[str, torch.Tensor]


class AdamState(NamedTuple):
    count: torch.Tensor  # int32 scalar
    mu: Tensors
    nu: Tensors


class AdagradState(NamedTuple):
    sum_of_squares: Tensors


class RmsPropState(NamedTuple):
    nu: Tensors


class SgdState(NamedTuple):
    pass


class Adam:
    """``optax.adam(lr, b1, b2, eps)`` over a dict of tensors."""

    def __init__(self, lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.lr, self.b1, self.b2, self.eps = float(lr), float(b1), float(b2), float(eps)

    def init(self, params: Tensors) -> AdamState:
        device = next(iter(params.values())).device
        return AdamState(
            count=torch.zeros((), dtype=torch.int32, device=device),
            mu={k: torch.zeros_like(p) for k, p in params.items()},
            nu={k: torch.zeros_like(p) for k, p in params.items()},
        )

    @torch.no_grad()
    def step(self, params: Tensors, grads: Tensors, state: AdamState) -> AdamState:
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


class Adagrad:
    """``optax.adagrad(lr, initial_accumulator_value, eps)``."""

    def __init__(self, lr: float, initial_accumulator_value: float = 0.0, eps: float = 1e-10):
        self.lr, self.initial, self.eps = float(lr), float(initial_accumulator_value), float(eps)

    def init(self, params: Tensors) -> AdagradState:
        return AdagradState({k: torch.full_like(p, self.initial) for k, p in params.items()})

    @torch.no_grad()
    def step(self, params: Tensors, grads: Tensors, state: AdagradState) -> AdagradState:
        sums = {}
        for k, p in params.items():
            g = grads[k]
            sums[k] = g * g + state.sum_of_squares[k]
            scale = torch.where(sums[k] > 0, torch.rsqrt(sums[k] + self.eps), 0.0)
            p.add_((scale * g) * -self.lr)
        return AdagradState(sums)


class RmsProp:
    """``optax.rmsprop(lr, decay, eps)`` (eps inside the root, no momentum)."""

    def __init__(self, lr: float, decay: float = 0.99, eps: float = 1e-8):
        self.lr, self.decay, self.eps = float(lr), float(decay), float(eps)

    def init(self, params: Tensors) -> RmsPropState:
        return RmsPropState({k: torch.zeros_like(p) for k, p in params.items()})

    @torch.no_grad()
    def step(self, params: Tensors, grads: Tensors, state: RmsPropState) -> RmsPropState:
        nu = {}
        for k, p in params.items():
            g = grads[k]
            nu[k] = (1.0 - self.decay) * (g * g) + self.decay * state.nu[k]
            p.add_((torch.rsqrt(nu[k] + self.eps) * g) * -self.lr)
        return RmsPropState(nu)


class Sgd:
    """``optax.sgd(lr)``: no momentum, no state."""

    def __init__(self, lr: float):
        self.lr = float(lr)

    def init(self, params: Tensors) -> SgdState:
        return SgdState()

    @torch.no_grad()
    def step(self, params: Tensors, grads: Tensors, state: SgdState) -> SgdState:
        for k, p in params.items():
            p.add_(grads[k] * -self.lr)
        return state


def get_optimizer(name: str, lr: float):
    """Reference _get_optim (model/basemodel.py:569-584), with the settings
    of ``mmlrec_tpu/train/optimizers.py:17-27``."""
    name = (name or "").lower()
    if name == "sgd":
        return Sgd(lr)
    if name == "adam":
        return Adam(lr, b1=0.9, b2=0.999, eps=1e-8)
    if name == "adagrad":
        return Adagrad(lr, initial_accumulator_value=0.0, eps=1e-10)
    if name == "rmsprop":
        return RmsProp(lr, decay=0.99, eps=1e-8)
    raise NotImplementedError(f"optimizer {name!r}")
