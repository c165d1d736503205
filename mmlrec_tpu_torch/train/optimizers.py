"""Optimizers of the port's trainer (the port of
``mmlrec_tpu/train/optimizers.py``): adam, adagrad, rmsprop and sgd, each
written as optax's update, and ``Flat``, the port of ``optax.flatten``.

Over a dict of tensors, in optax's order (the ``scale_by_*`` transform,
then ``scale_by_learning_rate``, then ``apply_updates``), so that a state
moves across from the JAX package and both sides take the same f32 steps.
With ``g`` the gradient and ``p`` the parameter:

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
fills any of them from an optax state by name.  A step updates the
parameters AND the state in place and returns the same state object: a
CUDA graph that captured the step reads the tensors it captured, so no
step may hand back new ones.  (``mu * b1 + (1 - b1) * g`` in place rounds
as optax's ``(1 - b1) * g + b1 * mu``: an f32 sum of two rounded products
is the same in either order.)

``Flat`` runs the same elementwise chain once over all the parameters:
its state fields are ``FlatTensors``, named views into one flat buffer,
the gradients are concatenated into one vector, and the update is added to
every parameter by one multi-tensor add.  Elementwise, so it is bitwise
equal to the per-tensor path, on the CPU and on the card.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Sequence, Tuple

import numpy as np
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


class FlatTensors(dict):
    """Named views (a state field, by parameter name) into ONE flat f32
    buffer ``flat``: saved, loaded and compared by name like any dict of
    tensors, updated in one piece by ``Flat``."""

    def __init__(self, flat: torch.Tensor = None, views=()):
        super().__init__(views)
        self.flat = flat


def flat_like(params: Tensors, value: float, members: int = 0) -> FlatTensors:
    """A ``FlatTensors`` shaped as ``params`` (in their order), filled with
    ``value``; with ``members`` S, ``[S, N]``, whose views carry the
    leading S."""
    first = next(iter(params.values()))
    lead = (members,) if members else ()
    flat = torch.full(lead + (sum(p.numel() for p in params.values()),), float(value),
                      dtype=torch.float32, device=first.device)
    views, off = {}, 0
    for k, p in params.items():
        views[k] = flat[..., off:off + p.numel()].view(*lead, *p.shape)
        off += p.numel()
    return FlatTensors(flat, views)


def _field(params: Tensors, value: float, flat: bool) -> Tensors:
    if flat:
        return flat_like(params, value)
    return {k: torch.full_like(p, value) for k, p in params.items()}


class _Elementwise:
    """An optimizer as one elementwise chain: ``_shared`` once per step
    (the step count's terms), ``_apply`` per tensor (or once over the flat
    vectors), which moves the state tensors in place and returns the
    parameter delta.

    ``HYPER`` names the update-time hyperparameters.  The chain reads them
    through ``k``, the constants ``_derive`` computes from them in double
    precision (``1 - b1``, ``-lr``, ...): Python floats here, and in an
    ``inject``-ed copy f32 tensors of the same values, one per stacked
    member (optax's ``inject_hyperparams`` state leaves), so a member's
    step takes the f32 constants a plain optimizer of its values takes."""

    HYPER: Tuple[str, ...] = ()

    def __init__(self, **hyper: float):
        self.hyper = {k: float(v) for k, v in hyper.items()}
        for name, v in self.hyper.items():
            setattr(self, name, v)
        self.k = self._derive(**self.hyper)

    def _derive(self, **hyper) -> Dict[str, object]:
        raise NotImplementedError

    def inject(self, values: Dict[str, object], device) -> "_Elementwise":
        """A copy whose hyperparameters are f32 tensors on ``device``: a
        sequence in ``values[name]`` gives one value per member (``[S, 1]``,
        against a member-stacked ``Flat``), a number a 0-d tensor, and a
        name it does not give keeps its value as a 0-d tensor.  A name
        outside ``HYPER`` raises KeyError."""
        unknown = sorted(set(values) - set(self.HYPER))
        if unknown:
            raise KeyError(f"{unknown} are not update-time hyperparameters of "
                           f"{type(self).__name__} (available: {sorted(self.HYPER)})")

        def leaf(v):
            a = np.asarray(v, np.float64)
            return a.reshape(-1, 1) if a.ndim else a

        hyper = {k: leaf(values.get(k, v)) for k, v in self.hyper.items()}
        out = object.__new__(type(self))
        out.hyper = dict(self.hyper)
        out.__dict__.update({k: v for k, v in self.__dict__.items() if k not in ("k", "hyper")})
        out.k = {name: torch.tensor(np.asarray(v), dtype=torch.float32, device=device)
                 for name, v in self._derive(**hyper).items()}
        return out

    def fields(self, state) -> Tuple[Tensors, ...]:
        return tuple(v for v in state if isinstance(v, dict))

    def _shared(self, state) -> tuple:
        return ()

    @torch.no_grad()
    def step(self, params: Tensors, grads: Tensors, state):
        """Update ``params`` and ``state`` in place from ``grads``; returns
        ``state``."""
        shared = self._shared(state)
        fields = self.fields(state)
        for k, p in params.items():
            p.add_(self._apply(grads[k], *(f[k] for f in fields), *shared))
        return state


class Adam(_Elementwise):
    """``optax.adam(lr, b1, b2, eps)`` over a dict of tensors."""

    HYPER = ("lr", "b1", "b2", "eps")

    def __init__(self, lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        super().__init__(lr=lr, b1=b1, b2=b2, eps=eps)

    def _derive(self, lr, b1, b2, eps):
        return dict(neg_lr=-lr, b1=b1, one_b1=1.0 - b1, b2=b2, one_b2=1.0 - b2, eps=eps)

    def init(self, params: Tensors, flat: bool = False) -> AdamState:
        device = next(iter(params.values())).device
        return AdamState(count=torch.zeros((), dtype=torch.int32, device=device),
                         mu=_field(params, 0.0, flat), nu=_field(params, 0.0, flat))

    def _shared(self, state):
        state.count.add_(1)
        t = state.count.to(torch.float32)
        return 1.0 - self.k["b1"] ** t, 1.0 - self.k["b2"] ** t

    def _apply(self, g, mu, nu, c1, c2):
        k = self.k
        mu.mul_(k["b1"]).add_(k["one_b1"] * g)
        nu.mul_(k["b2"]).add_(k["one_b2"] * (g * g))
        return ((mu / c1) / (torch.sqrt(nu / c2) + k["eps"])) * k["neg_lr"]


class Adagrad(_Elementwise):
    """``optax.adagrad(lr, initial_accumulator_value, eps)``; the initial
    accumulator is an init-time value, no hyperparameter of the chain."""

    HYPER = ("lr", "eps")

    def __init__(self, lr: float, initial_accumulator_value: float = 0.0, eps: float = 1e-10):
        super().__init__(lr=lr, eps=eps)
        self.initial = float(initial_accumulator_value)

    def _derive(self, lr, eps):
        return dict(neg_lr=-lr, eps=eps)

    def init(self, params: Tensors, flat: bool = False) -> AdagradState:
        return AdagradState(_field(params, self.initial, flat))

    def _apply(self, g, s):
        s.add_(g * g)
        scale = torch.where(s > 0, torch.rsqrt(s + self.k["eps"]), 0.0)
        return (scale * g) * self.k["neg_lr"]


class RmsProp(_Elementwise):
    """``optax.rmsprop(lr, decay, eps)`` (eps inside the root, no momentum)."""

    HYPER = ("lr", "decay", "eps")

    def __init__(self, lr: float, decay: float = 0.99, eps: float = 1e-8):
        super().__init__(lr=lr, decay=decay, eps=eps)

    def _derive(self, lr, decay, eps):
        return dict(neg_lr=-lr, decay=decay, one_decay=1.0 - decay, eps=eps)

    def init(self, params: Tensors, flat: bool = False) -> RmsPropState:
        return RmsPropState(_field(params, 0.0, flat))

    def _apply(self, g, nu):
        k = self.k
        nu.mul_(k["decay"]).add_(k["one_decay"] * (g * g))
        return (torch.rsqrt(nu + k["eps"]) * g) * k["neg_lr"]


class Sgd(_Elementwise):
    """``optax.sgd(lr)``: no momentum, no state."""

    HYPER = ("lr",)

    def __init__(self, lr: float):
        super().__init__(lr=lr)

    def _derive(self, lr):
        return dict(neg_lr=-lr)

    def init(self, params: Tensors, flat: bool = False) -> SgdState:
        return SgdState()

    def _apply(self, g):
        return g * self.k["neg_lr"]


class Flat:
    """``optax.flatten(inner)``: ``inner``'s chain once over the
    concatenation of every tensor (trainer.py:547-580), on ``FlatTensors``
    state; the state keeps ``inner``'s type and field names.

    ``members`` S > 0: every tensor carries a leading axis of S stacked
    members (``train/multi_seed.py``); the flat buffers are ``[S, N]``, one
    row per member in the solo order, so a per-member ``[S, 1]``
    hyperparameter (``_Elementwise.inject``) broadcasts over its row."""

    def __init__(self, inner: _Elementwise, members: int = 0):
        self.inner = inner
        self.members = int(members)

    def init(self, params: Tensors, flat: bool = True):
        if not self.members:
            return self.inner.init(params, flat=True)
        member = {k: p[0] for k, p in params.items()}
        state = self.inner.init(member, flat=True)
        return type(state)(**{
            field: flat_like(member, float(value.flat[0]), members=self.members)
            if isinstance(value, FlatTensors) else value
            for field, value in state._asdict().items()})

    @torch.no_grad()
    def step(self, params: Tensors, grads: Tensors, state):
        """Update ``params`` and ``state`` in place; returns ``state``.
        ``grads`` may be a ``FlatTensors`` in the buffers' order, whose
        vector is stepped as it is."""
        fields = self.inner.fields(state)
        if not all(isinstance(f, FlatTensors) for f in fields):
            raise TypeError("Flat steps a state made by Flat.init (FlatTensors fields)")
        names = list(fields[0]) if fields else list(params)  # the flat buffers' order
        tensors: List[torch.Tensor] = [params[k] for k in names]
        lead = (self.members,) if self.members else ()
        if (not lead and isinstance(grads, FlatTensors) and list(grads) == names
                and grads.flat.shape[-1] == sum(p.numel() for p in tensors)):
            g = grads.flat  # already one vector in this order (a mesh's reduced one)
        else:
            g = torch.cat([grads[k].reshape(*lead, -1) for k in names], dim=-1)
        delta = self.inner._apply(g, *(f.flat for f in fields), *self.inner._shared(state))
        parts = delta.split([p[0].numel() if lead else p.numel() for p in tensors], dim=-1)
        torch._foreach_add_(tensors, [d.view(p.shape) for d, p in zip(parts, tensors)])
        return state


def load_state_(state, loaded) -> None:
    """Copy a state of the same type, by field and name, INTO ``state``
    (whose tensors a captured step may read)."""
    for field, dst in state._asdict().items():
        src = getattr(loaded, field) if not isinstance(loaded, dict) else loaded[field]
        if isinstance(dst, dict):
            if set(dst) != set(src):
                raise ValueError(f"{field}: names {sorted(src)} do not match {sorted(dst)}")
            for k, t in dst.items():
                t.copy_(src[k])
        else:
            dst.copy_(src)


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
