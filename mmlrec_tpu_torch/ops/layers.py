"""Core NN primitives (the port of ``mmlrec_tpu/ops/layers.py``).

Every "list of K parallel layers" of the reference is one stacked parameter
``[K, in, out]`` contracted with one einsum, as in the JAX package; the
kernels keep that layout so that weights copy across unchanged.  Submodules
are named as the flax ones are (``dense_0``, ``kernel``, ``bias``), so a
state-dict key is the flax path with ``.`` for ``/``.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch
from torch import nn

from .initializers import (
    eye_init,
    lecun_normal_init,
    normal_init,
    torch_linear_bias_init,
    torch_linear_kernel_init,
    zeros_init,
)
from .kernels import multihead_score


def activation_fn(name: Optional[str]) -> Callable[[torch.Tensor], torch.Tensor]:
    """Stateless activations (reference model/utils.py:10-37)."""
    if name is None or name == "" or name.lower() == "linear":
        return lambda x: x
    name = name.lower()
    if name == "relu":
        return torch.relu
    if name == "sigmoid":
        return torch.sigmoid
    if name in ("prelu", "dice"):
        raise NotImplementedError(
            f"activation {name!r} carries parameters and is not ported yet "
            "(ROADMAP A5)")
    raise NotImplementedError(f"activation {name!r}")


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator) -> torch.Tensor:
    """``nn.Dropout`` semantics as the JAX package's ``ShardedDropout`` has
    them on one device (layers.py:133-160): a Bernoulli keep mask drawn from
    ``generator`` (on ``x``'s device), kept values scaled by ``1 / keep``."""
    if rate == 0.0:
        return x
    if rate == 1.0:
        return torch.zeros_like(x)
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` in plain tensor ops (mmlrec_tpu/ops/layers.py:
    244-251, 327-335): statistics over the batch axis, one pair per entry of
    ``feature_shape`` (``[F]`` inside ``MLP``, ``[K, F]`` inside
    ``StackedMLP``, matching K independent ``BatchNorm1d``s).

    In training mode the batch statistics normalise the input and move the
    running ones, ``running = momentum * running + (1 - momentum) * batch``.
    The variance is the biased one, computed as ``mean(x^2) - mean(x)^2``
    clipped at 0, and that is also what the running variance accumulates:
    ``nn.BatchNorm1d`` keeps the unbiased one and would part from flax after
    one step.  ``scale`` and ``bias`` are parameters, ``mean`` and ``var``
    buffers, named as the flax leaves.  Synced statistics across devices are
    ROADMAP A9."""

    def __init__(self, feature_shape: Sequence[int], *, momentum: float = 0.9,
                 eps: float = 1e-5):
        super().__init__()
        shape = tuple(int(n) for n in feature_shape)
        self.momentum, self.eps = float(momentum), float(eps)
        self.scale = nn.Parameter(torch.ones(shape))
        self.bias = nn.Parameter(torch.zeros(shape))
        self.register_buffer("mean", torch.zeros(shape))
        self.register_buffer("var", torch.ones(shape))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() != self.scale.dim() + 1:
            raise ValueError(f"BatchNorm over {tuple(self.scale.shape)} features expects one "
                             f"batch axis before them, got {tuple(x.shape)}")
        if self.training:
            mean = x.mean(dim=0)
            var = torch.clamp((x * x).mean(dim=0) - mean * mean, min=0.0)
            with torch.no_grad():
                self.mean.mul_(self.momentum).add_(mean, alpha=1.0 - self.momentum)
                self.var.mul_(self.momentum).add_(var, alpha=1.0 - self.momentum)
        else:
            mean, var = self.mean, self.var
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.scale) + self.bias


class _DNN(nn.Module):
    """What ``MLP`` and ``StackedMLP`` share: per layer ``dense_i``, BatchNorm
    ``bn_i`` before the activation when ``use_bn``, dropout after it in
    training mode (the identity at eval) with masks from the
    ``dropout_generator`` the trainer sets and reseeds every step.  A
    subclass builds the layers (``_dense``) and names the shape of one
    layer's BatchNorm statistics (``_bn_shape``).  The parameterised
    activations are ROADMAP A5."""

    def __init__(self, in_dim: int, hidden_units: Sequence[int], *, generator: torch.Generator,
                 activation: Optional[str], dropout_rate: float, use_bn: bool, init_std: float):
        super().__init__()
        if len(hidden_units) == 0:
            raise ValueError("hidden_units is empty!!")
        self.act = activation_fn(activation)
        self.dropout_rate = float(dropout_rate)
        self.dropout_generator: Optional[torch.Generator] = None
        self.depth, self.use_bn = len(hidden_units), bool(use_bn)
        fan_in = in_dim
        for i, units in enumerate(hidden_units):
            self.add_module(f"dense_{i}", self._dense(
                fan_in, units, generator=generator, kernel_init=normal_init(init_std),
                bias_init=torch_linear_bias_init(fan_in)))
            if use_bn:
                self.add_module(f"bn_{i}", BatchNorm(self._bn_shape(units)))
            fan_in = units

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        drop = self.training and self.dropout_rate > 0
        if drop and self.dropout_generator is None:
            raise RuntimeError(
                "dropout in training mode needs a generator: set "
                "RecModel.set_dropout_generator (the Trainer does)")
        for i in range(self.depth):
            x = getattr(self, f"dense_{i}")(x)
            if self.use_bn:
                x = getattr(self, f"bn_{i}")(x)
            x = self.act(x)
            if drop:
                x = dropout(x, self.dropout_rate, self.dropout_generator)
        return x


class Dense(nn.Module):
    """flax ``nn.Dense``: kernel ``[in, out]`` and bias ``[out]``; by default
    flax's own init (LeCun-normal kernel, zero bias)."""

    def __init__(self, in_dim: int, features: int, *, generator: torch.Generator,
                 use_bias: bool = True, kernel_init: Optional[Callable] = None,
                 bias_init: Optional[Callable] = None):
        super().__init__()
        self.kernel = nn.Parameter((kernel_init or lecun_normal_init())(generator, (in_dim, features)))
        self.bias = None
        if use_bias:
            self.bias = nn.Parameter((bias_init or zeros_init())(generator, (features,)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x @ self.kernel
        return y if self.bias is None else y + self.bias


class MLP(_DNN):
    """Multi-layer perceptron (reference ``DNN``, model/utils.py:92-161;
    mmlrec_tpu/ops/layers.py:217-261): ``Dense`` layers with a normal(0,
    init_std) kernel and torch's default bias; BatchNorm statistics per
    feature."""

    def __init__(self, in_dim: int, hidden_units: Sequence[int], *, generator: torch.Generator,
                 activation: Optional[str] = "relu", dropout_rate: float = 0.0,
                 use_bn: bool = False, init_std: float = 1e-4):
        super().__init__(in_dim, hidden_units, generator=generator, activation=activation,
                         dropout_rate=dropout_rate, use_bn=use_bn, init_std=init_std)

    def _dense(self, fan_in, units, **init):
        return Dense(fan_in, units, **init)

    def _bn_shape(self, units):
        return (units,)


class StackedDense(nn.Module):
    """K parallel Dense layers as one einsum (mmlrec_tpu/ops/layers.py:
    264-296).  Input [B, in] (broadcast to every stack member) or
    [B, K, in]; output [B, K, out]."""

    def __init__(
        self,
        stack: int,
        in_dim: int,
        features: int,
        *,
        generator: torch.Generator,
        use_bias: bool = True,
        kernel_init: Optional[Callable] = None,
        bias_init: Optional[Callable] = None,
    ):
        super().__init__()
        kinit = kernel_init or torch_linear_kernel_init()
        self.kernel = nn.Parameter(kinit(generator, (stack, in_dim, features)))
        self.bias = None
        if use_bias:
            binit = bias_init or torch_linear_bias_init(in_dim)
            self.bias = nn.Parameter(binit(generator, (stack, features)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() == 2:
            y = torch.einsum("bi,kio->bko", x, self.kernel)
        elif x.dim() == 3:
            y = torch.einsum("bki,kio->bko", x, self.kernel)
        else:
            raise ValueError(f"StackedDense expects rank 2/3 input, got {tuple(x.shape)}")
        if self.bias is not None:
            y = y + self.bias[None]
        return y


class StackedMLP(_DNN):
    """K parallel MLPs as stacked einsums (mmlrec_tpu/ops/layers.py:
    299-347): ``StackedDense`` layers; BatchNorm statistics per (stack,
    feature) pair."""

    def __init__(self, stack: int, in_dim: int, hidden_units: Sequence[int], *,
                 generator: torch.Generator, activation: Optional[str] = "relu",
                 dropout_rate: float = 0.0, use_bn: bool = False, init_std: float = 1e-4):
        self.stack = stack
        super().__init__(in_dim, hidden_units, generator=generator, activation=activation,
                         dropout_rate=dropout_rate, use_bn=use_bn, init_std=init_std)

    def _dense(self, fan_in, units, **init):
        return StackedDense(self.stack, fan_in, units, **init)

    def _bn_shape(self, units):
        return (self.stack, units)


class PredictionHeads(nn.Module):
    """Per-task output layer (reference ``PredictionLayer``, model/utils.py:
    225-248; mmlrec_tpu/ops/layers.py:350-369): a learned scalar bias per
    task (init zero), then sigmoid for binary heads.

    The port fuses the tower's final ``[T, H] -> 1`` projection into the
    head: ``forward(tower, weights)`` is one multihead-score kernel computing
    ``is_binary * sigmoid(tower . w + b) + (1 - is_binary) * (tower . w + b)``.
    ``from_logits`` is the JAX package's plain form, for logits that are no
    such product (the MLP family's one shared logit).
    """

    def __init__(self, task_types: Tuple[str, ...]):
        super().__init__()
        self.bias = nn.Parameter(torch.zeros(len(task_types)))
        binary = [1.0 if t == "binary" else 0.0 for t in task_types]
        self.register_buffer(
            "is_binary", torch.tensor(binary, dtype=torch.float32), persistent=False
        )

    def forward(self, tower: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
        """tower [B, T, H], weights [T, H] -> [B, T]."""
        return multihead_score(tower, weights, self.bias, self.is_binary)

    def from_logits(self, logits: torch.Tensor) -> torch.Tensor:
        """logits [B, T] (or [B, 1], broadcast to the T heads) -> [B, T],
        in plain tensor ops as in the JAX package (layers.py:361-369)."""
        out = logits + self.bias[None]
        return self.is_binary * torch.sigmoid(out) + (1.0 - self.is_binary) * out


class CrossStitchLayer(nn.Module):
    """Learned ``(T*F) x (T*F)`` mixing matrix, identity at init (reference
    model/cross_stitch.py:7-27; mmlrec_tpu/ops/layers.py:436-445).
    Input and output [B, T, F]."""

    def __init__(self, tasks: int, features: int, *, generator: torch.Generator):
        super().__init__()
        n = tasks * features
        self.cross_stitch_weight = nn.Parameter(eye_init()(generator, (n, n)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, f = x.shape
        return (x.reshape(b, t * f) @ self.cross_stitch_weight).reshape(b, t, f)


class AITMAttention(nn.Module):
    """AITM's two-token single-head attention transfer (reference
    model/aitm.py:44-49, 85-94; mmlrec_tpu/ops/layers.py:690-712): ``p`` is
    the information transferred from the previous task, ``q`` the task's own
    feature, both [B, F]; the output is their attention-weighted mix [B, dim]."""

    def __init__(self, in_dim: int, dim: int, *, generator: torch.Generator):
        super().__init__()
        self.dim = dim
        for name in ("h1", "h2", "h3"):
            self.add_module(name, Dense(
                in_dim, dim, generator=generator, kernel_init=torch_linear_kernel_init(),
                bias_init=torch_linear_bias_init(dim)))

    def forward(self, p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
        x = torch.stack([p, q], dim=1)  # [B, 2, F]
        V, K, Q = self.h1(x), self.h2(x), self.h3(x)
        att = torch.softmax(
            torch.sum(K * Q, dim=2, keepdim=True) / float(self.dim) ** 0.5, dim=1)
        return torch.sum(att * V, dim=1)
