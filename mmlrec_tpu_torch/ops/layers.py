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

from .initializers import normal_init, torch_linear_bias_init, torch_linear_kernel_init
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


class StackedMLP(nn.Module):
    """K parallel MLPs as stacked einsums (mmlrec_tpu/ops/layers.py:
    299-347).  Dropout follows each activation in training mode and is the
    identity at eval; its masks come from ``dropout_generator``, which the
    trainer sets and reseeds every step.  BatchNorm and the parameterised
    activations are ROADMAP A5."""

    def __init__(
        self,
        stack: int,
        in_dim: int,
        hidden_units: Sequence[int],
        *,
        generator: torch.Generator,
        activation: Optional[str] = "relu",
        dropout_rate: float = 0.0,
        use_bn: bool = False,
        init_std: float = 1e-4,
    ):
        super().__init__()
        if len(hidden_units) == 0:
            raise ValueError("hidden_units is empty!!")
        if use_bn:
            raise NotImplementedError("dnn_use_bn is not ported yet (ROADMAP A5)")
        self.act = activation_fn(activation)
        self.dropout_rate = float(dropout_rate)
        self.dropout_generator: Optional[torch.Generator] = None
        self.depth = len(hidden_units)
        fan_in = in_dim
        for i, units in enumerate(hidden_units):
            self.add_module(f"dense_{i}", StackedDense(
                stack, fan_in, units, generator=generator,
                kernel_init=normal_init(init_std),
                bias_init=torch_linear_bias_init(fan_in),
            ))
            fan_in = units

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        drop = self.training and self.dropout_rate > 0
        if drop and self.dropout_generator is None:
            raise RuntimeError(
                "dropout in training mode needs a generator: set "
                "RecModel.set_dropout_generator (the Trainer does)")
        for i in range(self.depth):
            x = self.act(getattr(self, f"dense_{i}")(x))
            if drop:
                x = dropout(x, self.dropout_rate, self.dropout_generator)
        return x


class PredictionHeads(nn.Module):
    """Per-task output layer (reference ``PredictionLayer``, model/utils.py:
    225-248; mmlrec_tpu/ops/layers.py:350-369): a learned scalar bias per
    task (init zero), then sigmoid for binary heads.

    The port fuses the tower's final ``[T, H] -> 1`` projection into the
    head: ``forward(tower, weights)`` is one multihead-score kernel computing
    ``is_binary * sigmoid(tower . w + b) + (1 - is_binary) * (tower . w + b)``.
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
