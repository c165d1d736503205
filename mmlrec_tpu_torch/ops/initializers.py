"""Parameter initializers matching the reference's PyTorch init choices
(the port of ``mmlrec_tpu/ops/initializers.py``).

* DNN / embedding weights: ``normal(0, init_std)`` with ``init_std=1e-4``
  (reference model/utils.py:140-142, 485-486).
* Plain ``nn.Linear`` layers keep PyTorch's default
  U(-1/sqrt(fan_in), +1/sqrt(fan_in)) for kernel and bias.

Kernels keep the JAX layout ``[..., in, out]``; fan_in is ``shape[-2]``.
Each init draws from an explicit ``torch.Generator``, on its device (the
host by default; a CUDA generator draws a full-width table on the card).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch


def normal_init(std: float = 1e-4):
    def init(gen: torch.Generator, shape: Sequence[int]) -> torch.Tensor:
        return std * torch.randn(tuple(shape), generator=gen, dtype=torch.float32,
                           device=gen.device)

    return init


def _uniform(gen, shape, bound):
    u = torch.rand(tuple(shape), generator=gen, dtype=torch.float32, device=gen.device)
    return (2.0 * u - 1.0) * bound


def torch_linear_kernel_init():
    """U(+-1/sqrt(fan_in)); fan_in = kernel shape[-2]."""

    def init(gen: torch.Generator, shape: Sequence[int]) -> torch.Tensor:
        fan_in = shape[-2]
        bound = 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0
        return _uniform(gen, shape, bound)

    return init


def torch_linear_bias_init(fan_in: int):
    def init(gen: torch.Generator, shape: Sequence[int]) -> torch.Tensor:
        bound = 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0
        return _uniform(gen, shape, bound)

    return init
