"""Parameter initializers matching the reference's PyTorch init choices
(the port of ``mmlrec_tpu/ops/initializers.py``).

* DNN / embedding weights: ``normal(0, init_std)`` with ``init_std=1e-4``
  (reference model/utils.py:140-142, 485-486).
* Plain ``nn.Linear`` layers keep PyTorch's default
  U(-1/sqrt(fan_in), +1/sqrt(fan_in)) for kernel and bias.
* The layers that the JAX package leaves to flax's ``nn.Dense`` defaults keep
  them: a LeCun-normal kernel (``lecun_normal_init``) and a zero bias.
* Cross-stitch matrices start as the identity (``eye_init``).
* The SNR gates' transforms and APG's shared matrices are Xavier draws
  (``xavier_normal_init``, ``xavier_uniform_init``), a gate's ``u`` and
  ``alpha`` uniform in a range, an open gate's ``alpha`` a constant.

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


def lecun_normal_init():
    """flax's default ``nn.Dense`` kernel init: a normal truncated at two
    standard deviations, scaled so that the draws have variance
    ``1 / fan_in`` (``jax.nn.initializers.lecun_normal``)."""
    lo, hi = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0))), 0.5 * (1.0 + math.erf(2.0 / math.sqrt(2.0)))
    truncated_std = 0.87962566103423978  # of a standard normal cut at +-2

    def init(gen: torch.Generator, shape: Sequence[int]) -> torch.Tensor:
        fan_in = shape[-2]
        u = torch.rand(tuple(shape), generator=gen, dtype=torch.float32, device=gen.device)
        x = math.sqrt(2.0) * torch.erfinv(2.0 * (lo + (hi - lo) * u) - 1.0)
        return x.clamp_(-2.0, 2.0) * (math.sqrt(1.0 / max(fan_in, 1)) / truncated_std)

    return init


def zeros_init():
    def init(gen: torch.Generator, shape: Sequence[int]) -> torch.Tensor:
        return torch.zeros(tuple(shape), dtype=torch.float32, device=gen.device)

    return init


def eye_init():
    """The identity, broadcast over any leading axes
    (mmlrec_tpu/ops/initializers.py:71)."""

    def init(gen: torch.Generator, shape: Sequence[int]) -> torch.Tensor:
        if len(shape) < 2 or shape[-1] != shape[-2]:
            raise ValueError(f"eye_init needs a square trailing shape, got {tuple(shape)}")
        eye = torch.eye(shape[-1], dtype=torch.float32, device=gen.device)
        return eye.expand(tuple(shape)).clone()

    return init


def xavier_uniform_init():
    """U(+-sqrt(6 / (fan_in + fan_out))) with the fans ``shape[-2]`` and
    ``shape[-1]`` alone, as mmlrec_tpu/ops/initializers.py:44 has them (not
    flax's receptive-field fans)."""

    def init(gen: torch.Generator, shape: Sequence[int]) -> torch.Tensor:
        return _uniform(gen, shape, math.sqrt(6.0 / (shape[-2] + shape[-1])))

    return init


def xavier_normal_init():
    """normal(0, sqrt(2 / (fan_in + fan_out))), fans as ``xavier_uniform_init``."""

    def init(gen: torch.Generator, shape: Sequence[int]) -> torch.Tensor:
        return normal_init(math.sqrt(2.0 / (shape[-2] + shape[-1])))(gen, shape)

    return init


def uniform_range_init(low: float, high: float):
    """U(low, high)."""

    def init(gen: torch.Generator, shape: Sequence[int]) -> torch.Tensor:
        u = torch.rand(tuple(shape), generator=gen, dtype=torch.float32, device=gen.device)
        return low + (high - low) * u

    return init


def constant_init(value: float):
    def init(gen: torch.Generator, shape: Sequence[int]) -> torch.Tensor:
        return torch.full(tuple(shape), float(value), dtype=torch.float32, device=gen.device)

    return init
