"""STAR's partitioned (per-domain) batch normalization (reference
``DomainBatchNorm``, model/utils.py:553-636; the port of
``mmlrec_tpu/ops/domain_norm.py``).

Two modes (``model_config.domain_bn_mode``):

* ``reference``: what the reference does in training, where
  ``F.batch_norm(..., training=True)`` normalises the whole batch by the
  whole batch's statistics whatever the domain; only ``gamma`` / ``beta``
  are per domain.
* ``intended``: each domain's rows are normalised by that domain's masked
  batch statistics.

In both, a training call moves the per-domain population statistics
``pop_mean`` / ``pop_var`` (decay 0.99) by the domain-masked batch
statistics, with the unbiased variance (torch ``Tensor.var``), and leaves a
domain absent from the batch alone; eval normalises by them.  Normalisation
uses the biased variance, eps 1e-5.  The whole-batch variance of
``reference`` mode is the two-pass one (``jnp.var``), the per-domain
variance ``E[x^2] - E[x]^2`` clipped at 0, as in the JAX module.

In a batch shard of a data-parallel step (``layers.batch_shard``) the
statistics are the global batch's (the JAX module's ``gsum``,
domain_norm.py:40-60): the per-domain counts, masked sums and masked sums
of squares are summed over the group in one ``all_reduce_sum``, and the
whole-batch moments are the rank moments summed and divided by the group's
size (equal shards), each pass of the two-pass variance in turn; with one
rank the values are the unsharded ones.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .layers import all_reduce_sum, current_batch_shard


class DomainBatchNorm(nn.Module):
    """[B, F] rows and their [B, D] one-hot domain mask -> [B, F].
    ``gamma`` / ``beta`` [D, F] are parameters, ``pop_mean`` / ``pop_var``
    [D, F] persistent buffers (the flax ``batch_stats``).  A module called
    several times in one training forward (STAR calls it once per pathway)
    moves its statistics at each call, each call reading what the previous
    one wrote, as flax's mutable collection does."""

    def __init__(self, num_features: int, num_domains: int, *, decay: float = 0.99,
                 eps: float = 1e-5, mode: str = "reference"):
        super().__init__()
        if mode not in ("reference", "intended"):
            raise ValueError(f"domain_bn_mode must be reference|intended, got {mode!r}")
        shape = (int(num_domains), int(num_features))
        self.decay, self.eps, self.mode = float(decay), float(eps), mode
        self.gamma = nn.Parameter(torch.ones(shape))
        self.beta = nn.Parameter(torch.zeros(shape))
        self.register_buffer("pop_mean", torch.zeros(shape))
        self.register_buffer("pop_var", torch.ones(shape))

    def _batch_moments(self, x: torch.Tensor):
        dp = current_batch_shard()
        m = x.mean(dim=0, keepdim=True)
        if dp is not None:
            m = all_reduce_sum(m, dp) / dp.world
        v = torch.square(x - m).mean(dim=0, keepdim=True)
        if dp is not None:
            v = all_reduce_sum(v, dp) / dp.world
        return m, v

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
        if mask is None:  # reference model/utils.py:609-611: plain, no affine
            m, v = self._batch_moments(x)
            return (x - m) / torch.sqrt(v + self.eps)
        mask = mask.to(x.dtype)
        if self.training:
            counts = mask.sum(dim=0)  # [D]
            msum, sqsum = mask.t() @ x, mask.t() @ (x * x)
            dp = current_batch_shard()
            if dp is not None:
                F = x.shape[1]
                sums = all_reduce_sum(torch.cat([counts[:, None], msum, sqsum], dim=1), dp)
                counts, msum, sqsum = sums[:, 0], sums[:, 1:1 + F], sums[:, 1 + F:]
            safe = torch.clamp(counts, min=1.0)[:, None]
            dom_mean = msum / safe
            sq = sqsum / safe
            dom_var = torch.clamp(sq - dom_mean * dom_mean, min=0.0)
            with torch.no_grad():
                unbiased = dom_var * (safe / torch.clamp(counts - 1.0, min=1.0)[:, None])
                new_mean = self.pop_mean * self.decay + dom_mean * (1.0 - self.decay)
                new_var = self.pop_var * self.decay + unbiased * (1.0 - self.decay)
                present = (counts > 0)[:, None]
                self.pop_mean.copy_(torch.where(present, new_mean, self.pop_mean))
                self.pop_var.copy_(torch.where(present, new_var, self.pop_var))
            if self.mode == "reference":
                m, v = self._batch_moments(x)
                normed = (x[:, None, :] - m[:, None, :]) / torch.sqrt(v[:, None, :] + self.eps)
            else:
                normed = (x[:, None, :] - dom_mean[None]) / torch.sqrt(dom_var[None] + self.eps)
        else:
            normed = (x[:, None, :] - self.pop_mean[None]) / torch.sqrt(self.pop_var[None] + self.eps)
        out = normed * self.gamma[None] + self.beta[None]  # [B, D, F]
        return torch.einsum("bd,bdf->bf", mask, out)
