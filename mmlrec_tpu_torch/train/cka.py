"""Linear CKA between domains' representations (the port of
``mmlrec_tpu/train/cka.py``, cka.py:17-36):
``CKA(X, Y) = ||Yc^T Xc||_F^2 / (||Xc^T Xc||_F ||Yc^T Yc||_F)`` on
column-centred matrices, summed over the domain pairs i < j."""

from __future__ import annotations

import torch


def linear_cka(x: torch.Tensor, y: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """x, y [B, F] -> the scalar CKA in [0, 1]."""
    xc = x - torch.mean(x, dim=0, keepdim=True)
    yc = y - torch.mean(y, dim=0, keepdim=True)
    hsic = torch.sum(torch.square(xc.T @ yc))
    norm_x = torch.sqrt(torch.sum(torch.square(xc.T @ xc)))
    norm_y = torch.sqrt(torch.sum(torch.square(yc.T @ yc)))
    return hsic / (norm_x * norm_y + eps)


def cka_domain_loss(last_layer: torch.Tensor, domain_mask: torch.Tensor,
                    alpha: float = 0.5) -> torch.Tensor:
    """``alpha`` times the sum over domain pairs i < j of the CKA between
    ``last_layer`` [B, F] masked to domain i and masked to domain j."""
    D = domain_mask.shape[-1]
    total = 0.0
    for i in range(D - 1):
        for j in range(i + 1, D):
            total = total + linear_cka(last_layer * domain_mask[:, i][:, None],
                                       last_layer * domain_mask[:, j][:, None])
    return alpha * total


def cka_domain_loss_sharded(last_layer: torch.Tensor, domain_mask: torch.Tensor, dp,
                            alpha: float = 0.5, eps: float = 1e-12) -> torch.Tensor:
    """``cka_domain_loss`` of the global batch whose rows ``[r B, (r + 1)
    B)`` this rank holds, ``dp`` the batch's data group: the per-domain
    column sums over every rank (one all-reduce, the count is ``world B``)
    centre the rank's rows, and the centred Gram terms ``Xc_i^T Xc_j`` of
    every domain pair (diagonal included) are summed over the ranks before
    the normalisation (one all-reduce).  Both reductions are
    ``ops.layers.all_reduce_sum``, differentiable, so each rank's rows get
    their part of the cotangent of the one global term."""
    from ..ops.layers import all_reduce_sum

    D = domain_mask.shape[-1]
    xs = [last_layer * domain_mask[:, i][:, None] for i in range(D)]
    n = last_layer.shape[0] * dp.world
    sums = all_reduce_sum(torch.stack([torch.sum(x, dim=0) for x in xs]), dp)
    xc = [x - (sums[i] / n)[None, :] for i, x in enumerate(xs)]
    pairs = [(i, j) for i in range(D) for j in range(i, D)]
    grams = all_reduce_sum(torch.stack([xc[i].T @ xc[j] for i, j in pairs]), dp)
    gram = dict(zip(pairs, grams))
    total = 0.0
    for i in range(D - 1):
        for j in range(i + 1, D):
            hsic = torch.sum(torch.square(gram[(i, j)]))
            norm_x = torch.sqrt(torch.sum(torch.square(gram[(i, i)])))
            norm_y = torch.sqrt(torch.sum(torch.square(gram[(j, j)])))
            total = total + hsic / (norm_x * norm_y + eps)
    return alpha * total
