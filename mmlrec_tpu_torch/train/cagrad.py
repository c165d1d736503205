"""CAGrad, conflict-averse gradient descent (the port of
``mmlrec_tpu/train/cagrad.py``, cagrad.py:38-77).

From the per-task gradients ``G`` [K, P]:

    min_{w in simplex}  w^T GG 1/K + c sqrt(w^T GG w + 1e-8),
    GG = G G^T,   c = alpha sqrt(mean(GG) + 1e-8),
    d = (mean_i g_i + c / ||G^T w|| G^T w) / (1 + alpha^2)

The simplex program is solved as the JAX code solves it: ``opt_steps``
steps of gradient descent at ``opt_lr`` on softmax logits from zeros.  The
gradient of that [K] objective is written out (``_objective_grad``), so
the step is plain tensor ops without a host read, as a captured step
needs.

A split gradient (``group``: the tensors named in ``sharded`` are row
shards over it, ``pcgrad.py`` says how): ``GG`` is the replicated part
plus the shards' part summed over ``group``, and so is ``||G^T w||^2``
(two all-reduces).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

from .pcgrad import flatten, gram, sq_norms, unflatten


def _objective_grad(theta: torch.Tensor, GG: torch.Tensor, lin: torch.Tensor,
                    c: torch.Tensor) -> torch.Tensor:
    """d/dtheta of ``w GG 1/K + c sqrt(w GG w + 1e-8)`` at ``w =
    softmax(theta)``; ``lin = GG 1/K`` (GG is symmetric)."""
    w = torch.softmax(theta, dim=0)
    gw = GG @ w
    d_w = lin + c * gw / torch.sqrt(w @ gw + 1e-8)
    return w * (d_w - torch.dot(w, d_w))  # through the softmax


def cagrad_merge(task_grads: List[Dict[str, torch.Tensor]], alpha: float = 0.5,
                 opt_steps: int = 25, opt_lr: float = 0.5, sharded: Sequence[str] = (),
                 group: Optional[object] = None) -> Dict[str, torch.Tensor]:
    """Per-task gradient dicts -> the merged gradient dict; with ``group``,
    of a split gradient (module docstring)."""
    like = task_grads[0]
    G = torch.stack([flatten(g) for g in task_grads])  # [K, P]
    K = G.shape[0]
    GG = gram(task_grads, sharded, group)
    c = alpha * torch.sqrt(torch.mean(GG) + 1e-8)
    lin = GG @ torch.full((K,), 1.0 / K, dtype=G.dtype, device=G.device)
    theta = torch.zeros((K,), dtype=G.dtype, device=G.device)
    for _ in range(opt_steps):
        theta = theta - opt_lr * _objective_grad(theta, GG, lin, c)
    w = torch.softmax(theta, dim=0)
    gw = w @ G
    gw_sq = sq_norms([unflatten(gw, like)], sharded, group)[0]
    lmbda = c / torch.sqrt(gw_sq + 1e-8)
    d = (torch.mean(G, dim=0) + lmbda * gw) / (1.0 + alpha ** 2)
    return unflatten(d, like)
