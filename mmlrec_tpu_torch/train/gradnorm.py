"""GradNorm, gradient-norm loss balancing (the port of
``mmlrec_tpu/train/gradnorm.py``, gradnorm.py:31-49).

Per step, from the per-task gradient dicts of ``w_i * L_i``:

    G_i      = || g_i ||, over every parameter
    r_i      = (L_i / L_i(0)) / mean_j(L_j / L_j(0))
    target_i = mean_j G_j * r_i ** alpha            (a constant)
    dw_i     = sign(G_i - target_i) * G_i / w_i

and the weights take one SGD step at ``lr``, floored at 1e-3 and
renormalised to sum to T.  The norm runs over every parameter, as the
JAX code does (its docstring's "shared params" is not what it computes).
Plain tensor ops, no host read.  A split gradient (``group``: the tensors
named in ``sharded`` are row shards over it, ``pcgrad.py`` says how): each
norm is the replicated part plus the shards' part summed over ``group``,
one all-reduce of the T squared parts.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from .pcgrad import sq_norms


def gradnorm_update(
    weights: torch.Tensor,
    task_losses: torch.Tensor,
    initial_losses: torch.Tensor,
    task_grads: List[Dict[str, torch.Tensor]],
    alpha: float = 1.5,
    lr: float = 0.025,
    sharded: Sequence[str] = (),
    group: Optional[object] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(new weights [T], norms [T]) from the weights [T], the unweighted
    losses [T], the losses of the first step [T] and the gradients of
    ``w_i * L_i``; with ``group``, of a split gradient (module docstring)."""
    T = weights.shape[0]
    norms = torch.sqrt(sq_norms(task_grads, sharded, group) + 1e-12)
    loss_ratio = task_losses / torch.clamp(initial_losses, min=1e-12)
    inv_rate = loss_ratio / torch.mean(loss_ratio)
    target = (torch.mean(norms) * inv_rate ** alpha).detach()
    raw = norms / torch.clamp(weights, min=1e-12)
    dw = torch.sign(norms - target) * raw
    new_w = torch.clamp(weights - lr * dw, min=1e-3)
    return new_w * (T / torch.sum(new_w)), norms
