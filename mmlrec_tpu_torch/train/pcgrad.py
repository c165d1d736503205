"""PCGrad, projecting conflicting gradients (the port of
``mmlrec_tpu/train/pcgrad.py``, pcgrad.py:40-80).

Takes one gradient dict per task (parameter name -> tensor, every dict
with the same names in the same order):

1. each task's gradient flattened into one vector, ``G`` [T, P];
2. each ``g_i`` projected, in task order (no shuffle), against every
   ``g_j`` of ``G`` (itself included):
   ``g_i -= (g_i . g_j) g_j / (||g_j||^2 + 1e-12)`` where ``g_i . g_j < 0``;
3. merged per tensor: the mean over tasks where every task's gradient of
   that tensor has a nonzero entry (a "shared" tensor), the sum elsewhere.

Plain tensor ops on the gradients' device, no host read: the step that
calls it can be captured as a CUDA graph.

**A split gradient** (``group``, a row-sharded table): the tensors named in
``sharded`` are this rank's row shards of tensors split over the process
``group``; every other tensor is replicated over it.  A dot product or a
norm is then the replicated tensors' part, computed here and never summed
over ``group``, plus the shards' part, summed over ``group``.  Each
projected ``g_i`` is a linear combination of the rows of ``G``, so one
all-reduce of the shards' ``[T, T]`` Gram matrix serves every dot product
of the merge (``gram``); the "shared" test of a sharded tensor is an
``any`` over ``group`` (one all-reduce MAX).  The merged gradient comes
back split the same way.  The JAX package computes the whole vectors
under GSPMD: the same values, the sums in another order.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist


def flatten(grads: Dict[str, torch.Tensor]) -> torch.Tensor:
    return torch.cat([g.reshape(-1) for g in grads.values()])


def unflatten(vec: torch.Tensor, like: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    out, at = {}, 0
    for name, t in like.items():
        out[name] = vec[at:at + t.numel()].view(t.shape)
        at += t.numel()
    return out


def _part(grads: Dict[str, torch.Tensor], names) -> torch.Tensor:
    parts = [grads[k].reshape(-1) for k in names]
    return torch.cat(parts) if parts else next(iter(grads.values())).new_zeros(0)


def gram(task_grads: List[Dict[str, torch.Tensor]], sharded: Sequence[str] = (),
         group=None) -> torch.Tensor:
    """``G G^T`` [T, T] of the task gradients over every tensor: the
    replicated tensors' part here plus the ``sharded`` tensors' part, with
    ``group`` summed over it by one all-reduce."""
    names = list(task_grads[0])
    rep = [k for k in names if k not in sharded]
    shd = [k for k in names if k in sharded]
    G = torch.stack([_part(g, rep) for g in task_grads])
    S = torch.stack([_part(g, shd) for g in task_grads])
    part = S @ S.T
    if group is not None:
        dist.all_reduce(part, group=group)
    return G @ G.T + part


def sq_norms(grads: List[Dict[str, torch.Tensor]], sharded: Sequence[str] = (),
             group=None) -> torch.Tensor:
    """[N] squared norms of N gradient dicts over every tensor, each a sum
    of its tensors' in order: the replicated tensors' part here plus the
    ``sharded`` tensors' part, with ``group`` summed over it by one
    all-reduce."""
    def sq(g, names):
        return sum((torch.sum(torch.square(g[k])) for k in names), g[next(iter(g))].new_zeros(()))

    names = list(grads[0])
    shd = torch.stack([sq(g, [k for k in names if k in sharded]) for g in grads])
    if group is not None:
        dist.all_reduce(shd, group=group)
    return shd + torch.stack([sq(g, [k for k in names if k not in sharded]) for g in grads])


def any_nonzero(task_grads: List[Dict[str, torch.Tensor]], sharded: Sequence[str] = (),
                group=None) -> Dict[str, torch.Tensor]:
    """Per tensor, [T] bool: whether task i's gradient of it has an entry
    that is not zero, anywhere: a ``sharded`` tensor's flags are the MAX
    over ``group`` (one all-reduce)."""
    flags = {k: torch.stack([torch.any(g[k] != 0) for g in task_grads]) for k in task_grads[0]}
    shd = [k for k in flags if k in sharded]
    if group is not None and shd:
        both = torch.stack([flags[k] for k in shd]).to(torch.int32)
        dist.all_reduce(both, op=dist.ReduceOp.MAX, group=group)
        flags.update({k: row.bool() for k, row in zip(shd, both)})
    return flags


def pcgrad_merge(task_grads: List[Dict[str, torch.Tensor]], sharded: Sequence[str] = (),
                 group: Optional[object] = None) -> Dict[str, torch.Tensor]:
    """Per-task gradient dicts -> the merged gradient dict; with ``group``,
    of a split gradient (module docstring)."""
    like = task_grads[0]
    G = torch.stack([flatten(g) for g in task_grads])  # [T, P]
    T = G.shape[0]
    GG = gram(task_grads, sharded, group)
    sq = torch.diagonal(GG)
    eye = torch.eye(T, dtype=G.dtype, device=G.device)
    projected = []
    for i in range(T):  # g_i as coefficients c_i over the rows of G: g_i . g_j = c_i . GG[:, j]
        gi, ci = G[i], eye[i]
        for j in range(T):
            dot = torch.dot(ci, GG[:, j])
            coef = torch.where(dot < 0, dot / (sq[j] + 1e-12), torch.zeros_like(dot))
            gi = gi - coef * G[j]
            ci = ci - coef * eye[j]
        projected.append(gi)
    pc = torch.stack(projected)
    mean, total = unflatten(pc.mean(dim=0), like), unflatten(pc.sum(dim=0), like)
    flags = any_nonzero(task_grads, sharded, group)
    return {name: torch.where(flags[name].all(), mean[name], total[name]) for name in like}
