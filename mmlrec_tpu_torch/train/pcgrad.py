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
"""

from __future__ import annotations

from typing import Dict, List

import torch


def flatten(grads: Dict[str, torch.Tensor]) -> torch.Tensor:
    return torch.cat([g.reshape(-1) for g in grads.values()])


def unflatten(vec: torch.Tensor, like: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    out, at = {}, 0
    for name, t in like.items():
        out[name] = vec[at:at + t.numel()].view(t.shape)
        at += t.numel()
    return out


def pcgrad_merge(task_grads: List[Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    """Per-task gradient dicts -> the merged gradient dict."""
    like = task_grads[0]
    G = torch.stack([flatten(g) for g in task_grads])  # [T, P]
    sq = torch.sum(G * G, dim=1)
    projected = []
    for i in range(G.shape[0]):
        gi = G[i]
        for j in range(G.shape[0]):
            dot = torch.dot(gi, G[j])
            coef = torch.where(dot < 0, dot / (sq[j] + 1e-12), torch.zeros_like(dot))
            gi = gi - coef * G[j]
        projected.append(gi)
    pc = torch.stack(projected)
    mean, total = unflatten(pc.mean(dim=0), like), unflatten(pc.sum(dim=0), like)
    out = {}
    for name in like:
        shared = torch.stack([torch.any(g[name] != 0) for g in task_grads]).all()
        out[name] = torch.where(shared, mean[name], total[name])
    return out
