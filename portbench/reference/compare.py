"""The numbers that decide ``correct``.

Training: step 1's loss; per leaf the norm of step 1's gradient, as
Adam's first moment holds it after one step; per leaf the norm of the
parameters' change over the steps.  The later steps' losses read the
round-off that Adam's step amplifies where a moment nearly cancels, and
swing from seed to seed (``later_loss_gap`` reads them, for the record);
the change holds the later steps instead.  Each is taken by its worst leaf as the
gap between the two sides' norms (not the norm of their difference),
against the reference's norm of that leaf or the median leaf's, whichever
is larger, since some gradients are all but zero.  Leaves whose reference
gradient is under a thousandth of the median leaf's move by round-off
alone under Adam and are left out of the change.

Serving: the widest gap between a served probability and the
reference's.
"""

from __future__ import annotations

import statistics
from typing import Dict, List

import torch

#: a leaf whose step-1 gradient norm is under this share of the median
#: leaf's is left out of the change
STILL_LEAF = 1e-3


def norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in tensors.items()}


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], keys: List[str]) -> Dict[str, float]:
    """Each leaf's gap of norms against its reference norm or the median
    leaf's, whichever is larger."""
    floor = statistics.median(ref[k] for k in keys)
    return {k: abs(prog[k] - ref[k]) / max(ref[k], floor, 1e-30) for k in keys}


def worst_gap(prog: Dict[str, float], ref: Dict[str, float], keys: List[str]) -> float:
    return max(leaf_gaps(prog, ref, keys).values())


def training_numbers(losses_prog: List[float], losses_ref: List[float],
                     grads_prog: Dict[str, torch.Tensor], grads_ref: Dict[str, torch.Tensor],
                     change_prog: Dict[str, torch.Tensor],
                     change_ref: Dict[str, torch.Tensor]) -> Dict[str, float]:
    loss_gap = abs(losses_prog[0] - losses_ref[0]) / max(abs(losses_ref[0]), 1e-30)
    g_ref = norms(grads_ref)
    keys = sorted(g_ref)
    grad_gap = worst_gap(norms(grads_prog), g_ref, keys)
    floor = statistics.median(g_ref[k] for k in keys)
    moving = [k for k in keys if g_ref[k] >= STILL_LEAF * floor]
    change_gap = worst_gap(norms(change_prog), norms(change_ref), moving)
    return {"loss_gap": loss_gap, "grad_norm_gap": grad_gap, "change_norm_gap": change_gap}


def later_loss_gap(losses_prog: List[float], losses_ref: List[float]) -> float:
    """The widest relative gap of the steps' losses after the first."""
    return max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(losses_prog[1:], losses_ref[1:]))


def worst_leaves(grads_prog, grads_ref, change_prog, change_ref, top: int = 3) -> Dict:
    """The leaves behind the gradient's and the change's gaps, worst
    first, with the reference's norms: what a look at a seed that reads
    high starts from."""
    g_ref, c_ref = norms(grads_ref), norms(change_ref)
    keys = sorted(g_ref)
    floor = statistics.median(g_ref[k] for k in keys)
    moving = [k for k in keys if g_ref[k] >= STILL_LEAF * floor]
    out = {}
    for tag, gaps, ref in (("grad", leaf_gaps(norms(grads_prog), g_ref, keys), g_ref),
                           ("change", leaf_gaps(norms(change_prog), c_ref, moving), c_ref)):
        worst = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
        out[tag] = [[k, v, ref[k]] for k, v in worst]
    out["still"] = sorted(set(keys) - set(moving))
    return out
