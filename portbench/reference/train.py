"""The reference of a training cell's first steps: the configuration's
model (``reference/model.py``) on the touched rows of its table, the sum
of the heads' binary cross-entropies (the reference MMLRec's
``F.binary_cross_entropy(reduction="sum")`` per head), one backward by
autograd, Adam on the dense parameters (optax.adam: bias-corrected, no
weight decay; the configuration's ``weight_decay`` is read by no code of
the reference MMLRec) and lazy Adam on the table's touched logical rows
(each row's gradient summed over its occurrences in the batch; untouched
rows and their moments keep their values; one step count for all), its
moments stored in the configuration's ``table_opt_dtype`` (rounded to
nearest even) and the step taken from the float32 moments before the
rounding.

Everything is float32 with TF32 off, unless ``tf32=True``: the control,
the same arithmetic with TF32 matmuls, the precision just below the one
the configuration states.  ``fault="half"`` leaves half of each batch out
and takes the mean over the rest (the loss of the first half, doubled).
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, NamedTuple, Optional

import torch
import torch.nn.functional as F

from .dims import B1, B2, EPS, Dims
from .model import TABLE, family

_MOMENT = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


class Steps(NamedTuple):
    losses: List[float]  # each step's loss, as the step reports it
    grads: Dict[str, torch.Tensor]  # step 1's gradient as Adam's first moment holds it
    params: Dict[str, torch.Tensor]  # after the last step; the table's touched rows as TABLE


@contextlib.contextmanager
def matmul_precision(tf32: bool):
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def loss_fn(probs: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return sum(F.binary_cross_entropy(probs[:, i], y[:, i], reduction="sum")
               for i in range(probs.shape[1]))


def run_steps(d: Dims, dense: Dict[str, torch.Tensor], rows: torch.Tensor, table0: torch.Tensor,
              batches: List[tuple], tf32: bool = False, fault: Optional[str] = None) -> Steps:
    """``batches``: per step (local row index [B, n_sparse] into ``rows``,
    dense [B, n_dense], labels [B, heads]), on one device; ``rows`` the
    sorted logical rows the steps touch, ``table0`` their initial values."""
    fam = family(d.model_name)
    params = {k: v.clone() for k, v in dense.items()}
    mu = {k: torch.zeros_like(v) for k, v in params.items()}
    nu = {k: torch.zeros_like(v) for k, v in params.items()}
    table = table0.clone()
    mdt = _MOMENT[d.moment_dtype]
    t_mu = torch.zeros_like(table, dtype=mdt)
    t_nu = torch.zeros_like(table, dtype=mdt)
    losses, grads = [], {}
    with matmul_precision(tf32):
        for step, (loc, dn, y) in enumerate(batches, start=1):
            leaves = {k: v.requires_grad_(True) for k, v in params.items()}
            emb = table[loc].requires_grad_(True)
            x = torch.cat([emb.flatten(1), dn], dim=1)
            if fault == "half":
                h = x.shape[0] // 2
                loss = 2.0 * loss_fn(fam.forward(leaves, x[:h], d), y[:h])
            else:
                loss = loss_fn(fam.forward(leaves, x, d), y)
            g = torch.autograd.grad(loss, [*leaves.values(), emb])
            losses.append(float(loss.detach()))
            c1, c2 = 1.0 - B1 ** step, 1.0 - B2 ** step
            with torch.no_grad():
                params = {k: v.detach() for k, v in params.items()}
                for (k, p), gk in zip(params.items(), g[:-1]):
                    mu[k] = B1 * mu[k] + (1.0 - B1) * gk
                    nu[k] = B2 * nu[k] + (1.0 - B2) * gk * gk
                    p -= d.lr * (mu[k] / c1) / (torch.sqrt(nu[k] / c2) + EPS)
                g_sum = torch.zeros_like(table).index_add_(
                    0, loc.reshape(-1), g[-1].reshape(-1, d.emb))
                hit = torch.zeros(table.shape[0], dtype=torch.bool, device=table.device)
                hit[loc.reshape(-1)] = True
                new_mu = B1 * t_mu[hit].float() + (1.0 - B1) * g_sum[hit]
                new_nu = B2 * t_nu[hit].float() + (1.0 - B2) * g_sum[hit] * g_sum[hit]
                table[hit] -= d.lr * (new_mu / c1) / (torch.sqrt(new_nu / c2) + EPS)
                t_mu[hit], t_nu[hit] = new_mu.to(mdt), new_nu.to(mdt)
            if step == 1:
                grads = {k: mu[k] / (1.0 - B1) for k in params}
                grads[TABLE] = t_mu.float() / (1.0 - B1)
    params = dict(params)
    params[TABLE] = table
    return Steps(losses, grads, params)
