"""Multi-task / multi-scenario losses (the port of
``mmlrec_tpu/train/losses.py``, losses.py:25-230).

Sum-reduced per-head losses summed over heads (reference
model/basemodel.py:270-298); ``sample_weight`` [B] zero-weights the padded
rows of a last partial batch and carries the intended domain masking.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

_EPS = 1e-12
# torch F.binary_cross_entropy clamps log terms at -100.
_LOG_CLAMP = -100.0


def bce_elementwise(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    logp = torch.clamp(torch.log(torch.clamp(pred, min=_EPS)), min=_LOG_CLAMP)
    log1mp = torch.clamp(torch.log(torch.clamp(1.0 - pred, min=_EPS)), min=_LOG_CLAMP)
    return -(target * logp + (1.0 - target) * log1mp)


def mse_elementwise(pred, target):
    return torch.square(pred - target)


def mae_elementwise(pred, target):
    return torch.abs(pred - target)


_LOSS_FNS = {
    "binary_crossentropy": bce_elementwise,
    "mse": mse_elementwise,
    "mae": mae_elementwise,
}


def get_loss_fn(name: str):
    if name not in _LOSS_FNS:
        raise NotImplementedError(f"loss {name!r}")
    return _LOSS_FNS[name]


def escm_loss(
    probs: torch.Tensor,
    y: torch.Tensor,
    weight: torch.Tensor,
    loss_names: Sequence[str],
    counterfactual_w: float = 0.1,
    global_w: float = 1.0,
) -> torch.Tensor:
    """ESCM^2 objective (reference basemodel.py:284-292, escm.py:99-111;
    losses.py:52-89).

    probs columns: [pCTR, pCVR, pCTCVR(, pIMP)]; y columns: [ctr_label,
    cvr_label].  loss = L(ctr) + 0.1 * IPW(L(cvr)) + 1.0 * L(ctcvr vs
    cvr_label).

    As in the reference, loss_1 is the *scalar* sum-reduced CVR loss
    multiplied by the per-sample inverse propensity, and gradients DO flow
    through the propensity (pCTR).  The reference multiplies the propensity
    by the batch length and then takes a mean over the same length, so the
    length cancels and padded rows (weight 0) add nothing: exact for any
    last-batch size.
    """
    fns = [get_loss_fn(n) for n in list(loss_names)[:2]]
    w = weight
    loss_0 = torch.sum(fns[0](probs[:, 0], y[:, 0]) * w)
    loss_1 = torch.sum(fns[1](probs[:, 1], y[:, 1]) * w)
    loss_2 = torch.sum(fns[1](probs[:, 2], y[:, 1]) * w)

    o = y[:, 0] * w
    ctr_num = torch.sum(o)
    ps = torch.clamp(probs[:, 0] * ctr_num, min=1e-6)
    ips = torch.clamp(1.0 / ps, -15.0, 15.0) * float(o.shape[0])
    loss_1 = torch.mean(loss_1 * ips * o)
    return loss_0 + counterfactual_w * loss_1 + global_w * loss_2


def multitask_loss(
    probs: torch.Tensor,
    y: torch.Tensor,
    sample_weight: torch.Tensor,
    loss_names: Sequence[str],
    task_name: str,
    num_domains: int,
    domain_mask: Optional[torch.Tensor] = None,
    model_name: str = "",
    loss_weights: Optional[Sequence[float]] = None,
) -> torch.Tensor:
    """Total training loss for one batch (losses.py:92-132): per head
    ``sum_b loss(pred_i, y_i) * w``, with ``w`` the sample weight times the
    domain mask of head i (msl: domain i, mtmsl: domain i % D) when one is
    given, and the optional per-head ``loss_weights``.  ESCM takes its
    entire-space objective (``escm_loss``) over its two label columns."""
    if model_name in ("escm", "escm_dr"):
        return escm_loss(probs, y, sample_weight, loss_names)
    num_tasks = probs.shape[-1]
    fns = [get_loss_fn(n) for n in list(loss_names)[:num_tasks]]
    if len(fns) < num_tasks:
        fns = fns + [fns[-1]] * (num_tasks - len(fns))
    total = 0.0
    for i in range(num_tasks):
        w = sample_weight
        if domain_mask is not None:
            if task_name == "msl":
                w = w * domain_mask[:, i]
            elif task_name == "mtmsl":
                w = w * domain_mask[:, i % num_domains]
        head = torch.sum(fns[i](probs[:, i], y[:, i]) * w)
        if loss_weights is not None:
            head = head * loss_weights[i % len(loss_weights)]
        total = total + head
    return total


def per_task_losses(
    probs: torch.Tensor,
    y: torch.Tensor,
    sample_weight: torch.Tensor,
    loss_names: Sequence[str],
    task_name: str,
    num_domains: int,
    domain_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The heads' sum-reduced losses as a [T] vector, weighted as in
    ``multitask_loss`` but without ``loss_weights`` (losses.py:135-157;
    GradNorm's ``L_i``)."""
    num_tasks = probs.shape[-1]
    fns = [get_loss_fn(n) for n in list(loss_names)[:num_tasks]]
    if len(fns) < num_tasks:
        fns = fns + [fns[-1]] * (num_tasks - len(fns))
    out = []
    for i in range(num_tasks):
        w = sample_weight
        if domain_mask is not None:
            if task_name == "msl":
                w = w * domain_mask[:, i]
            elif task_name == "mtmsl":
                w = w * domain_mask[:, i % num_domains]
        out.append(torch.sum(fns[i](probs[:, i], y[:, i]) * w))
    return torch.stack(out)


def l2_regularization(
    params: Dict[str, torch.Tensor],
    l2_embedding: float,
    l2_dnn: float,
    dnn_prefixes: Optional[Sequence[str]] = None,
    l2_linear: float = 0.0,
) -> torch.Tensor:
    """L2 penalty (losses.py:162-230) over named parameters (``a.b.kernel``
    for the flax path ``a/b/kernel``): embeddings at ``l2_embedding``; a
    weight-like leaf (``kernel``) whose top-level module starts with one of
    the model's ``dnn_prefixes`` at ``l2_dnn``; ``dnn_prefixes=None`` is the
    round-1 global heuristic of the JAX package."""
    emb_loss = dnn_loss = lin_loss = 0.0
    for name, leaf in params.items():
        keys = name.split(".")
        if keys[0] == "wide_linear":
            if l2_linear:
                lin_loss = lin_loss + torch.sum(torch.square(leaf))
            continue
        if "embeddings" in name or "table" in name:
            if l2_embedding:
                emb_loss = emb_loss + torch.sum(torch.square(leaf))
            continue
        if dnn_prefixes is not None:
            weight_like = keys[-1] == "kernel" or (
                keys[-1] == "alpha" and any(k.startswith("prelu") for k in keys))
            include = weight_like and any(keys[0].startswith(p) for p in dnn_prefixes)
        else:
            include = any(
                k in name for k in ("kernel", "trans", "cross_stitch_weight", "w_")
            ) and not name.endswith("bias")
        if include and l2_dnn:
            dnn_loss = dnn_loss + torch.sum(torch.square(leaf))
    return l2_embedding * emb_loss + l2_dnn * dnn_loss + l2_linear * lin_loss
