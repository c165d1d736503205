"""Validation metrics on the device: exact AUC, accuracy, MSE and log loss
as tensor programs (the port of ``mmlrec_tpu/train/device_metrics.py``).

The host path (``train/metrics.py``) moves the whole ``[N, heads]``
prediction matrix to the host each epoch; here the predictions stay on the
model's device and only the scalars come back.

* ``weighted_auc``: exact ROC AUC through the rank statistic
  U = sum over positives of (negatives below + 0.5 x negatives tied), which
  is scikit-learn's trapezoidal ``roc_auc_score`` with average-rank ties:
  one STABLE sort, a prefix sum and two binary searches; a row of weight 0
  (padding) takes part in the sort but adds no mass.
* ``regime_metrics``: the regime aggregation of ``regime_eval``
  (reference basemodel.py:373-393): msl sums the heads against label 0,
  mtmsl sums task-major blocks of D heads, mtl averages the columns.
* ``masked_test_metrics_device``: the final per-head masked LogLoss and
  AUC of ``metrics.masked_test_metrics`` (reference main.py:134-172).
* ``exact_train_stats``: the epoch's train AUC and accuracy as exact int64
  counts, which ``metrics.regime_from_counts`` turns into the floats
  ``regime_eval`` gives, bit for bit.

Apart from ``exact_train_stats``, sums and prefix sums run in float32, as
the JAX functions' do, so values may differ from scikit-learn's float64 in
the last ~1e-6.  ``logloss`` as a compiled metric has no device form here
(scikit-learn's 2-D ``log_loss`` normalises rows): the trainer validates
on the host whenever it is asked for.  Plain PyTorch: no kernel of the JAX
package runs here.
"""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

import torch

#: metric names ``regime_metrics`` computes on the device
SUPPORTED = ("auc", "acc", "accuracy", "mse")

#: the most rows ``exact_train_stats`` takes: the host's float64 rank sums
#: (under N^2 / 2) are exact up to 2^53, and the counts ride to the host
#: as float64 beside the loss
EXACT_ROWS = 1 << 26

#: numpy's float32 sum adds fewer than this many terms left to right; from
#: 8 on its pairwise sum regroups them
_SEQUENTIAL_TERMS = 8


def supports(metric_names: Iterable[str]) -> bool:
    """True if EVERY requested metric has a device form."""
    names = list(metric_names)
    return bool(names) and all(m in SUPPORTED for m in names)


def weighted_auc(labels: torch.Tensor, scores: torch.Tensor,
                 weights: torch.Tensor) -> torch.Tensor:
    """Exact weighted ROC AUC of 1-D ``scores`` against binary ``labels``;
    NaN when a class is absent (scikit-learn raises there)."""
    labels = labels.to(torch.float32).reshape(-1)
    scores = scores.to(torch.float32).reshape(-1).contiguous()
    weights = weights.to(torch.float32).reshape(-1)
    order = torch.argsort(scores, stable=True)
    s_sorted = scores[order]
    neg_w_sorted = (weights * (1.0 - labels))[order]
    # prefix[i]: the negative weight strictly before sorted position i
    prefix = torch.cat([neg_w_sorted.new_zeros(1), torch.cumsum(neg_w_sorted, 0)])
    left = torch.searchsorted(s_sorted, scores, side="left")
    right = torch.searchsorted(s_sorted, scores, side="right")
    neg_below = prefix[left]
    neg_tied = prefix[right] - prefix[left]
    pos_w = weights * labels
    u_stat = torch.sum(pos_w * (neg_below + 0.5 * neg_tied))
    total_pos = torch.sum(pos_w)
    total_neg = torch.sum(weights) - total_pos
    return u_stat / (total_pos * total_neg)


def _weighted_mean(values: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Mean of [N, C] ``values`` with per-row ``weights`` over C."""
    w = weights.reshape(-1, 1)
    return torch.sum(values * w) / (torch.sum(w) * values.shape[-1])


def regime_effective(y: torch.Tensor, preds: torch.Tensor, task_name: str,
                     num_domains: int, center: bool = False
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y_eff, p_eff) of the reference's evaluate (basemodel.py:373-393).
    ``center=True`` sums ``preds - 0.5``: AUC reads only the order of the
    sums, and sums of sigmoids near H x 0.5 tie in f32 early in training;
    ``p - 0.5`` is exact for p in [0.25, 1] (Sterbenz), so the centred sums
    keep their spread.  Value metrics (acc, mse) take the true sum."""
    shift = 0.5 if center else 0.0
    if task_name == "msl":
        return y[:, :1], torch.sum(preds - shift, dim=-1, keepdim=True)
    if task_name == "mtmsl":
        D = num_domains
        y_eff = torch.stack([y[:, 0], y[:, D]], dim=-1)
        p_eff = torch.stack([torch.sum(preds[:, :D] - shift, dim=-1),
                             torch.sum(preds[:, D:] - shift, dim=-1)], dim=-1)
        return y_eff, p_eff
    return y, preds


def weighted_logloss(labels: torch.Tensor, probs: torch.Tensor,
                     weights: torch.Tensor) -> torch.Tensor:
    """Weighted binary cross-entropy as scikit-learn's 1-D ``log_loss``,
    the probabilities clipped at float32's eps."""
    labels = labels.to(torch.float32).reshape(-1)
    weights = weights.to(torch.float32).reshape(-1)
    eps = torch.finfo(torch.float32).eps
    p = torch.clamp(probs.to(torch.float32).reshape(-1), eps, 1.0 - eps)
    ce = -(labels * torch.log(p) + (1.0 - labels) * torch.log1p(-p))
    return torch.sum(weights * ce) / torch.sum(weights)


def masked_test_metrics_device(y: torch.Tensor, preds: torch.Tensor, weights: torch.Tensor,
                               test_mask, task_name: str, num_domains: int
                               ) -> Dict[str, torch.Tensor]:
    """Per-head LogLoss and AUC masked to the head's domain rows (msl: head
    i = domain i; mtmsl: head i = domain i % D; mtl: unmasked), plus the
    total AUC of the summed predictions for msl and mtmsl.  ``preds`` are
    already column-selected (ESCM)."""
    out: Dict[str, torch.Tensor] = {}
    for i in range(preds.shape[1]):
        if task_name == "msl":
            w = weights * test_mask[:, i]
        elif task_name == "mtmsl":
            w = weights * test_mask[:, i % num_domains]
        else:
            w = weights
        out[f"log_loss_{i}"] = weighted_logloss(y[:, i], preds[:, i], w)
        out[f"auc_{i}"] = weighted_auc(y[:, i], preds[:, i], w)
    if task_name in ("msl", "mtmsl"):
        out["total_auc"] = regime_metrics(("auc",), y, preds, weights, task_name,
                                          num_domains)["auc"]
    return out


def regime_metrics(metric_names: Iterable[str], y: torch.Tensor, preds: torch.Tensor,
                   weights: torch.Tensor, task_name: str, num_domains: int
                   ) -> Dict[str, torch.Tensor]:
    """Scalars on the device matching ``metrics.regime_eval`` for the
    supported metrics."""
    y_eff, p_eff = regime_effective(y, preds, task_name, num_domains)
    out: Dict[str, torch.Tensor] = {}
    for name in metric_names:
        if name == "auc":
            y_rank, p_rank = regime_effective(y, preds, task_name, num_domains, center=True)
            per_col = [weighted_auc(y_rank[:, c], p_rank[:, c], weights)
                       for c in range(y_rank.shape[1])]
            out[name] = torch.mean(torch.stack(per_col))
        elif name in ("acc", "accuracy"):
            hard = torch.where(p_eff > 0.5, 1.0, 0.0)
            out[name] = _weighted_mean((hard == y_eff.to(torch.float32)).to(torch.float32),
                                       weights)
        elif name == "mse":
            out[name] = _weighted_mean(torch.square(y_eff.to(torch.float32) - p_eff), weights)
        else:
            raise ValueError(f"{name!r} has no device form (see supports())")
    return out


def _summed(preds: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """Columns ``lo:hi`` of ``preds`` added left to right, the order of
    numpy's ``np.sum(preds[:, lo:hi], axis=-1)`` under 8 terms."""
    out = preds[:, lo]
    for j in range(lo + 1, hi):
        out = out + preds[:, j]
    return out


def _regime_columns(y: torch.Tensor, preds: torch.Tensor, task_name: str, num_domains: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y_eff, p_eff), [rows, C] each, as ``metrics.regime_eval`` forms them."""
    if task_name == "msl":
        return y[:, :1], _summed(preds, 0, preds.shape[1])[:, None]
    if task_name == "mtmsl":
        D, H = num_domains, preds.shape[1]
        return y[:, [0, D]], torch.stack([_summed(preds, 0, D), _summed(preds, D, H)], dim=-1)
    return y, preds


def counts_exactly(task_name: str, num_domains: int, heads: int, label_columns: int,
                   rows: int) -> bool:
    """Whether ``exact_train_stats`` over ``rows`` rows of ``heads``
    predictions is bitwise ``regime_eval``: every regime sum under 8 terms
    (numpy's order is then left to right) and at most ``EXACT_ROWS`` rows."""
    if rows > EXACT_ROWS:
        return False
    if task_name == "msl":
        return heads < _SEQUENTIAL_TERMS
    if task_name == "mtmsl":
        return (0 < num_domains < heads and label_columns > num_domains
                and max(num_domains, heads - num_domains) < _SEQUENTIAL_TERMS)
    return label_columns == heads


def exact_train_stats(y: torch.Tensor, preds: torch.Tensor, weights: torch.Tensor,
                      task_name: str, num_domains: int) -> torch.Tensor:
    """The statistics of ``regime_eval``'s AUC and accuracy over the rows of
    weight > 0, as exact int64 counts.

    ``y`` [rows, T] labels, ``preds`` [rows, heads] f32 (already column
    selected), ``weights`` [rows] (0 marks a pad row).  Returns
    ``[2U, n_pos, n_neg, nans]`` for each regime column and then
    ``[hits, entries]``: U is the Mann-Whitney statistic, the sum over
    positives (label 1) of the negatives (any other label) scored below
    plus half those tied, so 2U = sum over positives of (negatives before
    the score's tie group + negatives up to its end), the two ends found by
    ``searchsorted`` in the sorted scores; ``nans`` counts NaN scores
    (``rankdata`` then gives NaN); ``hits`` counts entries whose label
    equals ``p > 0.5``, over ``entries`` = rows x columns, as
    ``metrics.accuracy`` flattens them.  ``counts_exactly`` says where
    these are ``regime_eval``'s."""
    y_eff, p_eff = _regime_columns(y, preds, task_name, num_domains)
    live = weights > 0
    scores = torch.where(live[:, None], p_eff, 0.0).T.contiguous()  # [C, rows]
    labels = y_eff.T
    pos = live & (labels == 1)
    neg = live & (labels != 1)
    ordered, order = torch.sort(scores, dim=1)
    neg_before = torch.nn.functional.pad(torch.cumsum(neg.gather(1, order).long(), 1), (1, 0))
    ends = (neg_before.gather(1, torch.searchsorted(ordered, scores, side="left"))
            + neg_before.gather(1, torch.searchsorted(ordered, scores, side="right")))
    per_column = torch.stack([
        torch.sum(ends * pos, dim=1), pos.sum(dim=1), neg.sum(dim=1),
        (live & torch.isnan(scores)).sum(dim=1)], dim=1)
    hits = (live[:, None] & (y_eff == (p_eff > 0.5))).sum()
    return torch.cat([per_column.reshape(-1), torch.stack([hits, live.sum() * p_eff.shape[1]])])
