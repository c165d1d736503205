"""Evaluation metrics on the host (the port of
``mmlrec_tpu/train/metrics.py``, which takes them from scikit-learn).

AUC and LogLoss are computed once per epoch over the gathered predictions.
The functions below are numpy/scipy versions of the four scikit-learn
metrics the JAX package binds, with scikit-learn's conventions, so that the
port needs no scikit-learn:

* ``roc_auc_score``: the rank statistic (Mann-Whitney U) with average ranks
  for ties, ranked in float64 whatever the scores' dtype (scikit-learn
  counts in float64 too); a 2-D target is the macro mean over its
  columns; a column with one class warns and gives NaN, as scikit-learn
  (1.9) does, so that an epoch whose validation slice lacks a class does
  not end the fit;
* ``log_loss``: the predictions clipped to ``[eps, 1 - eps]``, ``eps`` the
  machine epsilon of their dtype, and the arithmetic in that dtype; 1-D
  binary labels take the classes ``[1 - p, p]``; a 2-D binary-indicator
  target takes its columns as the classes, ``-sum_j y_j log p_j`` averaged
  over the rows, with no renormalisation (scikit-learn warns and goes on);
  a prediction outside [0, 1] raises ValueError;
* ``mean_squared_error``: the mean over rows and columns;
* ``accuracy``: labels against predictions thresholded at 0.5, flattened.

``regime_from_counts`` gives ``regime_eval``'s AUC and accuracy from the
exact counts of ``device_metrics.exact_train_stats``, bit for bit: the
rank sums here are exact in float64, so both end in the same division.
"""

from __future__ import annotations

import warnings
from typing import Callable, Dict, Iterable, Sequence

import numpy as np
from scipy.stats import rankdata


#: the compiled metrics ``regime_from_counts`` gives
COUNTED = ("auc", "acc", "accuracy")


def _one_class(n_pos: int, n_neg: int) -> bool:
    """True, with scikit-learn's warning, where a class is absent."""
    if n_pos and n_neg:
        return False
    warnings.warn("Only one class is present in y_true. ROC AUC score is not defined "
                  "in that case.", RuntimeWarning, stacklevel=4)
    return True


def _auc_1d(y_true: np.ndarray, y_score: np.ndarray) -> float:
    pos = y_true == 1
    n_pos = int(pos.sum())
    n_neg = int(len(y_true) - n_pos)
    if _one_class(n_pos, n_neg):
        return float("nan")
    # average ranks (a tie counts one half) in float64, where their sums are
    # exact: a SciPy that keeps float32 scores' dtype would round them
    ranks = rankdata(np.asarray(y_score, np.float64))
    return float((ranks[pos].sum() - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg))


def roc_auc_score(y_true, y_score) -> float:
    y_true, y_score = np.asarray(y_true), np.asarray(y_score)
    if y_true.ndim == 1:
        return _auc_1d(y_true, y_score.reshape(-1))
    return float(np.mean([_auc_1d(y_true[:, j], y_score[:, j])
                          for j in range(y_true.shape[1])]))


def log_loss(y_true, y_pred) -> float:
    y_true, y_pred = np.asarray(y_true), np.asarray(y_pred)
    if y_pred.dtype.kind != "f":
        y_pred = y_pred.astype(np.float64)
    if y_pred.max() > 1:
        raise ValueError(f"y_prob contains values greater than 1: {y_pred.max()}")
    if y_pred.min() < 0:
        raise ValueError(f"y_prob contains values lower than 0: {y_pred.min()}")
    if y_true.ndim == 1:  # binary labels: the classes are [1 - p, p]
        classes = np.unique(y_true)
        if len(classes) != 2:
            raise ValueError(
                f"y_true contains {len(classes)} label(s) ({classes}); log_loss on 1-D "
                "labels needs exactly two")
        y1 = y_true == classes[1]
        y_true = np.stack([~y1, y1], axis=1)
        p = y_pred.reshape(-1, 1)
        y_pred = np.concatenate([1 - p, p], axis=1)
    # scikit-learn computes in the predictions' dtype and does not renormalise
    eps = np.finfo(y_pred.dtype).eps
    p = np.clip(y_pred, eps, 1 - eps)
    loss = -np.sum(y_true.astype(p.dtype) * np.log(p), axis=1)
    return float(np.mean(loss))


def mean_squared_error(y_true, y_pred) -> float:
    y_true, y_pred = np.asarray(y_true), np.asarray(y_pred)
    per_output = np.average((y_true - y_pred) ** 2, axis=0)  # in the inputs' dtype
    return float(np.average(per_output))


def accuracy(y_true, y_pred) -> float:
    y = np.asarray(y_true).reshape(-1)
    return float(np.mean(y == np.where(np.asarray(y_pred).reshape(-1) > 0.5, 1, 0)))


def get_metric_fns(names: Sequence[str]) -> Dict[str, Callable]:
    fns: Dict[str, Callable] = {}
    for m in names or []:
        if m in ("binary_crossentropy", "logloss"):
            fns[m] = log_loss
        elif m == "auc":
            fns[m] = roc_auc_score
        elif m == "mse":
            fns[m] = mean_squared_error
        elif m in ("accuracy", "acc"):
            fns[m] = accuracy
    return fns


def _mtmsl_totals(y: np.ndarray, preds: np.ndarray, num_domains: int):
    D = num_domains
    return y[:, [0, D]], np.stack(
        [np.sum(preds[:, :D], axis=-1), np.sum(preds[:, D:], axis=-1)], axis=-1)


def regime_eval(
    metric_fns: Dict[str, Callable],
    y: np.ndarray,
    preds: np.ndarray,
    task_name: str,
    num_domains: int,
) -> Dict[str, float]:
    """Validation-time aggregation (reference evaluate, basemodel.py:373-393).

    msl:   metric(y[:,0], sum_i pred_i)
    mtmsl: metric(y[:, [0, D]], [sum preds[:, :D], sum preds[:, D:]])
    mtl:   metric(y, preds)  (the multi-output average)
    """
    out = {}
    for name, fn in metric_fns.items():
        if task_name == "msl":
            out[name] = float(fn(y[:, 0], np.sum(preds, axis=-1)))
        elif task_name == "mtmsl":
            out[name] = float(fn(*_mtmsl_totals(y, preds, num_domains)))
        else:
            out[name] = float(fn(y, preds))
    return out


def regime_from_counts(names: Iterable[str], counts: Sequence[int]) -> Dict[str, float]:
    """``regime_eval``'s values of the metrics ``names`` (each in
    ``COUNTED``, in their order) from ``device_metrics.exact_train_stats``'s
    ``counts``: a column's AUC is U / (n_pos n_neg), NaN with a NaN score or
    (warning) one class, the macro mean over columns; accuracy is hits /
    entries."""
    *columns, hits, entries = (int(c) for c in counts)
    aucs = []
    for two_u, n_pos, n_neg, nans in zip(*[iter(columns)] * 4):
        if _one_class(n_pos, n_neg) or nans:
            aucs.append(float("nan"))
        else:
            aucs.append((two_u / 2) / (n_pos * n_neg))
    return {name: float(np.mean(aucs)) if name == "auc" else hits / entries
            for name in names}


def masked_test_metrics(
    y: np.ndarray,
    preds: np.ndarray,
    task_name: str,
    num_domains: int,
    test_mask,
    task_types: Sequence[str],
) -> Dict[str, float]:
    """Final test metrics with per-domain masking + total AUC
    (reference main.py:134-172)."""
    results: Dict[str, float] = {}
    for i, _ in enumerate(task_types):
        if task_name == "msl":
            m = test_mask[:, i].astype(bool)
        elif task_name == "mtmsl":
            m = test_mask[:, i % num_domains].astype(bool)
        else:
            m = slice(None)
        results[f"log_loss_{i}"] = round(float(log_loss(y[m, i], preds[m, i])), 4)
        results[f"auc_{i}"] = round(float(roc_auc_score(y[m, i], preds[m, i])), 4)
    if task_name == "msl":
        results["total_auc"] = round(
            float(roc_auc_score(y[:, 0], np.sum(preds, axis=-1))), 4)
    elif task_name == "mtmsl":
        results["total_auc"] = round(
            float(roc_auc_score(*_mtmsl_totals(y, preds, num_domains))), 4)
    return results
