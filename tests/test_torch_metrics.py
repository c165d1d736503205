"""The port's host metrics (numpy/scipy, no scikit-learn) against
scikit-learn's, and ``regime_eval`` / ``masked_test_metrics`` against the
JAX package's ``mmlrec_tpu/train/metrics.py`` for the three regimes.

Tolerances: float64 inputs 1e-12 (the same arithmetic in another order);
float32 inputs 1e-6 (scikit-learn keeps float32 predictions in float32, and
so does the port, but its sums run in another order).  ``masked_test_metrics``
rounds to 4 decimals on both sides, so its rows must be equal.
"""

import warnings

import numpy as np
import pytest
import sklearn.metrics as sk

from mmlrec_tpu.train import metrics as JM
from mmlrec_tpu_torch.train import metrics as M

TOL = {np.float32: 1e-6, np.float64: 1e-12}


def _data(dtype, n=600, cols=2, seed=0):
    rng = np.random.default_rng(seed)
    y = (rng.random((n, cols)) < 0.3).astype(np.float32)
    p = rng.random((n, cols)).astype(dtype)
    p[: n // 4] = np.round(p[: n // 4], 1)  # many ties, across both classes
    p[0], p[1] = 0.0, 1.0  # the clipping at eps
    return y, p


@pytest.fixture(autouse=True)
def _quiet_sklearn():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # "y_prob values do not sum to one", renamed arguments
        yield


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("cols", [1, 2, 3])
def test_metrics_match_sklearn(dtype, cols):
    y, p = _data(dtype, cols=cols)
    if cols == 1:
        y, p = y[:, 0], p[:, 0]
    tol = TOL[dtype]
    np.testing.assert_allclose(M.roc_auc_score(y, p), sk.roc_auc_score(y, p), rtol=0, atol=tol)
    np.testing.assert_allclose(M.log_loss(y, p), sk.log_loss(y, p), rtol=0, atol=tol)
    np.testing.assert_allclose(M.mean_squared_error(y, p), sk.mean_squared_error(y, p),
                               rtol=0, atol=tol)
    np.testing.assert_allclose(M.accuracy(y, p), JM._accuracy(y, p), rtol=0, atol=0)


def test_auc_ties_constant_column_and_one_class():
    y = np.array([0, 1, 0, 1, 1, 0], np.float32)
    tied = np.array([0.5, 0.5, 0.2, 0.9, 0.5, 0.2])
    # scikit-learn integrates the ROC curve, the port counts ranks: one ulp apart
    np.testing.assert_allclose(M.roc_auc_score(y, tied), sk.roc_auc_score(y, tied), rtol=1e-15)
    assert M.roc_auc_score(y, tied) == pytest.approx(8 / 9, rel=1e-15)  # 6 + 4 * 0.5 of 9 pairs
    const = np.full(6, 0.3)
    assert M.roc_auc_score(y, const) == sk.roc_auc_score(y, const) == 0.5
    # multi-output: the macro mean over the columns, a constant column included
    y2, p2 = np.stack([y, 1 - y], 1), np.stack([tied, const], 1)
    np.testing.assert_allclose(M.roc_auc_score(y2, p2), sk.roc_auc_score(y2, p2), rtol=1e-15)
    for fn in (M.roc_auc_score, sk.roc_auc_score):  # one class present: both warn, NaN
        with pytest.warns(Warning, match="Only one class is present"):
            assert np.isnan(fn(np.ones(6), tied))
        with pytest.warns(Warning, match="Only one class is present"):
            assert np.isnan(fn(np.stack([y, np.zeros(6)], 1), p2))


def test_log_loss_refuses_what_sklearn_refuses():
    y = np.array([0, 1, 1, 0], np.float32)
    for bad in (np.array([0.2, 1.2, 0.5, 0.1]), np.array([0.2, -0.1, 0.5, 0.1])):
        for fn in (M.log_loss, sk.log_loss):
            with pytest.raises(ValueError, match="y_prob contains values"):
                fn(y, bad)
    for fn in (M.log_loss, sk.log_loss):
        with pytest.raises(ValueError):
            fn(np.ones(4), np.array([0.2, 0.3, 0.5, 0.1]))  # one label only


def test_get_metric_fns_names():
    fns = M.get_metric_fns(["auc", "logloss", "binary_crossentropy", "mse", "acc", "accuracy",
                            "unknown"])
    assert list(fns) == list(JM.get_metric_fns(["auc", "logloss", "binary_crossentropy", "mse",
                                                "acc", "accuracy", "unknown"]))
    assert M.get_metric_fns(None) == {}


@pytest.mark.parametrize("task,heads,domains", [("mtl", 2, 2), ("msl", 2, 2), ("mtmsl", 4, 2)])
def test_regime_eval_and_masked_test_metrics_match_jax(task, heads, domains):
    rng = np.random.default_rng(4)
    n = 500
    y = (rng.random((n, heads)) < 0.4).astype(np.float32)
    if task != "mtl":  # each label column repeated across its domains
        y = np.repeat(y[:, :: domains], domains, axis=1)
    preds = rng.random((n, heads))
    domain = rng.integers(0, domains, n)
    test_mask = (domain[:, None] == np.arange(domains)[None]).astype(np.float32)
    if task != "mtl":  # the model gates each head by its domain: the sums stay in [0, 1]
        preds = preds * test_mask[:, np.arange(heads) % domains]
    names = ["auc", "acc", "mse"] + (["logloss"] if task != "mtmsl" else [])
    got = M.regime_eval(M.get_metric_fns(names), y, preds, task, domains)
    want = JM.regime_eval(JM.get_metric_fns(names), y, preds, task, domains)
    assert set(got) == set(want) == set(names)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-12, err_msg=k)
    preds = np.clip(rng.random((n, heads)), 0.01, 0.99)
    types = ["binary"] * heads
    got = M.masked_test_metrics(y, preds, task, domains, test_mask, types)
    want = JM.masked_test_metrics(y, preds, task, domains, test_mask, types)
    assert got == want
    assert ("total_auc" in got) == (task != "mtl")
