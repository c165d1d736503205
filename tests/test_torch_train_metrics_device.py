"""The epoch's train AUC and accuracy counted on the device
(``device_metrics.exact_train_stats``) and finished on the host
(``metrics.regime_from_counts``) against ``metrics.regime_eval`` over the
same rows, on the CPU: every value bitwise (``==``, NaN where NaN), and the
same one-class warning.

``regime_eval`` ranks float32 scores in float64, where the rank sums are
exact; the counts are exact in int64, so the two end in the same division.
The regime sums (msl's heads, mtmsl's blocks of D heads) are numpy's
``np.sum`` on one side and additions left to right on the other, equal
below 8 terms: the seven-head msl case holds the widest.  The tests that
take the ``card`` fixture run the counts on a CUDA card at an epoch's size
and skip without one.
"""

import warnings

import numpy as np
import pytest
import torch

from mmlrec_tpu_torch.train import device_metrics
from mmlrec_tpu_torch.train.metrics import get_metric_fns, regime_eval, regime_from_counts

NAMES = ["auc", "acc", "accuracy"]
ROWS = 600
# (task_name, num_domains, heads): label columns = heads
REGIMES = {"mtl1": ("mtl", 1, 1), "mtl2": ("mtl", 1, 2), "msl2": ("msl", 2, 2),
           "msl3": ("msl", 3, 3), "msl7": ("msl", 7, 7), "mtmsl2": ("mtmsl", 2, 4)}
VARIANTS = ["plain", "pads", "ties", "one_class", "nan", "nan_in_a_pad"]


def _data(heads, variant, seed=0):
    """(labels, float32 probabilities, weights) of ``ROWS`` rows."""
    rng = np.random.default_rng(seed)
    y = (rng.random((ROWS, heads)) < 0.3).astype(np.float32)
    p = rng.random((ROWS, heads), dtype=np.float32)
    w = np.ones(ROWS, np.float32)
    if variant in ("pads", "nan_in_a_pad"):
        w[-37:] = 0.0  # a ragged last batch's pads
        w[rng.choice(ROWS - 37, 20, replace=False)] = 0.0
    if variant == "ties":  # heavy ties, across the classes too
        p = np.round(p * 4).astype(np.float32) / np.float32(4)
    if variant == "one_class":
        y[:, 0] = 0.0
    if variant == "nan":
        p[5, 0] = np.nan
    if variant == "nan_in_a_pad":
        p[-1, :] = np.nan
    return y, p, w


def _assert_same(got, want):
    assert list(got) == list(want)
    for k in want:
        assert type(got[k]) is float
        assert got[k] == want[k] or (np.isnan(got[k]) and np.isnan(want[k])), (k, got, want)


def _both(y, p, w, task_name, num_domains, names=NAMES):
    """(device counts finished on the host, ``regime_eval`` on the live
    rows), each with the warnings it gave."""
    with warnings.catch_warnings(record=True) as dev_warned:
        warnings.simplefilter("always")
        counts = device_metrics.exact_train_stats(
            torch.from_numpy(y), torch.from_numpy(p), torch.from_numpy(w), task_name,
            num_domains)
        assert counts.dtype == torch.int64
        got = regime_from_counts(names, counts.tolist())
    live = w > 0
    with warnings.catch_warnings(record=True) as host_warned:
        warnings.simplefilter("always")
        want = regime_eval(get_metric_fns(names), y[live], p[live], task_name, num_domains)
    return (got, [(type(m.message), str(m.message)) for m in dev_warned],
            want, [(type(m.message), str(m.message)) for m in host_warned])


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("regime", sorted(REGIMES))
def test_device_counts_equal_regime_eval_bitwise(regime, variant):
    task_name, num_domains, heads = REGIMES[regime]
    y, p, w = _data(heads, variant)
    got, got_warned, want, want_warned = _both(y, p, w, task_name, num_domains)
    _assert_same(got, want)
    assert got_warned == want_warned
    if variant == "one_class" and task_name != "mtmsl":  # mtmsl's column 0 keeps label D
        assert np.isnan(want["auc"]) and want_warned[0][0] is RuntimeWarning
    if variant == "nan":
        assert np.isnan(want["auc"]) and not want_warned
    if variant in ("plain", "pads", "ties", "nan_in_a_pad"):
        assert 0.0 < want["auc"] < 1.0


@pytest.mark.parametrize("names", [["auc"], ["acc"], ["accuracy", "auc"]])
def test_each_counted_metric_alone_in_its_order(names):
    y, p, w = _data(2, "pads", seed=3)
    got, _, want, _ = _both(y, p, w, "mtl", 1, names)
    _assert_same(got, want)


def test_many_seeds_of_tied_sums():
    """msl sums of rounded heads tie often; the mtmsl blocks too."""
    for seed in range(8):
        for task_name, num_domains, heads in (("msl", 3, 3), ("mtmsl", 2, 4)):
            y, p, w = _data(heads, "ties", seed=seed)
            p = (p / np.float32(3)).astype(np.float32)  # sums whose last bit the order sets
            got, _, want, _ = _both(y, p, w, task_name, num_domains)
            _assert_same(got, want)


def test_host_ranks_in_float64_under_a_scipy_that_keeps_float32(monkeypatch):
    """A SciPy whose ``rankdata`` keeps float32 scores' dtype would round the
    rank sums of an epoch's rows (over 2^24 here); the host ranks float64
    scores, so it still gives the exact counts' values."""
    from mmlrec_tpu_torch.train import metrics

    real = metrics.rankdata
    monkeypatch.setattr(metrics, "rankdata", lambda a: real(a).astype(np.asarray(a).dtype))
    rng = np.random.default_rng(5)
    rows = 20_000
    y = (rng.random((rows, 2)) < 0.3).astype(np.float32)
    p = rng.random((rows, 2), dtype=np.float32)
    assert metrics.rankdata(p[:, 0]).dtype == np.float32
    got, _, want, _ = _both(y, p, np.ones(rows, np.float32), "mtl", 1)
    _assert_same(got, want)


@pytest.mark.parametrize("args,exact", [
    (("msl", 7, 7, 7, 1000), True),
    (("msl", 8, 8, 8, 1000), False),  # numpy's pairwise sum from 8 terms on
    (("mtmsl", 2, 4, 4, 1000), True),
    (("mtmsl", 8, 10, 10, 1000), False),
    (("mtmsl", 2, 4, 2, 1000), False),  # no label column D
    (("mtl", 1, 12, 12, 1000), True),  # no sum
    (("mtl", 1, 2, 3, 1000), False),  # labels and heads disagree
    (("mtl", 1, 2, 2, device_metrics.EXACT_ROWS), True),
    (("mtl", 1, 2, 2, device_metrics.EXACT_ROWS + 1), False),
])
def test_counts_exactly_where_the_order_and_the_rows_allow(args, exact):
    assert device_metrics.counts_exactly(*args) is exact


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the counts run there as in a fit")
    return torch.cuda.get_device_name(0)


@pytest.mark.parametrize("regime", ["mtl2", "msl2", "mtmsl2"])
def test_the_card_counts_what_the_host_computes(card, regime):
    """An epoch of 256 batches of 4096 rows, the last 100 rows pads, scores
    tied in part: the card's counts finished on the host equal
    ``regime_eval`` on the host bitwise."""
    task_name, num_domains, heads = REGIMES[regime]
    rng = np.random.default_rng(11)
    rows = 256 * 4096
    y = (rng.random((rows, heads)) < 0.3).astype(np.float32)
    p = rng.random((rows, heads), dtype=np.float32)
    p[: rows // 2] = np.round(p[: rows // 2] * 1000).astype(np.float32) / np.float32(1000)
    w = np.ones(rows, np.float32)
    w[-100:] = 0.0
    counts = device_metrics.exact_train_stats(
        *(torch.from_numpy(a).cuda() for a in (y, p, w)), task_name, num_domains)
    got = regime_from_counts(NAMES, counts.cpu().tolist())
    live = w > 0
    _assert_same(got, regime_eval(get_metric_fns(NAMES), y[live], p[live], task_name,
                                  num_domains))
