"""The port's validation metrics on the device (mmlrec_tpu_torch/train/
device_metrics.py) held against scikit-learn, the JAX package's device
metrics and the port's own host path, on the CPU.

Tolerances: the AUC against scikit-learn's float64 within 1e-5 (16k rows,
f32 prefix sums; the JAX tests pin the same); the port against the JAX
functions on the same f32 inputs within 1e-6 (the sums run in other
orders); host against device through a fit as the JAX tests hold them: 2e-5
per metric, 5e-4 where msl sums the heads in f32 on the device and f64 on
the host, which may swap near-equal sums and move the AUC by a pair.
"""

import numpy as np
import pytest
import torch
from sklearn.metrics import roc_auc_score

from mmlrec_tpu.train import device_metrics as J
from mmlrec_tpu_torch.data import get_test_mask
from mmlrec_tpu_torch.models import get_model
from mmlrec_tpu_torch.synthetic import make_config, make_data
from mmlrec_tpu_torch.train import Trainer
from mmlrec_tpu_torch.train import device_metrics as D
from mmlrec_tpu_torch.train.metrics import get_metric_fns, masked_test_metrics, regime_eval


def _auc_case(name):
    rng = np.random.RandomState({"random": 0, "ties": 1, "zero_weights": 2}[name])
    n = 16384 if name == "random" else 2000
    y = rng.randint(0, 2, n).astype(np.float32)
    s = rng.rand(n).astype(np.float32)
    w = np.ones(n, np.float32)
    if name == "ties":  # scores quantised to 8 values
        s = (rng.randint(0, 8, n) / 8.0).astype(np.float32)
    if name == "zero_weights":
        w = (rng.rand(n) > 0.3).astype(np.float32)
    return y, s, w


@pytest.mark.parametrize("name", ["random", "ties", "zero_weights"])
def test_weighted_auc_matches_sklearn_and_jax(name):
    y, s, w = _auc_case(name)
    ours = float(D.weighted_auc(torch.from_numpy(y), torch.from_numpy(s), torch.from_numpy(w)))
    keep = w.astype(bool)
    assert ours == pytest.approx(roc_auc_score(y[keep], s[keep]), abs=1e-5)
    assert ours == pytest.approx(float(J.weighted_auc(y, s, w)), abs=1e-6)


def test_weighted_auc_of_one_class_is_nan():
    y = torch.ones(8)
    assert torch.isnan(D.weighted_auc(y, torch.rand(8), torch.ones(8)))


def test_supports():
    for names in (["auc", "acc"], ["auc", "mse", "accuracy"], ["auc", "logloss"], []):
        assert D.supports(names) == J.supports(names)
    assert D.SUPPORTED == J.SUPPORTED


REGIMES = [("mtl", 1, 2, 2), ("msl", 3, 3, 3), ("mtmsl", 2, 4, 4)]


@pytest.mark.parametrize("task_name,num_domains,n_heads,n_labels", REGIMES)
def test_regime_metrics_match_host_and_jax(task_name, num_domains, n_heads, n_labels):
    rng = np.random.RandomState(3)
    n = 2048
    y = rng.randint(0, 2, (n, n_labels)).astype(np.float32)
    p = rng.rand(n, n_heads).astype(np.float32)
    w = np.ones(n, np.float32)
    names = ("auc", "acc", "mse")
    host = regime_eval(get_metric_fns(list(names)), y.astype(np.float64), p.astype(np.float64),
                       task_name, num_domains)
    dev = D.regime_metrics(names, torch.from_numpy(y), torch.from_numpy(p), torch.from_numpy(w),
                           task_name, num_domains)
    jdev = J.regime_metrics(names, y, p, w, task_name, num_domains)
    for k in host:
        assert float(dev[k]) == pytest.approx(host[k], abs=2e-5), (task_name, k)
        assert float(dev[k]) == pytest.approx(float(jdev[k]), abs=1e-6), (task_name, k)


@pytest.mark.parametrize("task_name,num_domains,n_heads,n_labels", REGIMES)
def test_masked_test_metrics_device_matches_jax_and_host(task_name, num_domains, n_heads,
                                                         n_labels):
    rng = np.random.RandomState(5)
    n, pad = 1000, 24
    y = rng.randint(0, 2, (n + pad, n_labels)).astype(np.float32)
    p = rng.uniform(0.05, 0.95, (n + pad, n_heads)).astype(np.float32)
    w = np.concatenate([np.ones(n), np.zeros(pad)]).astype(np.float32)
    tm = get_test_mask(rng.randint(0, num_domains, n + pad), list(range(num_domains)),
                       num_domains)
    tm[n:] = 0.0
    dev = D.masked_test_metrics_device(torch.from_numpy(y), torch.from_numpy(p),
                                       torch.from_numpy(w), torch.from_numpy(tm), task_name,
                                       num_domains)
    jdev = J.masked_test_metrics_device(y, p, w, tm, task_name, num_domains)
    host = masked_test_metrics(y[:n].astype(np.float64), p[:n].astype(np.float64), task_name,
                               num_domains, tm[:n], ["binary"] * n_heads)
    assert set(dev) == set(jdev) == set(host)
    for k in host:
        assert float(dev[k]) == pytest.approx(float(jdev[k]), abs=1e-6), k
        assert float(dev[k]) == pytest.approx(host[k], abs=1e-4), k


def test_msl_auc_survives_init_scale_spread():
    """Per-head sigmoids within ~1e-7 of 0.5 tie when summed in f32; the
    centred sum keeps their order."""
    rng = np.random.RandomState(7)
    n = 4096
    p = (0.5 + rng.randn(n, 2) * 3e-8).astype(np.float32)
    y = rng.randint(0, 2, (n, 1)).astype(np.float32)
    assert len(np.unique(p.sum(axis=1, dtype=np.float32))) < 10
    expected = roc_auc_score(y[:, 0], p.astype(np.float64).sum(axis=1))
    dev = D.regime_metrics(("auc",), torch.from_numpy(np.repeat(y, 2, 1)), torch.from_numpy(p),
                           torch.ones(n), "msl", 2)
    assert float(dev["auc"]) == pytest.approx(expected, abs=1e-4)


def test_regime_metrics_padding_matches_unpadded():
    rng = np.random.RandomState(4)
    n, pad = 1000, 24
    y = rng.randint(0, 2, (n, 2)).astype(np.float32)
    p = rng.rand(n, 2).astype(np.float32)
    y_pad = torch.from_numpy(np.concatenate([y, np.repeat(y[-1:], pad, axis=0)]))
    p_pad = torch.from_numpy(np.concatenate([p, np.repeat(p[-1:], pad, axis=0)]))
    w = torch.cat([torch.ones(n), torch.zeros(pad)])
    base = D.regime_metrics(("auc", "acc"), torch.from_numpy(y), torch.from_numpy(p),
                            torch.ones(n), "mtl", 1)
    padded = D.regime_metrics(("auc", "acc"), y_pad, p_pad, w, "mtl", 1)
    for k in base:
        assert float(base[k]) == pytest.approx(float(padded[k]), abs=1e-6)


def _fit(model_name, task_name, device_eval, metrics=("auc", "acc"), epochs=3):
    cfg = make_config(task_name=task_name, model_name=model_name, emb=4, n_sparse=4, n_dense=2,
                      hidden=(16, 8), tower=(8,), gate=(8,), batch_size=64)
    cfg.training_config.extra["device_eval"] = device_eval
    layout, x, y, _ = make_data(cfg, n=448, seed=0)
    _, xv, yv, _ = make_data(cfg, n=200, seed=9)  # 200 % 64 != 0: pads
    tr = Trainer(get_model(model_name, layout, cfg, device="cpu"), seed=0,
                 device="cpu").compile(metrics=list(metrics))
    tr.fit(x, y, batch_size=64, epochs=epochs, validation_data=(xv, yv), verbose=0)
    return tr


@pytest.mark.parametrize("model_name,task_name,tol", [
    ("mmoe", "mtl", 2e-5), ("star", "msl", 5e-4), ("escm", "mtl", 2e-5)])
def test_fit_device_eval_matches_host_eval(model_name, task_name, tol):
    host = _fit(model_name, task_name, device_eval=False)
    dev = _fit(model_name, task_name, device_eval=True)
    assert dev._use_device_eval() and not host._use_device_eval()
    assert len(host.history) == len(dev.history) == 3
    for hh, hd in zip(host.history, dev.history):
        assert hd["val_auc"] == pytest.approx(hh["val_auc"], abs=tol)
        assert hd["val_acc"] == pytest.approx(hh["val_acc"], abs=tol)
        assert hd["loss"] == pytest.approx(hh["loss"], rel=1e-6)


@pytest.mark.parametrize("model_name,task_name", [("mmoe", "mtl"), ("star", "msl"),
                                                  ("escm", "mtl")])
def test_trainer_masked_test_metrics_device_matches_host(model_name, task_name):
    tr = _fit(model_name, task_name, device_eval=False, metrics=("auc",), epochs=2)
    cfg = tr.cfg
    _, xt, yt, _ = make_data(cfg, n=200, seed=9)
    dc = cfg.data_config
    test_mask = None
    if task_name in ("msl", "mtmsl"):
        test_mask = get_test_mask(xt[dc.mask_column], dc.mask_values, dc.num_domains)
    host = masked_test_metrics(tr._prepare_y(yt), tr.predict(xt, 64), task_name,
                               dc.num_domains, test_mask, tr.model.task_types)
    dev = tr.masked_test_metrics_device(xt, yt, test_mask, batch_size=64)
    assert list(dev) == list(host)  # the reference's row order
    for k in host:
        assert dev[k] == pytest.approx(host[k], abs=1e-3), k


def test_device_eval_falls_back_on_unsupported_metric():
    tr = _fit("mmoe", "mtl", device_eval=True, metrics=("auc", "logloss"), epochs=1)
    assert not tr._use_device_eval()
    assert "val_logloss" in tr.history[-1]
