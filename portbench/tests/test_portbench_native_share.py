"""``fit.worker_metadata_native_share``: the share of the window's epochs
whose host step metadata the program's native pass built (``fit_timing``'s
``meta_native``), in %; no value, never a 0, where the program records no
such key (the port before the pass)."""

from types import SimpleNamespace

import pytest

from mmlrec_tpu_torch import native
from portbench import run
from portbench.tests.tiny import SCALES, SECONDS


def _read(ctx):
    return run.metric_module("fit.worker_metadata_native_share").read(ctx)


def test_the_native_share_counts_the_epochs_the_pass_built():
    epochs = [{"meta_s": 0.5, "meta_native": v} for v in (1.0, 1.0, 0.0, 1.0)]
    assert _read(SimpleNamespace(fit_timing=epochs)) == pytest.approx(75.0)
    assert _read(SimpleNamespace(fit_timing=epochs[:2])) == pytest.approx(100.0)
    assert _read(SimpleNamespace(fit_timing=[{"meta_s": 0.5}])) is None  # the port before it


def test_a_traced_ae_train_reads_every_epoch_from_the_pass():
    try:
        native.get_host_meta_lib()
        expected = 100.0
    except native.NativeUnavailable:
        expected = 0.0  # no compiler: every epoch from the numpy formulation
    r = run.run_cell("ae.train", 2**31 + 11, SECONDS, True, device="cpu",
                     scale=SCALES["ae.train"])
    assert r["correct"], r["checks"]
    assert r["metrics"]["fit.worker_metadata_native_share"]["value"] == expected
