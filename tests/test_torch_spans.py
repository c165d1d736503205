"""The port's spans and epoch counters (``utils/spans.py``): off, a span
site enters nothing; under the profiler, the fit loop and the serving
entry record their spans where their work runs, and each epoch's
``Trainer.fit_timing`` entry holds every key, its counters agreeing with
its spans.  On the CPU, no JAX."""

import pytest
import torch

from mmlrec_tpu_torch import synthetic as tsyn
from mmlrec_tpu_torch.models import get_model
from mmlrec_tpu_torch.serving import ServingBundle, save_serving_bundle
from mmlrec_tpu_torch.train import Trainer, staging
from mmlrec_tpu_torch.train.graphs import StepGraphs
from mmlrec_tpu_torch.train.multi_seed import SeedSuiteTrainer
from mmlrec_tpu_torch.utils import spans
from mmlrec_tpu_torch.utils.seeding import make_generator

BASE = dict(task_name="mtl", model_name="mmoe", n_sparse=4, n_dense=2, hidden=(16, 8),
            tower=(8,), gate=(8,), batch_size=64, lr=3e-3)
# the two-phase step with host metadata (the worker's path), and the dense fit
MODES = {"host_meta": dict(vocab=1 << 16, two_phase_embedding=True, table_update="pallas"),
         "dense": dict(vocab=400)}
N = 330  # 6 batches of 64 a full epoch, then 0.2 of them held out for validation
EPOCH_SPANS = ("mmlrec.fit.prep_wait", "mmlrec.fit.issue", "mmlrec.fit.sync",
               "mmlrec.fit.train_metrics", "mmlrec.fit.validate")
SERVE_CHILDREN = ("mmlrec.serve.pack", "mmlrec.serve.copy_in", "mmlrec.serve.forward",
                  "mmlrec.serve.copy_out")


def _trainer(mode):
    kw = dict(MODES[mode])
    vocab = kw.pop("vocab")
    cfg = tsyn.make_config(vocab=vocab, **BASE, **kw)
    layout, x, y, _ = tsyn.make_data(cfg, n=N, seed=0, vocab=vocab)
    model = get_model("mmoe", layout, cfg, generator=make_generator(0), device="cpu")
    return Trainer(model, seed=0, device="cpu").compile(metrics=["auc"]), x, y


def _fit(tr, x, y, epochs=3, **kw):
    tr.fit(x, y, batch_size=64, epochs=epochs, validation_split=0.2, verbose=0, **kw)
    return tr


def _bundle(tmp_path, fixed=False):
    cfg = tsyn.make_config(vocab=400, **BASE)
    layout, x, _, _ = tsyn.make_data(cfg, n=200, seed=0, vocab=400)
    save_serving_bundle(get_model("mmoe", layout, cfg, generator=make_generator(0),
                                  device="cpu"), str(tmp_path))
    bundle = ServingBundle.load(str(tmp_path), device="cpu")
    if fixed:
        bundle.meta["batch_mode"], bundle.meta["batch_size"] = "fixed", 64
    return bundle, x


def _profiled(fn):
    """``fn()`` under the profiler as the benchmark starts it, inside a range
    of its own; returns the main thread's events and that range."""
    with torch.autograd.profiler.profile(use_kineto=True) as prof:
        with torch.profiler.record_function("test.outer"):
            fn()
    events = list(prof.function_events)
    outer = next(e for e in events if e.name == "test.outer")
    return [e for e in events if e.thread == outer.thread], outer


def _named(events, name):
    return [e for e in events if e.name == name]


def _inside(inner, outer):
    return (outer.time_range.start <= inner.time_range.start
            and inner.time_range.end <= outer.time_range.end)


def test_a_span_off_is_the_shared_noop_and_timed_still_counts():
    assert not spans.enabled()
    assert spans.span("mmlrec.a") is spans.span("mmlrec.b")
    assert spans.span("mmlrec.a", on=False) is spans.span("mmlrec.b")
    timing = {}
    for _ in range(2):
        with spans.timed(timing, "k", "mmlrec.a"):
            pass
    assert set(timing) == {"k"} and timing["k"] >= 0.0
    with torch.autograd.profiler.profile(use_kineto=True):
        assert spans.enabled()
        assert isinstance(spans.span("mmlrec.a"), torch.profiler.record_function)


def test_off_the_fit_and_predict_enter_no_record_function(monkeypatch, tmp_path):
    """With no profiler running, no span site on the fit loop (its worker
    included) or the serving entry opens a profiler range."""
    def refuse(*args, **kwargs):
        raise AssertionError("a profiler range was opened with the profiler off")

    bundle, x = _bundle(tmp_path)
    tr, tx, ty = _trainer("host_meta")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    _fit(tr, tx, ty)
    assert len(tr.fit_timing) == 3 and tr.fit_timing[1]["meta_s"] > 0  # the worker ran
    assert bundle.predict(x).shape == (200, 2)
    assert bundle.predict(x, batch_size=64).shape == (200, 2)


def test_the_fit_records_its_spans_once_a_fit_and_once_an_epoch():
    """A two-phase full-shuffle fit of three epochs with validation: its
    set-up once (the packing inside it), each epoch phase once an epoch
    after it, all inside the fit."""
    tr, x, y = _trainer("host_meta")
    events, outer = _profiled(lambda: _fit(tr, x, y))
    for name, count in [("mmlrec.fit.pack", 1), ("mmlrec.fit.stage", 1),
                        *((n, 3) for n in EPOCH_SPANS)]:
        found = _named(events, name)
        assert len(found) == count, name
        assert all(_inside(e, outer) for e in found), name
    (stage,) = _named(events, "mmlrec.fit.stage")
    assert _inside(_named(events, "mmlrec.fit.pack")[0], stage)
    assert all(e.time_range.start >= stage.time_range.end
               for n in EPOCH_SPANS for e in _named(events, n))
    # epoch by epoch, in the loop's order
    starts = {n: [e.time_range.start for e in _named(events, n)] for n in EPOCH_SPANS}
    for epoch in range(3):
        order = [starts[n][epoch] for n in EPOCH_SPANS]
        assert order == sorted(order), epoch


@pytest.mark.parametrize("case", ["host_meta", "host_meta_one_epoch", "host_meta_streamed",
                                  "host_meta_block", "dense"])
def test_every_epoch_holds_every_key(case):
    """Every key in every epoch, non-negative; the metadata's seconds above 0
    wherever the host builds it each epoch (worker, inline or streamed), 0
    in block mode (built and uploaded once, at staging: the epoch uploads
    only its batch order, as part of its issue) and on the dense fit;
    ``meta_native`` 1.0 wherever the native pass built the metadata."""
    mode = "dense" if case == "dense" else "host_meta"
    tr, x, y = _trainer(mode)
    kw = {}
    if case == "host_meta_streamed":
        tr._device_data_bytes_cap = 0
    if case == "host_meta_block":
        kw["shuffle"] = "block"
    epochs = 1 if case == "host_meta_one_epoch" else 3
    _fit(tr, x, y, epochs=epochs, **kw)
    assert len(tr.fit_timing) == epochs
    for t in tr.fit_timing:
        assert tuple(t) == staging.TIMING_KEYS  # steps_device_s: on the card only
        assert all(v >= 0 for v in t.values())
        assert t["issue_s"] > 0 and t["val_s"] > 0 and t["metrics_s"] > 0
        assert (t["meta_s"] > 0) == (case not in ("dense", "host_meta_block")), case
        assert (t["upload_s"] > 0) == (case != "host_meta_block"), case
        # the native pass built the metadata (in block mode once, at staging)
        assert t["meta_native"] == (0.0 if case == "dense" else 1.0), case
        assert t["captures"] == 0 and t["capture_s"] == 0.0  # the CPU captures nothing


def test_captures_count_the_graphs_each_epoch_captured(monkeypatch):
    """The epochs' ``captures`` and ``capture_s`` add up to what the fit's
    ``StepGraphs`` captured.  The CPU captures no graph, so each first run
    of a key is counted here as the card's capture branch counts it."""
    fits = []

    def first_run_counted(self, key, body):
        body()
        if key not in self.graphs:
            self.graphs[key] = None
            self.captures += 1
            self.capture_s += 1e-3
        if not fits or fits[-1] is not self:
            fits.append(self)

    monkeypatch.setattr(StepGraphs, "run", first_run_counted)
    tr, x, y = _trainer("host_meta")
    _fit(tr, x, y)
    (graphs,) = fits
    assert [t["captures"] for t in tr.fit_timing] == [2, 0, 0]  # the gather step, the eval
    assert sum(t["captures"] for t in tr.fit_timing) == graphs.captures
    assert sum(t["capture_s"] for t in tr.fit_timing) == pytest.approx(graphs.capture_s)
    assert not hasattr(tr, "graph_capture_s")


def test_the_prep_wait_span_agrees_with_prep_s():
    tr, x, y = _trainer("host_meta")
    events, _ = _profiled(lambda: _fit(tr, x, y))
    span_s = sum(e.time_range.elapsed_us() for e in _named(events, "mmlrec.fit.prep_wait")) / 1e6
    prep_s = sum(t["prep_s"] for t in tr.fit_timing)
    assert abs(span_s - prep_s) <= max(0.1 * prep_s, 2e-3), (span_s, prep_s)


@pytest.mark.parametrize("fixed", [False, True], ids=["dynamic", "fixed"])
def test_each_predict_is_one_span_with_its_children(fixed, tmp_path):
    """One ``mmlrec.serve.predict`` span a call holding the packing once and
    the copies and the forward once a batch (200 rows: one call dynamic,
    four batches of 64 fixed)."""
    bundle, x = _bundle(tmp_path, fixed)
    events, _ = _profiled(lambda: [bundle.predict(x) for _ in range(2)])
    calls = _named(events, "mmlrec.serve.predict")
    assert len(calls) == 2
    per_call = {"mmlrec.serve.pack": 1, **{n: 4 if fixed else 1 for n in SERVE_CHILDREN[1:]}}
    for call in calls:
        for name, count in per_call.items():
            assert len([e for e in _named(events, name) if _inside(e, call)]) == count, name
    for name in SERVE_CHILDREN:
        assert all(any(_inside(e, c) for c in calls) for e in _named(events, name)), name


def test_the_suite_fit_fills_the_same_keys():
    """The stacked suite's epochs hold ``Trainer.fit_timing``'s keys with its
    spans, recorded as the solo fit records them: its set-up once (the
    packing inside it), each epoch phase once an epoch after it, in the
    loop's order, all inside the fit; the sequential suite's capture
    seconds come from each member fit's epochs."""
    cfg = tsyn.make_config(vocab=400, **BASE)
    layout, x, y, _ = tsyn.make_data(cfg, n=256, seed=0, vocab=400)
    _, xv, yv, _ = tsyn.make_data(cfg, n=128, seed=9, vocab=400)
    suite = SeedSuiteTrainer(get_model("mmoe", layout, cfg, device="cpu"), seeds=[0, 2],
                             device="cpu").compile(metrics=["auc"])
    events, outer = _profiled(lambda: suite.fit(x, y, batch_size=64, epochs=2,
                                                validation_data=(xv, yv), verbose=0))
    assert len(suite.fit_timing) == 2
    for t in suite.fit_timing:
        assert tuple(t) == staging.TIMING_KEYS and all(v >= 0 for v in t.values())
        assert t["meta_s"] == 0 and t["upload_s"] > 0 and t["val_s"] > 0
    assert len(_named(events, "mmlrec.fit.stage")) == 1
    for name in EPOCH_SPANS:
        assert len(_named(events, name)) == 2, name
    for name in ("mmlrec.fit.pack", "mmlrec.fit.stage", *EPOCH_SPANS):
        assert all(_inside(e, outer) for e in _named(events, name)), name
    (stage,) = _named(events, "mmlrec.fit.stage")
    (pack,) = _named(events, "mmlrec.fit.pack")
    assert _inside(pack, stage)
    assert all(e.time_range.start >= stage.time_range.end
               for n in EPOCH_SPANS for e in _named(events, n))
    starts = {n: [e.time_range.start for e in _named(events, n)] for n in EPOCH_SPANS}
    for epoch in range(2):
        order = [starts[n][epoch] for n in EPOCH_SPANS]
        assert order == sorted(order), epoch

    cfg2 = tsyn.make_config(vocab=400, two_phase_embedding=True, **BASE)
    seq = SeedSuiteTrainer(get_model("mmoe", layout, cfg2, device="cpu"), seeds=[0, 2],
                           device="cpu").compile(metrics=["auc"])
    seq.fit(x, y, batch_size=64, epochs=2, validation_data=(xv, yv), verbose=0)
    assert seq.sequential and seq.capture_s == [0.0, 0.0]
    assert tuple(seq.tr.fit_timing[-1]) == staging.TIMING_KEYS
