"""The port's fit on the JAX package's default path (train/staging.py,
train/graphs.py, the flat optimizer), on the CPU.

Within the port everything is held bitwise: the staged dataset against the
streaming loop, ``scan_steps`` 0 / 3 / ``true`` against each other (on the
CPU a chunk runs as eager steps; on the card as graph replays, which
``chip_smoke.py`` phase 12 holds bitwise against eager), the flat optimizer
against the per-tensor one, ``prefetch_batches`` 1 against 3, the
thread-ahead pool against the synchronous loop and a resumed fit against
an uninterrupted one: each path does the same f32 operations on the same
values.  Against the JAX trainer: the fit in block mode with scanned
steps, from one state carried over by ``convert.load_jax_train_state``, at
``test_torch_dense_fit.py``'s tolerances (losses rtol 1e-5, parameters
atol 1e-6; XLA sums in another order), the metadata codec bitwise, the
flat-optimizer rule's four cases, and ``batch_metric_curves``,
``epoch_callback``, ``reset_for_seed`` and ``profile`` by their outputs.
"""

import os
import threading
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_dense_fit as dense_t
import test_torch_f32_two_phase as f32_t
from mmlrec_tpu import synthetic as jsyn
from mmlrec_tpu.models import get_model as jax_get_model
from mmlrec_tpu.train import Trainer as JaxTrainer
from mmlrec_tpu.train import staging as jstaging
from mmlrec_tpu.train.sparse_embedding import batch_step_metadata as jax_batch_step_metadata
from mmlrec_tpu_torch import synthetic as tsyn
from mmlrec_tpu_torch.convert import load_jax_train_state
from mmlrec_tpu_torch.models import get_model
from mmlrec_tpu_torch.train import Trainer, staging
from mmlrec_tpu_torch.train.metrics import regime_eval
from mmlrec_tpu_torch.train.optimizers import Flat, FlatTensors, get_optimizer
from mmlrec_tpu_torch.utils.seeding import make_generator

BASE = dict(task_name="mtl", model_name="mmoe", n_sparse=4, n_dense=2, hidden=(16, 8),
            tower=(8,), gate=(8,), batch_size=64, lr=3e-3, dnn_dropout=0.2)
# the fit's kinds: the dense fit, the two-phase step with in-step (device)
# metadata, and with host metadata through the codec (the write kernel's six
# stacks, and the scatter update's two)
MODES = {
    "dense": dict(vocab=400),
    "device_meta": dict(vocab=1 << 16, two_phase_embedding=True, table_update="pallas",
                        table_opt_dtype="bfloat16", device_metadata=True),
    "host_meta": dict(vocab=1 << 16, two_phase_embedding=True, table_update="pallas"),
    "host_meta_scatter": dict(vocab=400, two_phase_embedding=True),
}
N = 330  # 6 batches of 64, the last of 10 rows: a ragged tail


def _trainer(mode, metrics=("auc",), seed=0, n=N, **extra):
    kw = {**BASE, **MODES[mode], **extra}
    vocab = kw.pop("vocab")
    cfg = tsyn.make_config(vocab=vocab, **kw)
    layout, x, y, _ = tsyn.make_data(cfg, n=n, seed=0, vocab=vocab)
    model = get_model("mmoe", layout, cfg, generator=make_generator(seed), device="cpu")
    return Trainer(model, seed=0, device="cpu").compile(metrics=list(metrics)), x, y


def _state(tr):
    """Every tensor the fit moves, by name, and the logs."""
    out = {f"model/{k}": v.clone() for k, v in tr.model.state_dict().items()}
    for field, value in tr.opt_state._asdict().items():
        for k, t in (value.items() if isinstance(value, dict) else [("", value)]):
            out[f"opt/{field}/{k}"] = t.clone()
    if tr.table_opt is not None:
        out.update({f"table_opt/{k}": t.clone() for k, t in tr.table_opt._asdict().items()})
    return out, [{k: v for k, v in h.items() if k != "epoch_s"} for h in tr.history]


def _assert_bitwise(a, b, what, train_metrics=True):
    """Every tensor and log bitwise; without ``train_metrics`` the logs'
    train metrics are left out (the losses and val_ keys stay)."""
    (sa, ha), (sb, hb) = a, b
    assert sa.keys() == sb.keys(), what
    for k in sa:
        assert torch.equal(sa[k], sb[k]), f"{what}: {k}"
    if not train_metrics:
        ha, hb = ([{k: v for k, v in h.items() if k == "loss" or k.startswith("val_")}
                   for h in logs] for logs in (ha, hb))
    assert ha == hb, what


def _fit(tr, x, y, **kw):
    tr.fit(x, y, batch_size=64, epochs=kw.pop("epochs", 2), verbose=0, **kw)
    return tr


def _streamed(mode, shuffle):
    tr, x, y = _trainer(mode)
    tr._device_data_bytes_cap = 0  # force the streaming loop
    return _state(_fit(tr, x, y, shuffle=shuffle))


@pytest.mark.parametrize("shuffle", [True, "block"])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_staged_equals_streaming_bitwise(mode, shuffle):
    """The staged paths against each other, and the streaming fit against
    the staged one: every tensor and loss bitwise.  The streaming fit's
    train metrics also count the last batch's pads, as JAX's streaming
    loop does (staging.py:748-752; test_streaming_fit_matches_jax), so they
    are left out of that comparison.  ``shuffle="block"`` streams in data
    order, as the JAX streaming loop does (trainer.py:1538): its streaming
    arm is held against the streaming ``shuffle=False`` fit, logs included,
    the equality JAX has."""
    runs = {}
    # scan_steps 3 (two chunks an epoch) for the dense kind only: the
    # two-phase kinds run the same chunk loop
    for scan in ((0, 3, True) if mode == "dense" else (0, True)):
        tr, x, y = _trainer(mode, scan_steps=scan)
        runs[f"staged scan_steps={scan}"] = _state(_fit(tr, x, y, shuffle=shuffle))
        assert tr.graph_replays == {"train": 0, "eval": 0}  # the CPU replays nothing
    streaming = _streamed(mode, shuffle)
    if shuffle == "block":
        _assert_bitwise(streaming, _streamed(mode, False),
                        f"{mode}, streaming shuffle=block vs shuffle=False")
    base = runs.pop("staged scan_steps=0")
    assert len(base[1]) == 2 and "auc" in base[1][-1]
    for name, run in runs.items():
        _assert_bitwise(run, base, f"{mode}, shuffle={shuffle}, {name}")
    if shuffle is True:
        _assert_bitwise(streaming, base, f"{mode}, shuffle=True, streaming",
                        train_metrics=False)


# (fit kind, task_name, metrics, model_config extras): the staged fit's
# train metrics counted on the device where every compiled metric is
# counted and no per-batch curve is asked for, else on the host
TRAIN_METRICS_CASES = {
    "mtl": ("host_meta", "mtl", ("auc", "acc"), {}),
    "msl": ("dense", "msl", ("auc", "accuracy"), {}),
    "logloss": ("dense", "mtl", ("auc", "acc", "logloss"), {}),
    "batch_curves": ("dense", "mtl", ("auc",), dict(batch_metric_curves=True)),
}


@pytest.mark.parametrize("case", sorted(TRAIN_METRICS_CASES))
def test_train_metrics_on_the_device_equal_the_host_bitwise(case):
    """A staged ``shuffle=False`` fit over whole batches (no pad rows)
    against the same fit streamed, whose train metrics ``regime_eval``
    computes on the host over the same rows: every tensor and log bitwise,
    train metrics included; ``fit_timing``'s ``metrics_device`` is 1.0 in
    each staged epoch of the counted cases and 0.0 elsewhere."""
    mode, task_name, metrics, extra = TRAIN_METRICS_CASES[case]
    runs = {}
    for path in ("staged", "streamed"):
        tr, x, y = _trainer(mode, metrics, n=320, task_name=task_name, **extra)
        if path == "streamed":
            tr._device_data_bytes_cap = 0
        runs[path] = _state(_fit(tr, x, y, shuffle=False))
        on_device = path == "staged" and case in ("mtl", "msl")
        assert [t["metrics_device"] for t in tr.fit_timing] == [float(on_device)] * 2, path
    _assert_bitwise(runs["staged"], runs["streamed"], f"{case}: staged vs streamed")
    assert set(metrics) <= set(runs["staged"][1][-1])


def test_block_mode_train_metrics_on_the_device_skip_the_pads():
    """Block mode over a ragged tail (pad rows at weight 0, the batches in a
    drawn order): the counted AUC and accuracy equal the host's of the same
    fit, which ``logloss`` sends to the host path."""
    logs = []
    for metrics in (("auc", "acc"), ("auc", "acc", "logloss")):
        tr, x, y = _trainer("host_meta_scatter", metrics)
        _fit(tr, x, y, shuffle="block", epochs=3)
        assert [t["metrics_device"] for t in tr.fit_timing] == [float(len(metrics) == 2)] * 3
        logs.append([{k: h[k] for k in ("loss", "auc", "acc")} for h in tr.history])
    assert logs[0] == logs[1]


def test_staged_path_takes_batches_on_the_device(monkeypatch):
    """The staged fit uploads the dataset once and the step takes its rows
    by index; the streaming fit uploads every batch."""
    seen = []
    real = staging.stage_dataset
    monkeypatch.setattr(staging, "stage_dataset",
                        lambda *a: seen.append(a[1].shape) or real(*a))
    tr, x, y = _trainer("host_meta")
    _fit(tr, x, y, epochs=3)
    assert seen == [(N, 4)]
    assert tr._scan_steps == 16 and isinstance(tr.tx, Flat)
    codec = tr._meta_codec  # the write kernel's six stacks, compacted
    assert [k for k, _ in codec.kinds] == ["idx16", "mask8", "raw", "idx16", "raw", "mask8"]
    seen.clear()
    tr2, x, y = _trainer("host_meta")
    tr2._device_data_bytes_cap = 0
    _fit(tr2, x, y)
    assert seen == []


@pytest.mark.parametrize("jax_side,scan", [("dense", 3), ("dense", True),
                                           ("f32_two_phase", 3)])
def test_block_mode_scanned_fit_matches_jax(jax_side, scan):
    """``shuffle="block"`` with ``scan_steps`` on both sides, from one state:
    the same block permutation and batch orders (one default_rng), the same
    steps within f32 reordering."""
    if jax_side == "dense":
        jtr, x, y = dense_t._jax_side(1, scan_steps=scan)
        tr = dense_t._port_trainer(1, dense_t._state_of(jtr), scan_steps=scan)
    else:
        jtr, x, y = f32_t._jax_side("pallas", 1)
        cfg = tsyn.make_config(vocab=f32_t.VOCAB[1], table_update="pallas", scan_steps=scan,
                               **f32_t.KW)
        layout, *_ = tsyn.make_data(cfg, n=8, seed=0, vocab=f32_t.VOCAB[1])
        tr = Trainer(get_model("mmoe", layout, cfg, device="cpu"), seed=0,
                     device="cpu").compile()
        load_jax_train_state(tr, *f32_t._state_of(jtr))
        jtr._scan_steps = scan if scan is not True else -1
    assert tr._scan_steps == (3 if scan == 3 else -1)
    rows = (dense_t._rows(x, 160, 328), y[160:328])  # 3 batches, the last of 40 rows
    jtr.fit(*rows, batch_size=64, epochs=2, shuffle="block", verbose=0)
    tr.fit(*rows, batch_size=64, epochs=2, shuffle="block", verbose=0)
    dense_t._assert_same_history(tr, jtr, 2)
    dense_t._assert_same_params(tr, jtr.variables["params"])


@pytest.mark.parametrize("jax_side,shuffle", [("dense", "block"), ("f32_two_phase", "block"),
                                               ("dense", True)])
def test_streaming_fit_matches_jax(jax_side, shuffle):
    """The fit over the cap (a cap of 0 bytes on both sides), two epochs of
    3 batches, the last of 40 rows, at the dense fit's tolerances.  With
    ``shuffle="block"`` JAX's streaming loop takes the rows in data order
    and draws nothing (trainer.py:1538), so the port's must too; either
    way the train metrics count the last batch's pads (staging.py:748-752)."""
    if jax_side == "dense":
        jtr, x, y = dense_t._jax_side(1)
        tr = dense_t._port_trainer(1, dense_t._state_of(jtr))
    else:
        jtr, x, y = f32_t._jax_side("pallas", 1)
        cfg = tsyn.make_config(vocab=f32_t.VOCAB[1], table_update="pallas", **f32_t.KW)
        layout, *_ = tsyn.make_data(cfg, n=8, seed=0, vocab=f32_t.VOCAB[1])
        tr = Trainer(get_model("mmoe", layout, cfg, device="cpu"), seed=0,
                     device="cpu").compile()
        load_jax_train_state(tr, *f32_t._state_of(jtr))
    assert tr.cfg.model_config.dnn_dropout == 0
    jtr._device_data_bytes_cap = tr._device_data_bytes_cap = 0
    rows = (dense_t._rows(x, 160, 328), y[160:328])
    jtr.fit(*rows, batch_size=64, epochs=2, shuffle=shuffle, verbose=0)
    tr.fit(*rows, batch_size=64, epochs=2, shuffle=shuffle, verbose=0)
    dense_t._assert_same_history(tr, jtr, 2)
    dense_t._assert_same_params(tr, jtr.variables["params"])
    if jax_side != "dense":
        table = jtr.variables["params"]["embeddings"]["fused"]["table"]
        np.testing.assert_allclose(tr.table.detach().numpy(), np.asarray(table), rtol=0,
                                   atol=1e-6)


@pytest.mark.parametrize("optimizer", ["adam", "adagrad", "rmsprop", "sgd"])
def test_flat_optimizer_bitwise_equal_to_per_tensor(optimizer):
    states = {}
    for flat in (True, False):
        cfg = tsyn.make_config(vocab=400, optimizer=optimizer, flat_optimizer=flat,
                               **{**BASE, "dnn_dropout": 0.0})
        layout, x, y, _ = tsyn.make_data(cfg, n=N, seed=0, vocab=400)
        tr = Trainer(get_model("mmoe", layout, cfg, device="cpu"), seed=0,
                     device="cpu").compile(optimizer=optimizer)
        assert isinstance(tr.tx, Flat) == flat
        states[flat] = _state(_fit(tr, x, y))
        fields = [v for v in tr.opt_state if isinstance(v, dict)]
        assert all(isinstance(f, FlatTensors) == flat for f in fields)
    _assert_bitwise(states[True], states[False], optimizer)
    # one step on random tensors of several shapes: the flat chain is the
    # per-tensor chain
    g = torch.Generator().manual_seed(3)
    shapes = {"a": (7, 3), "b": (5,), "c": (2, 4, 6)}
    params = {k: torch.randn(s, generator=g) for k, s in shapes.items()}
    grads = [{k: torch.randn(s, generator=g) for k, s in shapes.items()} for _ in range(3)]
    out = {}
    for flat in (True, False):
        tx = get_optimizer(optimizer, 0.01)
        tx = Flat(tx) if flat else tx
        p = {k: v.clone() for k, v in params.items()}
        st = tx.init(p)
        for gr in grads:
            assert tx.step(p, gr, st) is st  # in place
        out[flat] = p
    for k in shapes:
        assert torch.equal(out[True][k], out[False][k]), (optimizer, k)


@pytest.mark.parametrize("case", ["default", "opt_out", "large_table", "large_two_phase"])
def test_use_flat_optimizer_cases_match_jax(case):
    kw = dict(task_name="mtl", model_name="mmoe", emb=8, n_sparse=4, n_dense=2,
              hidden=(16, 8), tower=(8,), gate=(8,))
    vocab = 400
    if case == "opt_out":
        kw["flat_optimizer"] = False
    if case.startswith("large"):
        vocab = 1 << 18  # 4 x 2^18 x 8 = 2^23 elements >= 2^22
    if case == "large_two_phase":
        kw["two_phase_embedding"] = True
    jcfg = jsyn.make_config(vocab=vocab, **kw)
    jlayout, *_ = jsyn.make_data(jcfg, n=8, seed=0, vocab=vocab)
    want = JaxTrainer(jax_get_model("mmoe", jlayout, jcfg), seed=0)._use_flat_optimizer()
    cfg = tsyn.make_config(vocab=vocab, **kw)
    layout, *_ = tsyn.make_data(cfg, n=8, seed=0, vocab=vocab)
    tr = Trainer(get_model("mmoe", layout, cfg, device="cpu"), device="cpu").compile()
    assert tr._use_flat_optimizer() == want == (case in ("default", "large_two_phase"))
    assert isinstance(tr.tx, Flat) == want


@pytest.mark.parametrize("mode", ["host_meta", "dense"])
def test_prefetch_depths_equal_bitwise(mode):
    runs = {}
    for depth in (1, 3):
        tr, x, y = _trainer(mode, prefetch_batches=depth)
        tr._device_data_bytes_cap = 0  # the streaming loop reads the depth
        runs[depth] = _state(_fit(tr, x, y))
    _assert_bitwise(runs[3], runs[1], mode)


def test_thread_ahead_pool_equals_synchronous_loop(monkeypatch):
    """Epoch e+1's permutation is drawn on the main thread in the loop's
    order and its metadata built on the worker: the fit equals the loop
    without the pool (prefetch_batches 0 turns it off)."""
    threads = []
    real = staging.fs_host_prep
    monkeypatch.setattr(staging, "fs_host_prep", lambda *a: threads.append(
        threading.current_thread() is threading.main_thread()) or real(*a))
    runs = {}
    for depth in (2, 0):
        threads.clear()
        tr, x, y = _trainer("host_meta", prefetch_batches=depth)
        runs[depth] = _state(_fit(tr, x, y, epochs=3))
        assert threads == ([True, False, False] if depth else [True, True, True])
    _assert_bitwise(runs[2], runs[0], "thread-ahead")


def _jax_codec_trainer(update, space="position"):
    return types.SimpleNamespace(
        cfg=types.SimpleNamespace(model_config=types.SimpleNamespace(extra={})),
        mesh=None, update_space=space, table_update=update)


@pytest.mark.parametrize("update", ["scatter", "pallas"])
def test_meta_codec_matches_jax_on_step_stacks(update):
    rng = np.random.default_rng(0)
    flat = rng.integers(0, 3000, (3, 512)).astype(np.int64)
    meta = (jax_batch_step_metadata(flat) if update == "scatter"
            else jax_batch_step_metadata(flat, 4, 4096 // 4))
    tr = _jax_codec_trainer(update)
    jcodec, codec = jstaging.meta_codec(tr, meta), staging.meta_codec(tr, meta)
    assert codec.kinds == jcodec.kinds
    _assert_codec_equal(codec, jcodec, meta)


def test_meta_codec_matches_jax_with_the_k65536_sentinels():
    """The gather route's kinds (dead, slot16) on stacks that hit the uint16
    limit: K = Kp = 65,536, whose drop values 65,536 ride as 65,535."""
    K = Kp = 65536
    rng = np.random.default_rng(1)
    idx = rng.integers(0, K, (2, K)).astype(np.int32)
    idx[:, :3] = [0, K - 1, K - 2]
    slot = rng.integers(0, Kp, (2, K)).astype(np.int32)
    slot[slot == Kp - 1] = Kp - 2  # a real slot is below nuniq <= 65,535
    slot[:, :4] = [Kp, Kp - 2, 0, Kp]  # drop values among real slots
    meta = (idx, (rng.random((2, K)) < 0.5).astype(np.float32),
            rng.integers(0, 10**7, (2, Kp)).astype(np.int32), idx.copy(),
            np.full((2, 1), 60000, np.int32), (rng.random((2, K)) < 0.5).astype(np.float32),
            idx.copy(), idx.copy(), slot, idx.copy(), np.where(slot == Kp, K, slot))
    for space in ("position", "slot"):
        tr = _jax_codec_trainer("pallas", space)
        jcodec, codec = jstaging.meta_codec(tr, meta), staging.meta_codec(tr, meta)
        assert codec.kinds == jcodec.kinds and ("slot16", K) in codec.kinds
        _assert_codec_equal(codec, jcodec, meta)
    # above the uint16 range there is no codec, on either side
    wide = (np.zeros((1, K + 1), np.int32), np.zeros((1, K + 1), np.float32))
    assert staging.meta_codec(tr, wide) is None and jstaging.meta_codec(tr, wide) is None


def _assert_codec_equal(codec, jcodec, meta):
    enc, jenc = codec.encode(meta), jcodec.encode(meta)
    for a, b in zip(enc, jenc):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    for s in range(meta[0].shape[0]):
        rows = tuple(torch.from_numpy(staging.upload_form(a))[s] for a in enc)
        got = codec.decode(rows)
        want = jcodec.decode(tuple(jnp.asarray(a[s]) for a in jenc))
        for i, (a, b) in enumerate(zip(got, want)):
            b = np.asarray(b)
            assert a.numpy().dtype == b.dtype and np.array_equal(a.numpy(), b), (s, i)
        for i, (kind, _) in enumerate(codec.kinds):
            if kind != "dead":  # what the step reads is the stack's row
                np.testing.assert_array_equal(got[i].numpy(), meta[i][s])


# each fit() call draws its orders from default_rng(seed) afresh, as the JAX
# fit does, so a resumed fit repeats the uninterrupted one's orders only
# unshuffled; the dropout draws continue from the saved generator
@pytest.mark.parametrize("mode,shuffle", [("host_meta", False), ("dense", False)])
def test_resumed_staged_fit_equals_uninterrupted_bitwise(tmp_path, mode, shuffle):
    full, x, y = _trainer(mode)
    _fit(full, x, y, epochs=3, shuffle=shuffle)
    first, *_ = _trainer(mode)
    _fit(first, x, y, epochs=1, shuffle=shuffle)
    state = first.save_training_state(str(tmp_path))
    resumed, *_ = _trainer(mode)
    _fit(resumed, x, y, epochs=3, shuffle=shuffle, resume_from=state)
    a, b = _state(full), _state(resumed)
    _assert_bitwise((a[0], a[1][1:]), (b[0], b[1]), "resumed")


def _both_fits(batch_metric_curves=True, **fit_kw):
    """The JAX and the port trainer from one state, compiled with AUC."""
    extra = dict(batch_metric_curves=batch_metric_curves)
    jtr, x, y = dense_t._jax_side(1, **extra)
    jtr.compile(metrics=["auc"])
    tr = dense_t._port_trainer(1, dense_t._state_of(jtr), **extra)
    tr.compile(metrics=["auc"])
    return jtr, tr, x, y


@pytest.mark.parametrize("path", ["staged", "block", "streaming"])
def test_batch_metric_curves_match_jax(path):
    jtr, tr, x, y = _both_fits()
    kw = dict(shuffle="block") if path == "block" else {}
    if path == "streaming":
        jtr._device_data_bytes_cap = tr._device_data_bytes_cap = 0
    rows = (dense_t._rows(x, 160, 352), y[160:352])  # 3 batches of 64
    jtr.batch_history, tr.batch_history = [], []
    jtr.fit(*rows, batch_size=64, epochs=2, verbose=0, **kw)
    tr.fit(*rows, batch_size=64, epochs=2, verbose=0, **kw)
    assert len(tr.batch_history) == len(jtr.batch_history) == 2
    for got, want in zip(tr.batch_history, jtr.batch_history):
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            np.testing.assert_allclose(g["auc"], w["auc"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(tr.history[-1]["batch_mean_auc"],
                               jtr.history[-1]["batch_mean_auc"], rtol=0, atol=1e-5)


def test_epoch_callback_and_reset_for_seed_match_jax():
    jtr, tr, x, y = _both_fits(batch_metric_curves=False)
    calls = {"jax": [], "port": []}
    rows = (dense_t._rows(x, 160, 328), y[160:328])
    for name, t in (("jax", jtr), ("port", tr)):
        start = len(t.history)  # the JAX trainer's history holds its warm-up fit
        t.fit(*rows, batch_size=64, epochs=3, verbose=0, epoch_callback=lambda e, t, n=name,
              s=start: calls[n].append((e, len(t.history) - s, t.history[-1]["loss"])))
    assert [c[:2] for c in calls["port"]] == [c[:2] for c in calls["jax"]] == [
        (0, 1), (1, 2), (2, 3)]
    np.testing.assert_allclose([c[2] for c in calls["port"]], [c[2] for c in calls["jax"]],
                               rtol=1e-5)
    jtr.reset_for_seed(7)
    tr.reset_for_seed(7)
    for t in (jtr, tr):
        assert (t.seed, t.history, t.batch_history, t.best_variables,
                t.throughput_examples_per_s) == (7, [], [], None, None)
    # the port's reset draws the weights for the seed as get_model does: a
    # fit after it equals a fresh trainer's for that seed, bitwise
    fresh = get_model("mmoe", tr.layout, tr.cfg, generator=make_generator(7), device="cpu")
    other = Trainer(fresh, seed=7, device="cpu").compile(metrics=["auc"])
    assert all(torch.equal(a, b) for a, b in zip(tr.model.state_dict().values(),
                                                 fresh.state_dict().values()))
    tr.fit(*rows, batch_size=64, epochs=1, verbose=0)
    other.fit(*rows, batch_size=64, epochs=1, verbose=0)
    _assert_bitwise(_state(tr), _state(other), "reset_for_seed")


def test_profile_returns_its_trace_dir_as_jax(tmp_path):
    jtr, tr, x, y = _both_fits(batch_metric_curves=False)
    want = jtr.profile(x, y, batch_size=32, steps=1, trace_dir=str(tmp_path / "jax"))
    got = tr.profile(x, y, batch_size=32, steps=1, trace_dir=str(tmp_path / "port"))
    assert (want, got) == (str(tmp_path / "jax"), str(tmp_path / "port"))
    files = [f for _, _, fs in os.walk(got) for f in fs]
    assert any(f.endswith(".pt.trace.json") for f in files), files


def test_scan_steps_auto_rule_matches_jax():
    for raw, want in ((None, 16), (True, -1), (0, 0), (5, 5)):
        kw = {} if raw is None else dict(scan_steps=raw)
        jcfg = jsyn.make_config(vocab=400, **BASE, **kw)
        jlayout, *_ = jsyn.make_data(jcfg, n=8, seed=0, vocab=400)
        cfg = tsyn.make_config(vocab=400, **BASE, **kw)
        layout, *_ = tsyn.make_data(cfg, n=8, seed=0, vocab=400)
        j = JaxTrainer(jax_get_model("mmoe", jlayout, jcfg), seed=0)
        t = Trainer(get_model("mmoe", layout, cfg, device="cpu"), device="cpu")
        assert t._scan_steps == j._scan_steps == want
        assert t._prefetch_batches == j._prefetch_batches == 2
        assert t._device_data_bytes_cap == j._device_data_bytes_cap == 4 * 1024**3


def test_eval_program_equals_the_plain_forward():
    """predict and evaluate run the eval program (a replayed forward per
    batch on the card); on the CPU its batches equal the model's forward."""
    tr, x, y = _trainer("dense", metrics=("auc",))
    _fit(tr, x, y, epochs=1)
    ids, dense = tr.pack_inputs(x)
    want = []
    with torch.no_grad():
        for s in range(0, N, 100):
            a, b = torch.from_numpy(ids[s:s + 100]), torch.from_numpy(dense[s:s + 100])
            want.append(tr.model(a, b, None))
    want = torch.cat(want).numpy().astype(np.float64)
    np.testing.assert_array_equal(tr.predict(x, 100), want)  # 4 batches, the last padded
    assert tr.evaluate(x, y, 100) == regime_eval(
        tr.metric_fns, tr._prepare_y(y), want, "mtl", 2)


@pytest.mark.parametrize("update", ["scatter", "pallas"])
def test_epoch_metadata_is_one_call_equal_to_jax(update):
    """step_metadata builds an epoch's stacks in one batch_step_metadata
    call, as the JAX package's does on its worker; the stacks equal JAX's,
    array by array."""
    from mmlrec_tpu_torch.train import sparse_embedding as T

    tr, *_ = _trainer("host_meta" if update == "pallas" else "host_meta_scatter")
    flat = np.random.default_rng(2).integers(0, 1 << 17, (7, 256)).astype(np.int64)
    T.reset_metadata_calls()
    got = staging.step_metadata(tr, flat)
    assert sum(T.metadata_calls.values()) == 1
    want = (jax_batch_step_metadata(flat) if update == "scatter"
            else jax_batch_step_metadata(flat, tr._emb_pack_factor, tr._emb_phys_rows))
    assert len(got) == len(want) == (2 if update == "scatter" else 6)
    for a, b in zip(got, want):
        b = np.asarray(b)
        assert a.dtype == b.dtype and np.array_equal(a, b)
