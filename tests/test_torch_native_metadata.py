"""The port's native pass of the host step metadata
(``mmlrec_tpu_torch/csrc/step_metadata_host.cpp`` through
``mmlrec_tpu_torch.native``) held bitwise against the numpy formulation of
``batch_step_metadata`` and against the JAX package's single pass
(``native/step_metadata.cpp``'s ``sm_counts`` / ``sm_fill``, through the
port's bindings), in every form and at every thread count; its upload form
against ``MetaCodec.encode``; and a fit built by it against the same fit on
the numpy fallback.  On the CPU, no JAX.

Tolerance: none.  The metadata is integer bookkeeping of one stable sort.
"""

import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from mmlrec_tpu_torch import native
from mmlrec_tpu_torch import synthetic as tsyn
from mmlrec_tpu_torch.models import get_model
from mmlrec_tpu_torch.train import Trainer, staging
from mmlrec_tpu_torch.train import sparse_embedding as T
from mmlrec_tpu_torch.utils.seeding import make_generator


@pytest.fixture(scope="module")
def built():
    try:
        native.get_host_meta_lib()
        native.get_meta_lib()
    except native.NativeUnavailable:
        pytest.skip("no C++ compiler for the metadata passes")


def _ids(case, steps, K):
    rng = np.random.default_rng(steps * 1000 + K)
    if case == "same":
        return np.full((steps, K), 7, np.int64)
    if case == "bound":  # the largest id the composite holds, beside small ones
        ids = rng.integers(0, 50, (steps, K))
        ids[:, ::3] = (1 << (63 - max(1, (K - 1).bit_length()))) - 1
        return ids
    V = 60 if case == "heavy" else 1 << 13
    return rng.integers(0, V, (steps, K))


def _assert_same(a, b, what):
    assert len(a) == len(b), what
    for i, (x, y) in enumerate(zip(a, b)):
        assert x.dtype == y.dtype and x.shape == y.shape, (what, i, x.dtype, y.dtype)
        assert np.array_equal(x, y), (what, i)


def _sm_fill(ids, P, n_phys, want_route, r_cap_min):
    """The JAX package's pass on numpy's sorted composite, into arrays
    filled with the drop values as its contract asks."""
    steps, K = ids.shape
    idx_bits = max(1, (K - 1).bit_length())
    comp = np.ascontiguousarray(np.sort((ids << idx_bits) | np.arange(K), axis=1))
    Kp = -(-K // 256) * 256
    base = (np.empty((steps, K), np.int32), np.empty((steps, K), np.float32),
            np.empty((steps, Kp), np.int32), np.empty((steps, K), np.int32),
            np.empty((steps, 1), np.int32), np.empty((steps, K), np.float32))
    if not want_route:
        native.step_metadata_fill(comp, idx_bits, P, Kp, 0, 0, *base)
        return base
    n_resid, n_ldup = native.step_metadata_counts(comp, idx_bits, P)
    R = T._quantized_cap(max(int(n_resid.max()), r_cap_min))
    G = T._quantized_cap(max(int(n_ldup.max()), r_cap_min))
    route = (np.zeros((steps, Kp), np.int32), np.zeros((steps, R), np.int32),
             np.full((steps, R), Kp, np.int32), np.zeros((steps, G), np.int32),
             np.full((steps, G), K, np.int32))
    native.step_metadata_fill(comp, idx_bits, P, Kp, R, G, *base, *route)
    return base + route


# (ids, steps, K, pack factor or None for the scatter form, route, route floor)
FORMS = {
    "scatter": ("uniform", 5, 512, None, False, 0),
    "scatter_bound": ("bound", 3, 512, None, False, 0),
    "scatter_one_step": ("heavy", 1, 300, None, False, 0),
    "p1": ("uniform", 5, 512, 1, False, 0),
    "p16": ("heavy", 5, 512, 16, False, 0),
    "p16_k300": ("uniform", 4, 300, 16, False, 0),
    "p16_same": ("same", 3, 512, 16, False, 0),
    "route": ("heavy", 6, 512, 4, True, 0),
    "route_floor": ("uniform", 6, 300, 4, True, 1024),
    "route_one_step": ("heavy", 1, 512, 16, True, 0),
}


@pytest.mark.parametrize("threads", [1, 2, 7])
@pytest.mark.parametrize("form", sorted(FORMS))
def test_the_pass_is_bitwise_numpy_and_sm_fill(form, threads, built, monkeypatch):
    case, steps, K, P, route, floor = FORMS[form]
    ids = _ids(case, steps, K)
    n_phys = None if P is None else 4096 // P + 1024
    kw = dict(pack_factor=P, n_phys_rows=n_phys, want_route=route, r_cap_min=floor)
    want = T.batch_step_metadata(ids, **kw, use_native=False)
    monkeypatch.setattr(native, "usable_threads", lambda steps: threads)
    T.reset_metadata_calls()
    got = T.batch_step_metadata(ids, **kw, use_native=True)
    assert T.metadata_calls == {"native": 1, "numpy": 0}
    _assert_same(got, want, form)
    if P is not None:
        _assert_same(got, _sm_fill(ids, P, n_phys, route, floor), form)
    # the same steps read from shuffled rows of an ids matrix, its first F
    # columns plus offsets (an id at the bound takes none)
    F = 4
    offsets = np.zeros(F, np.int64) if case == "bound" else np.arange(F, dtype=np.int64) * 3
    rows = np.random.default_rng(1).permutation(ids.size // F)
    matrix = np.full((len(rows), F + 1), -1, np.int64 if case == "bound" else np.int32)
    matrix[rows, :F] = ids.reshape(-1, F) - offsets
    got, from_pass = T.epoch_step_metadata(matrix, rows.reshape(steps, -1), offsets, **kw)
    assert from_pass
    _assert_same(got, want, f"{form} from rows")


def test_the_pass_checks_its_ids_and_rows(built):
    K = 512
    with pytest.raises(AssertionError, match="id overflow"):
        T.batch_step_metadata(np.full((2, K), 1 << (63 - 9)), use_native=True)
    with pytest.raises(AssertionError, match="id overflow"):
        T.batch_step_metadata(np.full((2, K), 1 << (63 - 9)), use_native=False)
    with pytest.raises(ValueError, match="negative id"):
        T.batch_step_metadata(np.full((2, K), -1), 4, 4096, use_native=True)
    matrix = np.zeros((8, 3), np.int32)
    with pytest.raises(IndexError):
        T.epoch_step_metadata(matrix, np.array([[0, 8]]), np.zeros(3, np.int64))
    with pytest.raises(ValueError, match="offsets"):
        T.epoch_step_metadata(matrix, np.array([[0, 1]]), np.zeros(4, np.int64))


def test_threads_follow_the_affinity_mask(monkeypatch):
    for cores, steps, want in ((1, 256, 1), (2, 256, 1), (8, 256, 7), (8, 3, 3), (8, 1, 1)):
        monkeypatch.setattr(native.os, "sched_getaffinity", lambda pid: set(range(cores)))
        assert native.usable_threads(steps) == want, (cores, steps)


def _codec_trainer(update, space="position"):
    return SimpleNamespace(cfg=SimpleNamespace(model_config=SimpleNamespace(extra={})),
                           table_update=update, update_space=space)


@pytest.mark.parametrize("update,space,route", [
    ("scatter", "position", False), ("pallas", "position", False),
    ("pallas", "position", True), ("pallas", "slot", True)])
def test_the_upload_form_is_the_codecs_encoding(update, space, route, built):
    """With the fit's codec fixed, the pass writes ``MetaCodec.encode`` of
    the raw arrays byte for byte, dead entries included, into the caller's
    buffers, which a later build rewrites in place."""
    ids = _ids("heavy", 6, 512)
    kw = {} if update == "scatter" else dict(pack_factor=4, n_phys_rows=2048, want_route=route)
    raw = T.batch_step_metadata(ids, **kw, use_native=False)
    codec = staging.meta_codec(_codec_trainer(update, space), raw)
    assert codec is not None
    matrix, rows = ids.reshape(-1, 4), np.arange(ids.size // 4).reshape(6, -1)
    out = {}
    got, from_pass = T.epoch_step_metadata(matrix, rows, np.zeros(4, np.int64),
                                           widths=codec.widths(), out=out, **kw)
    assert from_pass
    _assert_same(got, codec.encode(raw), f"{update} {space} {route}")
    again = _ids("uniform", 6, 512)
    raw = T.batch_step_metadata(again, **kw, use_native=False)
    got2, _ = T.epoch_step_metadata(again.reshape(-1, 4), rows, np.zeros(4, np.int64),
                                    widths=codec.widths(), out=out, **kw)
    _assert_same(got2, codec.encode(raw), "rewritten")
    assert all(a is b for a, b in zip(got, got2) if a.shape == b.shape)


BASE = dict(task_name="mtl", model_name="mmoe", n_sparse=4, n_dense=2, hidden=(16, 8),
            tower=(8,), gate=(8,), batch_size=64, lr=3e-3, vocab=1 << 12,
            two_phase_embedding=True, table_update="pallas")


def _fit(max_steps=0):
    """Three epochs of 5 steps (264 of 330 rows; 66 validate)."""
    cfg = tsyn.make_config(**BASE)
    cfg.training_config.max_steps = max_steps
    layout, x, y, _ = tsyn.make_data(cfg, n=330, seed=0, vocab=1 << 12)
    model = get_model("mmoe", layout, cfg, generator=make_generator(0), device="cpu")
    tr = Trainer(model, seed=0, device="cpu").compile(metrics=["auc"])
    tr.fit(x, y, batch_size=64, epochs=3, validation_split=0.2, verbose=0)
    state = {k: v.clone() for k, v in tr.model.state_dict().items()}
    state.update({f"table_opt/{k}": v.clone() for k, v in tr.table_opt._asdict().items()})
    history = [{k: v for k, v in h.items() if k != "epoch_s"} for h in tr.history]
    return tr, state, history, tr.predict(x, 100)


def test_a_shuffled_fit_built_by_the_pass_equals_the_numpy_fit(built, monkeypatch):
    """A full-shuffle fit of three epochs with the metadata worker: every
    epoch's stacks from the pass (``meta_native`` 1.0) or, with no library,
    from numpy (0.0); the histories, states and predictions bitwise."""
    tr, state, history, probs = _fit()
    assert [t["meta_native"] for t in tr.fit_timing] == [1.0] * 3
    assert tuple(tr.fit_timing[0]) == staging.TIMING_KEYS

    def unavailable():
        raise native.NativeUnavailable("no library")

    monkeypatch.setattr(native, "get_host_meta_lib", unavailable)
    tr2, state2, history2, probs2 = _fit()
    assert [t["meta_native"] for t in tr2.fit_timing] == [0.0] * 3
    assert history == history2 and state.keys() == state2.keys()
    for k in state:
        assert torch.equal(state[k], state2[k]), k
    np.testing.assert_array_equal(probs, probs2)


@pytest.mark.parametrize("max_steps,ahead", [(0, True), (15, True), (14, False)])
def test_the_worker_runs_unless_max_steps_cuts_an_epoch_short(max_steps, ahead, monkeypatch):
    """The worker builds epochs 2 and 3 while their predecessors run, unless
    ``max_steps`` would cut the last epoch short; a cap that cannot bind
    leaves the fit bitwise the uncapped one."""
    on_main = []
    real = staging.fs_host_prep
    monkeypatch.setattr(staging, "fs_host_prep", lambda *a: on_main.append(
        threading.current_thread() is threading.main_thread()) or real(*a))
    tr, state, history, probs = _fit(max_steps)
    assert on_main == ([True, False, False] if ahead else [True, True, True])
    if max_steps == 15:
        _, state0, history0, probs0 = _fit()
        assert history == history0
        assert all(torch.equal(state[k], state0[k]) for k in state)
        np.testing.assert_array_equal(probs, probs0)
