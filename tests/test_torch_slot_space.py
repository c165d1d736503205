"""Slot space (``update_space="slot"``): the stacked container's update at
the batch's unique physical rows (``two_phase_sparse_adam_slot``), with its
phase 1 (the dual gather by ``pids`` with ``n_real``, then a take by
``pinv``), held against the JAX package on the CPU.

* The update bitwise against the JAX function on the same inputs (its
  Pallas write in interpret mode), and against the port's own position
  path; the pad slots hold the gather's poison and are never written.
* Inside the port, slot == position bitwise for a whole fit, as the JAX
  package pins it; ``update_space="auto"`` resolves from the first batch
  as JAX's does (slot from 25% physical duplication on the stacked
  container with the gather route).
* A fit against the JAX trainer from one carried state at
  ``test_torch_two_phase_fit.py``'s tolerances, and JAX's ValueErrors.
* The route lists' widths may grow in a later epoch of a full shuffle (the
  floor is a minimum): the fit then reallocates its metadata buffers, and
  equals the streaming fit, which builds each batch's lists alone, bitwise.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_route_common as C
from mmlrec_tpu import synthetic as jsyn
from mmlrec_tpu.models import get_model as jax_get_model
from mmlrec_tpu.train import Trainer as JaxTrainer
from mmlrec_tpu.train import sparse_embedding as J
from mmlrec_tpu.train import staging as jstaging
from mmlrec_tpu_torch import synthetic as tsyn
from mmlrec_tpu_torch.models import get_model
from mmlrec_tpu_torch.ops.row_gather import rows_gather_dual
from mmlrec_tpu_torch.train import Trainer, staging
from mmlrec_tpu_torch.train import sparse_embedding as T

ROUTE = ("accperm", "resid_pos", "resid_slot", "gdup_pos", "gdup_tgt")
STACKED = dict(table_update="pallas", table_opt_dtype="bfloat16", table_container="stacked")


def _slot_case(P, seed=5):
    D, K, Vp = 8, 512, 1024
    rng = np.random.default_rng(seed)
    fat = rng.normal(size=(2 * Vp, P * D)).astype(np.float32)
    fat[Vp:] = T.pack_monu_rounded(
        torch.from_numpy(rng.normal(0, 1e-2, (Vp, P * D)).astype(np.float32)),
        torch.from_numpy(np.abs(rng.normal(0, 1e-3, (Vp, P * D))).astype(np.float32))).numpy()
    flat = ((rng.zipf(1.1, K) - 1) % (Vp * P)).astype(np.int32)
    g = rng.normal(size=(K, D)).astype(np.float32)
    meta = T.batch_step_metadata(flat[None].astype(np.int64), P, Vp, want_route=True,
                                 use_native=False)
    m = [torch.from_numpy(a[0]) for a in meta]
    pair = rows_gather_dual(torch.from_numpy(fat).view(2, Vp, P * D), m[2], n_real=m[4])
    return fat, flat, g, m, pair


def _port_slot(fat, flat, g, m, pair, P):
    t = torch.from_numpy(fat.copy())
    t, st = T.two_phase_sparse_adam_slot(
        t, torch.from_numpy(g), torch.from_numpy(flat), m[1], m[2], m[4], pair[0], pair[1],
        T.SparseAdamFoldedState(count=torch.tensor(2, dtype=torch.int32)), 0.05, *m[6:],
        pack_factor=P)
    assert int(st.count) == 3
    return t


@pytest.mark.parametrize("P", [1, 16])
def test_slot_update_matches_jax_and_the_position_path(P):
    fat, flat, g, m, pair = _slot_case(P)
    n = int(m[4][0])
    assert n < m[2].shape[0] and torch.isnan(pair[:, n:]).all()  # the pads: poison
    got = _port_slot(fat, flat, g, m, pair, P)
    jm = [jnp.asarray(a.numpy()) for a in m]
    want, _ = J.two_phase_sparse_adam_slot(
        jnp.asarray(fat), jnp.asarray(g), jnp.asarray(flat), jm[1], jm[2], jm[4],
        jnp.asarray(pair[0].numpy()), jnp.asarray(pair[1].numpy()),
        J.SparseAdamFoldedState(count=jnp.asarray(2, jnp.int32)), lr=0.05,
        **dict(zip(ROUTE, jm[6:])), pack_factor=P, interpret=True)
    np.testing.assert_array_equal(C.bits(got), C.bits(want))
    # the position path on the same inputs: the same bits
    pos = torch.from_numpy(fat.copy())
    T.two_phase_sparse_adam_unique(
        pos, torch.from_numpy(g), torch.from_numpy(flat), m[0], m[1], m[2], m[3],
        T.SparseAdamFoldedState(count=torch.tensor(2, dtype=torch.int32)), lr=0.05,
        pack_factor=P, n_real=m[4], prep=m[5], **dict(zip(ROUTE, m[6:])))
    np.testing.assert_array_equal(C.bits(got), C.bits(pos))
    assert not np.array_equal(C.bits(got), C.bits(fat))


def _fit(vocab, n=320, epochs=2, **extra):
    cfg = tsyn.make_config(vocab=vocab, **{**C.KW, **STACKED, **extra})
    layout, x, y, _ = tsyn.make_data(cfg, n=n, seed=0, vocab=vocab)
    tr = Trainer(get_model("mmoe", layout, cfg, device="cpu"), device="cpu").compile()
    tr.fit(x, y, batch_size=64, epochs=epochs, verbose=0)
    return tr, x


def test_trainer_update_space_slot_matches_position():
    """A whole fit (vocab 80: heavy duplicates, every route list in use) in
    slot space equals position space bitwise: both planes of the
    container, the dense weights, the losses, the predictions."""
    fits = {space: _fit(80, update_space=space) for space in ("position", "slot")}
    a, b = fits["position"][0], fits["slot"][0]
    assert (a.update_space, b.update_space) == ("position", "slot")
    assert a.dedup_route == b.dedup_route == "gather"
    np.testing.assert_array_equal(C.bits(a.table), C.bits(b.table))
    for (k, p), q in zip(a.rest_params().items(), b.rest_params().values()):
        np.testing.assert_array_equal(C.bits(p), C.bits(q), err_msg=k)
    assert [h["loss"] for h in a.history] == [h["loss"] for h in b.history]
    x = fits["slot"][1]
    np.testing.assert_array_equal(a.predict(x, 64), b.predict(x, 64))


@pytest.mark.parametrize("vocab,container,want", [
    (80, "stacked", "slot"),  # heavy duplication
    (50000, "stacked", "position"),  # near-unique batches
    (80, "split", "position"),  # slot space needs the stacked container
])
def test_update_space_auto_resolution_matches_jax(vocab, container, want):
    tr, _ = _fit(vocab, n=192, epochs=1, table_container=container)
    assert tr.update_space == want and np.isfinite(tr.history[-1]["loss"])
    flat = staging.flat_ids(tr, tr.pack_inputs(tsyn.make_data(
        tr.cfg, n=64, seed=3, vocab=vocab)[1])[0], 1)
    views = [types.SimpleNamespace(update_space="auto", table_container=container,
                                   dedup_route="gather", _emb_pack_factor=tr._emb_pack_factor)
             for _ in range(2)]
    staging.resolve_update_space(views[0], flat)
    jstaging.resolve_update_space(views[1], flat)
    assert views[0].update_space == views[1].update_space


def test_slot_space_fit_matches_jax():
    extra = dict(STACKED, update_space="slot")
    jtr, x, y = C.jax_side(80, **extra)
    tr = C.port_trainer(80, C.state_of(jtr), **extra)
    assert tr.update_space == jtr.update_space == "slot"
    C.fit_both_and_compare(jtr, tr, x, y)


@pytest.mark.parametrize("extra,match", [
    (dict(update_space="slot", table_container="split"), "stacked"),
    (dict(update_space="slot", table_container="stacked", dedup_route="scatter"),
     "dedup_route='gather'"),
    (dict(update_space="slot", table_container="stacked", device_metadata=True),
     "position' only"),
    (dict(update_space="bogus"), "position|slot"),
])
def test_trainer_update_space_slot_validation(extra, match):
    kw = {**C.KW, "table_update": "pallas", "table_opt_dtype": "bfloat16", **extra}
    cfg = tsyn.make_config(vocab=80, **kw)
    layout, *_ = tsyn.make_data(cfg, n=8, vocab=80)
    with pytest.raises(ValueError, match=match):
        Trainer(get_model("mmoe", layout, cfg, device="cpu"), device="cpu")
    jcfg = jsyn.make_config(vocab=80, **kw)
    jlayout, *_ = jsyn.make_data(jcfg, n=8, vocab=80)
    with pytest.raises(ValueError, match=match):
        JaxTrainer(jax_get_model("mmoe", jlayout, jcfg))


def _growing_data(layout, n=1024, batch=256, seed=0):
    """Rows whose ids are spread over the vocabulary, but for the rows that
    the second epoch's permutation puts into its first batch: their ids lie
    in [0, 512), 2,048 logical ids on 128 physical rows.  The first epoch
    spreads them, so its lists need the narrowest width (256); the second
    epoch's first batch needs 1,024."""
    rng = np.random.default_rng(seed)
    perms = np.random.default_rng(0)  # the fit's own draws (Trainer seed 0)
    perms.permutation(n)
    packed = perms.permutation(n)[:batch]
    x = {}
    for slot in layout.sparse_slots:
        ids = rng.integers(0, slot.feature.vocabulary_size, n)
        ids[packed] = rng.integers(0, 512, batch)
        x[slot.feature.name] = ids
    for slot in layout.dense_slots:
        x[slot.feature.name] = rng.random(n).astype(np.float32)
    return x, (rng.random((n, 2)) < 0.3).astype(np.float32)


@pytest.mark.parametrize("space", ["position", "slot"])
def test_route_lists_grow_in_a_later_epoch(space, monkeypatch):
    vocab = 1 << 16
    cfg = tsyn.make_config(vocab=vocab, **{**C.KW, **STACKED, "update_space": space})
    layout, *_ = tsyn.make_data(cfg, n=8, vocab=vocab)
    x, y = _growing_data(layout)
    widths = []
    real = staging._buffer_like
    monkeypatch.setattr(staging, "_buffer_like", lambda tr, rows, a: widths.append(
        a.shape[1:]) or real(tr, rows, a))
    fits = {}
    for path in ("staged", "streaming"):
        tr = Trainer(get_model("mmoe", layout, cfg, device="cpu"), device="cpu").compile()
        if path == "streaming":
            tr._device_data_bytes_cap = 0
        tr.fit(x, y, batch_size=256, epochs=2, verbose=0)
        assert tr.update_space == space and tr._route_r_cap == 1024
        fits[path] = tr
    # the staged fit's buffers: 11 stacks at its first epoch, 11 anew at its
    # second, where resid_pos (entry 7) grew from 256 to 1,024
    assert len(widths) == 22 and (widths[7], widths[11 + 7]) == ((256,), (1024,))
    a, b = fits["staged"], fits["streaming"]
    np.testing.assert_array_equal(C.bits(a.table), C.bits(b.table))
    for (k, p), q in zip(a.rest_params().items(), b.rest_params().values()):
        np.testing.assert_array_equal(C.bits(p), C.bits(q), err_msg=k)
    assert [h["loss"] for h in a.history] == [h["loss"] for h in b.history]
