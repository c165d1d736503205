"""The port's host step metadata (mmlrec_tpu_torch/train/sparse_embedding.py
``batch_step_metadata``, its native pass and staging's fit-time resolution)
held against the JAX package on the CPU.

Tolerance: none.  The metadata is integer bookkeeping of one stable sort:
the numpy and the native paths of both packages must agree bitwise, and the
host metadata with the port's in-step device metadata wherever the two are
defined alike (the device's pid pads are one past the last row, the host's
distinct untouched rows).
"""

import numpy as np
import pytest
import torch

from mmlrec_tpu import synthetic as jsyn
from mmlrec_tpu.models import get_model as jax_get_model
from mmlrec_tpu.train import Trainer as JaxTrainer
from mmlrec_tpu.train import sparse_embedding as J
from mmlrec_tpu.train import staging as jstaging
from mmlrec_tpu_torch import native
from mmlrec_tpu_torch import synthetic as tsyn
from mmlrec_tpu_torch.models import get_model
from mmlrec_tpu_torch.train import Trainer, staging
from mmlrec_tpu_torch.train import sparse_embedding as T


def _cases():
    rng = np.random.default_rng(0)
    K, V = 512, 4096
    return {
        "uniform": rng.integers(0, V, (3, K)),
        "heavy": rng.integers(0, 60, (2, K)),
        "zipfish": (rng.zipf(1.2, (2, K)) - 1) % V,
        "all_same": np.full((1, K), 7),
        "all_unique": rng.permutation(V)[:K][None, :],
    }


CASES = _cases()


def _assert_same(a, b, what):
    assert len(a) == len(b), what
    for i, (x, y) in enumerate(zip(a, b)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=f"{what} [{i}]")
        assert np.asarray(x).dtype == np.asarray(y).dtype, f"{what} [{i}]"


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("P", [1, 4])
def test_numpy_metadata_matches_jax(case, P):
    ids = CASES[case].astype(np.int64)
    got = T.batch_step_metadata(ids, P, 4096 // P, use_native=False)
    want = J.batch_step_metadata(ids, P, 4096 // P, use_native=False)
    _assert_same(got, want, f"{case} P={P}")
    # the dedup-only form (the scatter update's)
    _assert_same(T.batch_step_metadata(ids), J.batch_step_metadata(ids), case)
    _assert_same(T.batch_dedup_metadata(ids), J.batch_dedup_metadata(ids), case)


@pytest.mark.parametrize("case", sorted(CASES))
def test_native_metadata_matches_numpy_and_jax_native(case):
    try:
        native.get_meta_lib()
    except native.NativeUnavailable:
        pytest.skip("no C++ compiler for native/step_metadata.cpp")
    ids = CASES[case].astype(np.int64)
    T.reset_metadata_calls()
    got = T.batch_step_metadata(ids, 4, 1024, use_native=True)
    assert T.metadata_calls == {"native": 1, "numpy": 0}
    _assert_same(got, T.batch_step_metadata(ids, 4, 1024, use_native=False), case)
    try:
        from mmlrec_tpu.native import get_meta_lib

        get_meta_lib()
    except Exception:
        pytest.skip("the JAX package's native library is unavailable")
    _assert_same(got, J.batch_step_metadata(ids, 4, 1024, use_native=True), case)


def test_native_builds_outside_the_native_directory():
    path = native.library_path()
    assert path.parent == native.BUILD_DIR and path.parent.name == "native"
    assert path.parent.parent.name == "build" and path.name.startswith("libstepmeta_")
    assert native.SOURCE.name == "step_metadata.cpp" and native.SOURCE.parent.name == "native"
    assert path.parent != native.SOURCE.parent


def test_native_fallback_rule(monkeypatch, tmp_path):
    """As the JAX rule: numpy when the library is unavailable, an error when
    the caller asked for the library.  Here no compiler is found and no
    library was built, for the JAX package's pass and the port's, which
    builds every form (the scatter update's too) and reads the epoch's rows
    itself."""
    monkeypatch.setattr(native, "_libs", {})
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.delenv("CXX", raising=False)
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    for load in (native.get_meta_lib, native.get_host_meta_lib):
        with pytest.raises(native.NativeUnavailable, match="no C"):
            load()
    ids = CASES["heavy"].astype(np.int64)
    T.reset_metadata_calls()
    got = T.batch_step_metadata(ids, 4, 1024)
    assert T.metadata_calls == {"native": 0, "numpy": 1}
    _assert_same(got, J.batch_step_metadata(ids, 4, 1024, use_native=False), "fallback")
    with pytest.raises(native.NativeUnavailable):
        T.batch_step_metadata(ids, 4, 1024, use_native=True)
    # the gather route's lists too (ported from ROADMAP A4)
    got = T.batch_step_metadata(ids, 4, 1024, want_route=True)
    assert T.metadata_calls == {"native": 0, "numpy": 2}
    _assert_same(got, J.batch_step_metadata(ids, 4, 1024, want_route=True, use_native=False),
                 "route fallback")
    with pytest.raises(ValueError, match="n_phys_rows"):
        T.batch_step_metadata(ids, 4, 512)  # Kp = 512 leaves no pad rows
    # the scatter form, and the epoch's rows read from the ids matrix
    _assert_same(T.batch_step_metadata(ids), J.batch_step_metadata(ids), "scatter fallback")
    assert T.metadata_calls == {"native": 0, "numpy": 3}
    with pytest.raises(native.NativeUnavailable):
        T.batch_step_metadata(ids, use_native=True)
    matrix, rows = ids.reshape(-1, 4).astype(np.int32), np.arange(ids.size // 4).reshape(2, -1)
    got, built = T.epoch_step_metadata(matrix, rows, np.zeros(4, np.int64), 4, 1024)
    assert not built and T.metadata_calls == {"native": 0, "numpy": 4}
    _assert_same(got, J.batch_step_metadata(ids, 4, 1024, use_native=False), "rows fallback")
    with pytest.raises(native.NativeUnavailable):
        T.epoch_step_metadata(matrix, rows, np.zeros(4, np.int64), 4, 1024, use_native=True)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("P", [1, 4])
def test_host_metadata_matches_device_metadata(case, P):
    ids = CASES[case].astype(np.int64)
    n_phys = 4096 // P
    inv, rep, pids, pinv, nuniq, prep = T.batch_step_metadata(ids, P, n_phys)
    for b in range(ids.shape[0]):
        d = [a.numpy() for a in T.device_step_metadata(
            torch.from_numpy(ids[b].astype(np.int32)), P, pids.shape[1], n_phys)]
        for name, h, dv in zip(("inv", "rep", "pinv", "prep"), (inv, rep, pinv, prep),
                               (d[0], d[1], d[3], d[5])):
            np.testing.assert_array_equal(dv, h[b], err_msg=f"{case} {name}")
        n = int(nuniq[b, 0])
        assert int(d[4][0]) == n
        np.testing.assert_array_equal(d[2][:n], pids[b, :n])
        assert (d[2][n:] == n_phys).all()
        tail = pids[b, n:]  # distinct rows the batch does not touch
        assert len(np.unique(tail)) == len(tail) and not np.isin(tail, pids[b, :n]).any()


KW = dict(task_name="mtl", model_name="mmoe", n_sparse=4, n_dense=2, hidden=(8,), tower=(4,),
          gate=(4,), batch_size=64, two_phase_embedding=True)


def _pair(vocab, **extra):
    """A port and a JAX trainer of one config, as the card would resolve
    ``table_update="auto"`` (the CPU resolves it to scatter at construction)."""
    cfg = tsyn.make_config(vocab=vocab, **KW, **extra)
    layout, *_ = tsyn.make_data(cfg, n=8, vocab=vocab)
    tr = Trainer(get_model("mmoe", layout, cfg, device="cpu"), device="cpu").compile()
    jcfg = jsyn.make_config(vocab=vocab, **KW, **extra)
    jlayout, *_ = jsyn.make_data(jcfg, n=8, vocab=vocab)
    jtr = JaxTrainer(jax_get_model("mmoe", jlayout, jcfg)).compile()
    return tr, jtr


@pytest.mark.parametrize("vocab,batch,want", [
    (1 << 16, 64, "pallas"),  # 16,384 physical rows > Kp = 256: no demotion
    (1 << 16, 4096, "scatter"),  # Kp = 16,384: auto demotes
    (400, 512, "scatter"),  # 1,664 physical rows, Kp = 2,048
])
def test_resolve_table_update_demotes_auto(vocab, batch, want):
    tr, jtr = _pair(vocab)
    for t in (tr, jtr):
        assert t.table_update == "scatter"  # the CPU's auto
        # the card's auto: the write kernel with f32 moments
        t.table_update, t._table_update_auto, t._packed_moments = "pallas", True, False
        t._emb_phys_rows = t._emb_phys_rows_static()
    staging.resolve_table_update(tr, batch)
    jstaging.resolve_table_update(jtr, batch)
    assert tr.table_update == jtr.table_update == want
    assert tr._packed_moments is jtr._packed_moments is False
    assert tr._emb_phys_rows == jtr._emb_phys_rows


def test_resolve_table_update_explicit_mode_raises():
    tr, jtr = _pair(1 << 16, table_update="pallas")
    assert tr.table_update == jtr.table_update == "pallas"
    for resolve, t in ((staging.resolve_table_update, tr), (jstaging.resolve_table_update, jtr)):
        with pytest.raises(ValueError, match="Kp=16384"):
            resolve(t, 4096)
        resolve(t, 64)
        assert t.table_update == "pallas"


def test_demotion_to_split_bf16_moments_is_refused():
    """Once ROADMAP A4 refused it; now the packed update demotes to the
    scatter update on split bf16 moments, as the JAX trainer does
    (staging.py:187-202), and the fit trains them
    (tests/test_torch_split_moments.py holds the packed state's unpacking
    bitwise against JAX)."""
    tr, _ = _pair(1 << 16, table_update="pallas", table_opt_dtype="bfloat16",
                  device_metadata=True)
    assert tr._packed_moments
    tr._table_update_auto = True  # as the card resolves "auto"
    staging.resolve_table_update(tr, 4096)
    assert tr.table_update == "scatter" and not tr._packed_moments
    cfg = tr.cfg
    _, x, y, _ = tsyn.make_data(cfg, n=4096, vocab=1 << 16)
    tr.fit(x, y, batch_size=4096, epochs=1, verbose=0)
    assert isinstance(tr.table_opt, T.SparseAdamState) and tr.table_opt.mu.dtype == torch.bfloat16
    assert int(tr.table_opt.count) == 1 and np.isfinite(tr.history[-1]["loss"])


def test_step_metadata_follows_the_update():
    tr, jtr = _pair(1 << 16, table_update="pallas")
    ids = np.random.default_rng(3).integers(0, 1 << 16, (64, 4))
    flat = (ids + tr._host_offsets[None, :]).reshape(1, -1)
    _assert_same(staging.step_metadata(tr, flat), jstaging.step_metadata(jtr, flat), "pallas")
    assert tr.update_space == "position"
    meta = tr.host_metadata(ids.astype(np.int32))
    assert len(meta) == 6 and all(isinstance(m, torch.Tensor) for m in meta)
    tr.table_update = jtr.table_update = "scatter"
    _assert_same(staging.step_metadata(tr, flat), jstaging.step_metadata(jtr, flat), "scatter")


@pytest.mark.parametrize("moments,vocab,batch", [
    ("float32", 1 << 16, 512),  # the shipped configs' moments: split
    ("bfloat16", 1 << 16, 512),  # packed moments with headroom: stacked
    ("bfloat16", 1 << 16, 4096),  # packed moments without headroom: split
    ("bfloat16", 100, 512),  # unpacked rows (P = 1, 64 lanes): split
])
def test_resolve_table_container_matches_jax(moments, vocab, batch, monkeypatch):
    """The container decision on the card, against the JAX predicate as it
    decides on an accelerator (its platform probe answered "tpu")."""
    import types

    import jax

    from mmlrec_tpu.train import resolve_table_container as jax_resolve
    from mmlrec_tpu_torch.train import resolve_table_container

    kw = dict(KW, batch_size=batch, table_opt_dtype=moments, n_sparse=16)
    cfg = tsyn.make_config(vocab=vocab, **kw)
    layout, *_ = tsyn.make_data(cfg, n=8, vocab=vocab)
    jcfg = jsyn.make_config(vocab=vocab, **kw)
    jlayout, *_ = jsyn.make_data(jcfg, n=8, vocab=vocab)
    monkeypatch.setattr(jax, "devices", lambda *a: [types.SimpleNamespace(platform="tpu")])
    jax_resolve(jcfg, jlayout)
    resolve_table_container(cfg, layout, device="cuda")
    want = jcfg.model_config.extra.get("table_container")
    assert cfg.model_config.extra.get("table_container") == want
    assert want == ("stacked" if (moments, vocab, batch) == ("bfloat16", 1 << 16, 512) else None)
    cpu = tsyn.make_config(vocab=vocab, **kw)
    resolve_table_container(cpu, layout, device="cpu")  # the CPU never opts in
    assert cpu.model_config.extra.get("table_container") is None
