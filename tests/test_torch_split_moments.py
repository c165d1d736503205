"""Split bf16 and f16 table moments, the "unique" update and
``sparse_embedding_update``, held against the JAX package on the CPU.

* The updates bitwise against their JAX functions on the same inputs: the
  scatter update (``two_phase_sparse_adam``: the moments' deltas computed
  and added in their own dtype, as XLA does), the unique update and the
  write-kernel update of split moments (``two_phase_sparse_adam_unique``,
  JAX's Pallas write in interpret mode), the unique update of packed
  moments, and the dense-gradient row update (``sparse_adam_row_update``).
* Inside the port, the unique update equals the scatter update bitwise for
  a whole fit (full shuffle and block mode).
* Fits against the JAX trainer from one state at
  ``test_torch_two_phase_fit.py``'s tolerances (``test_torch_route_common``):
  bf16 moments under the CPU's auto (the scatter update), f16 under the
  unique update and under the write kernel (which the card refuses for f16,
  as JAX refuses it on an accelerator: ``chip_smoke.py`` asserts that), and
  ``sparse_embedding_update`` on the dense-table fit.
* The fit-time demotions: a stacked container that ``resolve_table_container``
  opted into is rebuilt split when the fit's batch breaks the headroom
  before any step, and packed moments left by an earlier fit become split
  bf16 moments bit for bit, as JAX's ``resolve_table_update`` does.
"""

import types
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_route_common as C
from mmlrec_tpu.train import sparse_embedding as J
from mmlrec_tpu.train import staging as jstaging
from mmlrec_tpu_torch import synthetic as tsyn
from mmlrec_tpu_torch.models import get_model
from mmlrec_tpu_torch.train import Trainer, resolve_table_container, staging
from mmlrec_tpu_torch.train import sparse_embedding as T

_TABLE = "embeddings.fused.table"


def _table_atol(mdt):
    """The table's tolerance after the three compared steps: 1e-6 with f32
    moments; with bf16 or f16 ones, a gradient an ulp apart (the dense
    forward and backward sum in other orders) can flip a moment's rounding
    and so move a step of that lane by up to ~lr x 2^-7 (f16's subnormal
    nu: one ulp is a larger part of it): 3 x lr x 2^-7, the rule that
    ``chip_smoke.py`` phase 7 states for the card against the CPU."""
    return 1e-6 if mdt == "float32" else 3 * C.KW["lr"] * 2.0 ** -7


DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16, "float32": torch.float32}


def _inputs(P, mdt, seed=3, K=512, Vp=1024):
    """A table, split moments of ``mdt``, ids with duplicates (within one
    logical id and within one physical row) and row gradients."""
    rng = np.random.default_rng(seed)
    D = 8
    table = rng.normal(0, 0.3, (Vp, P * D)).astype(np.float32)
    mu = jnp.asarray(rng.normal(0, 1e-2, (Vp, P * D)).astype(np.float32)).astype(mdt)
    nu = jnp.asarray(np.abs(rng.normal(0, 1e-3, (Vp, P * D))).astype(np.float32)).astype(mdt)
    flat = rng.integers(0, Vp * P // 2, K).astype(np.int32)
    flat[:20] = flat[0]
    g = rng.normal(0, 0.1, (K, D)).astype(np.float32)
    return table, mu, nu, flat, g


def _states(mu, nu, count=4):
    return (J.SparseAdamState(mu=mu, nu=nu, count=jnp.asarray(count, jnp.int32)),
            T.SparseAdamState(mu=C.torch_of(mu), nu=C.torch_of(nu),
                              count=torch.tensor(count, dtype=torch.int32)))


def _assert_same_state(t_table, t_st, j_table, j_st):
    np.testing.assert_array_equal(C.bits(t_table), C.bits(j_table))
    for name in ("mu", "nu"):
        got, want = getattr(t_st, name), getattr(j_st, name)
        assert got.dtype == DTYPES[str(want.dtype)]
        np.testing.assert_array_equal(C.bits(got), C.bits(want), err_msg=name)
    assert int(t_st.count) == int(j_st.count) == 5


@pytest.mark.parametrize("mdt", ["bfloat16", "float16"])
@pytest.mark.parametrize("P", [1, 16])
def test_split_scatter_update_matches_jax(mdt, P):
    table, mu, nu, flat, g = _inputs(P, mdt)
    inv, rep = T.batch_step_metadata(flat[None].astype(np.int64))
    jst, tst = _states(mu, nu)
    jt, jst = J.two_phase_sparse_adam(jnp.asarray(table), jnp.asarray(g), jnp.asarray(flat),
                                      jnp.asarray(inv[0]), jnp.asarray(rep[0]), jst, lr=0.05,
                                      pack_factor=P)
    tt, tst = T.two_phase_sparse_adam(torch.from_numpy(table.copy()), torch.from_numpy(g),
                                      torch.from_numpy(flat), torch.from_numpy(inv[0]),
                                      torch.from_numpy(rep[0]), tst, lr=0.05, pack_factor=P)
    _assert_same_state(tt, tst, jt, jst)


@pytest.mark.parametrize("mdt", ["bfloat16", "float16"])
@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("P", [1, 16])
def test_split_unique_and_write_updates_match_jax(mdt, use_pallas, P):
    """The unique update (distinct rows, pads included) and the write
    kernel's (one write of (table, mu, nu), the moments rounded to mdt)."""
    table, mu, nu, flat, g = _inputs(P, mdt)
    meta = T.batch_step_metadata(flat[None].astype(np.int64), P, table.shape[0],
                                 use_native=False)
    jm = [jnp.asarray(a[0]) for a in meta]
    tm = [torch.from_numpy(a[0]) for a in meta]
    jst, tst = _states(mu, nu)
    jt, jst = J.two_phase_sparse_adam_unique(
        jnp.asarray(table), jnp.asarray(g), jnp.asarray(flat), jm[0], jm[1], jm[2], jm[3], jst,
        lr=0.05, pack_factor=P, use_pallas=use_pallas, interpret=True, n_real=jm[4],
        prep=jm[5])
    tt, tst = T.two_phase_sparse_adam_unique(
        torch.from_numpy(table.copy()), torch.from_numpy(g), torch.from_numpy(flat), tm[0],
        tm[1], tm[2], tm[3], tst, lr=0.05, pack_factor=P, use_pallas=use_pallas,
        n_real=tm[4], prep=tm[5])
    _assert_same_state(tt, tst, jt, jst)


def test_packed_unique_update_matches_jax():
    """The unique update of packed moments (sparse_embedding.py:1066-1083),
    which only a direct call reaches (the trainer packs for the write
    kernel alone)."""
    table, mu, nu, flat, g = _inputs(16, "bfloat16")
    monu = np.asarray(J.pack_monu(mu, nu))
    meta = T.batch_step_metadata(flat[None].astype(np.int64), 16, table.shape[0],
                                 use_native=False)
    jm = [jnp.asarray(a[0]) for a in meta]
    tm = [torch.from_numpy(a[0]) for a in meta]
    jt, jst = J.two_phase_sparse_adam_unique(
        jnp.asarray(table), jnp.asarray(g), jnp.asarray(flat), *jm[:4],
        J.SparseAdamPackedState(monu=jnp.asarray(monu), count=jnp.asarray(4, jnp.int32)),
        lr=0.05, pack_factor=16, use_pallas=False)
    tt, tst = T.two_phase_sparse_adam_unique(
        torch.from_numpy(table.copy()), torch.from_numpy(g), torch.from_numpy(flat), *tm[:4],
        T.SparseAdamPackedState(monu=torch.from_numpy(monu.copy()),
                                count=torch.tensor(4, dtype=torch.int32)),
        lr=0.05, pack_factor=16, use_pallas=False)
    np.testing.assert_array_equal(C.bits(tt), C.bits(jt))
    np.testing.assert_array_equal(C.bits(tst.monu), C.bits(jst.monu))
    with pytest.raises(ValueError, match="stacked"):
        T.two_phase_sparse_adam_unique(
            torch.from_numpy(table), torch.from_numpy(g), torch.from_numpy(flat), *tm[:4],
            T.SparseAdamFoldedState(count=torch.tensor(0, dtype=torch.int32)), lr=0.05,
            use_pallas=False)


@pytest.mark.parametrize("mdt", ["float32", "bfloat16", "float16"])
def test_sparse_adam_row_update_matches_jax(mdt):
    rng = np.random.default_rng(9)
    V, W, K = 96, 16, 200
    table = rng.normal(0, 0.3, (V, W)).astype(np.float32)
    g_table = rng.normal(0, 0.1, (V, W)).astype(np.float32)
    mu = jnp.asarray(rng.normal(0, 1e-2, (V, W)).astype(np.float32)).astype(mdt)
    nu = jnp.asarray(np.abs(rng.normal(0, 1e-3, (V, W))).astype(np.float32)).astype(mdt)
    rows = rng.integers(0, V // 2, K).astype(np.int32)  # duplicates; half the rows untouched
    jst, tst = _states(mu, nu)
    jt, jst = J.sparse_adam_row_update(jnp.asarray(table), jnp.asarray(g_table),
                                       jnp.asarray(rows), jst, lr=0.05)
    tt, tst = T.sparse_adam_row_update(torch.from_numpy(table.copy()),
                                       torch.from_numpy(g_table), torch.from_numpy(rows), tst,
                                       lr=0.05)
    _assert_same_state(tt, tst, jt, jst)
    np.testing.assert_array_equal(tt.numpy()[V // 2:], table[V // 2:])


@pytest.mark.parametrize("mdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("shuffle", [True, "block"])
def test_trainer_table_update_unique_matches_scatter(mdt, shuffle):
    fits = {}
    for update in ("scatter", "unique"):
        cfg = tsyn.make_config(vocab=400, **{**C.KW, "table_update": update,
                                             "table_opt_dtype": mdt})
        layout, x, y, _ = tsyn.make_data(cfg, n=320, seed=0, vocab=400)
        tr = Trainer(get_model("mmoe", layout, cfg, device="cpu"), device="cpu").compile()
        tr.fit(x, y, batch_size=64, epochs=2, verbose=0, shuffle=shuffle)
        assert tr.table_update == update and tr.table_opt.mu.dtype == DTYPES[mdt]
        fits[update] = tr
    a, b = fits["scatter"], fits["unique"]
    for x_, y_ in zip((a.table, a.table_opt.mu, a.table_opt.nu),
                      (b.table, b.table_opt.mu, b.table_opt.nu)):
        np.testing.assert_array_equal(C.bits(x_), C.bits(y_))
    assert [h["loss"] for h in a.history] == [h["loss"] for h in b.history]


@pytest.mark.parametrize("update,mdt,vocab", [
    ("auto", "bfloat16", 1 << 16),  # the CPU's auto: the scatter update, split bf16
    ("unique", "float16", 400),
    ("pallas", "float16", 1 << 16),  # the write kernel, split f16 (the CPU only)
])
def test_split_moment_fit_matches_jax(update, mdt, vocab):
    extra = dict(table_opt_dtype=mdt)
    if update != "auto":
        extra["table_update"] = update
    jtr, x, y = C.jax_side(vocab, **extra)
    tr = C.port_trainer(vocab, C.state_of(jtr), **extra)
    assert tr.table_update == jtr.table_update == ("scatter" if update == "auto" else update)
    assert isinstance(tr.table_opt, T.SparseAdamState) and tr.table_opt.mu.dtype == DTYPES[mdt]
    C.fit_both_and_compare(jtr, tr, x, y, table_atol=_table_atol(mdt))


def _sparse_update_state(jtr):
    """(params, table_opt, opt_state) of a JAX ``sparse_embedding_update``
    trainer: its Adam state lives in the multi_transform's "rest" branch,
    with masked placeholders at the table, which the port's optimizer does
    not cover."""
    params = jax.tree_util.tree_map(np.asarray, jtr.variables["params"])
    adam = jtr._train_state["opt_state"].inner_states["rest"].inner_state[0]

    def rest(tree):
        return {k: jax.tree_util.tree_map(np.asarray, v) for k, v in tree.items()
                if k != "embeddings"}

    topt = jtr._train_state["table_opt"]
    return (params, {"count": np.asarray(topt.count), "mu": np.asarray(topt.mu),
                     "nu": np.asarray(topt.nu)},
            {"count": np.asarray(adam.count), "mu": rest(adam.mu), "nu": rest(adam.nu)})


@pytest.mark.parametrize("mdt", ["float32", "bfloat16"])
def test_sparse_embedding_update_fit_matches_jax(mdt):
    """The dense-table fit with ``sparse_embedding_update``, from one warm
    state carried over: the table out of the dense optimizer (no moments of
    it there), its touched rows by SparseAdam with row moments of ``mdt``."""
    extra = dict(two_phase_embedding=False, sparse_embedding_update=True, table_opt_dtype=mdt)
    jtr, x, y = C.jax_side(400, **extra)
    tr = C.port_trainer(400, _sparse_update_state(jtr), **extra)
    assert tr.sparse_embedding_update and not tr.two_phase_embedding
    assert _TABLE not in tr.opt_state.mu and tr.table_opt.mu.dtype == DTYPES[mdt]
    C.fit_both_and_compare(jtr, tr, x, y, table_atol=_table_atol(mdt))


def _wide_cfg(**extra):
    """emb 128 at P = 1: 128-lane rows at 1,664 physical rows (vocab 400 x 4)."""
    return tsyn.make_config(vocab=400, **{**C.KW, "emb": 128, "batch_size": 16,
                                          "table_opt_dtype": "bfloat16", **extra})


def test_stacked_auto_demotes_on_fit_batch_headroom():
    """The stacked container opted into at the config batch (16 x 4 ids)
    is rebuilt split from its table plane when fit(batch_size=512) breaks
    the headroom (Kp 2,048 >= 1,664 rows) before any step; the fit then
    equals a split bf16-moment scatter fit from the same init bitwise.  An
    explicit stacked container raises."""
    cfg = _wide_cfg()
    layout, x, y, _ = tsyn.make_data(cfg, n=1024, seed=0, vocab=400)
    resolve_table_container(cfg, layout, device="cuda")  # the card's opt-in
    assert cfg.model_config.extra["table_container"] == "stacked"
    assert cfg.model_config.extra["_table_container_auto"]
    cfg.model_config.extra["table_update"] = "pallas"
    model = get_model("mmoe", layout, cfg, device="cpu")
    init = {k: v.detach().clone() for k, v in model.state_dict().items()}
    init[_TABLE] = init[_TABLE][:1664].clone()  # the table plane
    tr = Trainer(model, device="cpu").compile()
    tr._table_update_auto = True  # as the card resolves "auto"
    assert tr.table_container == "stacked" and tr._packed_moments
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        tr.fit(x, y, batch_size=512, epochs=1, shuffle=False, verbose=0)
    assert any("demoting" in str(m.message) for m in w)
    assert (tr.table_container, tr.table_update, tr.pair_gather) == ("split", "scatter", "split")
    assert cfg.model_config.extra["table_container"] == "split"
    assert "_table_container_auto" not in cfg.model_config.extra
    assert tr.table.shape == (1664, 128) and not tr.model.embeddings.fused.dual_container
    assert tr.table_opt.mu.dtype == torch.bfloat16

    ref_model = get_model("mmoe", layout, _wide_cfg(table_update="scatter"), device="cpu")
    ref_model.load_state_dict(init)
    ref = Trainer(ref_model, device="cpu").compile()
    ref.fit(x, y, batch_size=512, epochs=1, shuffle=False, verbose=0)
    for a, b in ((tr.table, ref.table), (tr.table_opt.mu, ref.table_opt.mu),
                 (tr.table_opt.nu, ref.table_opt.nu)):
        np.testing.assert_array_equal(C.bits(a), C.bits(b))
    assert [h["loss"] for h in tr.history] == [h["loss"] for h in ref.history]

    explicit = _wide_cfg(table_container="stacked", table_update="pallas")
    tr2 = Trainer(get_model("mmoe", layout, explicit, device="cpu"), device="cpu").compile()
    with pytest.raises(ValueError, match="stacked"):
        tr2.fit(x, y, batch_size=512, epochs=1, verbose=0)


def test_packed_moments_demote_to_split_bf16_as_jax():
    """Packed moments left by an earlier fit become split bf16 moments, bit
    for bit, when a later fit's batch breaks the headroom (the JAX
    trainer's staging.py:187-202 on the same state), and the fit goes on
    with the scatter update."""
    cfg = _wide_cfg(table_update="pallas", table_container="split")
    layout, x, y, _ = tsyn.make_data(cfg, n=1024, seed=0, vocab=400)
    tr = Trainer(get_model("mmoe", layout, cfg, device="cpu"), device="cpu").compile()
    tr._table_update_auto = True  # as the card resolves "auto"
    tr.fit(x, y, batch_size=64, epochs=1, verbose=0)  # packed moments, gather route
    assert isinstance(tr.table_opt, T.SparseAdamPackedState) and tr.dedup_route == "gather"
    monu = tr.table_opt.monu.clone()
    jview = types.SimpleNamespace(
        table_update="pallas", layout=tr.layout, _emb_phys_rows=tr._emb_phys_rows,
        cfg=types.SimpleNamespace(model_config=types.SimpleNamespace(extra={})),
        table_container="split", _table_update_auto=True, variables={}, _step_fns={},
        _train_state={"table_opt": J.SparseAdamPackedState(monu=jnp.asarray(monu.numpy()),
                                                           count=jnp.asarray(5, jnp.int32))})
    jstaging.resolve_table_update(jview, 512)
    staging.resolve_table_update(tr, 512)
    assert tr.table_update == jview.table_update == "scatter"
    assert tr._packed_moments is jview._packed_moments is False
    jst = jview._train_state["table_opt"]
    assert isinstance(tr.table_opt, T.SparseAdamState) and isinstance(jst, J.SparseAdamState)
    np.testing.assert_array_equal(C.bits(tr.table_opt.mu), C.bits(jst.mu))
    np.testing.assert_array_equal(C.bits(tr.table_opt.nu), C.bits(jst.nu))
    tr.fit(x, y, batch_size=512, epochs=1, verbose=0)
    assert tr.table_opt.mu.dtype == torch.bfloat16 and np.isfinite(tr.history[-1]["loss"])


@pytest.mark.parametrize("extra", [
    dict(two_phase_embedding=False, sparse_embedding_update=True, table_opt_dtype="bfloat16"),
    dict(table_update="scatter", table_opt_dtype="float16"),
])
def test_split_moment_states_resume_bitwise(extra, tmp_path):
    """A training state with split bf16 or f16 table moments (two-phase, or
    the dense fit's ``sparse_embedding_update``) saves and resumes in its
    dtype: the resumed fit equals the uninterrupted one bitwise."""
    cfg = tsyn.make_config(vocab=400, **{**C.KW, **extra})
    layout, x, y, _ = tsyn.make_data(cfg, n=256, seed=0, vocab=400)

    def trainer():
        return Trainer(get_model("mmoe", layout, cfg, device="cpu"), device="cpu").compile()

    full = trainer()
    full.fit(x, y, batch_size=64, epochs=2, shuffle=False, verbose=0)
    first = trainer()
    first.fit(x, y, batch_size=64, epochs=1, shuffle=False, verbose=0)
    path = first.save_training_state(str(tmp_path))
    resumed = trainer()
    resumed.fit(x, y, batch_size=64, epochs=2, shuffle=False, verbose=0, resume_from=path)
    assert resumed.table_opt.mu.dtype == DTYPES[extra["table_opt_dtype"]]
    for a, b in ((full.table, resumed.table), (full.table_opt.mu, resumed.table_opt.mu),
                 (full.table_opt.nu, resumed.table_opt.nu)):
        np.testing.assert_array_equal(C.bits(a), C.bits(b))
    assert int(resumed.table_opt.count) == int(full.table_opt.count) == 8
