"""The two-phase step with split f32 moments and host metadata, the route of
every shipped two-phase config, held against the JAX package on the CPU:
the scatter update (``two_phase_sparse_adam``) and the write-kernel update
of (table, mu, nu) (``two_phase_sparse_adam_unique``'s non-packed branch,
JAX's Pallas kernel in interpret mode, the port's plain B3).

Tolerances.  One update from equal inputs: none.  Both packages run the
same f32 op chain elementwise in the same order, the scatter adds one
value that is not zero per lane (so their order is immaterial), and the
write route accumulates old row + delta in f32 where the sum has at most
two terms past zero.  The fits, from one transplanted state: the losses
within rtol 1e-5, dense weights and the table within atol 1e-6, and the
moments within rtol 1e-5 + 1e-6 of each tensor's largest: the dense
forward and backward sum in other orders (a matmul's blocking), which
moves a gradient by ulps; Adam turns that into a table step that may
differ by ulps of lr, and a moment whose gradient sum cancelled keeps
that sum's absolute rounding (2.4e-5 relative at 7e-8 of the largest
mu was seen).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from mmlrec_tpu import synthetic as jsyn
from mmlrec_tpu.models import get_model as jax_get_model
from mmlrec_tpu.train import Trainer as JaxTrainer
from mmlrec_tpu.train import sparse_embedding as J
from mmlrec_tpu_torch import synthetic as tsyn
from mmlrec_tpu_torch.convert import load_jax_train_state
from mmlrec_tpu_torch.models import get_model
from mmlrec_tpu_torch.ops import kernels as K
from mmlrec_tpu_torch.train import Trainer
from mmlrec_tpu_torch.train import sparse_embedding as T

KW = dict(task_name="mtl", model_name="mmoe", n_sparse=4, n_dense=2, hidden=(16, 8),
          tower=(8,), gate=(8,), batch_size=64, lr=3e-3, two_phase_embedding=True)
VOCAB = {1: 400, 16: 1 << 16}  # 1664 rows unpacked; 2^18 rows, lane-packed P = 16
SLICES = ((160, 224, False), (224, 288, True), (288, 328, True))  # 3 steps, the last partial


def _bits(a):
    return np.asarray(a).view(np.uint32)


def _update_inputs(P, seed=3):
    rng = np.random.default_rng(seed)
    D, Vp, K = 8, 256, 96
    W = P * D
    table = rng.normal(0, 0.3, (Vp, W)).astype(np.float32)
    mu = rng.normal(0, 1e-2, (Vp, W)).astype(np.float32)
    nu = np.abs(rng.normal(0, 1e-3, (Vp, W))).astype(np.float32)
    flat = rng.integers(0, Vp * P // 2, K).astype(np.int32)  # duplicates
    g_rows = rng.normal(0, 0.1, (K, D)).astype(np.float32)
    return table, mu, nu, flat, g_rows


@pytest.mark.parametrize("P", [1, 16])
def test_scatter_update_matches_jax_bitwise(P):
    table, mu, nu, flat, g_rows = _update_inputs(P)
    inv, rep = J.batch_step_metadata(flat[None].astype(np.int64))
    j_table, j_st = J.two_phase_sparse_adam(
        jnp.asarray(table), jnp.asarray(g_rows), jnp.asarray(flat), jnp.asarray(inv[0]),
        jnp.asarray(rep[0]), J.SparseAdamState(mu=jnp.asarray(mu), nu=jnp.asarray(nu),
                                               count=jnp.asarray(4, jnp.int32)),
        lr=0.05, pack_factor=P)
    tinv, trep = T.batch_step_metadata(flat[None].astype(np.int64))
    t = [torch.from_numpy(a.copy()) for a in (table, mu, nu)]
    out, st = T.two_phase_sparse_adam(
        t[0], torch.from_numpy(g_rows), torch.from_numpy(flat), torch.from_numpy(tinv[0]),
        torch.from_numpy(trep[0]), T.SparseAdamState(mu=t[1], nu=t[2],
                                                     count=torch.tensor(4, dtype=torch.int32)),
        lr=0.05, pack_factor=P)
    assert out is t[0] and st.mu is t[1] and st.nu is t[2]  # in place
    assert int(st.count) == int(j_st.count) == 5
    changed = _bits(np.asarray(j_table)) != _bits(table)
    assert changed.any() and not changed.all()
    for got, want in ((out, j_table), (st.mu, j_st.mu), (st.nu, j_st.nu)):
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(np.asarray(want)))


@pytest.mark.parametrize("P", [1, 16])
def test_write_kernel_update_of_f32_moments_matches_jax_bitwise(P):
    table, mu, nu, flat, g_rows = _update_inputs(P)
    Vp = table.shape[0]
    meta = J.batch_step_metadata(flat[None].astype(np.int64), P, Vp, chunk=128)
    inv, rep, pids, pinv, nuniq, prep = (jnp.asarray(a[0]) for a in meta)
    phys = flat // P
    j_table, j_st = J.two_phase_sparse_adam_unique(
        jnp.asarray(table), jnp.asarray(g_rows), jnp.asarray(flat), inv, rep, pids, pinv,
        J.SparseAdamState(mu=jnp.asarray(mu), nu=jnp.asarray(nu),
                          count=jnp.asarray(4, jnp.int32)),
        lr=0.05, pack_factor=P, use_pallas=True, interpret=True, chunk=128, n_real=nuniq,
        sup=jnp.take(jnp.asarray(table), jnp.asarray(phys), axis=0), prep=prep)
    tmeta = [torch.from_numpy(a[0]) for a in T.batch_step_metadata(
        flat[None].astype(np.int64), P, Vp, chunk=128)]
    t = [torch.from_numpy(a.copy()) for a in (table, mu, nu)]
    K.reset_launch_counts()
    out, st = T.two_phase_sparse_adam_unique(
        t[0], torch.from_numpy(g_rows), torch.from_numpy(flat), tmeta[0], tmeta[1], tmeta[2],
        tmeta[3], T.SparseAdamState(mu=t[1], nu=t[2], count=torch.tensor(4, dtype=torch.int32)),
        lr=0.05, pack_factor=P, use_pallas=True, n_real=tmeta[4], prep=tmeta[5],
        sup=t[0].index_select(0, torch.from_numpy(phys).long()))
    assert sum(K.launch_counts.values()) == 0  # the CPU writes through the plain B3
    assert out is t[0] and st.mu is t[1] and st.nu is t[2]
    assert int(st.count) == int(j_st.count) == 5
    for got, want in ((out, j_table), (st.mu, j_st.mu), (st.nu, j_st.nu)):
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(np.asarray(want)))
    # and equal to the scatter update of the same inputs
    t2 = [torch.from_numpy(a.copy()) for a in (table, mu, nu)]
    s_out, s_st = T.two_phase_sparse_adam(
        t2[0], torch.from_numpy(g_rows), torch.from_numpy(flat), tmeta[0], tmeta[1],
        T.SparseAdamState(mu=t2[1], nu=t2[2], count=torch.tensor(4, dtype=torch.int32)),
        lr=0.05, pack_factor=P)
    for a, b in ((out, s_out), (st.mu, s_st.mu), (st.nu, s_st.nu)):
        np.testing.assert_array_equal(_bits(a.numpy()), _bits(b.numpy()))


def _rows(x, a, b):
    return {k: v[a:b] for k, v in x.items()}


def _numpy_params(shapes, seed):
    rng = np.random.default_rng(seed)
    std = {"table": 0.3, "bias": 0.1, "kernel": 0.3}
    return jax.tree_util.tree_map_with_path(
        lambda path, a: rng.normal(0, std[path[-1].key], a.shape).astype(np.float32), shapes)


def _jax_side(update, P):
    vocab = VOCAB[P]
    cfg = jsyn.make_config(vocab=vocab, table_update=update, **KW)
    layout, x, y, _ = jsyn.make_data(cfg, n=328, seed=0, vocab=vocab)
    jtr = JaxTrainer(jax_get_model("mmoe", layout, cfg), seed=0).compile()
    ids, dense = jtr.pack_inputs(x)
    shapes = jax.eval_shape(
        lambda i, d: jtr.model.init(jax.random.PRNGKey(0), i, d, None, train=False),
        jnp.asarray(ids[:2]), jnp.asarray(dense[:2]))["params"]
    jtr.variables = {"params": jax.tree_util.tree_map(jnp.asarray, _numpy_params(shapes, 1))}
    jtr.fit(_rows(x, 0, 160), y[:160], batch_size=64, epochs=1, verbose=0)  # warm state
    assert jtr.table_update == update and not getattr(jtr, "device_metadata", False)
    assert isinstance(jtr._train_state["table_opt"], J.SparseAdamState)
    return jtr, x, y


def _state_of(jtr):
    params = jax.tree_util.tree_map(np.asarray, jtr.variables["params"])
    st = jtr._train_state
    adam = st["opt_state"][0]  # optax.flatten(adam): flat mu / nu vectors
    _, unravel = ravel_pytree(JaxTrainer._without_table(params)[0])
    opt_state = {"count": np.asarray(adam.count), "mu": unravel(adam.mu),
                 "nu": unravel(adam.nu)}
    topt = st["table_opt"]
    table_opt = {"count": np.asarray(topt.count), "mu": np.asarray(topt.mu),
                 "nu": np.asarray(topt.nu)}
    return params, table_opt, opt_state


def _close_moments(got, want):
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * scale)


@pytest.mark.parametrize("update,P", [("scatter", 1), ("scatter", 16),
                                      ("pallas", 1), ("pallas", 16)])
def test_f32_two_phase_fit_matches_jax(update, P):
    jtr, x, y = _jax_side(update, P)
    cfg = tsyn.make_config(vocab=VOCAB[P], table_update=update, **KW)
    layout, *_ = tsyn.make_data(cfg, n=8, seed=0, vocab=VOCAB[P])
    tr = Trainer(get_model("mmoe", layout, cfg, device="cpu"), seed=0, device="cpu").compile()
    load_jax_train_state(tr, *_state_of(jtr))
    assert tr.table_update == update and isinstance(tr.table_opt, T.SparseAdamState)
    assert tr.table_opt.mu.dtype == torch.float32 and not tr.device_metadata
    K.reset_launch_counts()
    T.reset_metadata_calls()
    for a, b, shuffle in SLICES:  # 1 step, then 2 more
        jtr.fit(_rows(x, a, b), y[a:b], batch_size=64, epochs=1, verbose=0, shuffle=shuffle)
        tr.fit(_rows(x, a, b), y[a:b], batch_size=64, epochs=1, verbose=0, shuffle=shuffle)
        np.testing.assert_allclose(tr.history[-1]["loss"], jtr.history[-1]["loss"], rtol=1e-5)
        params, table_opt, _ = _state_of(jtr)
        table = params["embeddings"]["fused"]["table"]
        np.testing.assert_allclose(tr.table.detach().numpy(), table, rtol=0, atol=1e-6)
        _close_moments(tr.table_opt.mu.numpy(), table_opt["mu"])
        _close_moments(tr.table_opt.nu.numpy(), table_opt["nu"])
        assert int(tr.table_opt.count) == int(table_opt["count"])
    assert sum(K.launch_counts.values()) == 0
    assert T.metadata_calls["native"] + T.metadata_calls["numpy"] == 3  # one per step
    flat_j = {"/".join(str(p.key) for p in path): np.asarray(a)
              for path, a in jax.tree_util.tree_flatten_with_path(jtr.variables["params"])[0]}
    for k, p in tr.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), flat_j[k.replace(".", "/")],
                                   rtol=0, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(tr.predict(_rows(x, 0, 100), 64),
                               jtr.predict(_rows(x, 0, 100), 64), rtol=0, atol=1e-6)


def test_f32_route_refusals():
    """Split bf16 moments and the unique update run (ported from ROADMAP A4:
    tests/test_torch_split_moments.py holds them against JAX); the stacked
    container still needs packed moments, as the JAX trainer says."""
    for extra, kind in ((dict(table_update="scatter", table_opt_dtype="bfloat16"),
                         torch.bfloat16),
                        (dict(table_update="unique"), torch.float32),
                        (dict(table_update="pallas", table_container="stacked"), None)):
        cfg = tsyn.make_config(vocab=400, **{**KW, **extra})
        layout, x, y, _ = tsyn.make_data(cfg, n=128, seed=0, vocab=400)
        model = get_model("mmoe", layout, cfg, device="cpu")
        if kind is None:
            with pytest.raises(ValueError, match="packed bf16"):
                Trainer(model, device="cpu")
            continue
        tr = Trainer(model, device="cpu").compile()
        table0 = tr.table.detach().clone()
        tr.fit(x, y, batch_size=64, epochs=1, verbose=0)
        assert tr.table_update == extra["table_update"]
        assert isinstance(tr.table_opt, T.SparseAdamState) and tr.table_opt.mu.dtype == kind
        assert int(tr.table_opt.count) == 2 and not torch.equal(tr.table.detach(), table0)
