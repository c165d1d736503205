"""The port's dense-table fit of MMoE (``two_phase_embedding`` off), held
against the JAX Trainer on the CPU, plus the port's own pins.

Both sides start from one state: the JAX trainer fits 160 rows from
transplanted numpy weights (so its optimizer state is warm), and that whole
state, the fused table's moments included, is carried into the port
(``convert.load_jax_train_state``).  Then both run the same ``fit`` calls
at dropout 0: shuffled epochs with a last partial batch, validation,
metrics, and an unshuffled epoch.

Tolerances, all from f32 products and sums that run in another order in
PyTorch than in XLA: per-epoch losses rtol 1e-5; every parameter, the fused
table included, atol 1e-6 after the steps (an Adam step moves a weight by at
most lr = 3e-3, and a gradient that differs in its last bits moves that
step by ~1e-7 of it); Adam's mu atol 1e-6 and nu rtol 1e-4 + atol 1e-10;
AUC and logloss of equal-to-1e-6 predictions atol 1e-5.  The one-hot
product and the scatter-add of the table cotangent agree to ~4e-6 per the
JAX docstring (embedding.py:129-131); each mode is compared with the same
mode in JAX.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.flatten_util import ravel_pytree

from mmlrec_tpu import synthetic as jsyn
from mmlrec_tpu.models import get_model as jax_get_model
from mmlrec_tpu.train import Trainer as JaxTrainer
from mmlrec_tpu.train.optimizers import get_optimizer as jax_get_optimizer
from mmlrec_tpu_torch import synthetic as tsyn
from mmlrec_tpu_torch.convert import load_jax_train_state
from mmlrec_tpu_torch.models import get_model
from mmlrec_tpu_torch.ops import kernels as K
from mmlrec_tpu_torch.ops.embedding import MATMUL_GRAD_BUDGET_BYTES, FusedEmbedding
from mmlrec_tpu_torch.ops.layers import dropout
from mmlrec_tpu_torch.serving import ServingBundle, save_serving_bundle
from mmlrec_tpu_torch.train import Trainer
from mmlrec_tpu_torch.train.optimizers import Flat, FlatTensors, get_optimizer
from mmlrec_tpu_torch.utils.seeding import make_generator

KW = dict(model_name="mmoe", n_sparse=4, n_dense=2, hidden=(16, 8), tower=(8,), gate=(8,),
          batch_size=64, lr=3e-3)
VOCAB = {1: 400, 16: 1 << 16}  # 1664 rows unpacked; 2^18 rows, lane-packed P = 16
METRICS = ["auc", "logloss"]
_TABLE = "embeddings/fused/table"


def _rows(x, a, b):
    return {k: v[a:b] for k, v in x.items()}


def _numpy_params(shapes, seed):
    rng = np.random.default_rng(seed)
    std = {"table": 0.3, "bias": 0.1, "kernel": 0.3}
    return jax.tree_util.tree_map_with_path(
        lambda path, a: rng.normal(0, std[path[-1].key], a.shape).astype(np.float32), shapes)


def _flat(tree):
    return {"/".join(str(p.key) for p in path): np.asarray(a)
            for path, a in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _metrics(task):
    # msl sums the heads' probabilities, which may pass 1: scikit-learn's
    # log_loss (the JAX side) refuses that, and so does the port's
    return METRICS if task == "mtl" else ["auc", "acc"]


def _jax_side(P, task="mtl", optimizer="adam", warm=160, **extra):
    vocab = VOCAB[P]
    cfg = jsyn.make_config(task_name=task, vocab=vocab, **KW, **extra)
    layout, x, y, _ = jsyn.make_data(cfg, n=428, seed=0, vocab=vocab)
    jtr = JaxTrainer(jax_get_model("mmoe", layout, cfg), seed=0).compile(
        optimizer=optimizer, metrics=_metrics(task))
    ids, dense = jtr.pack_inputs(x)
    dm = jnp.ones((2, 2), jnp.float32) if task != "mtl" else None
    shapes = jax.eval_shape(
        lambda i, d: jtr.model.init(jax.random.PRNGKey(0), i, d, dm, train=False),
        jnp.asarray(ids[:2]), jnp.asarray(dense[:2]))["params"]
    jtr.variables = {"params": jax.tree_util.tree_map(jnp.asarray, _numpy_params(shapes, 1))}
    if warm:
        jtr.fit(_rows(x, 0, warm), y[:warm], batch_size=64, epochs=1, verbose=0)
    return jtr, x, y


def _state_of(jtr):
    """(params, optax state by field name) of a dense-fit JAX trainer, as
    numpy trees; an optax.flatten state is unravelled."""
    params = jax.tree_util.tree_map(np.asarray, jtr.variables["params"])
    _, unravel = ravel_pytree(params)
    inner = jtr._train_state["opt_state"][0]
    opt_state = {}
    for field in getattr(inner, "_fields", ()):
        value = getattr(inner, field)
        if field == "count":
            opt_state[field] = np.asarray(value)
        else:
            opt_state[field] = unravel(value) if getattr(value, "ndim", 0) == 1 else value
    return params, opt_state


def _port_trainer(P, state, task="mtl", optimizer="adam", **extra):
    cfg = tsyn.make_config(task_name=task, vocab=VOCAB[P], **KW, **extra)
    layout, *_ = tsyn.make_data(cfg, n=8, seed=0, vocab=VOCAB[P])
    tr = Trainer(get_model("mmoe", layout, cfg, device="cpu"), seed=0, device="cpu").compile(
        optimizer=optimizer, metrics=_metrics(task))
    params, opt_state = state
    return load_jax_train_state(tr, params, None, opt_state)


def _assert_same_history(tr, jtr, n_epochs):
    """The last ``n_epochs`` logs (the JAX trainer's history also holds its
    warm-up fit)."""
    assert len(tr.history) >= n_epochs and len(jtr.history) >= n_epochs
    for got, want in zip(tr.history[-n_epochs:], jtr.history[-n_epochs:]):
        assert set(got) == set(want)
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
        for k in want:
            if k not in ("loss", "epoch_s"):
                np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5, err_msg=k)


def _assert_same_params(tr, jax_params, atol=1e-6):
    want = _flat(jax_params)
    got = {k.replace(".", "/"): p.detach().numpy() for k, p in tr.model.named_parameters()}
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=atol, err_msg=k)


@pytest.mark.parametrize("grad_mode,P,task", [
    ("matmul", 1, "mtl"), ("scatter", 1, "mtl"), ("auto", 16, "mtl"), ("auto", 1, "msl")])
def test_dense_fit_matches_jax(grad_mode, P, task):
    extra = dict(embedding_grad=grad_mode)
    jtr, x, y = _jax_side(P, task, **extra)
    tr = _port_trainer(P, _state_of(jtr), task, **extra)
    fused = tr.model.embeddings.fused
    assert fused.pack_factor == P and tr.table.requires_grad
    assert fused.table_grad_mode(64 * 4) == ("scatter" if P > 1 or grad_mode == "scatter"
                                             else "matmul")
    val = (_rows(x, 328, 428), y[328:428])
    K.reset_launch_counts()
    # two shuffled epochs of 168 rows (3 steps, the last of 40 rows) with
    # validation, then one unshuffled epoch with the tail split off
    for kw in (dict(epochs=2, validation_data=val), dict(shuffle=False, validation_split=0.25)):
        jtr.fit(_rows(x, 160, 328), y[160:328], batch_size=64, verbose=0, **kw)
        tr.fit(_rows(x, 160, 328), y[160:328], batch_size=64, verbose=0, **kw)
    assert sum(K.launch_counts.values()) == 0  # the CPU runs the plain versions
    assert K.backward_counts["embed_concat"] == 3 * 2 + 2  # once per step
    _assert_same_history(tr, jtr, 3)
    names = _metrics(task)
    assert {*names, *(f"val_{k}" for k in names)} <= set(tr.history[-1])

    j_params, j_opt = _state_of(jtr)
    _assert_same_params(tr, j_params)
    assert int(tr.opt_state.count) == int(j_opt["count"]) == 3 + 6 + 2
    mu, nu = _flat(j_opt["mu"]), _flat(j_opt["nu"])
    for k, p in tr.model.named_parameters():
        key = k.replace(".", "/")
        np.testing.assert_allclose(tr.opt_state.mu[k].numpy(), mu[key], rtol=0, atol=1e-6,
                                   err_msg=key)
        np.testing.assert_allclose(tr.opt_state.nu[k].numpy(), nu[key], rtol=1e-4, atol=1e-10,
                                   err_msg=key)
    # rows the batches never touched: the whole-table Adam decays nothing
    # into them (zero gradient, zero moments), so they keep their bits
    touched = np.zeros(fused.table.numel() // 8, bool)
    ids = np.stack([x[f"s{i}"][:328] for i in range(4)], 1) + np.arange(4) * VOCAB[P]
    touched[ids.reshape(-1)] = True
    start = _flat(_numpy_params(jax.tree_util.tree_map(np.asarray, j_params), 1))[_TABLE]
    np.testing.assert_array_equal(
        tr.table.detach().numpy().reshape(-1, 8)[~touched], start.reshape(-1, 8)[~touched])

    ev, jev = tr.evaluate(*val, batch_size=64), jtr.evaluate(*val, batch_size=64)
    assert set(ev) == set(jev) == set(names)
    for k in ev:
        np.testing.assert_allclose(ev[k], jev[k], rtol=0, atol=1e-5, err_msg=k)
    np.testing.assert_allclose(tr.predict(val[0], 64), jtr.predict(val[0], 64), rtol=0, atol=1e-6)


def test_best_snapshot_early_stop_and_max_steps_match_jax(tmp_path):
    """A fit that overfits 64 rows at a large step: val_auc peaks early, so
    the best snapshot is not the last epoch and the fit stops early; then a
    fit capped by max_steps.  The history, the stop and the snapshot follow
    the JAX trainer's."""
    jtr, x, y = _jax_side(1, warm=0)
    jtr.fit(_rows(x, 0, 64), y[:64], batch_size=64, epochs=1, verbose=0)
    tr = _port_trainer(1, _state_of(jtr))
    for t in (jtr, tr):
        t.cfg.optim_config.early_stop = 2
        assert t.cfg.optim_config.lr == 3e-3
    val = (_rows(x, 328, 428), y[328:428])
    kw = dict(batch_size=32, epochs=12, validation_data=val, verbose=0, shuffle=False)
    jtr.fit(_rows(x, 64, 128), y[64:128], **kw)
    tr.fit(_rows(x, 64, 128), y[64:128], **kw)
    assert 2 < len(jtr.history) - 1 < 12  # it did stop early
    assert len(tr.history) == len(jtr.history) - 1
    _assert_same_history(tr, jtr, len(tr.history))
    aucs = [h["val_auc"] for h in tr.history]
    best = int(np.argmax(aucs))  # the first epoch at the maximum: strict '>'
    assert best == len(aucs) - 1 - 2 and tr.best_variables is not None
    _assert_same_params(tr, jtr.variables["params"], atol=2e-6)  # the last epoch's
    want = _flat(jtr.best_variables["params"])
    for k, v in tr.best_variables.items():
        np.testing.assert_allclose(v.numpy(), want[k.replace(".", "/")], rtol=0, atol=2e-6)
        assert v.data_ptr() != dict(tr.model.named_parameters())[k].data_ptr()  # an owned copy
    # evaluate and predict read the snapshot, and so does the exported bundle
    assert tr.evaluate(*val, batch_size=32)["auc"] == aucs[best]
    np.testing.assert_allclose(tr.predict(val[0], 32), jtr.predict(val[0], 32), rtol=0, atol=2e-6)
    save_serving_bundle(tr, str(tmp_path))
    bundle = ServingBundle.load(str(tmp_path), device="cpu")
    np.testing.assert_array_equal(bundle.predict(val[0], 32), tr.predict(val[0], 32))
    assert not np.array_equal(bundle.model.embeddings.fused.table.detach().numpy(),
                              tr.table.detach().numpy())

    # max_steps: 5 steps over epochs of 2 steps; no validation, so the fit
    # ends without a snapshot and predict reads the current weights again
    for t in (jtr, tr):
        t.cfg.training_config.max_steps = 5
    n0 = len(tr.history)
    jtr.fit(_rows(x, 64, 128), y[64:128], batch_size=32, epochs=10, verbose=0)
    tr.fit(_rows(x, 64, 128), y[64:128], batch_size=32, epochs=10, verbose=0)
    assert len(tr.history) - n0 == 3 and tr.best_variables is None
    _assert_same_history(tr, jtr, 3)
    _assert_same_params(tr, jtr.variables["params"], atol=2e-6)
    assert tr.throughput_examples_per_s > 0


@pytest.mark.parametrize("name", ["sgd", "adagrad", "rmsprop"])
def test_dense_fit_other_optimizers_match_jax(name):
    """The optax state of each optimizer moves across and both sides take
    the same steps (adam: test_dense_fit_matches_jax)."""
    jtr, x, y = _jax_side(1, optimizer=name, warm=128)
    params, opt_state = _state_of(jtr)
    assert set(opt_state) == {"sgd": set(), "adagrad": {"sum_of_squares"},
                              "rmsprop": {"nu"}}[name]
    tr = _port_trainer(1, (params, opt_state), optimizer=name)
    jtr.fit(_rows(x, 160, 328), y[160:328], batch_size=64, epochs=1, verbose=0)
    tr.fit(_rows(x, 160, 328), y[160:328], batch_size=64, epochs=1, verbose=0)
    _assert_same_history(tr, jtr, 1)
    # rmsprop and adagrad divide by a root that starts near zero: a weight
    # whose gradient is rounding noise may move by lr either way
    _assert_same_params(tr, jtr.variables["params"], atol=1e-6 if name == "sgd" else 2e-5)
    with pytest.raises(ValueError, match="opt_state has"):
        load_jax_train_state(tr, params, None, {"count": 0, "mu": {}, "nu": {}})


@pytest.mark.parametrize("name", ["sgd", "adam", "adagrad", "rmsprop"])
def test_optimizer_matches_optax(name):
    """Five steps on numpy gradients, against the JAX package's factory:
    f32 elementwise chains in optax's order, so one ulp on weights of
    order 1 (rtol 3e-7 + atol 1e-7: a fused multiply-add on one side, and a
    reciprocal root that neither library rounds correctly)."""
    rng = np.random.default_rng(3)
    shapes = {"a": (7, 5), "b": (11,)}
    p0 = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.normal(size=s) * 10.0 ** rng.integers(-4, 1)).astype(np.float32)
              for k, s in shapes.items()} for _ in range(5)]
    grads[1]["b"][:3] = 0.0  # adagrad's where(sum > 0) branch stays reachable
    grads[0]["b"][:3] = 0.0
    tx = jax_get_optimizer(name, 1e-2)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    jstate = tx.init(jp)
    opt = get_optimizer(name, 1e-2)
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    tstate = opt.init(tp)
    for g in grads:
        updates, jstate = tx.update({k: jnp.asarray(v) for k, v in g.items()}, jstate, jp)
        jp = optax.apply_updates(jp, updates)
        tstate = opt.step(tp, {k: torch.from_numpy(v) for k, v in g.items()}, tstate)
    for k in shapes:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=3e-7, atol=1e-7)
    for field in getattr(tstate, "_fields", ()):
        want = getattr(jstate[0], field)
        got = getattr(tstate, field)
        if field == "count":
            assert int(got) == int(want) == 5
        else:
            for k in shapes:
                np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6,
                                           atol=1e-12)


def test_get_optimizer_rejects_unknown_names():
    with pytest.raises(NotImplementedError, match="lamb"):
        get_optimizer("lamb", 1e-3)


# ----------------------------------------------------------------------
# the table cotangent's mode
# ----------------------------------------------------------------------
def test_matmul_grad_budget_boundary():
    """"auto" takes the one-hot product while its f32 [B, F, vmax] one-hot
    fits the budget, to the byte (embedding.py:303-313)."""
    vmax = 1 << 10
    fused = FusedEmbedding((vmax, 7, 300), 8, generator=make_generator(0))
    n_fit = MATMUL_GRAD_BUDGET_BYTES // (vmax * 4)  # ids whose one-hot is exactly the budget
    assert n_fit * vmax * 4 == MATMUL_GRAD_BUDGET_BYTES
    assert fused.table_grad_mode(n_fit) == "matmul"
    assert fused.table_grad_mode(n_fit + 1) == "scatter"
    halved = FusedEmbedding((vmax, 7, 300), 8, generator=make_generator(0),
                            grad_budget_divisor=2)
    assert halved.table_grad_mode(n_fit // 2) == "matmul"
    assert halved.table_grad_mode(n_fit // 2 + 1) == "scatter"
    forced = FusedEmbedding((vmax, 7), 8, generator=make_generator(0), grad_mode="matmul")
    assert forced.table_grad_mode(100 * n_fit) == "matmul"
    never = FusedEmbedding((vmax, 7), 8, generator=make_generator(0), grad_mode="scatter")
    assert never.table_grad_mode(1) == "scatter"
    packed = FusedEmbedding((1 << 17, 1 << 17), 8, generator=make_generator(0),
                            grad_mode="matmul")
    assert packed.pack_factor == 16 and packed.table_grad_mode(1) == "scatter"
    # the flagship's one-hot ([4096, 16, 100] f32, 26 MB) fits; at 65,536 ids
    # per feature (17 GB) the rule sends it to the scatter-add
    assert FusedEmbedding((100,) * 16, 8, generator=make_generator(0)).table_grad_mode(
        4096 * 16) == "matmul"
    assert FusedEmbedding((1 << 13,) * 16, 8, generator=make_generator(0),
                          ).table_grad_mode(4096 * 16) == "scatter"
    with pytest.raises(ValueError, match="embedding_grad"):
        FusedEmbedding((10,), 8, generator=make_generator(0), grad_mode="onehot")


def test_lane_packed_table_gradient_lands_in_the_packed_view():
    fused = FusedEmbedding((1 << 17, 1 << 17), 8, generator=make_generator(0))
    ids = torch.tensor([[5, 9], [5, 131071]], dtype=torch.int32)
    out = fused.embed_concat(ids, torch.zeros(2, 0))
    (g,) = torch.autograd.grad(out.sum(), fused.table)
    assert g.shape == fused.table.shape == (16384, 128)
    flat = g.reshape(-1, 8)
    assert flat[5].eq(2).all() and flat[131072 + 9].eq(1).all() and flat[262143].eq(1).all()
    assert float(g.sum()) == 4 * 8


# ----------------------------------------------------------------------
# dropout
# ----------------------------------------------------------------------
def test_dropout_keep_rate_scaling_and_seeding():
    """The masks cannot equal JAX's (another generator): the keep rate is
    held to 4 standard errors, the scaling exactly, and equal seeds give
    equal masks."""
    x = torch.ones(400, 250)
    for rate in (0.1, 0.5, 0.8):
        out = dropout(x, rate, make_generator(3))
        kept = out != 0
        keep = 1.0 - rate
        assert abs(float(kept.float().mean()) - keep) < 4 * np.sqrt(keep * rate / x.numel())
        torch.testing.assert_close(out[kept], torch.full_like(out[kept], 1.0 / keep))
        assert torch.equal(out, dropout(x, rate, make_generator(3)))
        assert not torch.equal(out, dropout(x, rate, make_generator(4)))
    assert dropout(x, 0.0, make_generator(0)) is x
    assert not dropout(x, 1.0, make_generator(0)).any()


def _dropout_trainer(seed):
    cfg = tsyn.make_config(task_name="mtl", vocab=400, dnn_dropout=0.5, **KW)
    layout, x, y, _ = tsyn.make_data(cfg, n=192, seed=0, vocab=400)
    model = get_model("mmoe", layout, cfg, generator=make_generator(5), device="cpu")
    return Trainer(model, seed=seed, device="cpu").compile(metrics=[]), x, y


def test_dropout_in_the_fit_follows_the_trainers_generator():
    a, x, y = _dropout_trainer(0)
    b, _, _ = _dropout_trainer(0)
    c, _, _ = _dropout_trainer(1)
    a.fit(x, y, batch_size=64, epochs=2, shuffle=False, verbose=0)
    # the generator's state carries over from one fit to the next
    b.fit(x, y, batch_size=64, epochs=1, shuffle=False, verbose=0)
    b.fit(x, y, batch_size=64, epochs=1, shuffle=False, verbose=0)
    c.fit(x, y, batch_size=64, epochs=2, shuffle=False, verbose=0)
    assert [h["loss"] for h in a.history] == [h["loss"] for h in b.history]
    assert [h["loss"] for h in a.history] != [h["loss"] for h in c.history]
    assert not a.model.training  # training mode lasts for the step only
    p1, p2 = a.predict(x, 64), a.predict(x, 64)
    np.testing.assert_array_equal(p1, p2)  # no dropout at eval
    model = a.model
    model.set_dropout_generator(None)
    model.train()
    with pytest.raises(RuntimeError, match="generator"):
        model(torch.zeros(2, 4, dtype=torch.int32), torch.zeros(2, 2))


# ----------------------------------------------------------------------
# refusals
# ----------------------------------------------------------------------
# the host-loop knobs (scan_steps, batch_metric_curves, flat_optimizer,
# prefetch_batches), sparse_embedding_update and the per-task methods are
# ported: their cases (item None) fit with the knob and check that it took
# effect; tests/test_torch_staged_fit.py holds the host-loop knobs against
# the other paths bitwise, tests/test_torch_split_moments.py
# sparse_embedding_update and tests/test_torch_task_gradients.py CAGrad
# against JAX
@pytest.mark.parametrize("override,item", [
    (dict(sparse_embedding_update=True), None),
    (dict(scan_steps=16), None),
    (dict(batch_metric_curves=True), None),
    (dict(use_cagrad=True), None),
    (dict(table_container="stacked", stacked_shards=2),
     ValueError("the dense-table fit needs the split table")),
    (dict(flat_optimizer=False), None),
    (dict(prefetch_batches=4), None),
])
def test_dense_fit_unported_knobs_name_their_roadmap_item(override, item):
    cfg = tsyn.make_config(**{**KW, "vocab": 400, **override})
    layout, x, y, _ = tsyn.make_data(cfg, n=150, seed=0, vocab=400)
    if item is not None:
        err, match = ((type(item), str(item)) if isinstance(item, Exception)
                      else (NotImplementedError, item))
        with pytest.raises(err, match=match):
            Trainer(get_model("mmoe", layout, cfg, device="cpu"), device="cpu")
        return
    tr = Trainer(get_model("mmoe", layout, cfg, device="cpu"), device="cpu").compile(
        metrics=["auc"])
    if "prefetch_batches" in override:
        tr._device_data_bytes_cap = 0  # the streaming loop reads the depth
    tr.fit(x, y, batch_size=64, epochs=2, verbose=0)
    assert np.isfinite([h["loss"] for h in tr.history]).all()
    assert tr._scan_steps == 16 and tr._prefetch_batches == override.get("prefetch_batches", 2)
    assert isinstance(tr.tx, Flat) == ("flat_optimizer" not in override)
    assert isinstance(tr.opt_state.mu, FlatTensors) == ("flat_optimizer" not in override)
    if "batch_metric_curves" in override:
        assert [len(c) for c in tr.batch_history] == [3, 3]  # ceil(150 / 64) batches
        want = np.mean([c["auc"] for c in tr.batch_history[-1]])
        assert abs(tr.history[-1]["batch_mean_auc"] - want) < 1e-12
    else:
        assert tr.batch_history == [] and "batch_mean_auc" not in tr.history[-1]
    assert tr.per_task == ("cagrad" if "use_cagrad" in override else None)
    if "sparse_embedding_update" in override:  # the table's own SparseAdam, 6 steps
        assert "embeddings.fused.table" not in tr.opt_state.mu
        assert int(tr.table_opt.count) == 6 and tr.table_opt.mu.any()


@pytest.mark.parametrize("call", ["Trainer(debug=True)", "fit(epoch_callback=...)"])
def test_trainer_arguments_not_ported_name_their_roadmap_item(call):
    """Both arguments are ported: debug runs the eager steps with anomaly
    detection and raises on a step whose loss is not finite; the callback
    sees each epoch's trainer after its log."""
    cfg = tsyn.make_config(vocab=400, **KW)
    layout, x, y, _ = tsyn.make_data(cfg, n=64, seed=0, vocab=400)
    model = get_model("mmoe", layout, cfg, device="cpu")
    if call.startswith("Trainer"):
        was = torch.is_anomaly_enabled()
        try:
            tr = Trainer(model, debug=True, device="cpu").compile()
            assert tr.debug and torch.is_anomaly_enabled()
            tr.fit(x, y, batch_size=32, epochs=1, verbose=0)
            assert np.isfinite(tr.history[-1]["loss"]) and tr.throughput_examples_per_s
            with torch.no_grad():
                tr.model.embeddings.fused.table.fill_(float("nan"))
            with pytest.raises(FloatingPointError, match="debug: .*(nan|not finite)"):
                tr.fit(x, y, batch_size=32, epochs=1, verbose=0)
        finally:
            torch.autograd.set_detect_anomaly(was)
    else:
        seen = []
        tr = Trainer(model, device="cpu").compile()
        tr.fit(x, y, batch_size=32, epochs=3, verbose=0,
               epoch_callback=lambda epoch, t: seen.append((epoch, len(t.history))))
        assert seen == [(0, 1), (1, 2), (2, 3)]
    # the defaults of the knobs are accepted
    cfg.model_config.extra.update(flat_optimizer=True, prefetch_batches=2)
    Trainer(model, debug=False, device="cpu")


def test_dense_fit_refusals_and_default_device(monkeypatch, tmp_path):
    cfg = tsyn.make_config(vocab=400, **KW)
    layout, x, y, _ = tsyn.make_data(cfg, n=64, seed=0, vocab=400)
    model = get_model("mmoe", layout, cfg, device="cpu")
    tr = Trainer(model, device="cpu").compile()
    trace = tr.profile(x, y, batch_size=32, steps=2, trace_dir=str(tmp_path / "trace"))
    assert trace == str(tmp_path / "trace") and any(
        f.endswith(".json") for f in os.listdir(trace))  # torch.profiler's Chrome trace
    # checkpoints, device validation and the device's test metrics are
    # ported (tests/test_torch_checkpoints.py, tests/test_torch_device_metrics.py)
    assert os.path.isdir(tr.save_checkpoint(str(tmp_path)))
    assert set(tr.masked_test_metrics_device(x, y, None, 32)) == {
        "log_loss_0", "auc_0", "log_loss_1", "auc_1"}
    cfg.training_config.extra["device_eval"] = True
    cfg.save_config.save = True
    assert Trainer(model, device="cpu").compile()._use_device_eval()
    cfg.training_config.extra.pop("device_eval")
    cfg.save_config.save = False
    stacked = tsyn.make_config(vocab=400, table_container="stacked", **KW)
    with pytest.raises(ValueError, match="split table"):
        Trainer(get_model("mmoe", layout, stacked, device="cpu"), device="cpu")
    # evaluate follows the trainer's device rule: the card unless asked for the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(model)
    assert set(tr.evaluate(x, y, 32)) == {"auc", "acc"}
