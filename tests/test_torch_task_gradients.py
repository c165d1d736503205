"""The per-task gradient methods (PCGrad, GradNorm, CAGrad) and the CKA domain
loss of the port, held against the JAX package on the CPU.

Unit tests: the same numpy inputs through ``mmlrec_tpu/train/pcgrad.py``,
``gradnorm.py``, ``cagrad.py``, ``cka.py`` and ``losses.per_task_losses`` and
through the port's counterparts, on conflicting, agreeing and partly
all-zero task gradients; tolerance rtol 1e-5, atol 1e-6 (sums of f32
products in another order).

Fits: both trainers start cold from one numpy state (parameters and
BatchNorm statistics) and fit the same 230 rows at batch 64 (four steps,
the last of 38 rows, padded), dropout 0; losses rtol 1e-5, every parameter,
every running statistic and GradNorm's state atol 1e-6 (an Adam step moves
a weight by at most lr = 1e-3, and a gradient that differs in its last
bits moves that step by ~1e-7 of it).  The family with BatchNorm trains
with SGD, where a bias that feeds a BatchNorm (gradient zero in exact
arithmetic) keeps its rounding noise small (tests/test_torch_family_fit.py).
So do the CKA fits: with the CKA term an entry of ``mlp``'s first kernel
had a first-step gradient of 8.3e-8, a near-cancelling sum of terms of
order 0.1, and Adam's ``g / (|g| + 1e-8)`` turned its rounding into a
step that differed from JAX's by 0.6% of lr (5.9e-6).

The per-task step's traps are pinned within the port, bitwise: one
BatchNorm update per step, no ``loss_weights`` and no CKA term in a task's
loss, no CKA term in the two-phase step, GradNorm's state reset by a second
fit and carried by a checkpoint.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmlrec_tpu import synthetic as jsyn
from mmlrec_tpu.models import get_model as jax_get_model
from mmlrec_tpu.train import Trainer as JaxTrainer
from mmlrec_tpu.train.cagrad import cagrad_merge as jax_cagrad_merge
from mmlrec_tpu.train.cka import cka_domain_loss as jax_cka_domain_loss
from mmlrec_tpu.train.cka import linear_cka as jax_linear_cka
from mmlrec_tpu.train.gradnorm import gradnorm_update as jax_gradnorm_update
from mmlrec_tpu.train.losses import per_task_losses as jax_per_task_losses
from mmlrec_tpu.train.pcgrad import pcgrad_merge as jax_pcgrad_merge
from mmlrec_tpu_torch import synthetic as tsyn
from mmlrec_tpu_torch.convert import load_jax_variables
from mmlrec_tpu_torch.models import get_model
from mmlrec_tpu_torch.ops import kernels as K
from mmlrec_tpu_torch.train import Trainer
from mmlrec_tpu_torch.train.cagrad import cagrad_merge
from mmlrec_tpu_torch.train.cka import cka_domain_loss, linear_cka
from mmlrec_tpu_torch.train.gradnorm import gradnorm_update
from mmlrec_tpu_torch.train.losses import per_task_losses
from mmlrec_tpu_torch.train.pcgrad import pcgrad_merge
from tests.test_torch_models import numpy_variables

RTOL, ATOL = 1e-5, 1e-6
SHAPES = {"a": (3, 4), "b": (5,), "c": (2, 2)}
KW = dict(n_sparse=4, n_dense=2, hidden=(16, 8), tower=(8,), gate=(8,), batch_size=64,
          lr=1e-3, vocab=100)
N, BATCH = 230, 64
SGD_LR = 0.005


# ----------------------------------------------------------------------
# the plain modules against JAX
# ----------------------------------------------------------------------
def _task_grads(kind, T, seed=0):
    """T gradient dicts: ``conflicting`` (alternating signs of one direction
    plus noise), ``agreeing`` (one direction plus noise), ``zeros`` (tensor
    ``b`` all zero for task 0, tensor ``c`` all zero for every task)."""
    rng = np.random.default_rng(seed)
    base = {k: rng.normal(0, 1, s) for k, s in SHAPES.items()}
    out = []
    for t in range(T):
        g = {}
        for k, s in SHAPES.items():
            if kind == "conflicting":
                v = (-1.0) ** t * base[k] + 0.3 * rng.normal(0, 1, s)
            elif kind == "agreeing":
                v = base[k] + 0.3 * rng.normal(0, 1, s)
            else:
                v = rng.normal(0, 1, s)
                if k == "c" or (k == "b" and t == 0):
                    v = np.zeros(s)
            g[k] = v.astype(np.float32)
        out.append(g)
    return out


def _both(grads):
    return ([{k: jnp.asarray(v) for k, v in g.items()} for g in grads],
            [{k: torch.from_numpy(v.copy()) for k, v in g.items()} for g in grads])


def _assert_dicts(got, want, rtol=RTOL, atol=ATOL):
    assert list(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=rtol, atol=atol,
                                   err_msg=k)


@pytest.mark.parametrize("T", [2, 3])
@pytest.mark.parametrize("kind", ["conflicting", "agreeing", "zeros"])
def test_pcgrad_merge_matches_jax(kind, T):
    jg, tg = _both(_task_grads(kind, T))
    got = pcgrad_merge(tg)
    _assert_dicts(got, jax_pcgrad_merge(jg))
    if kind == "zeros":  # not shared: the sum over tasks, of zeros where all are zero
        assert not got["c"].any()
    if kind == "agreeing":  # no conflict: the plain mean
        np.testing.assert_allclose(got["a"].numpy(), np.mean([g["a"] for g in tg], axis=0),
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("T", [2, 3])
@pytest.mark.parametrize("kind", ["conflicting", "agreeing", "zeros"])
def test_gradnorm_update_matches_jax(kind, T):
    rng = np.random.default_rng(7)
    w = rng.uniform(0.5, 1.5, T).astype(np.float32)
    losses = rng.uniform(10, 50, T).astype(np.float32)
    first = rng.uniform(10, 50, T).astype(np.float32)
    jg, tg = _both(_task_grads(kind, T, seed=3))
    j_w, j_norms = jax_gradnorm_update(jnp.asarray(w), jnp.asarray(losses), jnp.asarray(first),
                                       jg, alpha=1.5, lr=0.025)
    t_w, t_norms = gradnorm_update(torch.from_numpy(w), torch.from_numpy(losses),
                                   torch.from_numpy(first), tg, alpha=1.5, lr=0.025)
    np.testing.assert_allclose(t_norms.numpy(), np.asarray(j_norms), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(t_w.numpy(), np.asarray(j_w), rtol=RTOL, atol=ATOL)
    assert abs(float(t_w.sum()) - T) < 1e-5 and not np.allclose(t_w.numpy(), w)


@pytest.mark.parametrize("T", [2, 3])
@pytest.mark.parametrize("kind", ["conflicting", "agreeing", "zeros"])
@pytest.mark.parametrize("alpha", [0.5, 0.2])
def test_cagrad_merge_matches_jax(kind, T, alpha):
    jg, tg = _both(_task_grads(kind, T, seed=5))
    _assert_dicts(cagrad_merge(tg, alpha=alpha), jax_cagrad_merge(jg, alpha=alpha))


@pytest.mark.parametrize("D", [2, 3])
def test_cka_matches_jax(D):
    rng = np.random.default_rng(D)
    x = rng.normal(0, 1, (48, 6)).astype(np.float32)
    y = (0.5 * x + rng.normal(0, 1, (48, 6))).astype(np.float32)
    mask = np.eye(D, dtype=np.float32)[rng.integers(0, D, 48)]
    np.testing.assert_allclose(float(linear_cka(torch.from_numpy(x), torch.from_numpy(y))),
                               float(jax_linear_cka(jnp.asarray(x), jnp.asarray(y))),
                               rtol=RTOL, atol=ATOL)
    got = cka_domain_loss(torch.from_numpy(x), torch.from_numpy(mask), alpha=0.5)
    want = jax_cka_domain_loss(jnp.asarray(x), jnp.asarray(mask), alpha=0.5)
    np.testing.assert_allclose(float(got), float(want), rtol=RTOL, atol=ATOL)
    assert 0.0 < float(got) <= 0.5 * D * (D - 1) / 2


@pytest.mark.parametrize("task,T,masked", [
    ("mtl", 2, False), ("msl", 2, True), ("msl", 2, False), ("mtmsl", 4, True)])
def test_per_task_losses_match_jax(task, T, masked):
    rng = np.random.default_rng(T)
    B = 40
    probs = rng.uniform(0.02, 0.98, (B, T)).astype(np.float32)
    y = rng.integers(0, 2, (B, T)).astype(np.float32)
    w = (rng.random(B) > 0.2).astype(np.float32)
    dmask = np.eye(2, dtype=np.float32)[rng.integers(0, 2, B)] if masked else None
    names = ["binary_crossentropy", "mse"]
    want = jax_per_task_losses(jnp.asarray(probs), jnp.asarray(y), jnp.asarray(w), names, task,
                               2, domain_mask=None if dmask is None else jnp.asarray(dmask))
    got = per_task_losses(torch.from_numpy(probs), torch.from_numpy(y), torch.from_numpy(w),
                          names, task, 2,
                          domain_mask=None if dmask is None else torch.from_numpy(dmask))
    assert got.shape == (T,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


# ----------------------------------------------------------------------
# fits against the JAX trainer
# ----------------------------------------------------------------------
def _pair(name, task, optimizer="adam", **extra):
    """(JAX trainer, port trainer, x, y) from one numpy state, cold."""
    args = dict(KW, task_name=task, model_name=name, **extra)
    if optimizer == "sgd":
        args["lr"] = SGD_LR
    jcfg, tcfg = jsyn.make_config(**args), tsyn.make_config(**args)
    jl, x, y, _ = jsyn.make_data(jcfg, n=N, seed=0, vocab=KW["vocab"])
    tl, *_ = tsyn.make_data(tcfg, n=8, seed=0, vocab=KW["vocab"])
    jtr = JaxTrainer(jax_get_model(name, jl, jcfg), seed=0).compile(
        optimizer=optimizer, metrics=["auc"])
    ids, dense = jtr.pack_inputs(x)
    dm = jnp.ones((2, 2), jnp.float32) if task != "mtl" else None
    shapes = jax.eval_shape(
        lambda i, d: jtr.model.init(jax.random.PRNGKey(0), i, d, dm, train=False),
        jnp.asarray(ids[:2]), jnp.asarray(dense[:2]))
    variables = numpy_variables(shapes, seed=1)
    jtr.variables = jax.tree_util.tree_map(jnp.asarray, variables)
    tr = Trainer(get_model(name, tl, tcfg, device="cpu"), seed=0, device="cpu").compile(
        optimizer=optimizer, metrics=["auc"])
    load_jax_variables(tr.model, variables)
    return jtr, tr, x, y


def _flat(tree):
    return {".".join(str(p.key) for p in path): np.asarray(a)
            for path, a in jax.tree_util.tree_flatten_with_path(tree)[0]}


def assert_fit_matches(tr, jtr, n_epochs, atol=ATOL):
    """Losses of the last ``n_epochs`` logs, every parameter and running
    statistic, and GradNorm's state when there is one."""
    for got, want in zip(tr.history[-n_epochs:], jtr.history[-n_epochs:]):
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
        np.testing.assert_allclose(got["auc"], want["auc"], atol=1e-5)
    want = {**_flat(jtr.variables["params"]), **_flat(jtr.variables.get("batch_stats", {}))}
    got = {k: v.detach().numpy() for k, v in tr.model.state_dict().items()}
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=atol, err_msg=k)
    if tr.gn_state is not None:
        st = jtr._train_state
        for k in ("task_weights", "initial_losses"):
            np.testing.assert_allclose(tr.gn_state[k].numpy(), np.asarray(st[k]),
                                       rtol=RTOL, atol=ATOL, err_msg=k)
        assert int(tr.gn_state["gn_step"]) == int(st["gn_step"])


@pytest.mark.parametrize("name,task,extra,method", [
    ("pcg", "mtl", {}, "pcgrad"),
    ("mmoe", "msl", dict(use_gradnorm=True, masked_loss=True), "gradnorm"),
    ("mmoe", "mtl", dict(use_cagrad=True, cagrad_alpha=0.4), "cagrad"),
])
def test_per_task_fit_matches_jax(name, task, extra, method):
    jtr, tr, x, y = _pair(name, task, **extra)
    assert tr.per_task == method
    for fit in range(2):  # a second fit: GradNorm's weights start over, as in JAX
        for t in (jtr, tr):
            t.fit(x, y, batch_size=BATCH, epochs=1, verbose=0)
        assert_fit_matches(tr, jtr, 1)
        if method == "gradnorm":
            assert int(tr.gn_state["gn_step"]) == 4  # four steps of this fit
            assert not torch.equal(tr.gn_state["task_weights"], torch.ones(2))


def test_pcgrad_fit_with_batchnorm_matches_jax():
    jtr, tr, x, y = _pair("pcg", "msl", optimizer="sgd", dnn_use_bn=True)
    for t in (jtr, tr):
        t.fit(x, y, batch_size=BATCH, epochs=1, verbose=0)
    assert_fit_matches(tr, jtr, 1)


@pytest.mark.parametrize("name,layer", [("mlp", "last_layer"), ("mmoe", "dnn_input")])
def test_cka_fit_matches_jax(name, layer):
    jtr, tr, x, y = _pair(name, "msl", optimizer="sgd", use_cka_loss=True, masked_loss=True)
    with torch.no_grad():
        _, inter = tr.model(torch.from_numpy(tr.pack_inputs(x)[0][:BATCH]),
                            torch.zeros(BATCH, 2), return_intermediates=True)
    assert (layer == "last_layer") == ("last_layer" in inter)
    for t in (jtr, tr):
        t.fit(x, y, batch_size=BATCH, epochs=1, verbose=0)
    assert_fit_matches(tr, jtr, 1)
    # the term is in the loss: the same fit without it differs
    _, plain, *_ = _pair(name, "msl", optimizer="sgd", masked_loss=True)
    plain.fit(x, y, batch_size=BATCH, epochs=1, verbose=0)
    assert plain.history[-1]["loss"] != tr.history[-1]["loss"]


def test_two_phase_fit_with_cka_trains_without_the_term():
    """The JAX two-phase loss (``_loss_terms_injected``) has no CKA term: the
    port's two-phase fit with ``use_cka_loss`` equals JAX's, and its own fit
    without the flag bitwise."""
    extra = dict(masked_loss=True, two_phase_embedding=True, table_update="scatter",
                 vocab=400)
    jtr, tr, x, y = _pair("mmoe", "msl", use_cka_loss=True, **extra)
    for t in (jtr, tr):
        t.fit(x, y, batch_size=BATCH, epochs=1, verbose=0)
    for got, want in zip(tr.history, jtr.history):
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    want = _flat(jtr._train_state["params"])
    for k, v in tr.model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k], rtol=0, atol=ATOL, err_msg=k)
    _, plain, *_ = _pair("mmoe", "msl", **extra)
    plain.fit(x, y, batch_size=BATCH, epochs=1, verbose=0)
    assert plain.history[-1]["loss"] == tr.history[-1]["loss"]
    for k, v in tr.model.state_dict().items():
        assert torch.equal(v, plain.model.state_dict()[k]), k


# ----------------------------------------------------------------------
# the per-task step's traps, within the port
# ----------------------------------------------------------------------
def _port(name="mmoe", task="msl", **extra):
    cfg = tsyn.make_config(**dict(KW, task_name=task, model_name=name, **extra))
    layout, x, y, _ = tsyn.make_data(cfg, n=N, seed=0, vocab=KW["vocab"])
    model = get_model(name, layout, cfg, device="cpu")
    load_jax_variables(model, numpy_variables(_shapes_of(model), seed=1))
    return Trainer(model, seed=0, device="cpu").compile(metrics=["auc"]), x, y


def _shapes_of(model):
    """A flax-style shape tree of a port model's parameters and buffers."""
    params, stats = {}, {}
    names = {k for k, _ in model.named_parameters()}
    for k, v in model.state_dict().items():
        node = params if k in names else stats
        *path, leaf = k.split(".")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = jax.ShapeDtypeStruct(tuple(v.shape), jnp.float32)
    return {"params": params, "batch_stats": stats}


def _same_fit(a, b):
    assert [h["loss"] for h in a.history] == [h["loss"] for h in b.history]
    sb = b.model.state_dict()
    for k, v in a.model.state_dict().items():
        assert torch.equal(v, sb[k]), k


def test_per_task_step_moves_batchnorm_once():
    tr, x, y = _port("pcg", dnn_use_bn=True)
    ids, dense = tr.pack_inputs(x)
    dmask, yy = tr._domain_mask_from(x), tr._prepare_y(y)
    batch = [torch.from_numpy(a[:BATCH]) for a in (ids, dense, yy, dmask)] + [torch.ones(BATCH)]
    once = get_model("pcg", tr.layout, tr.cfg, device="cpu")
    once.load_state_dict(tr.model.state_dict())
    once.train()
    with torch.no_grad():
        once(batch[0], batch[1], None)  # one training-mode forward
    K.reset_launch_counts()
    tr.train_step(*batch)
    assert K.backward_counts["embed_concat"] == 2  # one backward per task
    params = {k for k, _ in tr.model.named_parameters()}
    stats = [k for k in tr.model.state_dict() if k not in params]
    assert stats
    for k in stats:
        assert torch.equal(tr.model.state_dict()[k], once.state_dict()[k]), k


@pytest.mark.parametrize("extra", [
    dict(use_loss_weights=True, loss_weights=[3.0, 0.5]),  # not read by a task's loss
    dict(use_cka_loss=True, masked_loss=True),  # no CKA term in a task's loss
])
def test_per_task_loss_has_no_loss_weights_and_no_cka(extra):
    base = {k: v for k, v in extra.items() if k == "masked_loss"}
    a, x, y = _port("pcg", **extra)
    b, *_ = _port("pcg", **base)
    for t in (a, b):
        t.fit(x, y, batch_size=BATCH, epochs=1, verbose=0)
    _same_fit(a, b)


def test_method_priority_gradnorm_then_cagrad_then_pcgrad():
    every = _port("pcg", use_gradnorm=True, use_cagrad=True)[0]
    assert every.per_task == "gradnorm"
    a, x, y = _port("pcg", use_cagrad=True)
    b, *_ = _port("mmoe", use_cagrad=True)
    assert a.per_task == b.per_task == "cagrad"
    assert _port("pcg")[0].per_task == "pcgrad" and _port("mmoe")[0].per_task is None
    for t in (a, b):
        t.fit(x, y, batch_size=BATCH, epochs=1, verbose=0)
    _same_fit(a, b)


@pytest.mark.parametrize("name,extra", [
    ("escm", dict(use_gradnorm=True)), ("escm_dr", dict(use_cagrad=True)),
    ("mmoe", dict(use_gradnorm=True, two_phase_embedding=True)),
    ("pcg", dict(sparse_embedding_update=True, two_phase_embedding=True)),
])
def test_per_task_refusals_are_the_jax_value_errors(name, extra):
    cfg = tsyn.make_config(**dict(KW, task_name="mtl", model_name=name, **extra))
    layout, *_ = tsyn.make_data(cfg, n=8, seed=0, vocab=KW["vocab"])
    match = "ESCM" if name.startswith("escm") else "per-task gradient methods"
    with pytest.raises(ValueError, match=match):
        Trainer(get_model(name, layout, cfg, device="cpu"), device="cpu")


def test_gradnorm_with_sparse_embedding_update_runs():
    """The merged table gradient feeds the table's SparseAdam (trainer.py:
    1074-1094)."""
    tr, x, y = _port("mmoe", use_gradnorm=True, sparse_embedding_update=True)
    tr.fit(x, y, batch_size=BATCH, epochs=1, verbose=0)
    assert int(tr.table_opt.count) == 4 and tr.table_opt.mu.any()
    assert "embeddings.fused.table" not in tr.opt_state.mu


@pytest.mark.parametrize("scan", [0, 16])
def test_gradnorm_resume_equals_the_uninterrupted_fit(scan, tmp_path):
    """Unshuffled, as tests/test_torch_checkpoints.py resumes: each fit draws
    its epoch orders from a fresh ``default_rng(seed)``, in JAX too."""
    full, x, y = _port("mmoe", use_gradnorm=True, scan_steps=scan, dnn_dropout=0.2)
    full.fit(x, y, batch_size=BATCH, epochs=3, shuffle=False, verbose=0)
    first, *_ = _port("mmoe", use_gradnorm=True, scan_steps=scan, dnn_dropout=0.2)
    first.fit(x, y, batch_size=BATCH, epochs=1, shuffle=False, verbose=0)
    path = first.save_training_state(str(tmp_path))
    resumed, *_ = _port("mmoe", use_gradnorm=True, scan_steps=scan, dnn_dropout=0.2)
    resumed.fit(x, y, batch_size=BATCH, epochs=3, shuffle=False, verbose=0,
                 resume_from=path)
    assert [h["loss"] for h in resumed.history] == [h["loss"] for h in full.history[1:]]
    sf = full.model.state_dict()
    for k, v in resumed.model.state_dict().items():
        assert torch.equal(v, sf[k]), k
    for k, v in full.gn_state.items():
        assert torch.equal(v, resumed.gn_state[k]), k
    assert int(full.gn_state["gn_step"]) == 12
    full.reset_for_seed(3)
    assert full.gn_state is None


@pytest.mark.parametrize("flags", [
    ["--run", "true", "--model_name", "pcg"],
    {"use_gradnorm": True}, {"use_cagrad": True}, {"use_cka_loss": True},
])
def test_cli_trains_the_per_task_methods_and_cka(flags, tmp_path, monkeypatch):
    """``python -m mmlrec_tpu_torch.main`` on the example msl config (MMoE,
    masked loss), one epoch: the row in the JAX schema."""
    from _torch_cli_common import cut_config, run_port

    monkeypatch.chdir(tmp_path)
    cfg = cut_config("configs/example_synthetic_msl.json", tmp_path)
    with open(cfg) as f:
        raw = json.load(f)
    extra = []
    if isinstance(flags, dict):
        raw["model_config"].update(flags)
    else:
        extra = flags
    with open(cfg, "w") as f:
        json.dump(raw, f)
    rows = run_port(cfg, *extra)
    model = "pcg" if extra else raw["model_config"]["model_name"]
    assert len(rows) == 1
    row = rows[0]
    assert list(row) == ["type", "log_loss_0", "auc_0", "log_loss_1", "auc_1", "total_auc",
                         "examples_per_s"]
    assert row["type"] == f"{raw['data_config']['data_name']}_msl_{model}_0"
    assert all(np.isfinite(v) for k, v in row.items() if k != "type")
    assert os.path.exists(raw["data_config"]["test_result_path"])
