"""The port's fits of the model families against the JAX Trainer on the CPU.

Both sides start cold from one numpy-made state (parameters and BatchNorm
statistics) and run the same ``fit``: two shuffled epochs of 168 rows at
batch 64 (three steps an epoch, the last of 40 rows, padded), validation,
AUC.  BatchNorm's batch statistics see the padded rows on both sides, as
the JAX step feeds them.

Tolerances, all from f32 products and sums that run in another order in
PyTorch than in XLA: per-epoch losses rtol 1e-5; every parameter and every
BatchNorm running statistic atol 1e-6 after the last step (an Adam step
moves a weight by at most lr = 1e-3, and a gradient that differs in its
last bits moves that step by ~1e-7 of it); metrics of equal-to-1e-6
predictions atol 1e-5; ``escm_loss`` rtol 1e-6.

A bias that feeds a BatchNorm has a gradient of exactly zero in exact
arithmetic (the layer subtracts the batch mean), so what either framework
computes for it is rounding noise, which Adam scales to steps of +-lr in
directions that differ between the two.  The model's output does not depend
on such a bias, but the layer's running mean follows it.  So the families
with BatchNorm are fitted with SGD (lr 0.005), where noise stays noise and
every parameter and statistic is held.  The cases that run Adam with
BatchNorm hold what that noise cannot reach: the losses and metrics of the
training-mode forwards, and every parameter and statistic but those biases
and running means; their eval-mode predictions (which read the running
means) are left out.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmlrec_tpu import synthetic as jsyn
from mmlrec_tpu.models import get_model as jax_get_model
from mmlrec_tpu.train import Trainer as JaxTrainer
from mmlrec_tpu.train.losses import escm_loss as jax_escm_loss
from mmlrec_tpu.train.losses import multitask_loss as jax_multitask_loss
from mmlrec_tpu_torch import synthetic as tsyn
from mmlrec_tpu_torch.convert import load_jax_train_state, load_jax_variables
from mmlrec_tpu_torch.models import get_model
from mmlrec_tpu_torch.ops import kernels as K
from mmlrec_tpu_torch.serving import ServingBundle, save_serving_bundle
from mmlrec_tpu_torch.train import Trainer
from mmlrec_tpu_torch.train.losses import escm_loss, multitask_loss
from mmlrec_tpu_torch.train.sparse_embedding import split_stacked_planes, unpack_monu_f32
from tests.test_torch_models import numpy_variables

KW = dict(n_sparse=4, n_dense=2, hidden=(16, 8), tower=(8,), gate=(8,), batch_size=64,
          lr=1e-3, vocab=400)
CASES = [  # family, regime, BatchNorm, optimizer
    ("mlp", "mtl", False, "adam"), ("sharedbottom", "msl", True, "sgd"),
    ("sharedbottom", "mtl", False, "adam"), ("esmm", "mtl", False, "adam"),
    ("escm", "mtl", False, "adam"), ("escm_dr", "mtl", True, "sgd"),
    ("hmoe", "mtl", False, "adam"), ("hmoe", "msl", False, "adam"),
    ("cross_stitch", "mtl", True, "sgd"), ("aitm", "mtl", False, "adam"),
    ("ple", "mtl", True, "sgd"), ("ple", "mtmsl", False, "adam"),
]
SGD_LR = 0.005


def _rows(x, a, b):
    return {k: v[a:b] for k, v in x.items()}


def _numpy_variables(shapes, seed, fat=False):
    """Weights from numpy, as tests/test_torch_models.py draws them
    (kernels and mixing matrices 1.5 / sqrt(fan_in), the table 0.3, biases
    0.1, BatchNorm scales around 1, running variances positive, gate
    parameters inside their clip bounds); a stacked container's moment half
    zero."""
    tree = numpy_variables(shapes, seed)
    if fat:
        table = tree["params"]["embeddings"]["fused"]["table"]
        table[table.shape[0] // 2:] = 0.0
    return tree


def _flat(tree):
    return {".".join(str(p.key) for p in path): np.asarray(a)
            for path, a in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _both_sides(name, task, metrics=("auc",), optimizer="adam", **extra):
    """(JAX trainer, port trainer, x, y) from one numpy state."""
    args = dict(KW, task_name=task, model_name=name, **extra)
    if optimizer == "sgd":
        args["lr"] = SGD_LR
    if task == "mtmsl":
        args["num_tasks"] = 4  # 2 tasks x 2 domains
    jcfg, tcfg = jsyn.make_config(**args), tsyn.make_config(**args)
    jl, x, y, _ = jsyn.make_data(jcfg, n=268, seed=0, vocab=KW["vocab"])
    tl, *_ = tsyn.make_data(tcfg, n=8, seed=0, vocab=KW["vocab"])
    jtr = JaxTrainer(jax_get_model(name, jl, jcfg), seed=0).compile(
        optimizer=optimizer, metrics=list(metrics))
    ids, dense = jtr.pack_inputs(x)
    dm = jnp.ones((2, 2), jnp.float32) if task != "mtl" else None
    shapes = jax.eval_shape(
        lambda i, d: jtr.model.init(jax.random.PRNGKey(0), i, d, dm, train=False),
        jnp.asarray(ids[:2]), jnp.asarray(dense[:2]))
    variables = _numpy_variables(shapes, seed=1,
                                 fat=extra.get("table_container") == "stacked")
    jtr.variables = jax.tree_util.tree_map(jnp.asarray, variables)
    tr = Trainer(get_model(name, tl, tcfg, device="cpu"), seed=0, device="cpu").compile(
        optimizer=optimizer, metrics=list(metrics))
    load_jax_variables(tr.model, variables)
    return jtr, tr, x, y


def _noise_driven(model):
    """The biases that feed a BatchNorm and that layer's running mean."""
    keys = set()
    for k in model.state_dict():
        if k.endswith(".mean"):
            layer = k.rsplit(".", 2)[0] + ".dense_" + k.rsplit(".", 2)[1].removeprefix("bn_")
            keys |= {k, layer + ".bias"}
    return keys


def _assert_same_state(tr, jtr, skip=(), atol=1e-6):
    want = {**_flat(jtr.variables["params"]), **_flat(jtr.variables.get("batch_stats", {}))}
    got = {k: v.detach().numpy() for k, v in tr.model.state_dict().items()}
    assert set(got) == set(want)
    for k in want:
        if k not in skip:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=atol, err_msg=k)


def _assert_same_history(tr, jtr, n_epochs):
    assert len(tr.history) == len(jtr.history) == n_epochs
    for got, want in zip(tr.history, jtr.history):
        assert set(got) == set(want)
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
        for k in want:
            if k not in ("loss", "epoch_s"):
                np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("name,task,use_bn,optimizer", CASES)
def test_family_dense_fit_matches_jax(name, task, use_bn, optimizer, tmp_path):
    jtr, tr, x, y = _both_sides(name, task, optimizer=optimizer, dnn_use_bn=use_bn)
    skip = ()
    val = (_rows(x, 168, 268), y[168:268])
    K.reset_launch_counts()
    for t in (jtr, tr):
        t.fit(_rows(x, 0, 168), y[:168], batch_size=64, epochs=2, validation_data=val, verbose=0)
    assert sum(K.launch_counts.values()) == 0  # the CPU runs the plain versions
    _assert_same_history(tr, jtr, 2)
    assert {"loss", "auc", "val_auc"} <= set(tr.history[-1])
    _assert_same_state(tr, jtr, skip)
    stats = [k for k in tr.model.state_dict() if k.endswith((".mean", ".var"))]
    assert bool(stats) == (use_bn and name != "mlp")
    if optimizer == "adam":
        assert int(tr.opt_state.count) == 6

    # predict and evaluate read the best epoch's snapshot, BatchNorm statistics included
    assert tr.best_variables is not None and set(tr.best_variables) == set(tr.model.state_dict())
    want = _flat(jtr.best_variables["params"]) | _flat(jtr.best_variables.get("batch_stats", {}))
    for k, v in tr.best_variables.items():
        if k not in skip:
            np.testing.assert_allclose(v.numpy(), want[k], rtol=0, atol=1e-6, err_msg=k)
    preds, jpreds = tr.predict(val[0], 64), jtr.predict(val[0], 64)
    assert preds.shape == jpreds.shape == (100, tr.num_tasks)  # escm keeps [pCTR, pCTCVR]
    np.testing.assert_allclose(preds, jpreds, rtol=0, atol=1e-6)
    ev, jev = tr.evaluate(*val, batch_size=64), jtr.evaluate(*val, batch_size=64)
    assert set(ev) == set(jev) == {"auc"}
    np.testing.assert_allclose(ev["auc"], jev["auc"], rtol=0, atol=1e-5)

    # the serving bundle carries the snapshot's buffers and gives the same answers
    meta = save_serving_bundle(tr, str(tmp_path))
    bundle = ServingBundle.load(str(tmp_path), device="cpu")
    assert meta["num_heads"] == tr.num_tasks and bundle.model.training is False
    for k, v in bundle.model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), tr.best_variables[k].numpy(), err_msg=k)
    np.testing.assert_array_equal(bundle.predict(val[0], 64), preds)


def test_batchnorm_under_adam_matches_jax_where_the_arithmetic_is_defined():
    """SharedBottom with BatchNorm under Adam: the training-mode losses and
    metrics, and every parameter and statistic except the biases that feed a
    BatchNorm and that layer's running mean (see the module docstring)."""
    jtr, tr, x, y = _both_sides("sharedbottom", "mtl", dnn_use_bn=True)
    skip = _noise_driven(tr.model)
    assert skip == {"bottom_dnn.dense_0.bias", "bottom_dnn.bn_0.mean", "bottom_dnn.dense_1.bias",
                    "bottom_dnn.bn_1.mean", "tower_dnn.dense_0.bias", "tower_dnn.bn_0.mean"}
    for t in (jtr, tr):
        t.fit(_rows(x, 0, 168), y[:168], batch_size=64, epochs=2, verbose=0)
    _assert_same_history(tr, jtr, 2)
    assert {"loss", "auc"} <= set(tr.history[-1])
    _assert_same_state(tr, jtr, skip)
    moved = tr.model.bottom_dnn.bn_0.var.numpy()
    assert int(tr.opt_state.count) == 6 and not np.allclose(moved, 1.0, atol=1e-2)


def test_batchnorm_state_carries_over_from_a_warm_jax_trainer():
    """``load_jax_train_state`` with ``batch_stats``: the JAX trainer fits an
    epoch first, its parameters, running statistics and Adam state move
    across, and both continue alike."""
    jtr, tr, x, y = _both_sides("sharedbottom", "mtl", optimizer="sgd", dnn_use_bn=True)
    jtr.fit(_rows(x, 0, 128), y[:128], batch_size=64, epochs=1, verbose=0)
    params = jax.tree_util.tree_map(np.asarray, jtr.variables["params"])
    stats = jax.tree_util.tree_map(np.asarray, jtr.variables["batch_stats"])
    opt_state = {}  # SGD keeps none
    load_jax_train_state(tr, params, None, opt_state, batch_stats=stats)
    np.testing.assert_array_equal(tr.model.bottom_dnn.bn_0.mean.numpy(),
                                  stats["bottom_dnn"]["bn_0"]["mean"])
    for t in (jtr, tr):
        t.fit(_rows(x, 128, 268), y[128:268], batch_size=64, epochs=1, verbose=0)
    np.testing.assert_allclose(tr.history[-1]["loss"], jtr.history[-1]["loss"], rtol=1e-5)
    _assert_same_state(tr, jtr)
    with pytest.raises(ValueError, match="batch_stats mismatch"):
        load_jax_train_state(tr, params, None, opt_state)  # the statistics left out


@pytest.mark.parametrize("use_bn", [False, True])
def test_ple_two_phase_fit_on_the_stacked_container_matches_jax(use_bn):
    """The two-phase SparseAdam step with injected rows through a family
    other than MMoE: PLE on the stacked container, two epochs with a partial
    last batch.  The step is Adam's, so with BatchNorm the noise-driven
    biases and running means, and the eval-mode predictions that read them,
    are left out (see the module docstring).  PLE has 59 tensors and two
    levels of gates: among its ~10,000 weights a few have a gradient that is
    a near-cancelling sum, whose last bits differ between the frameworks and
    which Adam (dividing by the root of a second moment that starts at
    zero) turns into a visible part of a step.  So weights and table are
    held to 1% of an Adam step (atol 1e-5), the losses to rtol 1e-5."""
    extra = dict(two_phase_embedding=True, table_update="pallas", table_opt_dtype="bfloat16",
                 device_metadata=True, table_container="stacked", dnn_use_bn=use_bn)
    jtr, tr, x, y = _both_sides("ple", "mtl", metrics=(), **extra)
    skip = _noise_driven(tr.model)
    assert bool(skip) == use_bn
    for t in (jtr, tr):
        t.fit(_rows(x, 0, 168), y[:168], batch_size=64, epochs=2, verbose=0)
    assert tr.pair_gather == jtr.pair_gather == "dual"
    _assert_same_history(tr, jtr, 2)
    table_key = "embeddings.fused.table"
    _assert_same_state(tr, jtr, skip=skip | {table_key}, atol=1e-5)
    table, monu = split_stacked_planes(tr.table.detach())
    j_table = np.asarray(jtr.variables["params"]["embeddings"]["fused"]["table"])
    Vp = table.shape[0]
    np.testing.assert_allclose(table.numpy(), j_table[:Vp], rtol=0, atol=1e-5)
    # one bf16 rounding flip of a moment lane per step: 2^-7 relative; a lane
    # 1e-4 below the largest holds a gradient sum that cancelled
    for a, b in zip(unpack_monu_f32(monu), unpack_monu_f32(torch.from_numpy(j_table[Vp:].copy()))):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2.0 ** -7,
                                   atol=1e-4 * float(b.abs().max()))
    assert int(tr.table_opt.count) == 6
    if not use_bn:
        np.testing.assert_allclose(tr.predict(_rows(x, 168, 268), 64),
                                   jtr.predict(_rows(x, 168, 268), 64), rtol=0, atol=1e-5)


@pytest.mark.parametrize("columns", [3, 4])
def test_escm_loss_matches_jax(columns):
    """A batch with zero-weight (padded) rows, against the JAX function;
    the gradient flows through the propensity on both sides."""
    rng = np.random.default_rng(columns)
    B = 48
    probs = rng.uniform(0.02, 0.98, (B, columns)).astype(np.float32)
    probs[:, 2] = probs[:, 0] * probs[:, 1]
    y = (rng.random((B, 2)) < 0.4).astype(np.float32)
    y[:, 1] *= y[:, 0]  # a conversion needs a click
    w = np.ones(B, np.float32)
    w[40:] = 0.0
    names = ["binary_crossentropy"] * 2
    want, want_grad = jax.value_and_grad(
        lambda p: jax_escm_loss(p, jnp.asarray(y), jnp.asarray(w), names))(jnp.asarray(probs))
    p = torch.from_numpy(probs).requires_grad_(True)
    got = escm_loss(p, torch.from_numpy(y), torch.from_numpy(w), names)
    (grad,) = torch.autograd.grad(got, p)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    np.testing.assert_allclose(grad.numpy(), np.asarray(want_grad), rtol=1e-5, atol=1e-6)
    assert not grad[40:].any() and grad[:40, 0].abs().min() > 0  # pads add nothing
    # the padded length cancels: the same loss without the pad rows
    short = escm_loss(p[:40], torch.from_numpy(y[:40]), torch.from_numpy(w[:40]), names)
    np.testing.assert_allclose(float(short), float(got), rtol=1e-6)
    # multitask_loss takes the branch by the model's name, over two label columns
    for model_name in ("escm", "escm_dr"):
        routed = multitask_loss(p, torch.from_numpy(y), torch.from_numpy(w), names, "mtl", 2,
                                model_name=model_name)
        routed_want = jax_multitask_loss(jnp.asarray(probs), jnp.asarray(y), jnp.asarray(w),
                                         names, "mtl", 2, model_name=model_name)
        np.testing.assert_allclose(float(routed), float(routed_want), rtol=1e-6)
        assert float(routed) == float(got)
