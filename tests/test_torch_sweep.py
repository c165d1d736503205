"""The port's hyperparameter sweep (``mmlrec_tpu_torch.train.sweep``) on the
CPU: every case of tests/test_sweep.py against the port's own solo
``Trainer`` at each combination's seed and hyperparameters, plus one stacked
grid against the JAX ``GridSweepTrainer``.

As in tests/test_torch_seed_suite.py (whose module docstring says why),
the stacked grids start each member and its solo twin from numpy weights of
std 0.3; the sequential two-phase grid keeps the model's own init and is
held bitwise; against JAX the val AUC is held within one pair.
"""

import jax
import numpy as np
import pytest
import torch

from _torch_suite_common import SIZES, STD, numpy_init
from mmlrec_tpu import synthetic as jsyn
from mmlrec_tpu.models import get_model as jax_get_model
from mmlrec_tpu.train.sweep import GridSweepTrainer as JaxGrid
from mmlrec_tpu_torch.convert import load_jax_variables
from mmlrec_tpu_torch.models import get_model
from mmlrec_tpu_torch.synthetic import make_config, make_data
from mmlrec_tpu_torch.train import Trainer
from mmlrec_tpu_torch.train.optimizers import Adam, get_optimizer
from mmlrec_tpu_torch.train.sweep import GridSweepTrainer, injectable_optimizer
from mmlrec_tpu_torch.utils.seeding import make_generator


def _setup(model_name="mmoe", task_name="mtl", **kw):
    cfg = make_config(task_name=task_name, model_name=model_name, **SIZES, **kw)
    layout, x, y, _ = make_data(cfg, n=320, seed=0)
    _, xv, yv, _ = make_data(cfg, n=128, seed=9)
    return cfg, layout, x, y, xv, yv


def _sweep(cfg, layout, init=True, **kw):
    sweep = GridSweepTrainer(get_model("mmoe", layout, cfg, device="cpu"), device="cpu", **kw)
    if init and not sweep.sequential:
        for g, m in zip(sweep.grid, sweep.members):
            numpy_init(m, g["seed"])
    return sweep


def _solo(cfg, layout, seed, optimizer, init=True):
    model = get_model("mmoe", layout, cfg, generator=make_generator(seed, "cpu"), device="cpu")
    if init:
        numpy_init(model, seed)
    return Trainer(model, seed=seed, device="cpu").compile(optimizer=optimizer, metrics=["auc"])


@pytest.mark.parametrize("grid", [
    None,  # test_grid_matches_solo_trainers: seeds [0, 2] x lrs [1e-3, 1e-2]
    [{"seed": 0, "lr": 3e-3, "b1": 0.9}, {"seed": 0, "lr": 3e-3, "b1": 0.5}],
    # test_multi_hyperparam_grid_matches_solo
])
def test_grid_matches_solo_trainers(grid):
    cfg, layout, x, y, xv, yv = _setup()
    kw = dict(seeds=[0, 2], lrs=[1e-3, 1e-2]) if grid is None else dict(grid=grid)
    sweep = _sweep(cfg, layout, **kw).compile(metrics=["auc"])
    assert len(sweep.grid) == (4 if grid is None else 2)
    sweep.fit(x, y, batch_size=64, epochs=3, validation_data=(xv, yv), verbose=0)
    preds = sweep.predict(xv, batch_size=64)
    for i, g in enumerate(sweep.grid):
        solo = _solo(cfg, layout, g["seed"], Adam(g["lr"], b1=g.get("b1", 0.9)))
        solo.fit(x, y, batch_size=64, epochs=3, validation_data=(xv, yv), verbose=0)
        np.testing.assert_allclose(preds[i], solo.predict(xv, 64), atol=1e-6,
                                   err_msg=f"combo {g} diverges from solo run")
        for h_sweep, h_solo in zip(sweep.histories[i], solo.history):
            assert h_sweep["loss"] == pytest.approx(h_solo["loss"], rel=1e-5)
    if grid is not None:
        assert np.abs(preds[0] - preds[1]).max() > 1e-5  # b1 actually varied


def test_lrs_actually_differ_across_combos():
    cfg, layout, x, y, xv, yv = _setup()
    sweep = _sweep(cfg, layout, seeds=[0], lrs=[1e-5, 1e-2]).compile()
    sweep.fit(x, y, batch_size=64, epochs=2, verbose=0)
    p = sweep.predict(xv, batch_size=64)
    assert np.abs(p[0] - p[1]).max() > 1e-4  # same seed, 1000x lr apart


def test_results_summary_and_labels():
    cfg, layout, x, y, xv, yv = _setup()
    sweep = _sweep(cfg, layout, seeds=[0], lrs=[1e-3, 3e-3]).compile(metrics=["auc"])
    sweep.fit(x, y, batch_size=64, epochs=2, validation_data=(xv, yv), verbose=0)
    rows = sweep.results()
    assert len(rows) == 2
    for r in rows:
        assert 0.0 < r["best_val_auc"] <= 1.0
        assert r["epochs"] == 2
    assert sweep.labels == ["s0/lr0.001", "s0/lr0.003"]
    assert sweep.row_labels == ["0_lr0.001", "0_lr0.003"]


@pytest.mark.parametrize("name", ["adam", "adagrad", "sgd", "rmsprop"])
def test_injectable_matches_plain_optimizer(name):
    params = {"w": torch.ones(4), "b": torch.zeros(2)}
    grads = {"w": torch.full((4,), 0.5), "b": torch.full((2,), -1.0)}
    plain, inj = get_optimizer(name, 3e-3), injectable_optimizer(name, 3e-3)
    assert all(isinstance(v, torch.Tensor) for v in inj.k.values())
    p1 = {k: v.clone() for k, v in params.items()}
    p2 = {k: v.clone() for k, v in params.items()}
    s1, s2 = plain.init(p1), inj.init(p2)
    for _ in range(3):
        plain.step(p1, grads, s1)
        inj.step(p2, grads, s2)
    for k in params:
        np.testing.assert_allclose(p1[k].numpy(), p2[k].numpy(), atol=1e-7, err_msg=name)


@pytest.mark.parametrize("kw,err", [
    (dict(seeds=[0]), ValueError),  # test_grid_requires_lrs
    (dict(grid=[{"seed": 0, "lr": 1e-3, "initial_accumulator_value": 0.1}]), ValueError),
    (dict(grid=[{"seed": 0, "lr": 1e-3}, {"seed": 2}]), ValueError),  # a row misses lr
])
def test_grid_refusals(kw, err):
    cfg, layout, *_ = _setup()
    with pytest.raises(err):
        _sweep(cfg, layout, **kw)


def test_unknown_hyperparam_raises():
    cfg, layout, x, y, *_ = _setup()
    sweep = _sweep(cfg, layout, grid=[{"seed": 0, "lr": 1e-3, "nonsense": 1.0}]).compile()
    with pytest.raises(KeyError):
        sweep.fit(x, y, batch_size=64, epochs=1, verbose=0)


def test_sequential_grid_two_phase_matches_solo_bitwise():
    """Two-phase grids run sequential-shared grouped by lr; every
    combination is bitwise a solo fit at its (seed, lr)."""
    cfg, layout, x, y, xv, yv = _setup(two_phase_embedding=True)
    sweep = _sweep(cfg, layout, seeds=[0, 2], lrs=[1e-3, 1e-2]).compile(metrics=["auc"])
    assert sweep.sequential
    sweep.fit(x, y, batch_size=64, epochs=2, validation_data=(xv, yv), verbose=0)
    preds = sweep.predict(xv, batch_size=64)
    assert len(sweep.results()) == 4 and cfg.optim_config.lr == 1e-3
    for i, g in enumerate(sweep.grid):
        solo_cfg, *_ = _setup(two_phase_embedding=True, lr=g["lr"])
        solo = _solo(solo_cfg, layout, g["seed"], "adam", init=False)
        solo.fit(x, y, batch_size=64, epochs=2, validation_data=(xv, yv), verbose=0)
        assert np.array_equal(preds[i], solo.predict(xv, 64)), g
        assert [h["loss"] for h in sweep.histories[i]] == [h["loss"] for h in solo.history]


def test_sequential_grid_rejects_non_lr_hyperparams():
    cfg, layout, *_ = _setup(two_phase_embedding=True)
    with pytest.raises(NotImplementedError):
        _sweep(cfg, layout, grid=[{"seed": 0, "lr": 1e-3, "b1": 0.9}])


def test_stacked_grid_matches_jax_grid():
    """A (seed x lr) grid against the JAX GridSweepTrainer, each
    combination's init the JAX trainer's tree redrawn from numpy.  The lrs
    are at most tests/test_torch_dense_fit.py's 3e-3, the Adam step whose
    rounding its 1e-6 tolerance covers (the error grows with the step: at
    lr 1e-2 the predictions part by up to 1.6e-6)."""
    kw = dict(task_name="mtl", model_name="mmoe", **SIZES)
    jcfg = jsyn.make_config(**kw)
    layout, x, y, _ = jsyn.make_data(jcfg, n=320, seed=0)
    _, xv, yv, _ = jsyn.make_data(jcfg, n=128, seed=9)
    jgrid = JaxGrid(jax_get_model("mmoe", layout, jcfg), seeds=[0, 2], lrs=[1e-3, 3e-3])
    jgrid.compile(metrics=["auc"])
    ids, dense = jgrid.tr.pack_inputs(x)
    inits = []
    for g, jtr in zip(jgrid.grid, jgrid.trainers):
        rng = np.random.default_rng(g["seed"] + 100)
        tree = jax.tree_util.tree_map(
            lambda a: rng.normal(0, STD, a.shape).astype(np.float32),
            jax.tree_util.tree_map(np.asarray, jtr._init_variables(ids[:2], dense[:2])))
        inits.append(tree)
        jtr._init_variables = lambda i, d, t=tree: jax.tree_util.tree_map(jax.numpy.asarray, t)
    jgrid.fit(x, y, batch_size=64, epochs=2, validation_data=(xv, yv), verbose=0)
    jpreds = jgrid.predict(xv, batch_size=64)

    cfg = make_config(**kw)
    sweep = _sweep(cfg, make_data(cfg, n=8, seed=0)[0], init=False, seeds=[0, 2],
                   lrs=[1e-3, 3e-3]).compile(metrics=["auc"])
    for m, tree in zip(sweep.members, inits):
        load_jax_variables(m, tree)
    sweep.fit(x, y, batch_size=64, epochs=2, validation_data=(xv, yv), verbose=0)
    np.testing.assert_allclose(sweep.predict(xv, batch_size=64), jpreds, rtol=0, atol=1e-6)
    assert sweep.row_labels == jgrid.row_labels and sweep.labels == jgrid.labels
    for i in range(len(sweep.grid)):
        for h, jh in zip(sweep.histories[i], jgrid.histories[i]):
            assert h["loss"] == pytest.approx(jh["loss"], rel=1e-5)
