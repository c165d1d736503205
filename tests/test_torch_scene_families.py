"""The fits of the scene families (SNR-Trans, MSSM, STAR, APG, PEPNet)
against the JAX Trainer on the CPU, and their forwards from the shipped
configs that name them.

The fits follow tests/test_torch_family_fit.py: both sides start from one
numpy-made state and run the same two shuffled epochs of 168 rows at batch
64 (the last batch partial, padded) with validation and AUC; the families
with BatchNorm run SGD, where the gradient of a bias that feeds a BatchNorm
(zero in exact arithmetic) stays rounding noise.  Tolerances are that
file's: losses rtol 1e-5, every parameter and statistic atol 1e-6, metrics
atol 1e-5; the two-phase fits hold weights and table to 1% of an Adam step
(atol 1e-5), as its PLE case does.  STAR's DomainBatchNorm moves its
statistics T times per training forward, on both sides.

Stochastic gates draw u from the port's own generator, which cannot match
JAX's: the warmup epochs (midpoint gates) are held against the JAX fit, the
epochs after them by range and mean of u, finiteness and moving alphas.
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmlrec_tpu.config import ExperimentConfig as JaxConfig
from mmlrec_tpu.models import get_model as jax_get_model
from mmlrec_tpu.synthetic import make_data as jax_make_data
from mmlrec_tpu.train import Trainer as JaxTrainer
from mmlrec_tpu_torch.config import ExperimentConfig as TorchConfig
from mmlrec_tpu_torch.convert import load_jax_variables
from mmlrec_tpu_torch.models import get_model
from mmlrec_tpu_torch.ops import kernels as K
from mmlrec_tpu_torch.serving import ServingBundle, save_serving_bundle
from mmlrec_tpu_torch.synthetic import make_data
from mmlrec_tpu_torch.train.sparse_embedding import split_stacked_planes
from tests.test_torch_family_fit import (
    _assert_same_history,
    _assert_same_state,
    _both_sides,
    _flat,
    _rows,
)
from tests.test_torch_models import TOL, _jax_forward, numpy_variables

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIT_CASES = [  # family, regime, BatchNorm, optimizer, model_config
    ("snr_trans", "mtl", False, "adam", {}),
    ("mssm", "mtl", True, "sgd", {}),
    ("star", "msl", True, "sgd", dict(masked_loss=True)),
    ("apg", "msl", False, "adam", {}),
    ("pepnet", "msl", False, "adam", {}),
]
SHIPPED = ["configs/msl/config_IAAC.json", "configs/mtl/config_census.json",
           "configs/mtmsl/config_movielens.json", "configs/msl/config_amazon.json",
           "configs/mtmsl/config_amazon.json"]


def _assert_state(tr, jtr):
    """Every parameter within 1e-6 of the JAX trainer's, but for at most
    1e-3 of the entries, which stay within 1e-5 (1% of an Adam step): an
    entry whose gradient is a near-cancelling sum below Adam's eps keeps
    that sum's rounding in its step (PEPNet's gates have one such entry in
    2856).  Running statistics within 1e-6 + 1e-6 of their value: the
    variance ``E[x^2] - E[x]^2`` of a layer whose inputs have a mean of the
    order of their spread carries the rounding of E[x^2]."""
    want = {**_flat(jtr.variables["params"]), **_flat(jtr.variables.get("batch_stats", {}))}
    got = {k: v.detach().numpy() for k, v in tr.model.state_dict().items()}
    params = dict(tr.model.named_parameters())
    assert set(got) == set(want)
    over = total = 0
    for k in want:
        if k in params:
            diff = np.abs(got[k] - want[k])
            over, total = over + int((diff > 1e-6).sum()), total + diff.size
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5, err_msg=k)
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-6, err_msg=k)
    assert over <= 1e-3 * total, (over, total)


def _fit_both(jtr, tr, x, y, epochs=2):
    val = (_rows(x, 168, 268), y[168:268])
    for t in (jtr, tr):
        t.fit(_rows(x, 0, 168), y[:168], batch_size=64, epochs=epochs, validation_data=val,
              verbose=0)
    return val


@pytest.mark.parametrize("name,task,use_bn,optimizer,extra", FIT_CASES)
def test_scene_family_dense_fit_matches_jax(name, task, use_bn, optimizer, extra, tmp_path):
    jtr, tr, x, y = _both_sides(name, task, optimizer=optimizer, dnn_use_bn=use_bn, **extra)
    K.reset_launch_counts()
    val = _fit_both(jtr, tr, x, y)
    assert sum(K.launch_counts.values()) == 0  # the CPU runs the plain versions
    _assert_same_history(tr, jtr, 2)
    _assert_state(tr, jtr)
    stats = {k for k in tr.model.state_dict() if k.endswith(("mean", "var"))}
    if name == "star":  # one DomainBatchNorm, moved 2 x 6 times
        assert stats == {"domain_bn.pop_mean", "domain_bn.pop_var"}
        assert not np.allclose(tr.model.domain_bn.pop_var.numpy(), 1.0, atol=1e-3)
    assert bool(stats) == use_bn
    preds, jpreds = tr.predict(val[0], 64), jtr.predict(val[0], 64)
    np.testing.assert_allclose(preds, jpreds, rtol=0, atol=1e-6)
    # the bundle carries the best snapshot, DomainBatchNorm's statistics included
    save_serving_bundle(tr, str(tmp_path))
    bundle = ServingBundle.load(str(tmp_path), device="cpu")
    for k, v in bundle.model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), tr.best_variables[k].numpy(), err_msg=k)
    np.testing.assert_array_equal(bundle.predict(val[0], 64), preds)


@pytest.mark.parametrize("name,task,container,extra", [
    ("pepnet", "msl", "split", {}), ("apg", "msl", "stacked", {}),
    ("snr_trans", "mtl", "stacked", {}), ("mssm", "mtl", "split", {}),
    ("star", "msl", "stacked", dict(dnn_use_bn=True, masked_loss=True)),
])
def test_scene_family_two_phase_fit_matches_jax(name, task, container, extra):
    """The two-phase SparseAdam step with injected rows: the scene
    embedding the family reads (detached) comes from the injected rows;
    STAR's DomainBatchNorm sits behind an activation, so Adam holds it."""
    extra = dict(two_phase_embedding=True, table_update="pallas", table_opt_dtype="bfloat16",
                 device_metadata=True, table_container=container, **extra)
    jtr, tr, x, y = _both_sides(name, task, metrics=(), **extra)
    for t in (jtr, tr):
        t.fit(_rows(x, 0, 168), y[:168], batch_size=64, epochs=2, verbose=0)
    _assert_same_history(tr, jtr, 2)
    table_key = "embeddings.fused.table"
    _assert_same_state(tr, jtr, skip={table_key}, atol=1e-5)
    j_table = np.asarray(jtr.variables["params"]["embeddings"]["fused"]["table"])
    table = tr.table.detach()
    if container == "stacked":
        table = split_stacked_planes(table)[0]
    np.testing.assert_allclose(table.numpy(), j_table[: table.shape[0]], rtol=0, atol=1e-5)
    np.testing.assert_allclose(tr.predict(_rows(x, 168, 268), 64),
                               jtr.predict(_rows(x, 168, 268), 64), rtol=0, atol=1e-5)


def test_frozen_reference_parameters_take_no_step():
    """``ref_faithful_frozen_params``: MSSM's gate transforms and u, and
    STAR's specific tensors of domains 0..D-2, keep their values through a
    fit on both sides (Adam of a zero gradient is no step)."""
    for name, task in (("mssm", "mtl"), ("star", "msl")):
        jtr, tr, x, y = _both_sides(name, task, ref_faithful_frozen_params=True)
        before = {k: v.detach().clone() for k, v in tr.model.named_parameters()}
        for t in (jtr, tr):
            t.fit(_rows(x, 0, 168), y[:168], batch_size=64, epochs=1, verbose=0)
        _assert_same_state(tr, jtr)
        after = dict(tr.model.named_parameters())
        frozen = ([k for k in before if k.endswith((".trans", ".u"))] if name == "mssm"
                  else [k for k in before if ".specific_" in k])
        assert frozen
        for k in frozen:
            b, a = before[k], after[k].detach()
            if name == "star":  # the last domain trains
                b, a = b[:-1], a[:-1]
            assert torch.equal(a, b), k
        assert not all(torch.equal(before[k], after[k].detach()) for k in before)


def test_stochastic_gates_warm_up_as_the_jax_fit_then_draw():
    """``snr_stochastic_gates`` with ``snr_gate_noise_warmup_epochs: 2``:
    the two warmup epochs run the midpoint gate and match the JAX fit; a
    third epoch draws u in training (finite losses, a step away from the
    midpoint run, the gates' alphas moving)."""
    extra = dict(snr_stochastic_gates=True, snr_gate_alpha="per_connection",
                 snr_gate_noise_warmup_epochs=2)
    jtr, tr, x, y = _both_sides("snr_trans", "mtl", **extra)
    _fit_both(jtr, tr, x, y, epochs=2)
    _assert_same_history(tr, jtr, 2)
    _assert_same_state(tr, jtr)
    gates = [m for m in tr.model.modules() if hasattr(m, "noise_off")]
    assert len(gates) == 2 and all(g.noise_off for g in gates)
    # the port alone: the third epoch with noise, then again from the same
    # state at the midpoint
    state = copy.deepcopy((tr.model.state_dict(), tr.opt_state))
    alpha = tr.model.gate_1.alpha.detach().clone()
    tr.fit(_rows(x, 0, 168), y[:168], batch_size=64, epochs=3, initial_epoch=2, verbose=0)
    noisy = tr.history[-1]["loss"]
    assert not any(g.noise_off for g in gates) and np.isfinite(noisy)
    assert not torch.equal(alpha, tr.model.gate_1.alpha.detach())
    tr.model.load_state_dict(state[0])
    tr.opt_state, tr._gate_warmup_epochs = state[1], 3
    tr.fit(_rows(x, 0, 168), y[:168], batch_size=64, epochs=3, initial_epoch=2, verbose=0)
    assert all(g.noise_off for g in gates) and tr.history[-1]["loss"] != noisy


@pytest.mark.parametrize("path", SHIPPED)
def test_shipped_config_forward_matches_jax(path):
    """The shipped config's model (full widths) on a synthetic layout of its
    columns, random numpy weights, the mask where the regime has one."""
    full = os.path.join(ROOT, path)
    jcfg, tcfg = JaxConfig.from_file(full), TorchConfig.from_file(full)
    name = tcfg.model_config.model_name
    jl, x, _, mask = jax_make_data(jcfg, n=48, vocab=30, seed=0)
    tl, *_ = make_data(tcfg, n=48, vocab=30, seed=0)
    jmodel = jax_get_model(name, jl, jcfg)
    ids, dense = JaxTrainer(jmodel, seed=0).pack_inputs(x)
    dm = None if mask is None else jnp.ones((2, mask.shape[1]))
    shapes = jax.eval_shape(
        lambda i, d: jmodel.init(jax.random.PRNGKey(0), i, d, dm, train=False),
        jnp.asarray(ids[:2]), jnp.asarray(dense[:2]))
    variables = numpy_variables(shapes, seed=3)
    tmodel = load_jax_variables(get_model(name, tl, tcfg, device="cpu"), variables)
    want, state = _jax_forward(jmodel, variables, ids, dense, mask)
    with torch.inference_mode():
        got, inter = tmodel(torch.from_numpy(ids), torch.from_numpy(dense),
                            None if mask is None else torch.from_numpy(mask),
                            return_intermediates=True)
    assert got.shape == want.shape == (48, tcfg.num_tasks) and 0.01 < want.std()
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert set(inter) == set(state["intermediates"])
    assert bool(variables.get("batch_stats")) == (path == "configs/msl/config_amazon.json"
                                                  or path == "configs/mtl/config_census.json")
    if tcfg.model_config.dnn_use_bn:  # a training forward moves the same statistics
        want_tr, state = _jax_forward(jmodel, variables, ids, dense, mask, train=True)
        tmodel.train()
        with torch.no_grad():
            got_tr = tmodel(torch.from_numpy(ids), torch.from_numpy(dense),
                            None if mask is None else torch.from_numpy(mask))
        np.testing.assert_allclose(got_tr.numpy(), want_tr, **TOL)
        buffers = dict(tmodel.named_buffers())
        for k, v in _flat(state["batch_stats"]).items():
            np.testing.assert_allclose(buffers[k].numpy(), v, rtol=0, atol=1e-6, err_msg=k)
