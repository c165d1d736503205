"""Shared helpers of the port's two-phase route tests
(``test_torch_gather_route.py``, ``test_torch_slot_space.py``,
``test_torch_split_moments.py``; no tests of its own): a JAX trainer warmed up from numpy
weights, its whole state carried into a port trainer
(``convert.load_jax_train_state``), three further steps on both sides, and
the comparison at ``test_torch_two_phase_fit.py``'s tolerances: losses
rtol 1e-5, dense weights and the table atol 1e-6, moments 2^-7 relative
(one bf16 rounding flip of a lane a step, which an ulp of the gradient can
cause)."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import torch
from jax.flatten_util import ravel_pytree

from mmlrec_tpu import synthetic as jsyn
from mmlrec_tpu.models import get_model as jax_get_model
from mmlrec_tpu.train import Trainer as JaxTrainer
from mmlrec_tpu_torch import synthetic as tsyn
from mmlrec_tpu_torch.convert import load_jax_train_state
from mmlrec_tpu_torch.models import get_model
from mmlrec_tpu_torch.ops import kernels as K
from mmlrec_tpu_torch.train import Trainer
from mmlrec_tpu_torch.train.sparse_embedding import (
    SparseAdamFoldedState,
    SparseAdamPackedState,
    split_stacked_planes,
    unpack_monu_f32,
)

KW = dict(task_name="mtl", model_name="mmoe", n_sparse=4, n_dense=2, hidden=(16, 8),
          tower=(8,), gate=(8,), batch_size=64, lr=3e-3, two_phase_embedding=True)
N = 328
WARM = 160  # rows of the JAX side's warm-up fit
SLICES = ((160, 224, False), (224, 288, True), (288, 328, True))  # 3 steps, the last partial


def rows(x, a, b):
    return {k: v[a:b] for k, v in x.items()}


def bits(a) -> np.ndarray:
    """The bits of a numpy or torch array of a 4- or 2-byte dtype."""
    if isinstance(a, torch.Tensor):
        a = a.detach()
        return (a.view(torch.int32) if a.element_size() == 4 else a.view(torch.int16)).numpy()
    a = np.asarray(a)
    return a.view(np.int32) if a.itemsize == 4 else a.view(np.int16)


def torch_of(a) -> torch.Tensor:
    """A numpy or JAX array as a torch tensor of the same bits (bfloat16
    included)."""
    a = np.array(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def numpy_params(shapes, seed, fat=False):
    """Weights of every leaf from numpy; a stacked container's moment half
    starts at zero."""
    rng = np.random.default_rng(seed)
    std = {"table": 0.3, "bias": 0.1, "kernel": 0.3}

    def draw(path, a):
        x = rng.normal(0, std[path[-1].key], a.shape).astype(np.float32)
        if fat and path[-1].key == "table":
            x[a.shape[0] // 2:] = 0.0
        return x

    return jax.tree_util.tree_map_with_path(draw, shapes)


def jax_side(vocab, warm=True, **extra):
    """A JAX trainer of ``KW`` + ``extra`` at ``vocab`` from numpy weights,
    warmed up by one fit of the first WARM rows (its moments and Adam state
    then hold values), with its data."""
    cfg = jsyn.make_config(vocab=vocab, **{**KW, **extra})
    layout, x, y, _ = jsyn.make_data(cfg, n=N, seed=0, vocab=vocab)
    jtr = JaxTrainer(jax_get_model("mmoe", layout, cfg), seed=0).compile()
    ids, dense = jtr.pack_inputs(x)
    shapes = jax.eval_shape(
        lambda i, d: jtr.model.init(jax.random.PRNGKey(0), i, d, None, train=False),
        jnp.asarray(ids[:2]), jnp.asarray(dense[:2]))["params"]
    params = numpy_params(shapes, 1, fat=extra.get("table_container") == "stacked")
    jtr.variables = {"params": jax.tree_util.tree_map(jnp.asarray, params)}
    if warm:
        jtr.fit(rows(x, 0, WARM), y[:WARM], batch_size=64, epochs=1, verbose=0)
    return jtr, x, y


def state_of(jtr):
    """(params, table_opt, opt_state) of a two-phase JAX trainer as numpy,
    in ``load_jax_train_state``'s form."""
    params = jax.tree_util.tree_map(np.asarray, jtr.variables["params"])
    st = jtr._train_state
    adam = st["opt_state"][0]  # optax.flatten(adam): flat mu / nu vectors
    _, unravel = ravel_pytree(JaxTrainer._without_table(params)[0])
    opt_state = {"count": np.asarray(adam.count), "mu": unravel(adam.mu),
                 "nu": unravel(adam.nu)}
    topt = st["table_opt"]
    table_opt = {"count": np.asarray(topt.count)}
    for name in ("monu", "mu", "nu"):
        if hasattr(topt, name):
            table_opt[name] = np.asarray(getattr(topt, name))
    return params, table_opt, opt_state


def port_trainer(vocab, state, **extra):
    cfg = tsyn.make_config(vocab=vocab, **{**KW, **extra})
    layout, *_ = tsyn.make_data(cfg, n=8, seed=0, vocab=vocab)
    tr = Trainer(get_model("mmoe", layout, cfg, device="cpu"), seed=0, device="cpu").compile()
    return load_jax_train_state(tr, *state)


def table_and_moments(tr):
    """(table [Vp, W], mu, nu) of a port trainer, the moments as f32."""
    st = tr.table_opt
    if isinstance(st, SparseAdamFoldedState):
        table, monu = split_stacked_planes(tr.table.detach())
        return (table, *unpack_monu_f32(monu))
    if isinstance(st, SparseAdamPackedState):
        return (tr.table.detach(), *unpack_monu_f32(st.monu))
    return tr.table.detach(), st.mu.float(), st.nu.float()


def jax_table_and_moments(jtr):
    table = np.asarray(jtr.variables["params"]["embeddings"]["fused"]["table"])
    st = jtr._train_state["table_opt"]
    if hasattr(st, "monu"):
        monu = st.monu
    elif not hasattr(st, "mu"):  # folded: the container's bottom half
        Vp = table.shape[0] // 2
        table, monu = table[:Vp], table[Vp:]
    else:
        return torch_of(table), torch_of(st.mu).float(), torch_of(st.nu).float()
    return (torch.from_numpy(np.array(table)), *unpack_monu_f32(torch_of(monu)))


def fit_both_and_compare(jtr, tr, x, y, table_atol=1e-6):
    """The three SLICES steps on both trainers, one ``fit`` each; then the
    state held at the stated tolerances (the table at ``table_atol``)."""
    K.reset_launch_counts()
    for a, b, shuffle in SLICES:
        jtr.fit(rows(x, a, b), y[a:b], batch_size=64, epochs=1, verbose=0, shuffle=shuffle)
        tr.fit(rows(x, a, b), y[a:b], batch_size=64, epochs=1, verbose=0, shuffle=shuffle)
        np.testing.assert_allclose(tr.history[-1]["loss"], jtr.history[-1]["loss"], rtol=1e-5)
    assert sum(K.launch_counts.values()) == 0  # the CPU runs the plain versions
    want = {"/".join(str(p.key) for p in path): np.asarray(a)
            for path, a in jax.tree_util.tree_flatten_with_path(jtr.variables["params"])[0]}
    for k, p in tr.rest_params().items():  # the dense weights
        np.testing.assert_allclose(p.detach().numpy(), want[k.replace(".", "/")],
                                   rtol=0, atol=1e-6, err_msg=k)
    got, ref = table_and_moments(tr), jax_table_and_moments(jtr)
    np.testing.assert_allclose(got[0].numpy(), ref[0].numpy(), rtol=0, atol=table_atol)
    for a, b in zip(got[1:], ref[1:]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2.0 ** -7, atol=0)
    assert int(tr.table_opt.count) == int(jtr._train_state["table_opt"].count)
    np.testing.assert_allclose(tr.predict(rows(x, 0, 100), 64), jtr.predict(rows(x, 0, 100), 64),
                               rtol=0, atol=1e-6)


def jax_codec_view(update_space="position", table_update="pallas"):
    """The attributes both packages' ``meta_codec`` read, for a trainer of
    one device with the upload codec on."""
    return types.SimpleNamespace(
        cfg=types.SimpleNamespace(model_config=types.SimpleNamespace(extra={})),
        mesh=None, update_space=update_space, table_update=table_update)
