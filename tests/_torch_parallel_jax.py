"""The JAX side of the data-parallel tests (tests/test_torch_parallel*.py):
JAX's mesh fit from the port's numpy init, the port's single-process fits
of the workers' cases, and the comparisons (tolerances in
tests/test_torch_parallel_fit.py's docstring)."""

import jax
import jax.numpy as jnp
import numpy as np

from mmlrec_tpu import synthetic as jsyn
from mmlrec_tpu.models import get_model as jax_get_model
from mmlrec_tpu.parallel import create_mesh as jax_create_mesh
from mmlrec_tpu.parallel import shard_variables as jax_shard_variables
from mmlrec_tpu.train import Trainer as JaxTrainer
from tests._torch_parallel_common import ROWS, SGD_LR, SIZES, fit_arrays, numpy_params, port_setup


def _nest(flat):
    tree = {}
    for name, a in flat.items():
        *path, leaf = name.split(".")
        node = tree
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = jnp.asarray(a)
    return tree


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}.{k}" if prefix else k
        out.update(_flat(v, key) if isinstance(v, dict) else {key: np.asarray(v)})
    return out


def jax_mesh_fit(world, model_name="mmoe", task="mtl", optimizer="adam", n=ROWS, model=1,
                 **extra):
    """JAX's ``(world / model, model)`` mesh fit from the port's numpy init:
    (state by port name, GradNorm's state (``gn/``) where it has one,
    losses, predictions)."""
    port, *_ = port_setup(model_name, task, optimizer=optimizer, n=8, **extra)
    cfg = jsyn.make_config(task_name=task, model_name=model_name, **{**SIZES, **extra})
    layout, x, y, _ = jsyn.make_data(cfg, n=n, seed=0)
    mesh = jax_create_mesh(data=world // model, model=model, devices=jax.devices()[:world])
    jtr = JaxTrainer(jax_get_model(model_name, layout, cfg), seed=0, mesh=mesh).compile(
        optimizer=optimizer, metrics=[])
    ids, dense = jtr.pack_inputs(x)
    variables = dict(jtr._init_variables(ids[:2], dense[:2]))
    variables["params"] = _nest(numpy_params(port.model))
    jtr.variables = jax_shard_variables(variables, mesh)
    jtr.fit(x, y, batch_size=64, epochs=1, verbose=0, shuffle=False)
    v = jax.device_get(jtr.variables)
    state = {f"state/{k}": a for k, a in {**_flat(v["params"]),
                                           **_flat(v.get("batch_stats", {}))}.items()}
    st = jax.device_get(jtr._train_state)
    state.update({f"gn/{k}": np.asarray(st[k])
                  for k in ("task_weights", "initial_losses", "gn_step") if k in st})
    return dict(state, losses=np.asarray([h["loss"] for h in jtr.history]),
                pred=jtr.predict(x, batch_size=64))


def single_fit(case):
    """The port's single-process fit of a case."""
    kw = {"mmoe_fit": {}, "dropout_fit": dict(dnn_dropout=0.3), "escm": dict(model_name="escm"),
          "sparse_update": dict(sparse_embedding_update=True),
          "bn_mmoe": dict(optimizer="sgd", n=192, dnn_use_bn=True, lr=SGD_LR),
          "bn_star": dict(model_name="star", task="msl", optimizer="sgd", n=192,
                          dnn_use_bn=True, masked_loss=True, lr=SGD_LR)}[case]
    tr, x, y, _ = port_setup(**kw)
    return fit_arrays(tr, x, y)


def close(got, want, what):
    """Losses (GradNorm's first losses too) rtol 1e-5, every other value
    atol 1e-6."""
    assert set(got) == set(want), what
    for k in want:
        if k in ("losses", "gn/initial_losses"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=f"{what}: {k}")
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6, err_msg=f"{what}: {k}")


def ranks_equal(per_rank):
    """Every rank ends with the same bits (the replicated state)."""
    for other in per_rank[1:]:
        for k, a in per_rank[0].items():
            np.testing.assert_array_equal(other[k], a, err_msg=k)


def check_take(runs, world):
    """Each rank's rows of the global batch, every column bitwise (ids, f32
    columns with NaN, -0.0 and a denormal; the case_take data), the
    dataset's 37 rows staged ceil(37 / world) a rank; shard_batch splits a
    batch that divides and replicates one that does not."""
    rng = np.random.default_rng(3)
    n = 37
    ids = rng.integers(0, 1 << 30, (n, 3)).astype(np.int32)
    dense = rng.normal(size=(n, 2)).astype(np.float32)
    dense[0, 0], dense[1, 1], dense[2, 0] = np.nan, -0.0, np.float32(1e-41)
    y = rng.random((n, 2)).astype(np.float32)
    dmask = (rng.random((n, 2)) < 0.5).astype(np.float32)
    assert len(runs) == world
    for r, got in enumerate(runs):
        assert int(got["staged_rows"]) == -(-n // world)
        idx = got["idx"][r * 9:(r + 1) * 9]
        for name, whole in (("ids", ids), ("dense", dense), ("y", y), ("dmask", dmask)):
            np.testing.assert_array_equal(got[name].view(np.int32), whole[idx].view(np.int32),
                                          err_msg=name)
        np.testing.assert_array_equal(got["even"], np.arange(r * 8, (r + 1) * 8))
        assert bool(got["even_none"])
        np.testing.assert_array_equal(got["odd"], np.arange(8 * world + 1))
