"""Helpers of the data-parallel tests (tests/test_torch_parallel*.py): the
test-width setups, their numpy init, and the worker processes.

A test file spawns its gloo group once (``Group``): N processes of this
file, run as a script, join ``tcp://localhost:<port>``, run the file's
cases (the functions named ``case_*`` here) one after the other, and save
what each case returns as ``<out>/<case>_rank<r>.npz``.  The JAX side runs
in the pytest process meanwhile.  This module imports no JAX: it is what
the workers import.
"""

import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# the JAX sharding tests' flagship-shaped MMoE at test width
# (tests/test_sharding.py::_setup)
SIZES = dict(n_sparse=4, n_dense=2, hidden=(16, 8), tower=(8,), gate=(8,), batch_size=64,
             lr=3e-3)
ROWS = 512
SGD_LR = 0.005  # the BatchNorm cases (tests/test_torch_family_fit.py says why)


def numpy_params(model, seed=1):
    """Every parameter of ``model`` by name, from numpy: normal std 0.3, a
    bias 0.1, a BatchNorm scale / DomainBatchNorm gamma 1 + 0.1 n."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        draw = rng.normal(0, 0.1 if leaf in ("bias", "scale", "gamma") else 0.3, p.shape)
        out[name] = (draw + (1.0 if leaf in ("scale", "gamma") else 0.0)).astype(np.float32)
    return out


def port_setup(model_name="mmoe", task="mtl", mesh=None, optimizer="adam", metrics=None,
               n=ROWS, seed=0, **extra):
    """(trainer, x, y, dmask) of the port at test width on the CPU, from
    ``numpy_params``; ``mesh``: data parallel."""
    from mmlrec_tpu_torch.models import get_model
    from mmlrec_tpu_torch.synthetic import make_config, make_data
    from mmlrec_tpu_torch.train import Trainer

    cfg = make_config(task_name=task, model_name=model_name, **{**SIZES, **extra})
    layout, x, y, dmask = make_data(cfg, n=n, seed=seed)
    model = get_model(model_name, layout, cfg, device="cpu")
    with torch.no_grad():
        for name, a in numpy_params(model).items():
            model.get_parameter(name).copy_(torch.from_numpy(a))
    tr = Trainer(model, seed=0, mesh=mesh, device="cpu").compile(
        optimizer=optimizer, metrics=metrics if metrics is not None else [])
    return tr, x, y, dmask


def state_arrays(tr, prefix=""):
    """The trainer's parameters and buffers as numpy arrays by name."""
    return {prefix + k: v.detach().cpu().numpy().copy() for k, v in tr.model.state_dict().items()}


def fit_arrays(tr, x, y, batch=64, epochs=1, **kw):
    """Fit, then the state, the losses and the predictions as arrays."""
    tr.fit(x, y, batch_size=batch, epochs=epochs, verbose=0, shuffle=False, **kw)
    out = state_arrays(tr, "state/")
    out["losses"] = np.asarray([h["loss"] for h in tr.history])
    out["pred"] = tr.predict(x, batch)
    return out


# the JAX explicit-collective tests' shapes (tests/test_explicit_collectives.py,
# tests/test_mesh_stacked.py): the two-phase step, and the write-kernel
# update with packed bf16 moments in the split or the stacked container
TWO_PHASE = dict(two_phase_embedding=True)
EXPLICIT = dict(two_phase_embedding=True, explicit_collective_embedding=True)
PACKED = dict(EXPLICIT, table_update="pallas", table_opt_dtype="bfloat16", vocab=400)
STACKED = dict(PACKED, table_container="stacked", dedup_route="gather")


def sharded_setup(model_name="mmoe", task="mtl", mesh=None, n=ROWS, **extra):
    """``port_setup`` for the row-sharded table's cases: a stacked container
    is built shard-major over the mesh's ``model`` size (``stacked_shards``),
    its table the first Vp rows of the numpy draw and its moments zero, as a
    fresh container's are; ``mesh`` None is the one-process fit."""
    from mmlrec_tpu_torch.models import get_model
    from mmlrec_tpu_torch.parallel.mesh import model_size
    from mmlrec_tpu_torch.synthetic import make_config, make_data
    from mmlrec_tpu_torch.train import Trainer
    from mmlrec_tpu_torch.train.sparse_embedding import fold_stacked_planes, split_stacked_planes

    if extra.get("table_container") == "stacked" and mesh is not None:
        extra["stacked_shards"] = model_size(mesh)
    cfg = make_config(task_name=task, model_name=model_name, **{**SIZES, **extra})
    layout, x, y, dmask = make_data(cfg, n=n, seed=0, vocab=extra.get("vocab", 100))
    model = get_model(model_name, layout, cfg, device="cpu")
    with torch.no_grad():
        for name, a in numpy_params(model).items():
            model.get_parameter(name).copy_(torch.from_numpy(a))
        fused = model.embeddings.fused
        if fused.dual_container:  # the draw's first Vp rows are the table, in any layout
            plane = split_stacked_planes(fused.table, 1)[0].clone()
            fused.table.copy_(fold_stacked_planes(plane, torch.zeros_like(plane),
                                                  fused.dual_shards))
    tr = Trainer(model, seed=0, mesh=mesh, device="cpu").compile(metrics=[])
    return tr, x, y, dmask


def whole_state(tr, prefix="state/"):
    """``state_arrays`` with a row-sharded table gathered over ``model``
    (every rank calls it) and a stacked container cut to its table plane."""
    from mmlrec_tpu_torch.train import checkpointing

    out = {}
    for k, v in tr.model.state_dict().items():
        if k == "embeddings.fused.table":
            v = checkpointing._split_variables(tr, {k: v})[k]
        out[prefix + k] = v.detach().cpu().numpy().copy()
    return out


def sharded_fit(tr, x, y, batch=64, epochs=1, **kw):
    """``fit_arrays`` of a trainer whose table may be row-sharded, with
    GradNorm's state (``gn/``) where it has one."""
    tr.fit(x, y, batch_size=batch, epochs=epochs, verbose=0, shuffle=False, **kw)
    out = whole_state(tr)
    out["losses"] = np.asarray([h["loss"] for h in tr.history])
    out["pred"] = tr.predict(x, batch)
    if tr.gn_state is not None:
        out.update({f"gn/{k}": v.numpy().copy() for k, v in tr.gn_state.items()})
    return out


# ---------------------------------------------------------------------------
# spawning
# ---------------------------------------------------------------------------


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


class Group:
    """N worker processes running ``cases``; ``wait`` collects their output."""

    def __init__(self, world, cases, out_dir, timeout=240, env=None):
        self.world, self.cases, self.out = world, list(cases), Path(out_dir)
        self.timeout = timeout
        port = free_port()
        env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1", **(env or {}))
        self.logs = [open(self.out / f"rank{r}.log", "w+") for r in range(world)]
        self.procs = [
            subprocess.Popen([sys.executable, __file__, str(r), str(world), str(port),
                              str(self.out), ",".join(self.cases)],
                             stdout=self.logs[r], stderr=subprocess.STDOUT, env=env)
            for r in range(world)]

    def wait(self):
        """{case: [rank 0's arrays, rank 1's, ...]}; raises with the logs'
        tails when a worker failed or outlasted the timeout."""
        deadline = time.time() + self.timeout
        try:
            for p in self.procs:
                p.wait(timeout=max(deadline - time.time(), 1))
        except subprocess.TimeoutExpired:
            pass
        finally:
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        codes = [p.returncode for p in self.procs]
        if any(codes):
            tails = []
            for r, f in enumerate(self.logs):
                f.seek(0)
                tails.append(f"--- rank {r} (exit {codes[r]}):\n" + f.read()[-3000:])
            raise RuntimeError("a data-parallel worker failed\n" + "\n".join(tails))
        for f in self.logs:
            f.close()
        return {c: [dict(np.load(self.out / f"{c}_rank{r}.npz")) for r in range(self.world)]
                for c in self.cases}


# ---------------------------------------------------------------------------
# the cases (run in the workers)
# ---------------------------------------------------------------------------


def _mesh():
    from mmlrec_tpu_torch.parallel import create_mesh

    return create_mesh(data=dist.get_world_size(), device="cpu")


def case_mmoe_fit():
    """The flagship-shaped MMoE, one unshuffled epoch at batch 64: staged."""
    tr, x, y, _ = port_setup(mesh=_mesh())
    return fit_arrays(tr, x, y)


def case_mmoe_stream():
    """The same fit on the streaming path."""
    tr, x, y, _ = port_setup(mesh=_mesh())
    tr._device_data_bytes_cap = 0
    return fit_arrays(tr, x, y)


def case_indivisible():
    """A batch that does not divide by the ranks (62): it streams, every
    rank computing the whole batch."""
    from mmlrec_tpu_torch.train import staging

    streamed = []
    run = staging.StreamSource.run
    staging.StreamSource.run = lambda *a, **k: streamed.append(1) or run(*a, **k)
    try:
        tr, x, y, _ = port_setup(mesh=_mesh())
        out = fit_arrays(tr, x, y, batch=62)
    finally:
        staging.StreamSource.run = run
    out["streamed_epochs"] = np.asarray(len(streamed))
    return out


def case_bn_mmoe():
    """MMoE with BatchNorm, 3 steps of 64 under SGD."""
    tr, x, y, _ = port_setup(mesh=_mesh(), optimizer="sgd", n=192, dnn_use_bn=True,
                             lr=SGD_LR)
    return fit_arrays(tr, x, y)


def case_bn_star():
    """STAR with DomainBatchNorm (msl, the mask reaching the model), 3 steps
    of 64 under SGD."""
    tr, x, y, _ = port_setup("star", "msl", mesh=_mesh(), optimizer="sgd", n=192,
                             dnn_use_bn=True, masked_loss=True, lr=SGD_LR)
    return fit_arrays(tr, x, y)


def case_sparse_update():
    """MMoE with sparse_embedding_update: the table's rows take SparseAdam
    at the rows the global batch touched."""
    tr, x, y, _ = port_setup(mesh=_mesh(), sparse_embedding_update=True)
    return fit_arrays(tr, x, y)


def case_dropout_fit():
    """MMoE with dropout 0.3, one epoch."""
    tr, x, y, _ = port_setup(mesh=_mesh(), dnn_dropout=0.3)
    return fit_arrays(tr, x, y)


def case_eval():
    """msl MMoE with validation, 2 epochs, host and device metrics; its
    evaluate; the training state and the checkpoint written by rank 0."""
    out = {}
    for device_eval in (False, True):
        tr, x, y, _ = port_setup(task="msl", mesh=_mesh(), metrics=["auc"])
        tr.cfg.training_config.extra["device_eval"] = device_eval
        tr.fit(x, y, batch_size=64, epochs=2, validation_data=(x, y), verbose=0, shuffle=False)
        assert tr._use_device_eval() == device_eval
        tag = "device" if device_eval else "host"
        out[f"val_auc_{tag}"] = np.asarray([h["val_auc"] for h in tr.history])
    out["pred"] = tr.predict(x, 64)
    out["pred_32"] = tr.predict(x, 32)
    out["evaluate_auc"] = np.asarray(tr.evaluate(x, y, 64)["auc"])
    out.update(state_arrays(tr, "state/"))
    ckpt = os.environ["DP_CKPT"]
    out["state_dir"] = np.asarray(tr.save_training_state(ckpt))
    out["ckpt_dir"] = np.asarray(tr.save_checkpoint(ckpt))
    out["ckpt_exists"] = np.asarray(os.path.exists(os.path.join(str(out["ckpt_dir"]),
                                                                "variables.pt")))
    return out


def case_escm():
    """ESCM, whose entire-space loss is no sum over rows, one epoch."""
    tr, x, y, _ = port_setup("escm", mesh=_mesh())
    return fit_arrays(tr, x, y)


def case_local_step():
    """Part 3's helpers: each process feeds its local rows of one global
    batch of 64 through host_local_batch_to_global and takes one step."""
    from mmlrec_tpu_torch.parallel.multihost import host_local_batch_to_global, local_batch_size

    mesh = _mesh()
    tr, x, y, _ = port_setup(mesh=mesh)
    ids, dense = tr.pack_inputs(x)
    y2 = tr._prepare_y(y)
    b = local_batch_size(64)
    r = dist.get_rank()
    rows = slice(r * b, (r + 1) * b)
    batch = host_local_batch_to_global(
        (ids[rows], dense[rows], y2[rows], None, np.ones(b, np.float32)), mesh, device="cpu",
        global_batch_size=64)
    total, _, probs = tr.train_step(*batch)
    out = state_arrays(tr, "state/")
    out["loss"] = total.numpy()
    out["probs"] = probs.numpy()
    try:
        host_local_batch_to_global((ids[:b + r],), mesh, device="cpu")
    except ValueError as e:
        out["unequal_error"] = np.asarray(str(e))
    return out


def case_take():
    """distributed_take through the staging functions: an int id column and
    f32 columns (NaN, -0.0 and a denormal among them) of 37 rows, 9 ids a
    rank; and shard_batch on batches that divide and do not."""
    from types import SimpleNamespace

    from mmlrec_tpu_torch.parallel import shard_batch
    from mmlrec_tpu_torch.parallel.mesh import data_group
    from mmlrec_tpu_torch.train import staging

    mesh = _mesh()
    dp = data_group(mesh)
    rng = np.random.default_rng(3)
    n = 37
    ids = rng.integers(0, 1 << 30, (n, 3)).astype(np.int32)
    dense = rng.normal(size=(n, 2)).astype(np.float32)
    dense[0, 0], dense[1, 1], dense[2, 0] = np.nan, -0.0, np.float32(1e-41)
    y = rng.random((n, 2)).astype(np.float32)
    dmask = (rng.random((n, 2)) < 0.5).astype(np.float32)
    tr = SimpleNamespace(_dp=dp, device=torch.device("cpu"))
    staged = staging.stage_dataset(tr, ids, dense, y, dmask)
    idx = rng.integers(0, n, 9 * dp.world)
    got = staging.fetch_staged_rows(tr, staged, torch.as_tensor(idx))
    out = {"idx": idx, "staged_rows": np.asarray(staged.rows.shape[0])}
    for name, t in zip(("ids", "dense", "y", "dmask"), got):
        out[name] = t.numpy()
    even = shard_batch((np.arange(8 * dp.world), None), mesh)
    odd = shard_batch((np.arange(8 * dp.world + 1),), mesh)
    out["even"], out["even_none"], out["odd"] = even[0], np.asarray(even[1] is None), odd[0]
    return out


def case_refusals():
    """create_mesh's shapes and errors, and the mesh combinations the JAX
    trainer refuses, with its ValueErrors."""
    from mmlrec_tpu_torch.parallel import create_mesh

    world = dist.get_world_size()
    out = {}
    mesh = create_mesh(data=world // 2, model=2, device="cpu")
    out["shape"] = np.asarray(mesh.shape)
    out["names"] = np.asarray(mesh.mesh_dim_names)
    out["default_shape"] = np.asarray(create_mesh(model=2, device="cpu").shape)
    stacked = dict(two_phase_embedding=True, table_update="pallas", table_opt_dtype="bfloat16",
                   table_container="stacked", vocab=400)
    for name, call in (("bad_product", lambda: create_mesh(data=world + 1, model=2,
                                                            device="cpu")),
                       ("model_2", lambda: port_setup(mesh=mesh, two_phase_embedding=True,
                                                      table_update="pallas")),
                       ("pcg", lambda: port_setup("escm", mesh=_mesh(), use_cagrad=True)),
                       ("gradnorm", lambda: port_setup(mesh=mesh, **stacked,
                                                       explicit_collective_embedding=True,
                                                       stacked_shards=1)),
                       ("cka", lambda: port_setup(mesh=mesh, **stacked)),
                       ("two_phase", lambda: port_setup(mesh=_mesh(), two_phase_embedding=True,
                                                        table_update="unique",
                                                        explicit_collective_embedding=True))):
        try:
            call()
            out[name] = np.asarray("no error")
        except (ValueError, NotImplementedError) as e:
            out[name] = np.asarray(f"{type(e).__name__}: {e}")
    return out


def _mesh_model(model=2):
    """A (world / model, model) mesh: the table row-sharded over ``model``."""
    from mmlrec_tpu_torch.parallel import create_mesh

    return create_mesh(data=dist.get_world_size() // model, model=model, device="cpu")


def _sharded_case(**extra):
    tr, x, y, _ = sharded_setup(mesh=_mesh_model(), **extra)
    return sharded_fit(tr, x, y)


def case_sh_explicit():
    """The explicit two-phase step (scatter update) on the mesh."""
    return _sharded_case(**EXPLICIT)


def case_sh_gspmd():
    """The two-phase step on the mesh without the explicit flag (JAX's
    GSPMD path): the same exchange with the plain sharded update."""
    return _sharded_case(**TWO_PHASE)


def case_sh_dense():
    """The dense-table fit with the table row-sharded (model 2)."""
    return _sharded_case()


L2 = dict(l2_reg_embedding=1e-2, l2_reg_dnn=1e-3)  # penalties a model rank must not repeat


def case_sh_explicit_l2():
    """The explicit step with both L2 penalties: the dense one on data rank
    0, the touched rows' one partitioned by each data rank's ``rep``."""
    return _sharded_case(**EXPLICIT, **L2)


def case_sh_dense_l2():
    """The dense model-2 fit with both L2 penalties: each shard's rows once."""
    return _sharded_case(**L2)


def case_sh_chunked():
    """The explicit step with the pipelined exchange (4 tiles)."""
    return _sharded_case(**EXPLICIT, grad_exchange_chunks=4)


def case_sh_stream():
    """The explicit step on the streaming path."""
    tr, x, y, _ = sharded_setup(mesh=_mesh_model(), **EXPLICIT)
    tr._device_data_bytes_cap = 0
    return sharded_fit(tr, x, y)


def case_sh_packed_gather():
    """The write-kernel update of packed moments, gather dedup route."""
    return _sharded_case(**PACKED, dedup_route="gather")


def case_sh_packed_scatter():
    """The same with the scatter dedup route."""
    return _sharded_case(**PACKED, dedup_route="scatter")


def case_sh_split_f32():
    """The write-kernel update of split f32 moments."""
    return _sharded_case(**dict(PACKED, table_opt_dtype="float32"))


def case_sh_devmeta():
    """The write-kernel update with the metadata built in the step from
    the gathered ids."""
    return _sharded_case(**PACKED, device_metadata=True)


def case_sh_stacked():
    """The stacked container, shard-major, position space."""
    return _sharded_case(**STACKED, update_space="position")


def case_sh_stacked_slot():
    """The stacked container, slot space."""
    return _sharded_case(**STACKED, update_space="slot")


def case_sh_stacked_ckpt():
    """The stacked fit, then its training state and checkpoint, written by
    rank 0 from the shards every rank gathers."""
    tr, x, y, _ = sharded_setup(mesh=_mesh_model(), **STACKED, update_space="position")
    out = sharded_fit(tr, x, y)
    ckpt = os.environ["DP_CKPT"]
    out["state_dir"] = np.asarray(tr.save_training_state(ckpt))
    out["ckpt_dir"] = np.asarray(tr.save_checkpoint(ckpt))
    return out


# the per-task methods, CKA and sparse_embedding_update with the table
# row-sharded: model config fields by case (tests/test_torch_parallel_sharded.py)
TASKS = {"sh_pcg_l2": dict(model_name="pcg", **L2), "sh_gradnorm": dict(use_gradnorm=True),
         "sh_cagrad": dict(use_cagrad=True), "sh_seu": dict(sparse_embedding_update=True),
         "sh_cka": dict(task="msl", use_cka_loss=True)}


def case_sh_pcg_l2():
    """PCGrad with both L2 penalties: the dense one on data rank 0, the row
    shard's on every rank."""
    return _sharded_case(**TASKS["sh_pcg_l2"])


def case_sh_gradnorm():
    return _sharded_case(**TASKS["sh_gradnorm"])


def case_sh_cagrad():
    return _sharded_case(**TASKS["sh_cagrad"])


def case_sh_seu():
    """sparse_embedding_update: each shard's rows take SparseAdam."""
    return _sharded_case(**TASKS["sh_seu"])


def case_sh_cka():
    """The msl CKA fit, its table row-sharded."""
    return _sharded_case(**TASKS["sh_cka"])


SEU_GRADNORM = dict(sparse_embedding_update=True, use_gradnorm=True)


def case_sh_seu_gradnorm_ckpt():
    """sparse_embedding_update with GradNorm, then the training state
    (the SparseAdam moment shards gathered) written by rank 0."""
    from mmlrec_tpu_torch.train import checkpointing

    tr, x, y, _ = sharded_setup(mesh=_mesh_model(), **SEU_GRADNORM)
    out = sharded_fit(tr, x, y)
    for m in ("mu", "nu"):
        out[f"table_opt/{m}"] = checkpointing._whole(tr, getattr(tr.table_opt, m)).numpy().copy()
    ckpt = os.path.join(os.environ["DP_CKPT"], "seu_gradnorm")  # beside sh_stacked_ckpt's
    out["state_dir"] = np.asarray(tr.save_training_state(ckpt))
    return out


def merge_inputs(rng_seed=5):
    """Two tasks' gradients of three tensors for the merges over a split
    gradient: ``table`` [8, 4] is row-split over two model ranks and task
    0's rows 4..7 are zero (the second shard sees none of that task), task
    1's ``b`` is zero (a tensor one task does not reach)."""
    rng = np.random.default_rng(rng_seed)
    grads = [{"a": rng.normal(size=(5, 3)), "table": rng.normal(size=(8, 4)),
              "b": rng.normal(size=(7,))} for _ in range(2)]
    grads[0]["table"][4:] = 0.0
    grads[1]["b"][:] = 0.0
    return [{k: torch.from_numpy(v.astype(np.float32)) for k, v in g.items()} for g in grads]


MERGE_GRADNORM = dict(weights=[1.3, 0.7], task_losses=[0.6, 0.4], initial_losses=[0.7, 0.5])


def merge_outputs(task_grads, **split):
    """PCGrad's and CAGrad's merges and GradNorm's update of ``task_grads``
    as arrays."""
    from mmlrec_tpu_torch.train.cagrad import cagrad_merge
    from mmlrec_tpu_torch.train.gradnorm import gradnorm_update
    from mmlrec_tpu_torch.train.pcgrad import pcgrad_merge

    out = {f"pcgrad/{k}": v.numpy() for k, v in pcgrad_merge(task_grads, **split).items()}
    out.update({f"cagrad/{k}": v.numpy() for k, v in cagrad_merge(task_grads, **split).items()})
    gn = {k: torch.tensor(v) for k, v in MERGE_GRADNORM.items()}
    new_w, norms = gradnorm_update(gn["weights"], gn["task_losses"], gn["initial_losses"],
                                   task_grads, **split)
    out.update({"gradnorm/weights": new_w.numpy(), "gradnorm/norms": norms.numpy()})
    return out


def case_sh_merges():
    """The three merges on this rank's half of ``table`` (``merge_inputs``)
    with the other tensors whole, over the mesh's model group."""
    from mmlrec_tpu_torch.parallel.mesh import table_shard

    shard = table_shard(_mesh_model())
    rows = slice(4 * shard.index, 4 * shard.index + 4)
    local = [{**g, "table": g["table"][rows]} for g in merge_inputs()]
    return merge_outputs(local, sharded=("table",), group=shard.group)


def case_sh_task_refusals():
    """What the JAX trainer refuses with the per-task methods stays refused
    with the table row-sharded: ESCM's entire-space loss and the two-phase
    step (trainer.py:190-198, 488-495), with its ValueErrors."""
    out = {}
    for name, kw in (("escm", dict(model_name="escm", use_gradnorm=True)),
                     ("two_phase", dict(model_name="pcg", **EXPLICIT))):
        try:
            sharded_setup(mesh=_mesh_model(), **kw)
            out[name] = np.asarray("no error")
        except ValueError as e:
            out[name] = np.asarray(f"ValueError: {e}")
    return out


def case_task_pcg():
    """PCGrad with both L2 penalties (``reg / T`` a task, counted once)."""
    tr, x, y, _ = port_setup("pcg", mesh=_mesh(), l2_reg_embedding=1e-3, l2_reg_dnn=1e-3)
    return fit_arrays(tr, x, y)


def case_task_gradnorm():
    tr, x, y, _ = port_setup(mesh=_mesh(), use_gradnorm=True)
    out = fit_arrays(tr, x, y)
    out.update({f"gn/{k}": v.numpy() for k, v in tr.gn_state.items()})
    out["state_dir"] = np.asarray(tr.save_training_state(os.environ["DP_CKPT"]))
    return out


def case_task_cagrad():
    tr, x, y, _ = port_setup(mesh=_mesh(), use_cagrad=True)
    return fit_arrays(tr, x, y)


def case_task_cka():
    tr, x, y, _ = port_setup(task="msl", mesh=_mesh(), use_cka_loss=True)
    return fit_arrays(tr, x, y)


def _worker(rank, world, port, out_dir, cases):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=world)
    try:
        for case in cases:
            arrays = globals()[f"case_{case}"]()
            np.savez(os.path.join(out_dir, f"{case}_rank{rank}.npz"), **arrays)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    import warnings

    warnings.simplefilter("ignore", FutureWarning)  # torch's renamed collectives
    r, n, p, out, names = sys.argv[1:6]
    _worker(int(r), int(n), int(p), out, names.split(","))
