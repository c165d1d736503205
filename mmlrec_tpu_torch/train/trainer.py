"""Trainer of the port (``mmlrec_tpu/train/trainer.py``): the dense-table fit
and the two-phase SparseAdam step of production vocabularies, inside one
streaming ``fit`` with validation (on the host, or on the device with
``training_config.device_eval``), best snapshot, early stop, checkpoints
and resume, plus ``evaluate``, ``predict`` (with the named layer outputs
after ``update_save``) and the final test metrics on the device.

**The dense step** (``two_phase_embedding`` off; trainer.py:996-1107):
forward and loss (with the CKA term under ``use_cka_loss``), one
``torch.autograd.grad`` over all parameters, the fused table and the varlen
tables included (through the embed-concat kernel's plain backward), then
the compiled optimizer over all of them.  The per-task methods (``pcg``,
``use_gradnorm``, ``use_cagrad``) take one forward and one backward per
task instead, and merge the task gradients (``pcgrad.py``, ``gradnorm.py``,
``cagrad.py``) before the optimizer.

**The two-phase step** (trainer.py:797-962), on the model's device but for
host metadata:

1. dedup metadata of the batch's ids from one stable sort: in the step
   (``device_metadata``: ``device_step_metadata``) or on the host before
   it (``staging.step_metadata``: numpy or ``native/step_metadata.cpp``);
2. phase 1: the touched rows are gathered once, NOT differentiated: with
   the stacked container each (table, moment) row pair comes from one
   launch of the dual gather (``rows_gather_dual``);
3. phase 2: the loss forward and backward w.r.t. the dense parameters and
   the gathered rows, injected into the model (``rows=``);
4. SparseAdam of the touched rows and Adam of the dense parameters.  The
   table update is ``table_update``: "scatter" (``two_phase_sparse_adam``,
   rep-masked row adds into split moments), "unique" (row adds at the
   batch's distinct physical rows) or "pallas"
   (``two_phase_sparse_adam_unique``: one write launch per step, of
   (table, mu, nu) for split moments, of (table, monu) or the stacked pair
   for packed bf16 ones).  "auto" takes "pallas" on the card where the
   physical rows are 128 lanes wide, else "scatter"; at fit time an auto
   "pallas" whose table is not above the batch's padded id count falls back
   to "scatter" (``staging.resolve_table_update``).  With host metadata the
   packed update takes the gather dedup route (``dedup_route``), and on the
   stacked container slot space (``update_space``:
   ``two_phase_sparse_adam_slot``, phase 1 gathering each unique physical
   row's pair once) when the first batch shows 25% physical duplication.

No ``[V, D]`` gradient or moment exists there.  Neither step reads a device
value on the host (host metadata is built from the host's copy of the
ids), and every state either step carries (parameters, moments, counts,
BatchNorm statistics) is updated in place.

The dense step takes ``sparse_embedding_update``: the table leaves the
dense optimizer and its touched rows take SparseAdam from its dense
gradient (``sparse_adam_row_update``).

**The fit** takes the JAX package's default path (``train/staging.py``):
the dataset is staged on the device once when its bytes x 2 are under
4 GB, each step takes its batch there by a device step index, and
``scan_steps`` (unset = 16, ``true`` = the whole epoch, 0 = off) runs the
steps as replays of one captured CUDA graph (``train/graphs.py``); the
optimizer steps all dense tensors as one flat vector (``flat_optimizer``);
host metadata of the next epoch is built on a worker while the current
one runs; a larger dataset streams with a prefetch worker
(``prefetch_batches``).  Validation, ``predict``, ``evaluate`` and the
test metrics replay one captured forward per batch.  A fit synchronises
once per epoch, for the loss and the epoch's train metrics: their exact
counts on the device where they are bitwise the host's, else the collected
probabilities (``train/fit_loop.py``: the one epoch loop of every fit).

**Under a mesh** (``Trainer(mesh=parallel.create_mesh(data=N, model=M))``,
one process per rank on ``torch.distributed``) the fit runs data
parallel over ``data``: parameters and buffers are broadcast from rank 0
once; a batch
that divides by N is split, rank r taking rows ``[r B / N, (r + 1) B / N)``
(the staged dataset row-sharded and fetched by ``distributed_take``, the
streaming batches by ``shard_batch``), BatchNorm statistics and dropout
masks are the global batch's (``ops.layers.batch_shard``), and one
all-reduce SUM a step over the concatenated gradients (the flat optimizer's
order) and the loss makes the global step; the L2 penalty and ESCM's
entire-space loss, which is not a sum over rows, are counted once.  A batch
that does not divide is replicated: every rank computes all of it and the
all-reduce takes rank 0's gradients.  Eval rows are split the same way and
the probabilities all-gathered in order, so every rank holds the global
predictions and decides the same best epoch and early stop; rank 0 writes
the checkpoints.  With one rank every value equals the unsharded fit's.
The per-task methods stack each task's gradient and all-reduce the stack
before their non-linear merge (GradNorm's losses with it), and CKA sums
its Gram terms over the ranks before the normalisation; the penalty and
the CKA term count once.

With ``model = M > 1`` the fused table is row-sharded over ``model``
(``parallel/mesh.py``): the rank of model index m holds rows
``[m R / M, (m + 1) R / M)`` of the table, of its moments and of the
stacked container (shard-major, ``stacked_shards = M``).  The two-phase
step runs ``parallel/explicit_step.py`` on any mesh (the forward fetch's
all-reduce over ``model``, the dense gradients' over ``data``, the
exchange's all-gathers over ``data``, owner-local table updates); the
dense fit reads the table through ``owned_rows`` and builds the shard's
gradient owner-local from the data ranks' gathered ids and row
cotangents, its penalty counted once per row.  That gradient is global
already, so it stays out of the all-reduce over ``data``, in the plain
step and in the per-task methods' stack (each task's backward runs the
all-gather, in task order on every rank); the per-task merges sum the
shards' part of each dot product and norm over ``model``
(``pcgrad.py``), and ``sparse_embedding_update`` sets each shard's owned
rows (``parallel.shard_embedding.sharded_sparse_adam_row_update``).
Checkpoints gather the shards (the table, its moments, the dense
optimizer's state of it) over ``model``, so rank 0 writes what one process
would, and a serving bundle of such a trainer is the single-device bundle.
The mesh combinations the JAX trainer refuses raise its ValueErrors.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from ..config import ExperimentConfig
from ..models.base import RecModel
from ..ops.embedding import fused_table_geometry, pack_factor_for
from ..ops.layers import all_gather_rows, batch_shard
from ..ops.row_gather import rows_gather_dual
from ..parallel.mesh import data_group, model_size, shard_variables, table_shard
from . import checkpointing, device_metrics, fit_loop, staging
from .fit_loop import _EvalProgram
from .graphs import StepGraphs
from .cagrad import cagrad_merge
from .cka import cka_domain_loss, cka_domain_loss_sharded
from .gradnorm import gradnorm_update
from .losses import l2_regularization, multitask_loss, per_task_losses
from .metrics import get_metric_fns, regime_eval
from .optimizers import Adam, Flat, FlatTensors, _Elementwise, get_optimizer
from .pcgrad import pcgrad_merge
from .sparse_embedding import (
    MOMENT_DTYPES,
    SparseAdamFoldedState,
    device_step_metadata,
    init_sparse_adam,
    sparse_adam_row_update,
    two_phase_sparse_adam,
    two_phase_sparse_adam_slot,
    two_phase_sparse_adam_unique,
)

_TABLE = "embeddings.fused.table"
#: ``predict``, ``evaluate`` and the test metrics capture their forward from
#: this many batches on; fewer run eagerly, where a capture (a synchronise,
#: a garbage collection, a private memory pool) costs more than the replays
#: save (``chip_smoke.py`` phase 12 times both)
EVAL_GRAPH_MIN_BATCHES = 16


def stacked_auto_conditions(cfg, layout, batch_size, device="cuda", mesh=None) -> bool:
    """True iff the automatic stacked container applies at ``batch_size``
    (trainer.py:46-86): the two-phase step, the pallas update (auto or
    explicit) with packed bf16 moments, no mesh or an explicit-collective
    mesh whose ``model`` size divides the physical rows, 128-lane physical
    rows, the unique-metadata headroom and a card to run on."""
    mc = cfg.model_config
    if not (mc.extra.get("two_phase_embedding")
            and str(mc.extra.get("table_update", "auto")) in ("auto", "pallas")
            and str(mc.extra.get("table_opt_dtype") or "") == "bfloat16"):
        return False
    if bool(mc.extra.get("explicit_collective_embedding")) != (mesh is not None):
        return False
    geo = fused_table_geometry(layout)
    if geo is None:
        return False
    dim, P, phys_rows = geo
    if dim * P != 128:
        return False
    if mesh is not None and phys_rows % model_size(mesh):
        return False
    K = batch_size * len(layout.sparse_slots)
    if phys_rows <= -(-K // 256) * 256:
        return False
    return torch.device(device).type != "cpu"


def resolve_table_container(cfg, layout, device="cuda", mesh=None) -> None:
    """Opt into ``table_container="stacked"`` when the pallas update with
    packed moments will engage, BEFORE the model is built (trainer.py:89-130):
    the container fixes the table's shape.  Decided at the config's
    ``train_batch_size`` on ``device``; a ``table_container`` the config sets
    always wins.  The opt-in is marked (``_table_container_auto``): only it
    may be undone, when a fit's batch breaks the headroom before any step
    has run (``staging.resolve_table_update``).  On an explicit-collective
    ``mesh`` a stacked container (opted into, or set) is shard-major over
    the mesh's ``model`` size (``stacked_shards``).  Every shipped config
    keeps f32 moments and so the split container."""
    mc = cfg.model_config
    explicit_mesh = mesh is not None and mc.extra.get("explicit_collective_embedding")
    if mc.extra.get("table_container") is not None:
        if (mc.extra["table_container"] == "stacked" and explicit_mesh
                and mc.extra.get("stacked_shards") is None):
            mc.extra["stacked_shards"] = model_size(mesh)
        return
    if stacked_auto_conditions(cfg, layout, cfg.training_config.train_batch_size, device,
                               mesh):
        mc.extra["table_container"] = "stacked"
        mc.extra["_table_container_auto"] = True
        if mesh is not None:
            mc.extra["stacked_shards"] = model_size(mesh)


def get_mask(domain_values, mask_values, num_domains) -> np.ndarray:
    """[B] domain column -> one-hot [B, num_domains]
    (reference model/utils.py:639-645)."""
    dv = np.asarray(domain_values).reshape(-1, 1)
    mv = np.asarray(mask_values).reshape(1, -1)
    return (dv == mv).astype(np.float32)


def _grads(total: torch.Tensor, tensors: List[torch.Tensor],
           retain: bool = False) -> List[torch.Tensor]:
    """d total / d tensors, zeros for a tensor the loss does not reach (a
    parameter that a reference-faithful freeze detaches, a DomainBatchNorm
    that no mask reaches, another task's tower in a per-task backward), as
    jax.grad gives them; ``retain`` keeps the graph for another backward."""
    grads = torch.autograd.grad(total, tensors, allow_unused=True, retain_graph=retain)
    return [torch.zeros_like(t) if g is None else g for g, t in zip(grads, tensors)]


def _choice(mc, key: str, default: str, allowed: Tuple[str, ...]) -> str:
    value = str(mc.extra.get(key, default))
    if value not in allowed:
        raise ValueError(f"{key} must be {'|'.join(allowed)}, got {value!r}")
    return value


class Trainer:
    def __init__(
        self,
        model: RecModel,
        seed: int = 0,
        mesh=None,
        debug: bool = False,
        *,
        device: Union[str, torch.device, None] = None,
    ):
        """``device=None`` means the card, and raises when there is none;
        ``device="cpu"`` runs every kernel's plain version.  ``debug=True``
        (trainer.py:147-154) turns on ``torch.autograd.set_detect_anomaly``
        and checks every step's loss and probabilities on the host: either
        raises a FloatingPointError, as jax_debug_nans does; it runs every
        step and eval batch eagerly, as the JAX trainer turns donation off.

        ``mesh``: a ``parallel.create_mesh`` mesh: the fit runs data
        parallel over its ``data`` ranks, the fused table row-sharded over
        its ``model`` ranks (module docstring); this process's rank holds
        its model, and its row shard of the table, on ``device``."""
        self.debug = bool(debug)
        if self.debug:
            torch.autograd.set_detect_anomaly(True)
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "no CUDA device is available; pass device='cpu' to run the "
                    "plain versions of the kernels on the CPU")
            device = "cuda"
        self.device = torch.device(device)
        self.mesh = mesh
        #: this rank's view of the mesh's data dimension, or None
        self._dp = data_group(mesh) if mesh is not None else None
        #: whether the steps' batches are split over the ranks (else every
        #: rank computes the whole batch); the fit sets it from its batch
        self._dp_sharded = True
        #: the fused table's row shard this rank holds (``parallel.mesh.
        #: TableShard``) on a mesh, None without one
        self._table_shard = table_shard(mesh) if mesh is not None else None
        #: the step's loss as reported, where it is not the total it
        #: differentiates (the row shards' penalty, ``_loss_terms``)
        self._report_total: Optional[torch.Tensor] = None
        self.model = model.to(self.device)
        self.cfg: ExperimentConfig = model.cfg
        self.layout = model.layout
        self.seed = seed
        self.history: List[Dict[str, float]] = []
        #: per epoch, the metrics of each training batch (``batch_metric_curves``)
        self.batch_history: List[List[Dict[str, float]]] = []
        self.opt_state = None
        self.table_opt = None
        #: GradNorm's task weights, first losses and step (``reset_gradnorm``)
        self.gn_state: Optional[Dict[str, torch.Tensor]] = None
        #: the parameters and BatchNorm statistics of the last fit's best
        #: epoch by ``val_auc`` (owned copies, by state-dict key), or None:
        #: then the model's current state is the best there is.  ``predict``
        #: and ``evaluate`` read them.
        self.best_variables: Optional[Dict[str, torch.Tensor]] = None
        self.throughput_examples_per_s: Optional[float] = None
        #: CUDA-graph replays of the last fit's steps and validation batches
        self.graph_replays: Dict[str, int] = {"train": 0, "eval": 0}
        #: per epoch of the last fit, ``staging.TIMING_KEYS``: host seconds
        #: spent waiting for the epoch's indices and metadata (``prep_s``),
        #: building and uploading them wherever that ran (``meta_s``,
        #: ``upload_s``), issuing its steps, on the loss read that waits for
        #: the card, on its train metrics and its validation,
        #: ``metrics_device`` (1.0 where the train metrics were counted on
        #: the device), and the graphs it captured with their host seconds;
        #: on the card also ``steps_device_s``, the card's time between two
        #: events around the epoch's steps (their device time when the host
        #: keeps ahead of the card, else waits for the host included).  Each
        #: phase also opens a profiler span (``utils/spans.py``).
        self.fit_timing: List[Dict[str, float]] = []
        # (epochs done, best val_auc, epochs without a new best, best
        # snapshot) of the last fit, which save_training_state records
        self._progress = None
        self._save_layer_output = False
        # the seed of each step's draws (dropout masks, stochastic gates) is
        # drawn from this CPU generator, once per step, so the draws are a
        # function of (seed, step) and the state carries over from one fit()
        # to the next
        self._dropout_master = torch.Generator().manual_seed(seed + 1)
        self._dropout_gen = torch.Generator(device=self.device)
        self.model.set_dropout_generator(self._dropout_gen)
        # the fit's captured steps (staging.drive_steps); None between fits
        self._graphs: Optional[StepGraphs] = None
        self._meta_codec = "unset"
        # the gather route's monotone list width (staging.step_metadata)
        self._route_r_cap = 0
        # the side stream of the worker threads' uploads
        self._upload_stream = (torch.cuda.Stream(self.device) if self.device.type == "cuda"
                               else None)
        # gloo's collectives on CUDA tensors synchronise with the host, which
        # a captured graph cannot hold: such a mesh runs eager steps
        self._capturable = not (self._dp is not None and self.device.type == "cuda"
                                and dist.get_backend(self._dp.group) == "gloo")

        mc = self.cfg.model_config
        self.task_name = mc.task_name
        self.num_tasks = self.cfg.num_tasks
        self.num_domains = self.cfg.data_config.num_domains
        self.model_name = mc.model_name
        # ESCM emits [pCTR, pCVR, pCTCVR(, pIMP)] against two label columns:
        # metrics and predictions keep [pCTR, pCTCVR] (reference
        # basemodel.py:438-441)
        self._escm = self.model_name in ("escm", "escm_dr")
        self._reg_dnn_prefixes = (
            None if mc.extra.get("l2_reg_inclusion") == "all_kernels"
            else model.REG_DNN_PREFIXES
        )
        self._resolve_knobs()
        if mesh is not None:
            self._place_on_mesh()

    def _place_on_mesh(self) -> None:
        """Broadcast the variables from rank 0 and, with ``model > 1``, keep
        this rank's row shard of the fused table as the parameter
        (``shard_variables``); the embedding then reads it through
        ``owned_rows``."""
        state = self.model.state_dict()
        placed = shard_variables(state, self.mesh)
        fused = self.model.embeddings.fused if hasattr(self.model, "embeddings") else None
        if fused is None or placed.get(_TABLE) is state.get(_TABLE):  # replicated
            self._table_shard = self._table_shard._replace(index=0, count=1, group=None)
            return
        fused.table = torch.nn.Parameter(placed[_TABLE], requires_grad=fused.table.requires_grad)
        fused.shard = self._table_shard

    def _table_sharded(self) -> bool:
        """Whether this rank holds a row shard of the table (model > 1)."""
        return self._table_shard is not None and self._table_shard.count > 1

    # ------------------------------------------------------------------
    # knob resolution (trainer.py:205-486)
    # ------------------------------------------------------------------
    def _resolve_knobs(self) -> None:
        mc = self.cfg.model_config
        extra = mc.extra
        # the per-task gradient methods of the dense step, by the JAX
        # trainer's priority (trainer.py:1005-1066): GradNorm, CAGrad, PCGrad
        self.per_task = ("gradnorm" if extra.get("use_gradnorm")
                         else "cagrad" if extra.get("use_cagrad")
                         else "pcgrad" if self.model_name == "pcg" else None)
        self.two_phase_embedding = bool(extra.get("two_phase_embedding"))
        if self.per_task and self._escm:
            raise ValueError(
                "per-task gradient methods (pcg/gradnorm/cagrad) are not defined for ESCM's "
                "entire-space objective")
        if self.per_task and self.two_phase_embedding:
            raise ValueError(
                "two_phase_embedding is incompatible with per-task gradient methods (they "
                "need whole-param task gradients)")
        # the fit's host loop (trainer.py:505-522): the streaming prefetch
        # depth (1 = synchronous), the staging cap (datasets whose bytes x 2
        # are below it are staged on the device), and scan_steps: unset =
        # 16 steps a chunk, true = the whole epoch, 0 = eager steps
        self._prefetch_batches = int(extra.get("prefetch_batches", 2))
        self._device_data_bytes_cap = 4 * 1024**3
        raw_scan = extra.get("scan_steps", None)
        self._scan_steps = 16 if raw_scan is None else (
            -1 if raw_scan is True else int(raw_scan or 0))
        # the first E epochs train stochastic gates at their midpoint
        # (mmlrec_tpu/train/trainer.py:523-533); a separate captured step
        self._gate_warmup_epochs = int(extra.get("snr_gate_noise_warmup_epochs", 0) or 0)
        self._gate_warmup_active = False
        # two_phase_embedding supersedes sparse_embedding_update (trainer.py:200-236)
        self.sparse_embedding_update = (bool(extra.get("sparse_embedding_update"))
                                        and not self.two_phase_embedding)
        self._moment_dtype = str(extra.get("table_opt_dtype") or "float32")
        if self._moment_dtype not in MOMENT_DTYPES:
            raise ValueError(f"table_opt_dtype must be {'|'.join(MOMENT_DTYPES)}, got "
                             f"{self._moment_dtype!r}")
        self._packed_moments = False
        self.table_container = "split"
        fused = self.model.embeddings.fused
        if self.two_phase_embedding or self.sparse_embedding_update:
            flag = "two_phase_embedding" if self.two_phase_embedding else "sparse_embedding_update"
            sparse_dims = {int(s.feature.embedding_dim) for s in self.layout.sparse_slots}
            if len(sparse_dims) != 1 or self.layout.varlen_slots:
                raise ValueError(
                    f"{flag} requires the fused embedding path (uniform dims, no varlen "
                    "features)")
            if self.cfg.optim_config.optimizer != "adam":
                raise ValueError(f"{flag} implements SparseAdam")
            vocabs = [s.feature.vocabulary_size for s in self.layout.sparse_slots]
            self._emb_dim = sparse_dims.pop()
            self._emb_pack_factor = pack_factor_for(int(sum(vocabs)), self._emb_dim)
            self._host_offsets = np.concatenate([[0], np.cumsum(vocabs)[:-1]]).astype(np.int64)
            self._fused_offsets = torch.as_tensor(self._host_offsets.astype(np.int32),
                                                  device=self.device)
        self.table_update = _choice(mc, "table_update", "auto",
                                    ("auto", "scatter", "unique", "pallas"))
        self._table_update_auto = self.table_update == "auto"
        if self._table_update_auto:
            self.table_update = (
                "pallas"
                if (self.two_phase_embedding and self.mesh is None
                    and self._emb_dim * self._emb_pack_factor == 128
                    and self._moment_dtype in ("float32", "bfloat16")
                    and self.device.type == "cuda")
                else "scatter"
            )
        explicit = bool(extra.get("explicit_collective_embedding"))
        # the pipelined exchange of the explicit mesh step (explicit_step.py:84-92)
        self._exchange_chunks = int(extra.get("grad_exchange_chunks", 1) or 1) if explicit else 1
        n_model = model_size(self.mesh) if self.mesh is not None else 1
        if not self.two_phase_embedding:
            # the dense-table fit reads none of the two-phase knobs
            if fused is not None and fused.dual_container:
                raise ValueError(
                    "table_container='stacked' folds the two-phase step's moments "
                    "into the table; the dense-table fit needs the split table")
            return
        if (self.mesh is not None and self.table_update != "scatter"
                and not (self.table_update == "pallas" and explicit)):
            raise ValueError(
                "table_update unique/pallas with a mesh requires the "
                "explicit_collective_embedding path (pallas only); the GSPMD mesh path keeps "
                "its own update")
        # bf16 moments ride the write kernel packed as (mu, nu) pairs in f32
        # lanes; f16 has no packed layout (trainer.py:302-321)
        self._packed_moments = self.table_update == "pallas" and self._moment_dtype == "bfloat16"
        if (self.table_update == "pallas" and self.device.type == "cuda"
                and self._moment_dtype == "float16"):
            raise ValueError(
                "table_update='pallas' supports float32 or bfloat16 moment storage, got "
                f"table_opt_dtype={self._moment_dtype!r}")
        # the gather dedup route: the slots' accumulation as one designated
        # contributor's gather plus the residuals (trainer.py:322-352)
        self.dedup_route = _choice(mc, "dedup_route", "auto", ("auto", "scatter", "gather"))
        packed_pallas = self.table_update == "pallas" and self._packed_moments
        if self.dedup_route == "auto":
            self.dedup_route = "gather" if packed_pallas else "scatter"
        elif self.dedup_route == "gather" and not packed_pallas:
            raise ValueError(
                "dedup_route='gather' requires table_update='pallas' with packed bf16 moments")
        self.monu_gather = _choice(mc, "monu_gather", "auto", ("auto", "xla", "pallas"))
        if self.monu_gather == "auto":
            self.monu_gather = "xla"
        self.table_container = _choice(mc, "table_container", "split", ("split", "stacked"))
        if fused.dual_container != (self.table_container == "stacked"):
            raise ValueError(
                f"the model was built with table_container="
                f"{'stacked' if fused.dual_container else 'split'}, the config "
                f"says {self.table_container!r}")
        if self.table_container == "stacked" and not self._packed_moments:
            raise ValueError(
                "table_container='stacked' requires table_update='pallas' with packed bf16 "
                f"moments (resolved: {self.table_update!r}, "
                f"table_opt_dtype={self._moment_dtype!r})")
        if self.table_container == "stacked" and self.mesh is not None:
            # the shard-major layout of a row-sharded table (trainer.py:384-411)
            if not explicit:
                raise ValueError(
                    "table_container='stacked' on a mesh requires the "
                    "explicit_collective_embedding path (GSPMD keeps the split layout)")
            if self._emb_phys_rows_static() % n_model:
                raise ValueError(
                    f"stacked container needs the physical row count "
                    f"({self._emb_phys_rows_static()}) divisible by the 'model' axis "
                    f"({n_model})")
            declared = int(extra.get("stacked_shards", 1) or 1)
            if declared != n_model:
                raise ValueError(
                    f"model was built with stacked_shards={declared} but the mesh 'model' "
                    f"axis is {n_model}; set model_config.extra['stacked_shards'] to the "
                    "mesh's 'model' size BEFORE building the model")
        self.pair_gather = _choice(mc, "pair_gather", "auto", ("auto", "split", "dual"))
        if self.pair_gather == "auto":
            self.pair_gather = "dual" if self.table_container == "stacked" else "split"
        elif self.pair_gather == "dual" and self.table_container != "stacked":
            raise ValueError("pair_gather='dual' requires table_container='stacked'")
        # slot space: the update's gather and Adam chain at the unique
        # physical slots; "auto" resolves from the first host metadata batch
        # (staging.resolve_update_space, trainer.py:431-455)
        self.update_space = _choice(mc, "update_space", "auto", ("auto", "position", "slot"))
        if self.update_space == "slot":
            if self.table_container != "stacked":
                raise ValueError("update_space='slot' requires table_container='stacked'")
            if self.dedup_route != "gather":
                raise ValueError(
                    "update_space='slot' requires dedup_route='gather' (the slot route "
                    "rides the accperm/resid metadata)")
        # in-step metadata on the device, or per batch on the host
        # (staging.step_metadata: numpy or native/step_metadata.cpp)
        self.device_metadata = bool(extra.get("device_metadata"))
        if self.device_metadata:
            if self.table_update == "unique":
                raise ValueError(
                    "device_metadata is incompatible with table_update='unique' (its "
                    "unique-indices scatter needs the host path's distinct pad rows)")
            if extra.get("dedup_route") == "gather":
                raise ValueError(
                    "device_metadata has no gather-route lists; drop dedup_route='gather' "
                    "(the in-step scatter is used)")
            if extra.get("update_space") == "slot":
                raise ValueError(
                    "device_metadata supports update_space='position' only (slot space "
                    "rides the route metadata)")
            self.dedup_route, self.update_space = "scatter", "position"
        self._emb_phys_rows = self._emb_phys_rows_static()

    def _emb_phys_rows_static(self) -> int:
        """Physical rows of the fused table (staging.py:119-129)."""
        total = int(sum(s.feature.vocabulary_size for s in self.layout.sparse_slots))
        rows = -(-max(total, 1) // 128) * 128
        P = self._emb_pack_factor
        if P > 1:
            rows = -(-rows // (P * 128)) * (P * 128)
        return rows // P

    # ------------------------------------------------------------------
    # compile
    # ------------------------------------------------------------------
    def compile(self, optimizer=None, loss=None, metrics=None):
        """Bind optimizer, loss and metrics (reference basemodel.py:557-567).
        ``optimizer``: a name, or an optimizer object of
        ``train/optimizers.py`` (trainer.py:544-546); the elementwise ones
        step as one flat vector when ``_use_flat_optimizer`` says so."""
        oc = self.cfg.optim_config
        opt = optimizer or oc.optimizer
        tx = get_optimizer(opt, oc.lr) if isinstance(opt, str) else opt
        if self.two_phase_embedding and not isinstance(tx, Adam):
            raise ValueError("two_phase_embedding implements SparseAdam")
        if self._use_flat_optimizer() and isinstance(tx, _Elementwise):
            tx = Flat(tx)
        self.tx = tx
        loss = loss if loss is not None else oc.loss
        self.loss_names = [loss] if isinstance(loss, str) else list(loss)
        self.metric_fns = get_metric_fns(metrics if metrics is not None else oc.metrics)
        return self

    def _use_flat_optimizer(self) -> bool:
        """trainer.py:561-580: off with
        ``flat_optimizer: false``; on for the two-phase step and
        ``sparse_embedding_update``, whose table is not the dense
        optimizer's (the JAX trainer keeps the latter per tensor, as its
        masked transform does not ravel: elementwise, the same bits); else on
        while the embedding tables hold under 2^22 elements (the flat vector
        would copy a larger table every step).  The JAX trainer turns it off
        under a mesh, where the table's row sharding must survive in the
        optimizer state; the port's mesh replicates every tensor, and the
        flat and per-tensor paths are bitwise equal, so the rule stays."""
        if not self.cfg.model_config.extra.get("flat_optimizer", True):
            return False
        if self.two_phase_embedding or self.sparse_embedding_update:
            return True
        return sum(v * d for v, d in self.layout.embedding_specs.values()) < (1 << 22)

    # ------------------------------------------------------------------
    # input packing (trainer.py:585-636)
    # ------------------------------------------------------------------
    def pack_inputs(self, x) -> Tuple[np.ndarray, np.ndarray]:
        """dict {feature_name: array} -> (ids [N,S] int32, dense [N,Dd]
        float32) in layout order: the sparse columns, then each varlen
        feature's [N, maxlen] ids and its length column if it has one."""
        if isinstance(x, tuple) and len(x) == 2:
            return np.asarray(x[0], np.int32), np.asarray(x[1], np.float32)
        n = None
        ids_parts: List[np.ndarray] = []
        for slot in self.layout.sparse_slots:
            col = np.asarray(x[slot.feature.name]).reshape(-1, 1)
            ids_parts.append(col.astype(np.int32))
            n = len(col)
        for slot in self.layout.varlen_slots:
            seq = np.asarray(x[slot.feature.name]).reshape(n if n else -1, -1)
            ids_parts.append(seq.astype(np.int32))
            if slot.feature.length_name is not None:
                ids_parts.append(np.asarray(x[slot.feature.length_name])
                                 .reshape(-1, 1).astype(np.int32))
        dense_parts = [
            np.asarray(x[slot.feature.name], np.float32).reshape(-1, slot.feature.dimension)
            for slot in self.layout.dense_slots
        ]
        ids = np.concatenate(ids_parts, axis=1) if ids_parts else np.zeros((n or 0, 0), np.int32)
        dense = (np.concatenate(dense_parts, axis=1) if dense_parts
                 else np.zeros((len(ids), 0), np.float32))
        return ids, dense

    def _domain_mask_from(self, x) -> Optional[np.ndarray]:
        dc = self.cfg.data_config
        if self.task_name in ("msl", "mtmsl") and dc.mask_column:
            if isinstance(x, dict) and dc.mask_column in x:
                return get_mask(np.asarray(x[dc.mask_column]), dc.mask_values, dc.num_domains)
        return None

    def _prepare_y(self, y) -> np.ndarray:
        y = np.asarray(y, np.float32)
        if y.ndim == 1:
            y = y.reshape(-1, 1)
        T = self.num_tasks
        if self._escm:
            return y  # [N, 2]: the ctr and the cvr label
        if y.shape[1] != T and T % y.shape[1] == 0:
            # each label column replicated across its domains (the
            # reference's duplicated label_columns layout)
            y = np.repeat(y, T // y.shape[1], axis=1)
        return y

    # ------------------------------------------------------------------
    # state (trainer.py:1429-1476)
    # ------------------------------------------------------------------
    @property
    def table(self) -> torch.nn.Parameter:
        return self.model.embeddings.fused.table

    def rest_params(self) -> Dict[str, torch.nn.Parameter]:
        """Every parameter but the fused table: the dense Adam's domain in
        the two-phase step."""
        return {k: p for k, p in self.model.named_parameters() if k != _TABLE}

    def reset_gradnorm(self) -> None:
        """GradNorm's state on the device (trainer.py:1450-1454): the task
        weights at one, the first step's losses (taken at ``gn_step`` 0)
        and the step.  Every fit() starts it anew, as the JAX fit rebuilds
        it, unless the fit resumes a saved state."""
        T, dev = self.num_tasks, self.device
        self.gn_state = {"task_weights": torch.ones((T,), device=dev),
                         "initial_losses": torch.ones((T,), device=dev),
                         "gn_step": torch.zeros((), dtype=torch.int32, device=dev)}

    def init_state(self) -> None:
        """Optimizer state, kept across fit() calls as the JAX trainer keeps
        its state.  Dense fit: the compiled optimizer over every parameter,
        the table's SparseAdam state instead of its moments there under
        ``sparse_embedding_update`` (trainer.py:1414-1425).  Two-phase: Adam
        over the rest params plus the table's SparseAdam state: the step
        counter alone for the stacked container (the moments live in its
        bottom half), a zero packed container for packed moments, else zero
        split moments of ``table_opt_dtype``."""
        if self.sparse_embedding_update or self.two_phase_embedding:
            if self.two_phase_embedding:
                self.table.requires_grad_(False)  # never differentiated: rows are injected
            self.opt_state = self.tx.init(self.rest_params())
        else:
            self.opt_state = self.tx.init(dict(self.model.named_parameters()))
            return
        if self.table_container == "stacked":
            self.table_opt = SparseAdamFoldedState(
                count=torch.zeros((), dtype=torch.int32, device=self.device))
        elif self._packed_moments:
            self.table_opt = init_sparse_adam(self.table, packed=True)
        else:
            self.table_opt = init_sparse_adam(self.table,
                                              dtype=MOMENT_DTYPES[self._moment_dtype])

    # ------------------------------------------------------------------
    # the dense step (trainer.py:668-715, 996-1107)
    # ------------------------------------------------------------------
    def _shard(self):
        """The data group when this step's batch is split over the ranks."""
        return self._dp if self._dp is not None and self._dp_sharded else None

    def _data_loss(self, probs, y, dmask, weight):
        mc = self.cfg.model_config
        dp = self._shard()
        if self._escm and dp is not None:
            # ESCM's entire-space loss is no sum over rows (its propensity
            # reads the batch's click count and a mean): every rank takes
            # it over the global batch, its cotangent flowing back to each
            # rank's rows only; rank 0 alone reports it (_train_step_dense)
            probs = all_gather_rows(probs, dp)
            yw = all_gather_rows(torch.cat([y, weight[:, None]], dim=1), dp)
            y, weight = yw[:, :-1], yw[:, -1]
        return multitask_loss(
            probs, y, weight, self.loss_names, self.task_name, self.num_domains,
            domain_mask=dmask if mc.masked_loss else None,
            model_name=self.model_name,
            loss_weights=mc.loss_weights if mc.extra.get("use_loss_weights") else None,
        )

    def _forward(self, state, *args, **kwargs):
        """The model on ``args``: with its own tensors, or with ``state``
        (tensors by state-dict key, those of one member of a stacked suite
        under ``torch.func.vmap``) in their place."""
        if state is None:
            return self.model(*args, **kwargs)
        return torch.func.functional_call(self.model, state, args, kwargs)

    def _loss_terms(self, params, ids, dense, y, dmask, weight, state=None):
        """(total, data loss, probs) with the L2 penalty over ``params``, the
        whole table included, and under msl / mtmsl with a domain mask and
        ``use_cka_loss`` the CKA between the domains' representations: the
        model's ``last_layer``, else its ``dnn_input`` (trainer.py:668-715).
        ``state``: the tensors the model runs with (``_forward``)."""
        mc = self.cfg.model_config
        model_mask = dmask if (mc.masked_loss and dmask is not None) else None
        want_cka = (mc.use_cka_loss and self.task_name in ("msl", "mtmsl")
                    and dmask is not None)
        if want_cka:
            probs, inter = self._forward(state, ids, dense, model_mask,
                                         return_intermediates=True)
        else:
            probs = self._forward(state, ids, dense, model_mask)
        data_loss = self._data_loss(probs, y, dmask, weight)
        sharded_table = state is None and self._table_sharded()
        if sharded_table:
            params = {k: v for k, v in params.items() if k != _TABLE}
        lead = self._shard() is None or not self._dp.rank
        if not lead:
            # the ranks' totals add up to the global one: the penalty once
            total = data_loss
        else:
            reg = l2_regularization(
                params, mc.l2_reg_embedding, mc.l2_reg_dnn,
                dnn_prefixes=self._reg_dnn_prefixes, l2_linear=mc.l2_reg_linear)
            total = data_loss + reg
        if want_cka:
            last = inter.get("last_layer", inter.get("dnn_input"))
            if last is not None:
                dp = self._shard()
                if dp is None or dp.world == 1:
                    total = total + cka_domain_loss(last, dmask, alpha=0.5)
                else:  # the Gram terms of the global batch, the term counted once
                    cka = cka_domain_loss_sharded(last, dmask, dp, alpha=0.5)
                    total = total + (cka if lead else 0.0 * cka)
        self._report_total = None
        lam = self.cfg.model_config.l2_reg_embedding
        if sharded_table and lam:
            # the row shard's penalty on every rank: each rank's shard
            # gradient is its own, never all-reduced, so each holds the
            # penalty's gradient of its rows, once per row; the step reports
            # the model ranks' penalties summed, on data rank 0 alone
            pen = lam * torch.sum(torch.square(self.table))
            with torch.no_grad():
                whole = pen.detach().clone()
                dist.all_reduce(whole, group=self._table_shard.group)
                self._report_total = total.detach() + (whole if lead else 0.0)
            total = total + pen
        return total, data_loss, probs

    def _per_task_totals(self, params, ids, dense, y, dmask, weight, state=None):
        """(the T task totals, the last task's data loss, probs) of the
        per-task methods (trainer.py:1007-1024, ``_loss_terms_single_task``
        :1292-1316).  The JAX step runs T forwards from one rng and one set
        of BatchNorm statistics and keeps the last statistics: that is one
        forward here, whose statistics move once and whose dropout and gates
        draw once; task i's total is ``multitask_loss(probs . onehot_i +
        probs.detach() . (1 - onehot_i)) + reg / T``, without
        ``loss_weights`` and without the CKA term.  ``state``: the tensors
        the model runs with (``_forward``)."""
        mc = self.cfg.model_config
        model_mask = dmask if (mc.masked_loss and dmask is not None) else None
        probs = self._forward(state, ids, dense, model_mask)
        sharded_table = state is None and self._table_sharded()
        if sharded_table:
            params = {k: v for k, v in params.items() if k != _TABLE}
        reg = l2_regularization(
            params, mc.l2_reg_embedding, mc.l2_reg_dnn,
            dnn_prefixes=self._reg_dnn_prefixes, l2_linear=mc.l2_reg_linear)
        if state is None and self._shard() is not None and self._dp.rank:
            reg = 0.0  # the penalty once, on data rank 0
        if sharded_table and mc.l2_reg_embedding:
            # the row shard's penalty on every rank, as _loss_terms adds it:
            # the shard's gradient is never all-reduced over data
            reg = reg + mc.l2_reg_embedding * torch.sum(torch.square(self.table))
        frozen = probs.detach()
        heads = torch.arange(probs.shape[-1], device=probs.device)
        T = self.num_tasks
        totals = []
        for i in range(T):
            onehot = (heads == i).to(probs.dtype)[None]
            masked = probs * onehot + frozen * (1 - onehot)
            data_loss = multitask_loss(
                masked, y, weight, self.loss_names, self.task_name, self.num_domains,
                domain_mask=dmask if mc.masked_loss else None, model_name=self.model_name)
            totals.append(data_loss + reg / max(T, 1))
        return totals, data_loss, probs

    def _per_task_grads(self, params, ids, dense, y, dmask, weight):
        """(per-task gradient dicts, data loss, probs, GradNorm's task
        losses or None): one backward per task total of
        ``_per_task_totals``.  In a batch shard the tasks' gradients are
        stacked as ``[T, N]`` and all-reduced in one SUM with the data loss
        and GradNorm's ``[T]`` losses, so the merge sees the global batch's.
        A row shard of the table is left out of that SUM: each task's
        backward builds its gradient global already (``owned_rows``, whose
        all-gather over data each of the T backwards runs, in task order on
        every rank)."""
        totals, data_loss, probs = self._per_task_totals(params, ids, dense, y, dmask, weight)
        names = list(params)
        T = len(totals)
        task_grads = [dict(zip(names, _grads(total, list(params.values()), retain=i < T - 1)))
                      for i, total in enumerate(totals)]
        dp = self._shard()
        if dp is None:
            return task_grads, data_loss, probs, None
        with torch.no_grad():
            summed = [k for k in names if not (k == _TABLE and self._table_sharded())]
            stack = torch.stack([torch.cat([tg[k].reshape(-1) for k in summed])
                                 for tg in task_grads])
            extra = [data_loss.detach().reshape(1)]
            if self.per_task == "gradnorm":
                extra.append(self._task_losses(probs.detach(), y, dmask, weight))
            flat = torch.cat([stack.reshape(-1)] + extra)
            dist.all_reduce(flat, group=dp.group)
            n = stack.numel()
            sizes = [params[k].numel() for k in summed]
            task_grads = [
                {**tg, **{k: p.view(params[k].shape) for k, p in zip(summed, row.split(sizes))}}
                for tg, row in zip(task_grads, flat[:n].view(T, -1))]
            loss_vec = flat[n + 1:] if self.per_task == "gradnorm" else None
        return task_grads, flat[n], probs, loss_vec

    def _split_gradient(self) -> dict:
        """The merges' arguments for a gradient whose table part is this
        rank's row shard (``pcgrad.py``): none without one."""
        if not self._table_sharded():
            return {}
        return dict(sharded=(_TABLE,), group=self._table_shard.group)

    def _task_losses(self, probs, y, dmask, weight) -> torch.Tensor:
        """GradNorm's per-task losses ``L_i`` [T] of the batch."""
        mc = self.cfg.model_config
        return per_task_losses(probs, y, weight, self.loss_names, self.task_name,
                               self.num_domains, domain_mask=dmask if mc.masked_loss else None)

    def _gradnorm_terms(self, task_grads, probs, y, dmask, weight, st, loss_vec=None):
        """GradNorm's step as a function (trainer.py:1025-1044): (the summed
        gradients of ``w_i * L_i``, its loss ``sum(w * L)``, the new weights,
        the first losses) from the state ``st``, which it does not move;
        ``loss_vec`` (the global batch's losses) replaces the batch's own."""
        mc = self.cfg.model_config
        if loss_vec is None:
            loss_vec = self._task_losses(probs, y, dmask, weight)
        w = st["task_weights"]
        init_losses = torch.where(st["gn_step"] == 0, loss_vec, st["initial_losses"])
        scaled = [{k: w[i] * g for k, g in tg.items()} for i, tg in enumerate(task_grads)]
        grads = {k: sum(sg[k] for sg in scaled) for k in scaled[0]}
        new_w, _ = gradnorm_update(
            w, loss_vec, init_losses, scaled, alpha=float(mc.extra.get("gradnorm_alpha", 1.5)),
            lr=float(mc.extra.get("gradnorm_lr", 0.025)), **self._split_gradient())
        return grads, torch.sum(w * loss_vec), new_w, init_losses

    def _merge_task_grads(self, task_grads, data_loss, probs, y, dmask, weight, loss_vec=None):
        """(merged gradients, the step's loss) of the per-task method
        (trainer.py:1025-1066): GradNorm sums the gradients of ``w_i * L_i``
        and moves its weights in place (its loss ``sum(w * L)``); CAGrad and
        PCGrad merge, their loss the data loss."""
        mc = self.cfg.model_config
        split = self._split_gradient()
        if self.per_task == "cagrad":
            return cagrad_merge(task_grads, alpha=float(mc.extra.get("cagrad_alpha", 0.5)),
                                **split), data_loss
        if self.per_task == "pcgrad":
            return pcgrad_merge(task_grads, **split), data_loss
        st = self.gn_state
        grads, total, new_w, init_losses = self._gradnorm_terms(
            task_grads, probs, y, dmask, weight, st, loss_vec)
        st["task_weights"].copy_(new_w)
        st["initial_losses"].copy_(init_losses)
        st["gn_step"].add_(1)
        return grads, total

    def _train_step_dense(self, ids, dense, y, dmask, weight):
        params = dict(self.model.named_parameters())
        merged = False  # the per-task merge of a batch shard is global already
        with torch.enable_grad():
            if self.per_task:
                task_grads, data_loss, probs, loss_vec = self._per_task_grads(
                    params, ids, dense, y, dmask, weight)
                merged = self._shard() is not None
                probs = probs.detach()
                with torch.no_grad():
                    grads, total = self._merge_task_grads(
                        task_grads, data_loss, probs, y, dmask, weight, loss_vec)
            else:
                total, data_loss, probs = self._loss_terms(params, ids, dense, y, dmask, weight)
                grads = dict(zip(params, _grads(total, list(params.values()))))
        if self._dp is not None and not merged:
            report = total.detach()
            if self._table_sharded() and self._report_total is not None:
                report = self._report_total
            if self._escm and self._shard() is not None and self._dp.rank:
                report = torch.zeros_like(report)  # the global loss, counted by rank 0
            if self._table_sharded():
                # the shard's gradient is global already (owned_rows): only
                # the replicated parameters take the all-reduce over data
                g_table = grads.pop(_TABLE)
                reduced, total = self._reduce_grads(grads, report)
                grads = {k: g_table if k == _TABLE else reduced[k] for k in params}
            else:
                grads, total = self._reduce_grads(grads, report)
        if self.sparse_embedding_update:
            # the table leaves the dense optimizer; its touched physical rows
            # take SparseAdam from the dense gradient (trainer.py:1074-1094)
            g_table = grads.pop(_TABLE)
            table = params.pop(_TABLE)
            F = len(self.layout.sparse_slots)
            rows = (ids[:, :F] + self._fused_offsets[None, :]).reshape(-1)
            if self._shard() is not None:  # the rows the global batch touched
                rows = all_gather_rows(rows, self._dp)
            if self._emb_pack_factor > 1:
                rows = torch.div(rows, self._emb_pack_factor, rounding_mode="floor")
            with torch.no_grad():
                if self._table_sharded():  # this rank's rows of them
                    from ..parallel.shard_embedding import sharded_sparse_adam_row_update

                    _, self.table_opt = sharded_sparse_adam_row_update(
                        table, g_table, rows, self.table_opt, self.cfg.optim_config.lr,
                        self._table_shard.index)
                else:
                    _, self.table_opt = sparse_adam_row_update(
                        table, g_table, rows, self.table_opt, lr=self.cfg.optim_config.lr)
        self.opt_state = self.tx.step(params, grads, self.opt_state)
        return total.detach(), data_loss.detach(), probs.detach()

    # ------------------------------------------------------------------
    # data parallel (mesh.py, trainer.py:996-1107 under a mesh)
    # ------------------------------------------------------------------
    def _reduce_grads(self, grads: Dict[str, torch.Tensor], loss: torch.Tensor):
        """(the global gradients, the global loss) from this rank's: one
        all-reduce SUM of the gradients concatenated in their order (the
        flat optimizer's, which steps the reduced vector as it is) and the
        loss.  The loss is a weighted sum over rows, so the sum of the
        ranks' gradients is the global one, not their mean.  A replicated
        batch takes rank 0's: the other ranks send zeros."""
        names = list(grads)
        flat = torch.cat([grads[k].reshape(-1) for k in names] + [loss.reshape(1)])
        if not self._dp_sharded and self._dp.rank:
            flat.zero_()
        dist.all_reduce(flat, group=self._dp.group)
        parts = flat[:-1].split([grads[k].numel() for k in names])
        views = {k: p.view(grads[k].shape) for k, p in zip(names, parts)}
        return FlatTensors(flat[:-1], views), flat[-1]

    def _gather_batches(self, t: torch.Tensor) -> torch.Tensor:
        """[steps, ..., B / N, heads] rank rows of each batch -> the global
        batches [steps, ..., B, heads], rank r's at ``[r B / N, (r + 1) B / N)``."""
        out = all_gather_rows(t, self._dp).view(self._dp.world, *t.shape).movedim(0, -3)
        return out.reshape(*t.shape[:-2], -1, t.shape[-1])

    def _rank0_writes(self, write, directory: str) -> str:
        """Run ``write`` (which returns ``directory``) on rank 0 alone, the
        other ranks waiting at a barrier until it is done; with a row-sharded
        table on every rank, whose shards it gathers, rank 0 alone writing."""
        if self.mesh is None:
            return write()
        try:
            if self._table_sharded() or dist.get_rank() == 0:
                directory = write()
        finally:
            dist.barrier()
        return directory

    # ------------------------------------------------------------------
    # the two-phase step (trainer.py:745-962, device-metadata branch)
    # ------------------------------------------------------------------
    def _loss_terms_injected(self, rows, rep, ids, dense, y, dmask, weight):
        """Loss with the pre-gathered rows injected (trainer.py:745-795): the
        embedding penalty is the touched-rows form."""
        mc = self.cfg.model_config
        model_mask = dmask if (mc.masked_loss and dmask is not None) else None
        probs = self.model(ids, dense, model_mask, rows=rows)
        data_loss = self._data_loss(probs, y, dmask, weight)
        reg = l2_regularization(
            self.rest_params(), mc.l2_reg_embedding, mc.l2_reg_dnn,
            dnn_prefixes=self._reg_dnn_prefixes, l2_linear=mc.l2_reg_linear)
        if self._shard() is not None and self._dp.rank:
            reg = 0.0  # the dense penalty once, on data rank 0; rep partitions the rows' term
        if mc.l2_reg_embedding:
            flat_rows = rows.reshape(-1, rows.shape[-1])
            reg = reg + mc.l2_reg_embedding * torch.sum(rep[:, None] * torch.square(flat_rows))
        return data_loss + reg, data_loss, probs

    def train_step(self, ids, dense, y, dmask, weight, meta=None):
        """One training step on a padded batch of device tensors; returns
        (total_loss, data_loss, probs) as device tensors, without a sync.
        The model is in training mode for the step only: dropout draws its
        masks, and BatchNorm normalises by the batch's statistics (pad rows of
        a last partial batch included, as in the JAX step) and moves its
        running ones.  ``meta``: the batch's host dedup metadata on the
        device (``host_metadata``) when the two-phase step reads host
        metadata; when it is not given it is built here from ``ids`` read
        back to the host, the one way a step synchronises (the fit always
        passes it, from its host copy of the ids).  Under a mesh the batch
        is this rank's rows of the global batch (``parallel.multihost.
        host_local_batch_to_global``), and the step is the global one."""
        if self.opt_state is None:
            self.init_state()
        if self.per_task == "gradnorm" and self.gn_state is None:
            self.reset_gradnorm()
        self._reseed()
        return self._step_on_batch(ids, dense, y, dmask, weight, meta)

    def _reseed(self) -> None:
        """Seed the step's draws from the host generator: one draw per step,
        so they are a function of (seed, step) on every path, a replayed
        step's included (the graph reads the generator at its replay)."""
        seed = int(torch.randint(0, 2**62, (), generator=self._dropout_master))
        self._dropout_gen.manual_seed(seed)

    def _step_on_batch(self, ids, dense, y, dmask, weight, meta=None):
        """The step without the reseed: what a captured graph holds."""
        self.model.train()
        try:
            with batch_shard(self._shard()):
                if self.two_phase_embedding:
                    out = self._train_step_two_phase(ids, dense, y, dmask, weight, meta)
                else:
                    out = self._train_step_dense(ids, dense, y, dmask, weight)
        except RuntimeError as e:  # anomaly detection's NaN out of a backward
            if self.debug and "nan" in str(e):
                raise FloatingPointError(f"debug: {e}") from e
            raise
        finally:
            self.model.eval()
        if self.debug:
            for name, t in zip(("loss", "data loss", "probabilities"), out):
                if not bool(torch.isfinite(t).all()):
                    raise FloatingPointError(f"debug: the step's {name} is not finite")
        return out

    def _staged_step_body(self, kind: str, plan, batch_size: int):
        """The step of the staged path (trainer.py:1209-1239): at ``s =
        epoch_step % steps`` it takes its row indices (``"gather"``) or its
        batch start (``"slice"``, block mode), weights and metadata from the
        epoch's stacks, steps, writes its loss and probabilities at ``s``
        and advances ``epoch_step``, all on the device."""
        steps = plan.steps

        def body():
            s = torch.remainder(plan.epoch_step, steps)
            w = plan.w2d.index_select(0, s)[0]
            if self._dp is not None:  # this rank's rows of the global batch
                w = w[plan.rank_rows]
            if kind == "slice":
                idx = plan.arg.index_select(0, s) + plan.arange_b
            else:
                idx = plan.arg.index_select(0, s)[0]
            batch = staging.split_staged(self, staging.fetch_staged_rows(self, plan.staged, idx), w)
            total, _, probs = self._step_on_batch(
                *batch, meta=staging.slice_dedup(self, plan.dedup, s))
            plan.loss.index_copy_(0, s, total.reshape(1))
            if self.metric_fns:
                if plan.probs is None:  # the first call is eager: the shape is known there
                    plan.probs = torch.zeros((steps,) + tuple(probs.shape), device=self.device)
                plan.probs.index_copy_(0, s, probs[None])
            plan.epoch_step.add_(1)

        return body

    def host_metadata(self, ids: np.ndarray) -> Tuple[torch.Tensor, ...]:
        """The dedup metadata of one batch of host ids [B, S], built on the
        host (``staging.step_metadata``) and moved to the device: (inv, rep)
        for the scatter update, plus (pids, pinv, nuniq, prep) for the
        write-kernel and unique ones, plus the gather route's five lists
        (staging.py:720-725)."""
        F = len(self.layout.sparse_slots)
        return self._flat_metadata(np.asarray(ids)[:, :F].astype(np.int64) + self._host_offsets)

    def _flat_metadata(self, flat: np.ndarray) -> Tuple[torch.Tensor, ...]:
        """``host_metadata`` of fused logical ids (the mesh step's: the
        global batch's, gathered)."""
        return tuple(self._to_device(a[0])
                     for a in staging.step_metadata(self, np.asarray(flat).reshape(1, -1)))

    def _train_step_two_phase(self, ids, dense, y, dmask, weight, meta=None):
        if self.mesh is not None:
            from ..parallel.explicit_step import mesh_two_phase_step

            return mesh_two_phase_step(self, ids, dense, y, dmask, weight, meta)
        table = self.table
        B, F = ids.shape[0], len(self.layout.sparse_slots)
        P, D, W = self._emb_pack_factor, self._emb_dim, table.shape[1]
        K = B * F
        Kp = -(-K // 256) * 256
        if not self.device_metadata and meta is None:
            meta = self.host_metadata(ids.cpu().numpy())
        with torch.no_grad():
            flat_ids = (ids[:, :F] + self._fused_offsets[None, :]).reshape(-1)
            if self.device_metadata:
                meta = device_step_metadata(flat_ids, P, Kp, self._emb_phys_rows)
            inv, rep = meta[0], meta[1]
            route = meta[6:]  # the gather route's lists (trainer.py:914-919)
            slot_mode = self.update_space == "slot" and bool(route)
            phys = torch.div(flat_ids, P, rounding_mode="floor") if P > 1 else flat_ids
            sup_c = None
            if slot_mode:
                # phase 1 at the slots: each unique physical row's pair once
                # (n_real leaves the pads as the gather's poison), then the
                # positions' super-rows by pinv (trainer.py:843-859)
                pair = rows_gather_dual(table.view(2, table.shape[0] // 2, W), meta[2],
                                        n_real=meta[4])
                sup_slot, monu_slot = pair[0], pair[1]
                sup = sup_slot.index_select(0, meta[3].long())
            elif self.pair_gather == "dual":
                pair = rows_gather_dual(table.view(2, table.shape[0] // 2, W), phys)
                sup, sup_c = pair[0], pair[1]
            else:
                sup = table.index_select(0, phys.long())
            if P > 1:  # the logical sub-row of each super-row
                sub = torch.arange(K, device=flat_ids.device) * P + torch.remainder(flat_ids, P)
                rows = sup.reshape(K * P, D).index_select(0, sub)
            else:
                rows = sup
            rows = rows.reshape(B, F, D)
        rows.requires_grad_(True)
        rest = self.rest_params()
        with torch.enable_grad():
            total, data_loss, probs = self._loss_terms_injected(
                rows, rep, ids, dense, y, dmask, weight)
            grads = _grads(total, [*rest.values(), rows])
        lr = self.cfg.optim_config.lr
        g_rows = grads[-1].reshape(K, D)
        with torch.no_grad():
            if slot_mode:
                _, self.table_opt = two_phase_sparse_adam_slot(
                    table, g_rows, flat_ids, rep, meta[2], meta[4], sup_slot, monu_slot,
                    self.table_opt, lr, *route, pack_factor=P)
            elif self.table_update == "scatter":
                _, self.table_opt = two_phase_sparse_adam(
                    table, g_rows, flat_ids, inv, rep, self.table_opt, lr=lr, pack_factor=P)
            else:
                pids, pinv, nuniq, prep = meta[2:6]
                names = ("accperm", "resid_pos", "resid_slot", "gdup_pos", "gdup_tgt")
                _, self.table_opt = two_phase_sparse_adam_unique(
                    table, g_rows, flat_ids, inv, rep, pids, pinv, self.table_opt, lr=lr,
                    pack_factor=P, use_pallas=self.table_update == "pallas", n_real=nuniq,
                    sup=sup, sup_c=sup_c, prep=prep, monu_gather=self.monu_gather,
                    **dict(zip(names, route)))
            self.opt_state = self.tx.step(rest, dict(zip(rest, grads[:-1])), self.opt_state)
        return total.detach(), data_loss.detach(), probs.detach()

    # ------------------------------------------------------------------
    # fit (trainer.py:1366-1747)
    # ------------------------------------------------------------------
    def _to_device(self, a: Optional[np.ndarray]) -> Optional[torch.Tensor]:
        return staging.to_device(self, a)

    def fit(
        self,
        x=None,
        y=None,
        batch_size: Optional[int] = None,
        epochs: int = 1,
        initial_epoch: int = 0,
        validation_split: float = 0.0,
        validation_data=None,
        shuffle: Union[bool, str] = True,
        verbose: int = 1,
        resume_from: Optional[str] = None,
        epoch_callback=None,
    ) -> "Trainer":
        """Train on ``x`` (trainer.py:1366-1747).

        Each call draws its epoch orders from ``np.random.default_rng(seed)``
        as the JAX fit does: ``permutation(n)`` per epoch, the identity with
        ``shuffle=False``, or with ``shuffle="block"`` on the staged path
        one permutation of the rows per fit and one of the batch order per
        epoch (streamed, ``"block"`` takes the data order, as in JAX); the
        last partial batch is padded with row 0 at weight 0.  The dataset is
        staged on the device when its bytes x 2 are under 4 GB, else it
        streams (``train/staging.py``).  ``validation_split`` takes the tail
        of the data, before any shuffling; ``validation_data`` is ``(x,
        y)``.  With validation, the epoch with the best ``val_auc``
        (strictly above every earlier one, from 0.0) is kept as
        ``best_variables``, and the fit stops after ``optim_config.early_stop``
        epochs in a row without a new best.  Validation metrics come from the
        device (``train/device_metrics.py``) when
        ``training_config.device_eval`` is set and every compiled metric has
        a device form, else from the host.  With compiled metrics each
        epoch also logs them over its own training predictions (pad rows
        left out), and ``batch_metric_curves`` adds each batch's metrics to
        ``batch_history`` and their means as ``batch_mean_<metric>``.
        ``training_config.max_steps`` caps the steps of the call.
        ``epoch_callback(epoch, trainer)`` runs after each epoch's log.

        ``resume_from`` (a ``save_training_state`` directory) restores the
        whole training state and continues at its epoch; ``save_config.save``
        writes the best variables at the end (``save_checkpoint``; a failed
        save prints and the fit returns, as in the JAX trainer)."""
        if shuffle not in (True, False, "block"):
            raise ValueError(f"shuffle must be True, False or 'block', got {shuffle!r}")
        if not hasattr(self, "tx"):
            raise RuntimeError("call compile() before fit()")
        batch_size = batch_size or 256
        self._meta_codec = "unset"  # per fit: it follows this fit's K and Kp

        def start(ids, dense, y, dmask, val):
            # the first fit's state (or a resume's) and the fit's data path
            if self.two_phase_embedding:
                staging.resolve_table_update(self, batch_size)
            if self.opt_state is None:
                self.init_state()
            if self.per_task == "gradnorm":
                self.reset_gradnorm()
            progress = (initial_epoch, 0.0, 0, None)
            if resume_from is not None:
                progress = self._progress = checkpointing.restore_training_state(
                    self, resume_from)
                if verbose:
                    print(f"resumed from {resume_from} at epoch {progress[0]}")
            max_steps = self.cfg.training_config.max_steps or 0
            # under a mesh a batch that divides by the ranks is split, else
            # every rank computes all of it (shard_batch, mesh.py:116-129)
            self._dp_sharded = self._dp is None or batch_size % self._dp.world == 0
            self._graphs = StepGraphs(self.device, self._dropout_gen)
            source = staging.make_device_plan(
                self, ids, dense, y, dmask, batch_size, shuffle,
                np.random.default_rng(self.seed), epochs, progress[0], max_steps)
            if verbose:
                print(f"Train on {source.n} samples, validate on {len(val[0]) if val else 0} "
                      f"samples, {source.steps} steps per epoch")
            return fit_loop.FitRun(
                source, self._graphs, [self.history], self.model.state_dict, progress=progress,
                max_steps=max_steps,
                curves=bool(self.cfg.model_config.extra.get("batch_metric_curves")))

        try:
            fit_loop.fit(self, self, x, y, batch_size, epochs, validation_split,
                         validation_data, verbose, epoch_callback, start)
        finally:
            self._dp_sharded = True
            self._graphs = None
        if self.cfg.save_config.save:
            try:
                self.save_checkpoint(self.cfg.save_config.save_path)
            except Exception as e:  # a file-system failure ends no fit (trainer.py:1742-1746)
                print(f"checkpoint save failed: {e}")
        return self

    def _batch_curve(self, probs_all, y_all, spans) -> Dict[str, float]:
        """The reference's per-batch train metrics (basemodel.py:316-331,
        trainer.py:1636-1660) from the epoch's collected probabilities:
        appended to ``batch_history``; returns their means."""
        curve: List[Dict[str, float]] = []
        pos = 0
        for full, valid_n in spans:
            pb, yb = probs_all[pos:pos + valid_n], y_all[pos:pos + valid_n]
            pos += full
            if valid_n > 0:
                curve.append(regime_eval(self.metric_fns, yb, pb, self.task_name,
                                         self.num_domains))
        self.batch_history.append(curve)
        if not curve:
            return {}
        return {f"batch_mean_{k}": float(np.mean([c[k] for c in curve])) for k in curve[0]}

    # ------------------------------------------------------------------
    # predict and evaluate (trainer.py:1752-1768, 1879-1907)
    # ------------------------------------------------------------------
    def _selected(self, probs: torch.Tensor) -> torch.Tensor:
        """The columns that metrics and predictions keep: all, or ESCM's
        [pCTR, pCTCVR]."""
        return probs[..., [0, 2]] if self._escm else probs

    def _scanned_probs(self, ev: "staging.EvalTensors", use_best: bool = True) -> torch.Tensor:
        """[steps * batch, heads] selected probabilities of the staged eval
        batches on the device (trainer.py:1334-1350), with the best
        snapshot's state when there is one and ``use_best``; on the card one
        captured forward replayed per batch from ``EVAL_GRAPH_MIN_BATCHES``
        batches on, eager forwards below."""
        best = self.best_variables if use_best else None
        graphs = (StepGraphs(self.device)
                  if ev.ids.shape[0] >= EVAL_GRAPH_MIN_BATCHES and self._capturable else None)
        return _EvalProgram(self, ev, best, graphs).run()

    def _predict_packed(self, ids, dense, dmask, batch_size: int) -> np.ndarray:
        """[n, num_heads] float64 probabilities."""
        ev = staging.prepare_eval_tensors(self, ids, dense, dmask, batch_size)
        return self._scanned_probs(ev).cpu().numpy()[:ev.n].astype(np.float64)

    def update_save(self, value: bool = True) -> None:
        """Make ``predict`` also return the model's named intermediates
        (reference basemodel.py:458)."""
        self._save_layer_output = value

    def predict(self, x, batch_size: int = 256):
        """[N, num_heads] float64 probabilities from ``best_variables`` (the
        current parameters when there is no snapshot); after
        ``update_save()`` the pair (probabilities, {name: [N, ...] float64
        array of each intermediate}), batch by batch and eagerly, as the
        JAX trainer collects them (trainer.py:1879-1895)."""
        ids, dense = self.pack_inputs(x)
        dmask = self._domain_mask_from(x)
        if not getattr(self, "_save_layer_output", False):
            return self._predict_packed(ids, dense, dmask, batch_size)
        # every rank computes all rows here: the intermediates stay whole
        ev = staging.prepare_eval_tensors(self, ids, dense, dmask, batch_size, split=False)
        best = self.best_variables
        self.model.eval()
        outs, inters = [], {}
        with torch.no_grad():
            for s in range(ev.ids.shape[0]):
                args = (ev.ids[s], ev.dense[s], ev.dmask[s] if ev.dmask is not None else None)
                kw = {"return_intermediates": True}
                out, inter = (self.model(*args, **kw) if best is None
                              else torch.func.functional_call(self.model, best, args, kw))
                outs.append(out)
                for k, v in inter.items():
                    inters.setdefault(k, []).append(v)
        n = ev.n
        probs = self._selected(torch.cat(outs))
        return probs.cpu().numpy()[:n].astype(np.float64), {
            k: torch.cat(v).cpu().numpy()[:n].astype(np.float64) for k, v in inters.items()}

    def evaluate(self, x, y, batch_size: int = 256) -> Dict[str, float]:
        """The compiled metrics of the predictions of ``x`` against ``y``,
        aggregated per regime (``metrics.regime_eval``)."""
        ids, dense = self.pack_inputs(x)
        preds = self._predict_packed(ids, dense, self._domain_mask_from(x), batch_size)
        return regime_eval(self.metric_fns, self._prepare_y(y), preds,
                           self.task_name, self.num_domains)

    # ------------------------------------------------------------------
    # metrics on the device (trainer.py:1818-1860, 1909-1974)
    # ------------------------------------------------------------------
    def _use_device_eval(self) -> bool:
        """``training_config.device_eval`` is honoured only when every
        compiled metric has a device form (``device_metrics.SUPPORTED``);
        any other falls the whole validation back to the host."""
        return (bool(self.cfg.training_config.extra.get("device_eval"))
                and device_metrics.supports(self.metric_fns.keys()))

    def masked_test_metrics_device(self, x, y, test_mask, batch_size: int = 256) -> Dict[str, float]:
        """Per-head masked LogLoss and AUC (and the total AUC of msl and
        mtmsl) of the predictions of ``x``, computed on the device
        (``device_metrics.masked_test_metrics_device``), rounded to 4
        decimals in the reference's row order; raises on a value that is
        not finite, as scikit-learn would on a single-class head."""
        ids, dense = self.pack_inputs(x)
        ev = staging.prepare_eval_tensors(self, ids, dense, self._domain_mask_from(x),
                                          batch_size)
        total = ev.ids.shape[0] * batch_size
        y_dev, w_dev = staging.prepare_metric_tensors(self, self._prepare_y(y), total)
        tm_dev = staging.prepare_mask_tensor(self, test_mask, total)
        out = device_metrics.masked_test_metrics_device(
            y_dev, self._scanned_probs(ev), w_dev, tm_dev, self.task_name, self.num_domains)
        return _order_masked_row({k: float(v) for k, v in out.items()})

    # ------------------------------------------------------------------
    # seeds and profiling (trainer.py:1862-1877, 1992-2021)
    # ------------------------------------------------------------------
    def reset_for_seed(self, seed: int, generator: Optional[torch.Generator] = None) -> "Trainer":
        """Start over for ``seed``: the model's weights drawn anew, in place,
        as ``get_model`` draws them from ``generator`` on the generator's
        device, by default ``make_generator(seed, device)`` on the trainer's
        device, the generator the CLI seeds a model with on that device
        (``set_seed``), so the weights are the bits the CLI draws for
        ``seed``; the optimizer states, history, snapshots, the draws'
        generator, the fit's metadata codec and the knobs a fit resolves
        (``update_space``, the route lists' width) reset; compile's
        optimizer, loss and metrics kept (trainer.py:1862-1877)."""
        from ..models import get_model
        from ..utils.seeding import make_generator

        gen = generator if generator is not None else make_generator(seed, str(self.device))
        fresh = get_model(self.model_name, self.layout, self.cfg, generator=gen,
                          device=gen.device)
        with torch.no_grad():
            if self._table_sharded():  # the whole table back, then this rank's rows
                fused = self.model.embeddings.fused
                fused.shard = None
                fused.table = torch.nn.Parameter(torch.empty_like(fresh.embeddings.fused.table),
                                                 requires_grad=fused.table.requires_grad)
            self.model.load_state_dict(fresh.state_dict())
        del fresh
        if self.mesh is not None:
            self._place_on_mesh()
        self.seed = seed
        self.opt_state = self.table_opt = self.best_variables = self.gn_state = None
        self.history, self.batch_history = [], []
        self.throughput_examples_per_s = self._progress = None
        self._meta_codec = "unset"
        self._route_r_cap = 0
        if self.two_phase_embedding and not self.device_metadata:
            self.update_space = _choice(self.cfg.model_config, "update_space", "auto",
                                        ("auto", "position", "slot"))
        self._dropout_master = torch.Generator().manual_seed(seed + 1)
        return self

    def profile(self, x, y, batch_size: int = 256, steps: int = 5, trace_dir: Optional[str] = None):
        """Trace ``steps`` training steps on the first batch of ``x`` with
        ``torch.profiler`` (CPU and CUDA activities) after one step outside
        the trace; the trace goes to ``trace_dir`` (``mmlrec_trace`` in the
        temporary directory by default) as a Chrome trace JSON.  The steps
        train the model, as the JAX trainer's profiled steps train the
        state they are given (trainer.py:1992-2021).  Returns ``trace_dir``."""
        from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

        trace_dir = trace_dir or os.path.join(tempfile.gettempdir(), "mmlrec_trace")
        ids, dense = self.pack_inputs(x)
        yv, dmask = self._prepare_y(y), self._domain_mask_from(x)
        b = min(batch_size, len(ids))
        batch = [self._to_device(a[:b]) if a is not None else None
                 for a in (ids, dense, yv, dmask)] + [torch.ones(b, device=self.device)]
        self.train_step(*batch)
        activities = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if self.device.type == "cuda" else [])
        with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(trace_dir)):
            for _ in range(steps):
                self.train_step(*batch)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        return trace_dir

    # ------------------------------------------------------------------
    # checkpoints (train/checkpointing.py) and history
    # ------------------------------------------------------------------
    def save_training_state(self, path: str, epoch: Optional[int] = None) -> str:
        """Under a mesh rank 0 writes, the others wait (``_rank0_writes``)."""
        return self._rank0_writes(lambda: checkpointing.save_training_state(self, path, epoch),
                                  checkpointing.state_ckpt_dir(self, path))

    def save_checkpoint(self, path: str) -> str:
        """Under a mesh rank 0 writes, the others wait (``_rank0_writes``)."""
        return self._rank0_writes(lambda: checkpointing.save_checkpoint(self, path),
                                  checkpointing.model_ckpt_dir(self, path))

    def restore_checkpoint(self, path: str) -> "Trainer":
        return checkpointing.restore_checkpoint(self, path)

    def dump_history(self, path: str) -> None:
        """Write the per-epoch history as JSON lines."""
        os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
        with open(path, "w") as f:
            for epoch, logs in enumerate(self.history):
                f.write(json.dumps({"epoch": epoch, **logs}) + "\n")


def _order_masked_row(vals: Dict[str, float]) -> Dict[str, float]:
    """Round to the reference's 4 decimals in its row order: log_loss_i and
    auc_i per head, then total_auc (trainer.py:1941-1961)."""
    vals = {k: round(v, 4) for k, v in vals.items()}
    bad = [k for k, v in vals.items() if not np.isfinite(v)]
    if bad:
        raise ValueError(
            f"non-finite device test metrics {bad}: a head's masked rows are "
            "single-class (scikit-learn would raise here too)")
    n_heads = sum(1 for k in vals if k.startswith("auc_"))
    ordered = {}
    for i in range(n_heads):
        ordered[f"log_loss_{i}"] = vals[f"log_loss_{i}"]
        ordered[f"auc_{i}"] = vals[f"auc_{i}"]
    if "total_auc" in vals:
        ordered["total_auc"] = vals["total_auc"]
    return ordered
