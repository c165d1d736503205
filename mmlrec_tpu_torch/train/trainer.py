"""Trainer of the port (``mmlrec_tpu/train/trainer.py``): the dense-table fit
of the flagship and the two-phase SparseAdam step of production
vocabularies, inside one streaming ``fit`` with validation, host metrics,
best snapshot and early stop, plus ``evaluate`` and ``predict``.

**The dense step** (``two_phase_embedding`` off; trainer.py:996-1107 without
the per-task loop): forward and loss, one ``torch.autograd.grad`` over all
parameters, the fused table included (through the embed-concat kernel's
plain backward), then the compiled optimizer over all of them.

**The two-phase step** (trainer.py:745-962, device-metadata branch), all on
the model's device:

1. dedup metadata of the batch's ids from one stable sort
   (``device_step_metadata``);
2. phase 1: the touched rows are gathered once, NOT differentiated: with
   the stacked container each (table, moment) row pair comes from one
   launch of the dual gather (``rows_gather_dual``);
3. phase 2: the loss forward and backward w.r.t. the dense parameters and
   the gathered rows, injected into the model (``rows=``);
4. SparseAdam of the touched rows (``two_phase_sparse_adam_unique``: one
   write launch per step, ``rows_write_dual`` or ``rows_write``) and Adam
   of the dense parameters.

No ``[V, D]`` gradient or moment exists there.  Neither step reads a device
value on the host: a fit synchronises once per epoch, for the loss and the
collected probabilities.

Of the two-phase configurations the production recipe and its split twin are
ported: ``table_update: "pallas"``, ``table_opt_dtype: "bfloat16"``,
``device_metadata: true``, ``table_container`` "stacked" or "split"
(``monu_gather`` "xla" or "pallas").  Every knob that is not ported raises
NotImplementedError naming its ROADMAP item.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ..config import ExperimentConfig
from ..models.base import RecModel
from ..ops.embedding import pack_factor_for
from ..ops.row_gather import rows_gather_dual
from .losses import l2_regularization, multitask_loss
from .metrics import get_metric_fns, regime_eval
from .optimizers import get_optimizer
from .sparse_embedding import (
    SparseAdamFoldedState,
    device_step_metadata,
    init_sparse_adam,
    two_phase_sparse_adam_unique,
)

_TABLE = "embeddings.fused.table"


def get_mask(domain_values, mask_values, num_domains) -> np.ndarray:
    """[B] domain column -> one-hot [B, num_domains]
    (reference model/utils.py:639-645)."""
    dv = np.asarray(domain_values).reshape(-1, 1)
    mv = np.asarray(mask_values).reshape(1, -1)
    return (dv == mv).astype(np.float32)


def _grads(total: torch.Tensor, tensors: List[torch.Tensor]) -> List[torch.Tensor]:
    """d total / d tensors, zeros for a tensor the loss does not reach (a
    parameter that a reference-faithful freeze detaches, a DomainBatchNorm
    that no mask reaches), as jax.grad gives them."""
    grads = torch.autograd.grad(total, tensors, allow_unused=True)
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
        ``device="cpu"`` runs every kernel's plain version."""
        if mesh is not None:
            raise NotImplementedError("meshes are not ported yet (ROADMAP A9)")
        if debug:
            raise NotImplementedError(
                "debug (NaN checking, jax_debug_nans) is not ported yet (ROADMAP A3)")
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "no CUDA device is available; pass device='cpu' to run the "
                    "plain versions of the kernels on the CPU")
            device = "cuda"
        self.device = torch.device(device)
        self.model = model.to(self.device)
        self.cfg: ExperimentConfig = model.cfg
        self.layout = model.layout
        self.seed = seed
        self.history: List[Dict[str, float]] = []
        self.opt_state = None
        self.table_opt = None
        #: the parameters and BatchNorm statistics of the last fit's best
        #: epoch by ``val_auc`` (owned copies, by state-dict key), or None:
        #: then the model's current state is the best there is.  ``predict``
        #: and ``evaluate`` read them.
        self.best_variables: Optional[Dict[str, torch.Tensor]] = None
        self.throughput_examples_per_s: Optional[float] = None
        # the seed of each step's draws (dropout masks, stochastic gates) is
        # drawn from this CPU generator, once per step, so the draws are a
        # function of (seed, step) and the state carries over from one fit()
        # to the next
        self._dropout_master = torch.Generator().manual_seed(seed + 1)
        self._dropout_gen = torch.Generator(device=self.device)
        self.model.set_dropout_generator(self._dropout_gen)

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

    # ------------------------------------------------------------------
    # knob resolution (trainer.py:205-486)
    # ------------------------------------------------------------------
    def _resolve_knobs(self) -> None:
        mc = self.cfg.model_config
        extra = mc.extra
        if self.model_name == "pcg" or extra.get("use_gradnorm") or extra.get("use_cagrad"):
            raise NotImplementedError(
                "per-task gradient methods are not ported yet (ROADMAP A6)")
        if mc.use_cka_loss and self.task_name in ("msl", "mtmsl"):
            raise NotImplementedError("the CKA domain loss is not ported yet (ROADMAP A6)")
        if extra.get("scan_steps"):
            raise NotImplementedError(
                "scanned steps (scan_steps) are not ported yet (ROADMAP A3); the "
                "port runs one step per batch")
        if extra.get("sparse_embedding_update"):
            raise NotImplementedError(
                "sparse_embedding_update is not ported yet (ROADMAP A4)")
        if extra.get("batch_metric_curves"):
            raise NotImplementedError(
                "batch_metric_curves is not ported yet (ROADMAP A3)")
        if self.cfg.training_config.extra.get("device_eval"):
            raise NotImplementedError(
                "device_eval (metrics on the device) is not ported yet (ROADMAP A6)")
        if self.cfg.save_config.save:
            raise NotImplementedError("checkpoints are not ported yet (ROADMAP A7)")
        # the JAX trainer's host-loop knobs that the port would otherwise
        # ignore: the fused optimizer vector (bit-exact either way there) and
        # the prefetch thread's depth
        if extra.get("flat_optimizer", True) is not True:
            raise NotImplementedError(
                "flat_optimizer is not ported yet (ROADMAP A3); the port keeps "
                "one tensor per parameter")
        if int(extra.get("prefetch_batches", 2)) != 2:
            raise NotImplementedError(
                "prefetch_batches is not ported yet (ROADMAP A3); the port "
                "builds each batch on the step's thread")
        # the first E epochs train stochastic gates at their midpoint
        # (mmlrec_tpu/train/trainer.py:523-533)
        self._gate_warmup_epochs = int(extra.get("snr_gate_noise_warmup_epochs", 0) or 0)
        self.two_phase_embedding = bool(extra.get("two_phase_embedding"))
        fused = self.model.embeddings.fused
        if not self.two_phase_embedding:
            # the dense-table fit reads none of the two-phase knobs
            if fused is not None and fused.dual_container:
                raise ValueError(
                    "table_container='stacked' folds the two-phase step's moments "
                    "into the table; the dense-table fit needs the split table")
            return
        sparse_dims = {int(s.feature.embedding_dim) for s in self.layout.sparse_slots}
        if len(sparse_dims) != 1 or self.layout.varlen_slots:
            raise ValueError(
                "two_phase_embedding requires the fused embedding path "
                "(uniform dims, no varlen features)")
        vocabs = [s.feature.vocabulary_size for s in self.layout.sparse_slots]
        self._emb_dim = sparse_dims.pop()
        self._emb_pack_factor = pack_factor_for(int(sum(vocabs)), self._emb_dim)
        self._fused_offsets = torch.as_tensor(
            np.concatenate([[0], np.cumsum(vocabs)[:-1]]).astype(np.int32),
            device=self.device)
        mdt = str(extra.get("table_opt_dtype") or "float32")

        self.table_update = _choice(mc, "table_update", "auto",
                                    ("auto", "scatter", "unique", "pallas"))
        if self.table_update == "auto":
            self.table_update = (
                "pallas"
                if (self._emb_dim * self._emb_pack_factor == 128
                    and mdt in ("float32", "bfloat16")
                    and self.device.type == "cuda")
                else "scatter"
            )
        if self.table_update != "pallas":
            raise NotImplementedError(
                f"table_update={self.table_update!r} is not ported yet (ROADMAP "
                "A4); the port runs table_update='pallas'")
        if mdt != "bfloat16":
            raise NotImplementedError(
                f"table_opt_dtype={mdt!r} moments are not ported yet (ROADMAP A4); "
                "the port keeps packed bfloat16 moments")
        self.monu_gather = _choice(mc, "monu_gather", "auto", ("auto", "xla", "pallas"))
        if self.monu_gather == "auto":
            self.monu_gather = "xla"
        if not extra.get("device_metadata"):
            raise NotImplementedError(
                "host step metadata (batch_step_metadata, native/libstepmeta.so) "
                "is not ported yet (ROADMAP A4); set device_metadata")
        if _choice(mc, "dedup_route", "auto", ("auto", "scatter", "gather")) == "gather":
            raise NotImplementedError(
                "dedup_route='gather' is not ported yet (ROADMAP A4)")
        self.dedup_route = "scatter"
        if _choice(mc, "update_space", "auto", ("auto", "position", "slot")) == "slot":
            raise NotImplementedError("update_space='slot' is not ported yet (ROADMAP A4)")
        self.update_space = "position"
        self.table_container = _choice(mc, "table_container", "split", ("split", "stacked"))
        if fused.dual_container != (self.table_container == "stacked"):
            raise ValueError(
                f"the model was built with table_container="
                f"{'stacked' if fused.dual_container else 'split'}, the config "
                f"says {self.table_container!r}")
        self.pair_gather = _choice(mc, "pair_gather", "auto", ("auto", "split", "dual"))
        if self.pair_gather == "auto":
            self.pair_gather = "dual" if self.table_container == "stacked" else "split"
        elif self.pair_gather == "dual" and self.table_container != "stacked":
            raise ValueError("pair_gather='dual' requires table_container='stacked'")
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
        """Bind optimizer, loss and metrics (reference basemodel.py:557-567)."""
        oc = self.cfg.optim_config
        name = optimizer or oc.optimizer
        if self.two_phase_embedding and (name or "").lower() != "adam":
            raise ValueError("two_phase_embedding implements SparseAdam")
        self.tx = get_optimizer(name, oc.lr)
        loss = loss if loss is not None else oc.loss
        self.loss_names = [loss] if isinstance(loss, str) else list(loss)
        self.metric_fns = get_metric_fns(metrics if metrics is not None else oc.metrics)
        return self

    # ------------------------------------------------------------------
    # input packing (trainer.py:585-636)
    # ------------------------------------------------------------------
    def pack_inputs(self, x) -> Tuple[np.ndarray, np.ndarray]:
        """dict {feature_name: array} -> (ids [N,S] int32, dense [N,Dd]
        float32) in layout order."""
        if isinstance(x, tuple) and len(x) == 2:
            return np.asarray(x[0], np.int32), np.asarray(x[1], np.float32)
        n = None
        ids_parts: List[np.ndarray] = []
        for slot in self.layout.sparse_slots:
            col = np.asarray(x[slot.feature.name]).reshape(-1, 1)
            ids_parts.append(col.astype(np.int32))
            n = len(col)
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

    def init_state(self) -> None:
        """Optimizer state, kept across fit() calls as the JAX trainer keeps
        its state.  Dense fit: the compiled optimizer over every parameter.
        Two-phase: Adam over the rest params plus the table's SparseAdam
        state: the step counter alone for the stacked container (the moments
        live in its bottom half), a zero packed container for the split one."""
        if not self.two_phase_embedding:
            self.opt_state = self.tx.init(dict(self.model.named_parameters()))
            return
        self.table.requires_grad_(False)  # never differentiated: rows are injected
        self.opt_state = self.tx.init(self.rest_params())
        if self.table_container == "stacked":
            self.table_opt = SparseAdamFoldedState(
                count=torch.zeros((), dtype=torch.int32, device=self.device))
        else:
            self.table_opt = init_sparse_adam(self.table, packed=True)

    # ------------------------------------------------------------------
    # the dense step (trainer.py:668-715, 996-1107)
    # ------------------------------------------------------------------
    def _data_loss(self, probs, y, dmask, weight):
        mc = self.cfg.model_config
        return multitask_loss(
            probs, y, weight, self.loss_names, self.task_name, self.num_domains,
            domain_mask=dmask if mc.masked_loss else None,
            model_name=self.model_name,
            loss_weights=mc.loss_weights if mc.extra.get("use_loss_weights") else None,
        )

    def _loss_terms(self, params, ids, dense, y, dmask, weight):
        """(total, data loss, probs) with the L2 penalty over ``params``, the
        whole table included (trainer.py:668-715)."""
        mc = self.cfg.model_config
        model_mask = dmask if (mc.masked_loss and dmask is not None) else None
        probs = self.model(ids, dense, model_mask)
        data_loss = self._data_loss(probs, y, dmask, weight)
        reg = l2_regularization(
            params, mc.l2_reg_embedding, mc.l2_reg_dnn,
            dnn_prefixes=self._reg_dnn_prefixes, l2_linear=mc.l2_reg_linear)
        return data_loss + reg, data_loss, probs

    def _train_step_dense(self, ids, dense, y, dmask, weight):
        params = dict(self.model.named_parameters())
        with torch.enable_grad():
            total, data_loss, probs = self._loss_terms(params, ids, dense, y, dmask, weight)
            grads = _grads(total, list(params.values()))
        self.opt_state = self.tx.step(params, dict(zip(params, grads)), self.opt_state)
        return total.detach(), data_loss.detach(), probs.detach()

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
        if mc.l2_reg_embedding:
            flat_rows = rows.reshape(-1, rows.shape[-1])
            reg = reg + mc.l2_reg_embedding * torch.sum(rep[:, None] * torch.square(flat_rows))
        return data_loss + reg, data_loss, probs

    def train_step(self, ids, dense, y, dmask, weight):
        """One training step on a padded batch of device tensors; returns
        (total_loss, data_loss, probs) as device tensors, without a sync.
        The model is in training mode for the step only: dropout draws its
        masks, and BatchNorm normalises by the batch's statistics (pad rows of
        a last partial batch included, as in the JAX step) and moves its
        running ones."""
        if self.opt_state is None:
            self.init_state()
        seed = int(torch.randint(0, 2**62, (), generator=self._dropout_master))
        self._dropout_gen.manual_seed(seed)
        self.model.train()
        try:
            step = (self._train_step_two_phase if self.two_phase_embedding
                    else self._train_step_dense)
            return step(ids, dense, y, dmask, weight)
        finally:
            self.model.eval()

    def _train_step_two_phase(self, ids, dense, y, dmask, weight):
        table = self.table
        B, F = ids.shape[0], len(self.layout.sparse_slots)
        P, D, W = self._emb_pack_factor, self._emb_dim, table.shape[1]
        K = B * F
        Kp = -(-K // 256) * 256
        with torch.no_grad():
            flat_ids = (ids[:, :F] + self._fused_offsets[None, :]).reshape(-1)
            inv, rep, pids, pinv, nuniq, prep = device_step_metadata(
                flat_ids, P, Kp, self._emb_phys_rows)
            phys = torch.div(flat_ids, P, rounding_mode="floor") if P > 1 else flat_ids
            if self.pair_gather == "dual":
                pair = rows_gather_dual(table.view(2, table.shape[0] // 2, W), phys)
                sup, sup_c = pair[0], pair[1]
            else:
                sup, sup_c = table.index_select(0, phys.long()), None
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
        with torch.no_grad():
            _, self.table_opt = two_phase_sparse_adam_unique(
                table, grads[-1].reshape(K, D), flat_ids, inv, rep, pids, pinv,
                self.table_opt, lr=self.cfg.optim_config.lr, pack_factor=P,
                use_pallas=True, n_real=nuniq, sup=sup, sup_c=sup_c, prep=prep,
                monu_gather=self.monu_gather)
            self.opt_state = self.tx.step(rest, dict(zip(rest, grads[:-1])), self.opt_state)
        return total.detach(), data_loss.detach(), probs.detach()

    # ------------------------------------------------------------------
    # fit (streaming, one step per batch; trainer.py:1366-1538)
    # ------------------------------------------------------------------
    def _check_headroom(self, batch_size: int) -> None:
        """staging.py:132-186: the unique-row list of a batch must fit below
        the physical row count."""
        K = batch_size * len(self.layout.sparse_slots)
        Kp = -(-K // 256) * 256
        if self._emb_phys_rows <= Kp:
            raise ValueError(
                f"table_update='pallas' needs the physical table "
                f"({self._emb_phys_rows} rows) to exceed the padded per-batch id "
                f"count Kp={Kp}; use a larger vocabulary or a smaller batch")

    def _to_device(self, a: Optional[np.ndarray]) -> Optional[torch.Tensor]:
        return None if a is None else torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def fit(
        self,
        x=None,
        y=None,
        batch_size: Optional[int] = None,
        epochs: int = 1,
        initial_epoch: int = 0,
        validation_split: float = 0.0,
        validation_data=None,
        shuffle: bool = True,
        verbose: int = 1,
        resume_from: Optional[str] = None,
        epoch_callback=None,
    ) -> "Trainer":
        """Stream ``x`` through the training step, one batch per step
        (trainer.py:1366-1747).

        Each call draws its epoch orders from ``np.random.default_rng(seed)``
        (``permutation(n)`` per epoch, or the identity with
        ``shuffle=False``); the last partial batch is padded with dataset
        row 0 at weight 0, as the JAX fit does.  ``validation_split`` takes
        the tail of the data, before any shuffling; ``validation_data`` is
        ``(x, y)``.  With validation, the epoch with the best ``val_auc``
        (strictly above every earlier one, from 0.0) is kept as
        ``best_variables``, and the fit stops after ``optim_config.early_stop``
        epochs in a row without a new best.  With compiled metrics each
        epoch also logs them over its own training predictions (pad rows
        left out).  ``training_config.max_steps`` caps the steps of the call.

        The dataset stays on the host: staging it on the device, block
        shuffle, scanned steps and the thread-ahead pool are ROADMAP A3."""
        if resume_from is not None:
            raise NotImplementedError("resume_from (checkpoints) is not ported yet (ROADMAP A7)")
        if epoch_callback is not None:
            raise NotImplementedError("epoch_callback is not ported yet (ROADMAP A3)")
        if shuffle not in (True, False):
            raise NotImplementedError(
                f"shuffle={shuffle!r} (staged block mode) is not ported yet (ROADMAP A3)")
        if not hasattr(self, "tx"):
            raise RuntimeError("call compile() before fit()")
        oc = self.cfg.optim_config
        batch_size = batch_size or 256
        if self.two_phase_embedding:
            self._check_headroom(batch_size)
        ids, dense = self.pack_inputs(x)
        y = self._prepare_y(y)
        dmask = self._domain_mask_from(x)
        n = len(ids)

        val = None
        if validation_data is not None:
            vx, vy = validation_data[:2]
            val = (*self.pack_inputs(vx), self._prepare_y(vy), self._domain_mask_from(vx))
        elif validation_split and 0.0 < validation_split < 1.0:
            split = int(n * (1.0 - validation_split))
            val = (ids[split:], dense[split:], y[split:],
                   dmask[split:] if dmask is not None else None)
            ids, dense, y = ids[:split], dense[:split], y[:split]
            dmask = dmask[:split] if dmask is not None else None
            n = split

        if self.opt_state is None:
            self.init_state()
        steps_per_epoch = (n - 1) // batch_size + 1
        max_steps = self.cfg.training_config.max_steps or 0
        if verbose:
            print(f"Train on {n} samples, validate on {len(val[0]) if val else 0} samples, "
                  f"{steps_per_epoch} steps per epoch")
        rng_np = np.random.default_rng(self.seed)
        best_auc, early_stop_count, best_snapshot = 0.0, 0, None
        total_steps = examples_seen = 0
        train_time = 0.0
        val_batches = None
        for epoch in range(initial_epoch, epochs):
            t0 = time.time()
            if self._gate_warmup_epochs:
                self.model.set_gate_noise_off(epoch < self._gate_warmup_epochs)
            order = rng_np.permutation(n) if shuffle else np.arange(n)
            steps = steps_per_epoch
            if max_steps:
                steps = min(steps_per_epoch, max_steps - total_steps)
                if steps <= 0:
                    break
            take = min(n, steps * batch_size)  # the epoch's real rows; the rest are pads
            losses, probs = [], []
            for s in range(steps):
                idx = order[s * batch_size:(s + 1) * batch_size]
                weight = np.ones(batch_size, np.float32)
                pad = batch_size - len(idx)
                if pad:
                    weight[len(idx):] = 0.0
                    idx = np.concatenate([idx, np.zeros(pad, np.int64)])
                total, _, p = self.train_step(
                    self._to_device(ids[idx]), self._to_device(dense[idx]),
                    self._to_device(y[idx]),
                    self._to_device(dmask[idx]) if dmask is not None else None,
                    self._to_device(weight))
                losses.append(total)
                if self.metric_fns:
                    probs.append(p)
            total_steps += steps
            examples_seen += take
            epoch_loss = float(torch.stack(losses).sum())  # the epoch's first sync
            epoch_time = time.time() - t0
            train_time += epoch_time
            logs = {"loss": epoch_loss / max(n, 1), "epoch_s": epoch_time}
            if self.metric_fns:
                probs_all = self._selected(torch.cat(probs)).cpu().numpy()[:take]
                logs.update(regime_eval(self.metric_fns, y[order[:take]], probs_all,
                                        self.task_name, self.num_domains))
            if val is not None:
                if val_batches is None:  # the validation set goes to the device once
                    val_batches = self._eval_batches(val[0], val[1], val[3], batch_size)
                preds = self._predict_batches(val_batches, len(val[0]), use_best=False)
                val_result = regime_eval(self.metric_fns, val[2], preds,
                                         self.task_name, self.num_domains)
                logs.update({f"val_{k}": v for k, v in val_result.items()})
                auc = val_result.get("auc", 0.0)
                if auc > best_auc:
                    best_auc, early_stop_count = auc, 0
                    # the steps update parameters and BatchNorm statistics in
                    # place: the snapshot owns its copy
                    best_snapshot = {k: v.detach().clone()
                                     for k, v in self.model.state_dict().items()}
                else:
                    early_stop_count += 1
            self.history.append(logs)
            if verbose:
                print(f"Epoch {epoch + 1}/{epochs} - {epoch_time:.1f}s - " + " - ".join(
                    f"{k}: {v:.4f}" for k, v in logs.items() if k != "epoch_s"))
            if val is not None and early_stop_count >= oc.early_stop:
                break
            if max_steps and total_steps >= max_steps:
                break

        if train_time > 0:
            # steady state: the first epoch (warm-up) is left out when more ran
            epoch_times = [h["epoch_s"] for h in self.history]
            warm_time = sum(epoch_times[1:])
            if len(epoch_times) > 1 and warm_time > 0:
                per_epoch = examples_seen / len(epoch_times)
                self.throughput_examples_per_s = per_epoch * (len(epoch_times) - 1) / warm_time
            else:
                self.throughput_examples_per_s = examples_seen / train_time
        self.best_variables = best_snapshot
        return self

    # ------------------------------------------------------------------
    # predict and evaluate (trainer.py:1752-1768, 1879-1907)
    # ------------------------------------------------------------------
    def _eval_batches(self, ids, dense, dmask, batch_size: int):
        """(ids, dense, mask) device tensors per batch; the last batch is
        padded with its last row, as the JAX predict does."""
        mc = self.cfg.model_config
        n = len(ids)
        steps = (n - 1) // batch_size + 1
        pad = steps * batch_size - n

        def padded(a):
            if a is None or not pad:
                return a
            return np.concatenate([a, np.repeat(a[-1:], pad, axis=0)])

        ids, dense = padded(ids), padded(dense)
        dmask = padded(dmask) if (mc.masked_loss and dmask is not None) else None
        batches = []
        for s in range(steps):
            sl = slice(s * batch_size, (s + 1) * batch_size)
            batches.append((self._to_device(ids[sl]), self._to_device(dense[sl]),
                            self._to_device(dmask[sl]) if dmask is not None else None))
        return batches

    def _selected(self, probs: torch.Tensor) -> torch.Tensor:
        """The columns that metrics and predictions keep: all, or ESCM's
        [pCTR, pCTCVR]."""
        return probs[:, [0, 2]] if self._escm else probs

    def _predict_batches(self, batches, n: int, use_best: bool = True) -> np.ndarray:
        """[n, num_heads] float64 probabilities of the staged batches, with
        the best snapshot's state when there is one and ``use_best``; the
        model is in eval mode, so BatchNorm reads its running statistics."""
        self.model.eval()
        best = self.best_variables if use_best else None
        outs = []
        with torch.inference_mode():
            for args in batches:
                out = (self.model(*args) if best is None
                       else torch.func.functional_call(self.model, best, args))
                outs.append(out)
            probs = self._selected(torch.cat(outs)).cpu().numpy()
        return probs[:n].astype(np.float64)

    def _predict_packed(self, ids, dense, dmask, batch_size: int) -> np.ndarray:
        return self._predict_batches(self._eval_batches(ids, dense, dmask, batch_size), len(ids))

    def predict(self, x, batch_size: int = 256) -> np.ndarray:
        """[N, num_heads] float64 probabilities from ``best_variables`` (the
        current parameters when there is no snapshot)."""
        ids, dense = self.pack_inputs(x)
        return self._predict_packed(ids, dense, self._domain_mask_from(x), batch_size)

    def evaluate(self, x, y, batch_size: int = 256) -> Dict[str, float]:
        """The compiled metrics of ``predict(x)`` against ``y``, aggregated
        per regime (``metrics.regime_eval``)."""
        ids, dense = self.pack_inputs(x)
        preds = self._predict_packed(ids, dense, self._domain_mask_from(x), batch_size)
        return regime_eval(self.metric_fns, self._prepare_y(y), preds,
                           self.task_name, self.num_domains)

    # ------------------------------------------------------------------
    # not ported yet
    # ------------------------------------------------------------------
    def masked_test_metrics_device(self, *args, **kwargs):
        raise NotImplementedError(
            "metrics on the device are not ported yet (ROADMAP A6); use predict() and "
            "train.metrics.masked_test_metrics")

    def save_checkpoint(self, path: str):
        raise NotImplementedError("checkpoints are not ported yet (ROADMAP A7)")

    def profile(self, *args, **kwargs):
        raise NotImplementedError(
            "Trainer.profile is not ported yet (ROADMAP A3); "
            "python -m mmlrec_tpu_torch.tools.profile_step traces the step")
