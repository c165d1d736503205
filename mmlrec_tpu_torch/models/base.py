"""Model base: embedding front-end + multi-head epilogue (the port of
``mmlrec_tpu/models/base.py``).

Every model is an ``nn.Module`` called as::

    probs = model(ids, dense, domain_mask)

with ``ids: int32 [B, n_id_slots]`` (the sparse ids, then each varlen
feature's ``maxlen`` ids and its length column if it has one),
``dense: float32 [B, n_dense]``,
``domain_mask: [B, D] or None`` and output ``[B, num_tasks]``
probabilities (reference forward contract, e.g. model/mmoe.py:65-119).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from ..config import ExperimentConfig
from ..features import FeatureLayout
from ..ops.embedding import EmbeddingCollection
from ..ops.layers import PredictionHeads, StackedDense, StackedMLP, WideLinear, sequence_pooling


class RecModel(nn.Module):
    """Base of the port's model families."""

    # Per-model ``l2_reg_dnn`` inclusion set (mmlrec_tpu/models/base.py:
    # 42-49): top-level parameter-group prefixes whose ``kernel`` leaves are
    # penalized; () means embeddings only.
    REG_DNN_PREFIXES: Tuple[str, ...] = ()

    def __init__(
        self,
        layout: FeatureLayout,
        cfg: ExperimentConfig,
        *,
        generator: torch.Generator,
        init_std: float = 1e-4,
    ):
        super().__init__()
        self.layout = layout
        self.cfg = cfg
        self.init_std = init_std
        extra = self.mc.extra
        self.wide_linear: Optional[WideLinear] = None
        if extra.get("use_wide_linear"):
            self.wide_linear = self._make_wide_linear(generator)

    # ---- config shortcuts -------------------------------------------------
    @property
    def mc(self):
        return self.cfg.model_config

    @property
    def dc(self):
        return self.cfg.data_config

    @property
    def task_name(self) -> str:
        return self.mc.task_name

    @property
    def num_tasks(self) -> int:
        return self.cfg.num_tasks

    @property
    def num_domains(self) -> int:
        return self.dc.num_domains

    @property
    def task_types(self) -> Tuple[str, ...]:
        tt = tuple(self.mc.task_types)
        if len(tt) != self.num_tasks:
            tt = tuple(["binary"] * self.num_tasks)
        return tt

    @property
    def input_dim(self) -> int:
        return self.layout.input_dim

    # ---- shared submodules ------------------------------------------------
    def _make_embeddings(self, generator: torch.Generator) -> EmbeddingCollection:
        extra = self.mc.extra
        return EmbeddingCollection(
            self.layout, generator=generator, init_std=self.init_std,
            # "stacked": the two-phase moment container folded into the
            # table param, shard-major over ``stacked_shards`` shards on a
            # mesh with model > 1 (mmlrec_tpu/models/base.py:95-104)
            dual_container=str(extra.get("table_container", "split")) == "stacked",
            dual_shards=int(extra.get("stacked_shards", 1) or 1),
            # "auto" | "matmul" | "scatter" table cotangent, and the stack
            # width a vmapped suite divides the one-hot budget by
            # (mmlrec_tpu/models/base.py:90-94)
            grad_mode=str(extra.get("embedding_grad", "auto")),
            grad_budget_divisor=int(extra.get("_grad_budget_div", 1)),
        )

    def embed_inputs(self, ids: torch.Tensor, dense: torch.Tensor, rows=None):
        """Return (dnn_input [B, input_dim], sparse_emb [B, F, D_emb] or None):
        flattened sparse embeddings ++ pooled varlen embeddings ++ dense
        values (mmlrec_tpu/models/base.py:108-135, reference
        basemodel.py:461-487), built by one embed-concat kernel whose dense
        operand is ``cat(pooled varlen, dense)``; ``sparse_emb`` is a view
        into ``dnn_input``.

        ``rows`` [B, F, D] are the two-phase step's injected rows: then
        ``dnn_input = cat(rows.flatten(1), dense)`` in plain ops,
        differentiable w.r.t. the rows, and the table is not read."""
        fused = self.embeddings.fused
        if not self.layout.num_dense_dims:
            dense = dense.new_empty((dense.shape[0], 0))
        pooled = self.pooled_varlen(ids)
        side = torch.cat([*pooled, dense], dim=1) if pooled else dense
        if fused is None:
            if side.shape[1] == 0:
                raise ValueError("dnn_feature_columns is null!")
            return side, None
        n_sparse = len(self.layout.sparse_slots)
        if rows is not None:
            rows = self.embeddings.sparse_embeddings(ids, rows)
            return torch.cat([rows.flatten(1), side], dim=1), rows
        dnn_input = fused.embed_concat(ids[:, :n_sparse], side)
        sparse_emb = dnn_input[:, : n_sparse * fused.dim].unflatten(1, (n_sparse, fused.dim))
        return dnn_input, sparse_emb

    def pooled_varlen(self, ids: torch.Tensor) -> List[torch.Tensor]:
        """Each varlen feature's sequence pooled to [B, E] by its combiner:
        positions below the length column when the feature has one, else
        the ids other than 0 (reference model/utils.py:454)."""
        out = []
        for slot in self.layout.varlen_slots:
            seq_ids = ids[:, slot.start:slot.end]
            seq_emb = self.embeddings.varlen_embedding(slot.feature.embedding_name, seq_ids)
            if slot.length_slot is not None:
                steps = torch.arange(slot.feature.maxlen, device=ids.device)
                mask = steps[None, :] < ids[:, slot.length_slot][:, None]
            else:
                mask = seq_ids != 0
            out.append(sequence_pooling(seq_emb, mask, mode=slot.feature.combiner))
        return out

    def set_dropout_generator(self, generator: torch.Generator) -> None:
        """Hand every module that draws in training (dropout, stochastic
        gates) the generator it draws from (on the model's device).  The
        trainer owns it and reseeds it once per step."""
        for module in self.modules():
            if hasattr(module, "dropout_generator"):
                module.dropout_generator = generator

    def set_gate_noise_off(self, off: bool) -> None:
        """Switch every stochastic gate to its midpoint in training too (the
        trainer's ``snr_gate_noise_warmup_epochs``; mmlrec_tpu/ops/layers.py:
        115-130 is the JAX package's trace-time counterpart)."""
        for module in self.modules():
            if hasattr(module, "noise_off"):
                module.noise_off = bool(off)

    def _make_wide_linear(self, generator: torch.Generator) -> WideLinear:
        """The opt-in wide logit (mmlrec_tpu/models/base.py:140-168): one
        1-dim table per ``embedding_name`` (features sharing a name share
        it), each slot read from its own column of the packed ids."""
        names, slot_tables = [], []
        for s in self.layout.sparse_slots:
            n = s.feature.embedding_name
            if n not in names:
                names.append(n)
            slot_tables.append(names.index(n))
        return WideLinear(
            [self.layout.embedding_specs[n][0] for n in names], self.layout.num_dense_dims,
            generator=generator, init_std=self.init_std, slot_tables=slot_tables,
            slot_cols=[s.start for s in self.layout.sparse_slots])

    def wide_logit(self, ids: torch.Tensor, dense: torch.Tensor) -> Optional[torch.Tensor]:
        """[B, 1], added to every head before its sigmoid, with
        ``use_wide_linear``; else None."""
        return None if self.wide_linear is None else self.wide_linear(ids, dense)

    def make_heads(self) -> PredictionHeads:
        return PredictionHeads(self.task_types)

    def mlp_kwargs(self, generator: torch.Generator) -> Dict:
        """What every DNN of a family takes from the config."""
        mc = self.mc
        return dict(generator=generator, activation=mc.dnn_activation,
                    dropout_rate=mc.dnn_dropout, use_bn=mc.dnn_use_bn,
                    init_std=self.init_std)

    def make_towers(self, in_dim: int, generator: torch.Generator) -> None:
        """The per-task tail most families share: ``tower_dnn`` (None when
        ``tower_dnn_hidden_units`` is empty), the 1-unit ``tower_final``
        without a bias, and the heads ``out``."""
        T, units = self.num_tasks, self.mc.tower_dnn_hidden_units
        self.tower_dnn: Optional[StackedMLP] = None
        if len(units) > 0:
            self.tower_dnn = StackedMLP(T, in_dim, units, **self.mlp_kwargs(generator))
            in_dim = units[-1]
        self.tower_final = StackedDense(T, in_dim, 1, generator=generator, use_bias=False)
        self.out = self.make_heads()

    def head_scores(self, tower: torch.Tensor, weights: torch.Tensor,
                    wide: Optional[torch.Tensor] = None,
                    bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The heads over a per-task product: ``tower`` [B, T, H] (or
        [B, H], the same input for every task) . ``weights`` [T, H], plus
        the final layer's own ``bias`` [T] if it has one, plus the heads'
        bias, then the sigmoid -> [B, T]: one multihead-score launch.  With
        the ``wide`` logit [B, 1] the heads take ``(tower . w + bias) +
        wide`` in plain tensor ops (``from_logits``), as the JAX package
        adds it."""
        if tower.dim() == 2:  # the kernel reads one row per (example, task)
            tower = tower[:, None, :].expand(-1, self.num_tasks, -1)
        if wide is None:
            return self.out(tower.contiguous(), weights, bias)
        logits = torch.einsum("bth,th->bt", tower, weights)
        if bias is not None:
            logits = logits + bias
        return self.out.from_logits(logits + wide)

    def tower_scores(self, x: torch.Tensor, domain_mask, inter: Optional[Dict] = None,
                     wide: Optional[torch.Tensor] = None):
        """``x`` [B, T, H] (or [B, H], the same input for every task) through
        the towers and the heads (``head_scores``: the towers' final layer,
        the bias and the sigmoid), then the domain mask.  ``inter`` collects
        ``tower_outputs`` when there are towers."""
        tower = x
        if self.tower_dnn is not None:
            tower = self.tower_dnn(x)
            if inter is not None:
                inter["tower_outputs"] = tower
        probs = self.head_scores(tower, self.tower_final.kernel[..., 0], wide)
        return self.apply_domain_mask(probs, domain_mask)

    def apply_domain_mask(self, probs: torch.Tensor, domain_mask) -> torch.Tensor:
        """Per-head domain gating (reference epilogue, e.g. model/mmoe.py:
        101-106).  msl: head i gated by domain i; mtmsl: head i by domain
        i % D.  No-op when domain_mask is None."""
        if domain_mask is None:
            return probs
        if self.task_name == "msl":
            return probs * domain_mask
        if self.task_name == "mtmsl":
            idx = torch.arange(probs.shape[-1], device=probs.device) % self.num_domains
            return probs * domain_mask[:, idx]
        return probs
