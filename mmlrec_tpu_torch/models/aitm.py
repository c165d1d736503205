"""AITM (reference model/aitm.py; the port of ``mmlrec_tpu/models/aitm.py``)."""

from __future__ import annotations

import torch

from ..ops.layers import AITMAttention, Dense, StackedMLP
from .base import RecModel


class AITM(RecModel):
    """Adaptive information transfer: per-task bottom DNNs; task i's feature
    is fused with g(feature of task i-1) by a two-token attention (reference
    model/aitm.py:78-110; exactly 2 tasks, :31).  Two kernels a forward: the
    embed-concat and the fused head."""

    # reference aitm.py:60-62 (tower_dnn), :71-75 (bottom +
    # tower_dnn_final_layer); the attention's h1/h2/h3 and the g transforms
    # are NOT registered
    REG_DNN_PREFIXES = ("bottom", "tower_dnn", "tower_final")

    def __init__(self, layout, cfg, *, generator: torch.Generator, init_std: float = 1e-4):
        super().__init__(layout, cfg, generator=generator, init_std=init_std)
        T = self.num_tasks
        if T != 2:
            raise ValueError("the length of task_names must be equal to 2")
        units = self.mc.expert_dnn_hidden_units  # reference aitm.py:20
        dim = units[-1]
        self.embeddings = self._make_embeddings(generator)
        self.bottom = StackedMLP(T, self.input_dim, units, **self.mlp_kwargs(generator))
        for i in range(1, T):
            self.add_module(f"g_{i - 1}", Dense(dim, dim, generator=generator))
        self.attention = AITMAttention(dim, dim, generator=generator)
        self.make_towers(dim, generator)

    def forward(self, ids, dense, domain_mask=None, *, rows=None,
                return_intermediates: bool = False):
        T = self.num_tasks
        dnn_input, _ = self.embed_inputs(ids, dense, rows)
        feats = self.bottom(dnn_input)  # [B, T, F]
        feat_list = [feats[:, i] for i in range(T)]
        for i in range(1, T):
            p = getattr(self, f"g_{i - 1}")(feat_list[i - 1])
            feat_list[i] = self.attention(p, feat_list[i])
        probs = self.tower_scores(torch.stack(feat_list, dim=1), domain_mask,
                                  wide=self.wide_logit(ids, dense))
        return (probs, {"dnn_input": dnn_input}) if return_intermediates else probs
