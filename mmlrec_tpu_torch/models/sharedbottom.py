"""SharedBottom (reference model/sharedbottom.py; the port of
``mmlrec_tpu/models/sharedbottom.py``)."""

from __future__ import annotations

import torch

from ..ops.layers import MLP
from .base import RecModel


class SharedBottom(RecModel):
    """One shared bottom MLP -> per-task towers -> per-task 1-unit heads
    (reference model/sharedbottom.py:28-49, forward :52-86).  Two kernels a
    forward: the embed-concat and the fused head."""

    # reference sharedbottom.py:36-49: tower_dnn + bottom_dnn +
    # tower_dnn_final_layer weights get l2_reg_dnn
    REG_DNN_PREFIXES = ("bottom_dnn", "tower_dnn", "tower_final")

    def __init__(self, layout, cfg, *, generator: torch.Generator, init_std: float = 1e-4):
        super().__init__(layout, cfg, generator=generator, init_std=init_std)
        units = self.mc.bottom_dnn_hidden_units
        self.embeddings = self._make_embeddings(generator)
        self.bottom_dnn = MLP(self.input_dim, units, **self.mlp_kwargs(generator))
        self.make_towers(units[-1], generator)

    def forward(self, ids, dense, domain_mask=None, *, rows=None,
                return_intermediates: bool = False):
        dnn_input, _ = self.embed_inputs(ids, dense, rows)
        bottom = self.bottom_dnn(dnn_input)  # [B, H], the same for every task
        inter = {"dnn_input": dnn_input, "shared_bottom_outputs": bottom}
        probs = self.tower_scores(bottom, domain_mask, inter, wide=self.wide_logit(ids, dense))
        return (probs, inter) if return_intermediates else probs
