"""Fully-shared MLP (reference model/mlp.py; the port of
``mmlrec_tpu/models/mlp.py``)."""

from __future__ import annotations

import torch

from ..ops.layers import MLP as MLPStack
from ..ops.layers import Dense
from .base import RecModel


class MLP(RecModel):
    """A single MLP and ONE shared final layer: every task head emits the
    same logit and differs only in its output bias (reference
    model/mlp.py:24-29, forward :36-66).  The shared logit is no
    ``[B, T, H] . [T, H]`` product, so the heads take it in plain tensor ops
    (``PredictionHeads.from_logits``); the forward's one kernel is the
    embed-concat."""

    # reference mlp.py:31-33: only the mlp_layers' weights (NOT the shared
    # final layer) get l2_reg_dnn
    REG_DNN_PREFIXES = ("mlp_layer_",)

    def __init__(self, layout, cfg, *, generator: torch.Generator, init_std: float = 1e-4):
        super().__init__(layout, cfg, generator=generator, init_std=init_std)
        self.embeddings = self._make_embeddings(generator)
        fan_in = self.input_dim
        self.depth = len(self.mc.dnn_hidden_units)
        for i, units in enumerate(self.mc.dnn_hidden_units):
            self.add_module(f"mlp_layer_{i}", MLPStack(
                fan_in, [units], generator=generator, activation="relu", init_std=init_std))
            fan_in = units
        self.final_layer = Dense(fan_in, 1, generator=generator, use_bias=False)
        self.out = self.make_heads()

    def forward(self, ids, dense, domain_mask=None, *, rows=None,
                return_intermediates: bool = False):
        x, _ = self.embed_inputs(ids, dense, rows)
        inter = {"dnn_input": x}
        for i in range(self.depth):
            x = getattr(self, f"mlp_layer_{i}")(x)
            inter[f"mlp_output_{i}"] = x
        inter["last_layer"] = x
        logit = self.final_layer(x)  # [B, 1], broadcast to the T heads
        wide = self.wide_logit(ids, dense)
        probs = self.out.from_logits(logit if wide is None else logit + wide)
        probs = self.apply_domain_mask(probs, domain_mask)
        return (probs, inter) if return_intermediates else probs
