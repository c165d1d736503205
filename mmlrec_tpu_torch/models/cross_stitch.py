"""Cross-stitch network (reference model/cross_stitch.py; the port of
``mmlrec_tpu/models/cross_stitch.py``)."""

from __future__ import annotations

import torch

from ..ops.layers import MLP, CrossStitchLayer, StackedMLP
from .base import RecModel


class CrossStitch(RecModel):
    """A shared first layer, then per-task DNN columns with a learned
    cross-stitch mixing matrix between the layers (reference
    model/cross_stitch.py:30-121).  Two kernels a forward: the embed-concat
    and the fused head."""

    # reference cross_stitch.py:70-72: ONLY the tower DNN is registered;
    # shared/task layers, cross-stitch matrices and the final layers are not
    REG_DNN_PREFIXES = ("tower_dnn",)

    def __init__(self, layout, cfg, *, generator: torch.Generator, init_std: float = 1e-4):
        super().__init__(layout, cfg, generator=generator, init_std=init_std)
        mc, T = self.mc, self.num_tasks
        mlp = self.mlp_kwargs(generator)
        self.embeddings = self._make_embeddings(generator)
        self.shared_layer = MLP(self.input_dim, [mc.shared_hidden_unit], **mlp)
        fan_in = mc.shared_hidden_unit
        self.depth = len(mc.dnn_hidden_units)
        for i, units in enumerate(mc.dnn_hidden_units):
            self.add_module(f"task_layer_{i}", StackedMLP(T, fan_in, [units], **mlp))
            self.add_module(f"gate_{i}", CrossStitchLayer(T, units, generator=generator))
            fan_in = units
        self.make_towers(fan_in, generator)

    def forward(self, ids, dense, domain_mask=None, *, rows=None,
                return_intermediates: bool = False):
        dnn_input, _ = self.embed_inputs(ids, dense, rows)
        x = self.shared_layer(dnn_input)  # [B, shared]: every task column's input
        for i in range(self.depth):
            x = getattr(self, f"task_layer_{i}")(x)  # [B, T, units]
            x = getattr(self, f"gate_{i}")(x)
        inter = {"dnn_input": dnn_input, "cross_stitch_outputs": x}
        probs = self.tower_scores(x, domain_mask, inter, wide=self.wide_logit(ids, dense))
        return (probs, inter) if return_intermediates else probs
