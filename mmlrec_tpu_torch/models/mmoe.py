"""MMoE (reference model/mmoe.py; the port of ``mmlrec_tpu/models/mmoe.py``)."""

from __future__ import annotations

import torch

from ..ops.kernels import gated_expert_mix
from ..ops.layers import StackedDense, StackedMLP
from .base import RecModel


class MMOE(RecModel):
    """Multi-gate mixture-of-experts (reference model/mmoe.py:8-119).

    The forward runs three kernels: embed-concat builds the DNN input, the
    gated expert mix fuses the gate softmax with the expert mix, and the
    heads' multihead score fuses the tower's final layer with the bias and
    sigmoid.  The stacked layers between them are plain matrix products.
    """

    # reference mmoe.py:36-38 (gate_dnn), :49-51 (tower_dnn), :59-62
    # (expert_dnn + gate/tower final layers); mmlrec_tpu/models/mmoe.py:22
    REG_DNN_PREFIXES = ("gate_dnn", "tower_dnn", "expert_dnn",
                        "gate_final", "tower_final")

    def __init__(self, layout, cfg, *, generator: torch.Generator, init_std: float = 1e-4):
        super().__init__(layout, cfg, generator=generator, init_std=init_std)
        mc, T = self.mc, self.num_tasks
        mlp = self.mlp_kwargs(generator)
        self.embeddings = self._make_embeddings(generator)
        d_in = self.input_dim
        self.expert_dnn = StackedMLP(mc.num_experts, d_in, mc.expert_dnn_hidden_units, **mlp)
        expert_dim = mc.expert_dnn_hidden_units[-1]
        gate_in = d_in
        self.gate_dnn = None
        if len(mc.gate_dnn_hidden_units) > 0:
            self.gate_dnn = StackedMLP(T, d_in, mc.gate_dnn_hidden_units, **mlp)
            gate_in = mc.gate_dnn_hidden_units[-1]
        self.gate_final = StackedDense(
            T, gate_in, mc.num_experts, generator=generator, use_bias=False)
        self.make_towers(expert_dim, generator)

    def forward(self, ids, dense, domain_mask=None, *, rows=None,
                return_intermediates: bool = False):
        """``rows`` [B, F, D]: injected embedding rows (the two-phase
        training step), used instead of the table."""
        dnn_input, _ = self.embed_inputs(ids, dense, rows)
        expert_outs = self.expert_dnn(dnn_input).contiguous()  # [B, E, dim]
        gate_hidden = self.gate_dnn(dnn_input) if self.gate_dnn is not None else dnn_input
        gate_logits = self.gate_final(gate_hidden).contiguous()  # [B, T, E]
        mmoe_outs = gated_expert_mix(gate_logits, expert_outs)  # [B, T, dim]
        inter = {
            "dnn_input": dnn_input,
            "expert_outputs": expert_outs,
            "gate_outputs": torch.softmax(gate_logits, dim=-1),
            "mmoe_outputs": mmoe_outs,
        } if return_intermediates else None
        probs = self.tower_scores(mmoe_outs, domain_mask, inter, wide=self.wide_logit(ids, dense))
        return (probs, inter) if return_intermediates else probs
