"""HMoE (reference model/hmoe.py; the port of ``mmlrec_tpu/models/hmoe.py``)."""

from __future__ import annotations

import torch

from ..ops.kernels import gated_expert_mix
from ..ops.layers import StackedDense, StackedMLP
from .base import RecModel


class HMOE(RecModel):
    """MMoE backbone + per-task softmax weighting over ALL tasks' tower
    outputs, the other tasks' detached (reference model/hmoe.py:108-133).

    Three kernels a forward: the embed-concat, the gated expert mix and the
    fused head.  The second softmax mix has a ``detach()`` on the other
    tasks' towers and a diagonal split; it stays plain tensor ops, as it is
    plain ``jnp`` in the JAX package."""

    # reference hmoe.py:39-41 (gate_dnn), :51-53 (tower_dnn), :61-63
    # (task_weight), :77-80 (expert_dnn + gate/task_weight/tower finals)
    REG_DNN_PREFIXES = ("gate_dnn", "tower_dnn", "task_weight", "expert_dnn",
                        "gate_final", "tower_final", "task_weight_final")

    def __init__(self, layout, cfg, *, generator: torch.Generator, init_std: float = 1e-4):
        super().__init__(layout, cfg, generator=generator, init_std=init_std)
        mc, T, d_in = self.mc, self.num_tasks, self.input_dim
        mlp = self.mlp_kwargs(generator)
        self.embeddings = self._make_embeddings(generator)
        self.expert_dnn = StackedMLP(mc.num_experts, d_in, mc.expert_dnn_hidden_units, **mlp)
        self.gate_dnn, gate_in = None, d_in
        if len(mc.gate_dnn_hidden_units) > 0:
            self.gate_dnn = StackedMLP(T, d_in, mc.gate_dnn_hidden_units, **mlp)
            gate_in = mc.gate_dnn_hidden_units[-1]
        self.gate_final = StackedDense(T, gate_in, mc.num_experts, generator=generator,
                                       use_bias=False)
        self.task_weight, tw_in = None, d_in
        if len(mc.task_weight_hidden_units) > 0:
            self.task_weight = StackedMLP(T, d_in, mc.task_weight_hidden_units, **mlp)
            tw_in = mc.task_weight_hidden_units[-1]
        self.task_weight_final = StackedDense(T, tw_in, T, generator=generator, use_bias=False)
        # the towers run before the task mix, the final layer after it
        self.make_towers(mc.expert_dnn_hidden_units[-1], generator)

    def forward(self, ids, dense, domain_mask=None, *, rows=None,
                return_intermediates: bool = False):
        T = self.num_tasks
        dnn_input, _ = self.embed_inputs(ids, dense, rows)
        expert_outs = self.expert_dnn(dnn_input).contiguous()  # [B, E, dim]
        gate_hidden = self.gate_dnn(dnn_input) if self.gate_dnn is not None else dnn_input
        gate_logits = self.gate_final(gate_hidden).contiguous()  # [B, T, E]
        mmoe_outs = gated_expert_mix(gate_logits, expert_outs)  # [B, T, dim]

        # per-task softmax over tasks (reference task_weight nets :109-116):
        # weights[:, i, j] is task i's weight on task j's tower
        tw_hidden = self.task_weight(dnn_input) if self.task_weight is not None else dnn_input
        task_weights = torch.softmax(self.task_weight_final(tw_hidden), dim=-1)  # [B, T, T]
        towers = self.tower_dnn(mmoe_outs) if self.tower_dnn is not None else mmoe_outs
        # task i mixes its own tower (the gradient flows) with the detached
        # towers of the others (reference model/hmoe.py:126-132)
        eye = torch.eye(T, dtype=towers.dtype, device=towers.device)
        own = torch.einsum("btj,tj->bt", task_weights, eye)[..., None] * towers
        others = torch.einsum("btj,bjd->btd", task_weights * (1.0 - eye)[None], towers.detach())
        task_inputs = (own + others).contiguous()  # [B, T, d]
        probs = self.head_scores(task_inputs, self.tower_final.kernel[..., 0],
                                 self.wide_logit(ids, dense))
        probs = self.apply_domain_mask(probs, domain_mask)
        if not return_intermediates:
            return probs
        return probs, {"dnn_input": dnn_input, "expert_outputs": expert_outs,
                       "gate_outputs": torch.softmax(gate_logits, dim=-1),
                       "mmoe_outputs": mmoe_outs, "tower_outputs": towers}
