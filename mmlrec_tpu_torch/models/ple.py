"""PLE, progressive layered extraction (reference model/ple.py; the port of
``mmlrec_tpu/models/ple.py``)."""

from __future__ import annotations

import torch

from ..ops.kernels import gated_expert_mix
from ..ops.layers import MLP, Dense, StackedDense, StackedMLP
from ..utils.spans import span
from .base import RecModel


class PLE(RecModel):
    """``num_levels`` CGC layers: per-task specific experts and shared
    experts; a task's gate sees its own and the shared experts, the shared
    gate sees all (reference cgc_net model/ple.py:107-154, forward :156-198).
    As in the JAX package, exactly ``shared_expert_num`` shared experts are
    built (the reference builds more and uses only those).

    Kernels a forward: the embed-concat, the fused head, and the gated
    expert mix twice per level.  The per-task gates are the mix at batch
    ``B * T`` with one task over ``spec + shared`` experts; the shared gate
    is the mix at one task over ``T * spec + shared`` experts.

    Each level runs inside a ``mmlrec.model.cgc`` span (``utils/spans.py``):
    a profiler range in an eager forward while a profiler records, the
    shared no-op otherwise; a replayed graph runs no host code, so its
    levels show only by kernel name in the device trace.
    """

    # reference ple.py:57-59 (specific_gate_dnn), :74-76 (shared_gate_dnn),
    # :89-91 (tower_dnn), :99-103 (specific/shared experts + all final layers)
    REG_DNN_PREFIXES = ("specific_gate_dnn", "shared_gate_dnn", "tower_dnn",
                        "specific_experts", "shared_experts",
                        "specific_gate_final", "shared_gate_final",
                        "tower_final")

    def __init__(self, layout, cfg, *, generator: torch.Generator, init_std: float = 1e-4):
        super().__init__(layout, cfg, generator=generator, init_std=init_std)
        mc, T = self.mc, self.num_tasks
        spec, shared = mc.specific_expert_num, mc.shared_expert_num
        mlp = self.mlp_kwargs(generator)
        self.embeddings = self._make_embeddings(generator)
        self.has_gate_dnn = len(mc.gate_dnn_hidden_units) > 0
        d_in = self.input_dim
        for level in range(mc.num_levels):
            self.add_module(f"specific_experts_{level}", StackedMLP(
                T * spec, d_in, mc.expert_dnn_hidden_units, **mlp))
            self.add_module(f"shared_experts_{level}", StackedMLP(
                shared, d_in, mc.expert_dnn_hidden_units, **mlp))
            gate_in = d_in
            if self.has_gate_dnn:
                self.add_module(f"specific_gate_dnn_{level}", StackedMLP(
                    T, d_in, mc.gate_dnn_hidden_units, **mlp))
                gate_in = mc.gate_dnn_hidden_units[-1]
            self.add_module(f"specific_gate_final_{level}", StackedDense(
                T, gate_in, spec + shared, generator=generator, use_bias=False))
            if self.has_gate_dnn:
                self.add_module(f"shared_gate_dnn_{level}", MLP(
                    d_in, mc.gate_dnn_hidden_units, **mlp))
            self.add_module(f"shared_gate_final_{level}", Dense(
                gate_in, T * spec + shared, generator=generator, use_bias=False))
            d_in = mc.expert_dnn_hidden_units[-1]
        self.make_towers(d_in, generator)

    def forward(self, ids, dense, domain_mask=None, *, rows=None,
                return_intermediates: bool = False):
        mc, T = self.mc, self.num_tasks
        dnn_input, _ = self.embed_inputs(ids, dense, rows)
        B = dnn_input.shape[0]
        inter = {"dnn_input": dnn_input}
        # inputs [B, T + 1, d]: T task lanes and one shared lane, all equal
        # to dnn_input at level 0 (reference ple.py:162)
        inputs = dnn_input[:, None, :].expand(B, T + 1, dnn_input.shape[-1])
        for level in range(mc.num_levels):
            with span("mmlrec.model.cgc"):
                inputs = self._cgc(level, inputs, inter)
        probs = self.tower_scores(inputs[:, :T], domain_mask, inter,
                                  wide=self.wide_logit(ids, dense))
        return (probs, inter) if return_intermediates else probs

    def _cgc(self, level: int, inputs: torch.Tensor, inter: dict) -> torch.Tensor:
        """One CGC level: [B, T + 1, d] lanes in, [B, T + 1, h] out."""
        mc, T = self.mc, self.num_tasks
        spec, shared = mc.specific_expert_num, mc.shared_expert_num
        B = inputs.shape[0]
        sub = lambda name: getattr(self, f"{name}_{level}")  # noqa: E731
        # the specific experts are task-major: expert k serves task k // spec
        spec_out = sub("specific_experts")(
            inputs[:, :T].repeat_interleave(spec, dim=1))  # [B, T*spec, h]
        shared_out = sub("shared_experts")(
            inputs[:, T:].expand(B, shared, inputs.shape[-1]))  # [B, shared, h]
        h = spec_out.shape[-1]

        # per-task gates over the task's own and the shared experts
        gate_h = sub("specific_gate_dnn")(inputs[:, :T]) if self.has_gate_dnn else inputs[:, :T]
        gate_logits = sub("specific_gate_final")(gate_h).contiguous()  # [B, T, spec+shared]
        per_task_experts = torch.cat(
            [spec_out.reshape(B, T, spec, h),
             shared_out[:, None].expand(B, T, shared, h)], dim=2)  # [B, T, spec+shared, h]
        task_outs = gated_expert_mix(
            gate_logits.view(B * T, 1, spec + shared),
            per_task_experts.view(B * T, spec + shared, h)).view(B, T, h)

        # the shared gate over all experts
        sgate_h = sub("shared_gate_dnn")(inputs[:, T]) if self.has_gate_dnn else inputs[:, T]
        sgate_logits = sub("shared_gate_final")(sgate_h).contiguous()  # [B, T*spec+shared]
        all_experts = torch.cat([spec_out, shared_out], dim=1)
        shared_mix = gated_expert_mix(sgate_logits[:, None, :], all_experts)  # [B, 1, h]

        inputs = torch.cat([task_outs, shared_mix], dim=1)
        inter[f"ple_output_{level}"] = inputs
        return inputs
