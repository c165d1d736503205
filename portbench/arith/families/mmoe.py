"""MMoE: the gated expert mix (per task a softmax over the experts and the
weighted sum of their outputs) and the heads' multihead score."""

from ..ops import expert_mix, multihead_score


def extra_flops(d):
    width = d.widths["expert_dnn_hidden_units"][-1]
    return d.heads * d.num_experts * 2.0 * width


def fused_ops(d, rows):
    width = d.widths["expert_dnn_hidden_units"][-1]
    return [expert_mix(rows, d.heads, d.num_experts, width),
            multihead_score(rows, d.heads, d.widths["tower_dnn_hidden_units"][-1])]
