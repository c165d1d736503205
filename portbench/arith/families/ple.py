"""PLE: per CGC level two gated expert mixes, the tasks' (at ``rows x T``
rows, one task over its ``spec + shared`` experts) and the shared gate's
(one task over all ``T x spec + shared`` experts), then the heads'
multihead score.  PLE adds no kernel of its own."""

from ..ops import expert_mix, multihead_score


def _sizes(d):
    mc = d.model_config
    return (int(mc["specific_expert_num"]), int(mc["shared_expert_num"]),
            int(mc["num_levels"]))


def extra_flops(d):
    spec, shared, levels = _sizes(d)
    width = d.widths["expert_dnn_hidden_units"][-1]
    per_level = d.heads * (spec + shared) + (d.heads * spec + shared)
    return levels * per_level * 2.0 * width


def fused_ops(d, rows):
    spec, shared, levels = _sizes(d)
    width = d.widths["expert_dnn_hidden_units"][-1]
    mixes = [expert_mix(rows * d.heads, 1, spec + shared, width),
             expert_mix(rows, 1, d.heads * spec + shared, width)]
    return mixes * levels + [multihead_score(rows, d.heads, d.widths["tower_dnn_hidden_units"][-1])]
