"""SharedBottom: the heads' multihead score is its one fused operation
beside the embedding's; it mixes nothing."""

from ..ops import multihead_score


def extra_flops(d):
    return 0.0


def fused_ops(d, rows):
    return [multihead_score(rows, d.heads, d.widths["tower_dnn_hidden_units"][-1])]
