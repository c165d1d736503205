"""MLP: the embedding's is its one fused operation; the heads take the
one shared logit in plain tensor operations, and it mixes nothing."""


def extra_flops(d):
    return 0.0


def fused_ops(d, rows):
    return []
