"""The whole serving forward's share of the card's float32 peak: the
forward's matmul FLOPs a row (counted from the configuration's widths in
``arith/``) times the traced window's rows a second, over 67 TFLOP/s."""

from portbench.arith.peaks import F32_FLOP_PER_S
from portbench.metrics import layers

UNIT, LAYER, MOVES, SOURCE = "%", layers.FORWARD, "serve_examples_per_s", "device_trace"


def read(c):
    flops = getattr(c, "forward_flops_per_example", None)
    if flops is None:
        return None
    return 100.0 * flops * c.rate / F32_FLOP_PER_S
