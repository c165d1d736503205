"""The whole training step's share of the card's float32 peak: the model
FLOPs a trained example (three times the forward's matmuls, counted from
the configuration's widths in ``arith/``) times the traced window's
examples a second, over 67 TFLOP/s (TF32 is off in the port)."""

from portbench.arith.peaks import F32_FLOP_PER_S
from portbench.metrics import layers

UNIT, LAYER, MOVES, SOURCE = "%", layers.STEP, "train_examples_per_s", "device_trace"


def read(c):
    flops = getattr(c, "train_flops_per_example", None)
    if flops is None:
        return None
    return 100.0 * flops * c.rate / F32_FLOP_PER_S
