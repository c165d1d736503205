"""The hand-written kernels' share of their roofline over the training
window: the least time of the logical operations they ran (each from its
shapes, ``arith/ops.py``) over their measured device time."""

from portbench.arith.ops import kernel_names, roofline_share
from portbench.metrics import layers

UNIT, LAYER, MOVES, SOURCE = "%", layers.KERNELS, "train_examples_per_s", "device_trace"


def read(c):
    if getattr(c, "steps", None) is None:
        return None
    return roofline_share(c.ops, c.trace.seconds_matching(kernel_names()))
