"""The hand-written kernels' share of their roofline over the serving
window: the least time of the logical operations the requests' forwards
ran (each from its shapes, ``arith/ops.py``) over their measured device
time."""

from portbench.arith.ops import kernel_names, roofline_share
from portbench.metrics import layers

UNIT, LAYER, MOVES, SOURCE = "%", layers.KERNELS, "serve_examples_per_s", "device_trace"


def read(c):
    if getattr(c, "requests", None) is None:
        return None
    return roofline_share(c.ops, c.trace.seconds_matching(kernel_names()))
