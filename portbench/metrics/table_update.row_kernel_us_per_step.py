"""Device us a step of the table update's row kernels (the gathers and
writes of table rows with their moments, ``arith/kernels.json``)."""

from portbench.arith.ops import kernel_names, row_op_names
from portbench.metrics import layers

UNIT, LAYER, MOVES, SOURCE = "us", layers.TABLE, "train_examples_per_s", "device_trace"


def read(c):
    if getattr(c, "steps", None) is None:
        return None
    seconds = c.trace.seconds_matching(kernel_names())
    found = [seconds[k] for k in row_op_names() if k in seconds]
    if not found:
        return None
    return 1e6 * sum(found) / c.steps
