"""Device ms a training step: the union of the device's operations over
the traced window (the fit's validation, where the configuration has it,
included) over the window's steps."""

from portbench.metrics import layers

UNIT, LAYER, MOVES, SOURCE = "ms", layers.STEP, "train_examples_per_s", "device_trace"


def read(c):
    if getattr(c, "steps", None) is None:
        return None
    return 1e3 * c.trace.busy_s() / c.steps
