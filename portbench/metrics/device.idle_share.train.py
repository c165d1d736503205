"""The share of the traced training window in which no operation ran on
the device."""

from portbench.metrics import layers

UNIT, LAYER, MOVES, SOURCE = "%", layers.DEVICE, "train_examples_per_s", "device_trace"


def read(c):
    if getattr(c, "steps", None) is None:
        return None
    return 100.0 * (1.0 - c.trace.busy_s() / c.trace.window_s)
