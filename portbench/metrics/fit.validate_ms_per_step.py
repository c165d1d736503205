"""Host ms a step spent on the epochs' validation (``fit_timing``'s
``val_s``: the eval set staged on the first epoch, the eval program, the
metrics read as host floats), over the window's epochs."""

from portbench.metrics import layers, program

UNIT, LAYER, SOURCE = "ms", layers.FIT, "program_counter"
MOVES = "host_bound.train_examples_per_s"


def read(c):
    seconds = program.timing_sum(c, "val_s")
    return None if seconds is None else 1e3 * seconds / c.steps
