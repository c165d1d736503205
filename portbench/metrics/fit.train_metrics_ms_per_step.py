"""Host ms a step spent on the epochs' train metrics (``fit_timing``'s
``metrics_s``: the probabilities to the host and ``regime_eval``), over
the window's epochs."""

from portbench.metrics import layers, program

UNIT, LAYER, SOURCE = "ms", layers.FIT, "program_counter"
MOVES = "host_bound.train_examples_per_s"


def read(c):
    seconds = program.timing_sum(c, "metrics_s")
    return None if seconds is None else 1e3 * seconds / c.steps
