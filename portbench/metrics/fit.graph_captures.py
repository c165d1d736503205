"""CUDA graphs the window's fit captured (``fit_timing``'s ``captures``
summed): the training step and the eval forward once each; more is a
recapture, the gather route's lists having outgrown their buffers."""

from portbench.metrics import layers, program

UNIT, LAYER, SOURCE = "count", layers.FIT, "program_counter"
MOVES = "host_bound.train_examples_per_s"


def read(c):
    return program.timing_sum(c, "captures")
