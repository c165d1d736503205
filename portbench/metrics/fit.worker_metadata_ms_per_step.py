"""Host ms a step spent building the epochs' step metadata (``fit_timing``'s
``meta_s``: ``step_metadata``, ``encode_meta`` and ``upload_form`` of the
epoch each prep serves, on the metadata worker or inline), over the
window's epochs."""

from portbench.metrics import layers, program

UNIT, LAYER, SOURCE = "ms", layers.FIT, "program_counter"
MOVES = "host_bound.train_examples_per_s"


def read(c):
    seconds = program.timing_sum(c, "meta_s")
    return None if seconds is None else 1e3 * seconds / c.steps
