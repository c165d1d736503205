"""Host ms a step spent pinning the epochs' indices and metadata and
enqueueing their copies to the device (``fit_timing``'s ``upload_s``:
``upload_async``, on the metadata worker or inline), over the window's
epochs."""

from portbench.metrics import layers, program

UNIT, LAYER, SOURCE = "ms", layers.FIT, "program_counter"
MOVES = "host_bound.train_examples_per_s"


def read(c):
    seconds = program.timing_sum(c, "upload_s")
    return None if seconds is None else 1e3 * seconds / c.steps
