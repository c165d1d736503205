"""Host ms a step inside the program's ``mmlrec.fit.stage`` span (once a
fit: the dataset staged on the device, block metadata built and
uploaded) in the traced window."""

from portbench.metrics import layers, program

UNIT, LAYER, SOURCE = "ms", layers.FIT, "program_counter"
MOVES = "train_examples_per_s"


def read(c):
    if getattr(c, "steps", None) is None:
        return None
    seconds = program.span_s(c, "mmlrec.fit.stage")
    return None if seconds is None else 1e3 * seconds / c.steps
