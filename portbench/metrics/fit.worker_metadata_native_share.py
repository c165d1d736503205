"""Share of the window's epochs whose host step metadata the program's
native pass built (``fit_timing``'s ``meta_native``, 1.0 or 0 an epoch),
in %."""

from portbench.metrics import layers, program

UNIT, LAYER, SOURCE = "%", layers.FIT, "program_counter"
MOVES = "host_bound.train_examples_per_s"


def read(c):
    native = program.timing_sum(c, "meta_native")
    return None if native is None else 100.0 * native / len(c.fit_timing)
