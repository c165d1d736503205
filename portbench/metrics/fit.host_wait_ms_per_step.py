"""Host ms a step the fit waits for an epoch's indices and host metadata
(``Trainer.fit_timing``'s ``prep_s``: the wait for the metadata worker),
over the window's epochs."""

from portbench.metrics import layers

UNIT, LAYER, SOURCE = "ms", layers.FIT, "program_counter"
MOVES = "host_bound.train_examples_per_s"


def read(c):
    timing = getattr(c, "fit_timing", None)
    if not timing:
        return None
    return 1e3 * sum(t["prep_s"] for t in timing) / c.steps
