"""``table_update.segment_sum_us_per_step`` in a host-bound training cell, where it moves
``host_bound.train_examples_per_s``: the same reader."""

from portbench.run import metric_module

_BASE = metric_module("table_update.segment_sum_us_per_step")
UNIT, LAYER, SOURCE, read = _BASE.UNIT, _BASE.LAYER, _BASE.SOURCE, _BASE.read
MOVES = "host_bound.train_examples_per_s"
