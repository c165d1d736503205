"""Device us a training step in the deterministic accumulate of the
table's segment sums: ``index_put_(accumulate=True)``'s
``indexing_backward_kernel*`` on the card (``ops/kernels.py::
scatter_add_rows``, called by ``train/sparse_embedding.py::_segment_sum``),
over the window's steps."""

from portbench.metrics import layers

UNIT, LAYER, MOVES, SOURCE = "us", layers.TABLE, "train_examples_per_s", "device_trace"
KERNEL = "indexing_backward_kernel"


def read(c):
    if getattr(c, "steps", None) is None:
        return None
    found = [s for name, s in c.trace.seconds.items() if KERNEL in name]
    if not found:
        return None
    return 1e6 * sum(found) / c.steps
