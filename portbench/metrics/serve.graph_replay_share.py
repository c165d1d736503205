"""The share of the traced serving window's requests that the program
served by replaying a captured CUDA graph: its ``mmlrec.serve.replay``
ranges that start inside the window, over the window's requests."""

import numpy as np

from portbench.metrics import layers

UNIT, LAYER, SOURCE = "%", layers.SERVE, "program_counter"
MOVES = "serve_p95_ms"
SPAN = "mmlrec.serve.replay"
#: read on the card only: the port captures no graph on the CPU
CARD_ONLY = True


def read(c):
    trace = getattr(c, "trace", None)
    if trace is None or not getattr(c, "requests", None):
        return None
    sel = np.fromiter((n == SPAN for n in trace.host_names), bool, len(trace.host_names))
    if not sel.any():
        return None
    lo, hi = trace.window
    starts = trace.host_starts[sel]
    return 100.0 * int(((starts >= lo) & (starts < hi)).sum()) / c.requests
