"""What the program records, as the per-layer metrics read it: a key of
``Trainer.fit_timing`` summed over the window's epochs, and the seconds of
one of the program's spans (``mmlrec_tpu_torch/utils/spans.py``) inside the
traced window.  Each gives None where the program records no such key or
span, never 0."""

import numpy as np


def timing_sum(c, key):
    """``key`` of ``fit_timing`` summed over the window's epochs."""
    timing = getattr(c, "fit_timing", None)
    if not timing or key not in timing[0]:
        return None
    return sum(t[key] for t in timing)


def span_s(c, name):
    """Seconds of the host ranges named ``name`` inside the traced window."""
    trace = getattr(c, "trace", None)
    if trace is None:
        return None
    sel = np.fromiter((n == name for n in trace.host_names), bool, len(trace.host_names))
    if not sel.any():
        return None
    lo, hi = trace.window
    inside = np.minimum(trace.host_ends[sel], hi) - np.maximum(trace.host_starts[sel], lo)
    return float(np.clip(inside, 0, None).sum()) / 1e9
