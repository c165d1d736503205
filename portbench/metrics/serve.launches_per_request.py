"""Kernel launches on the device a request, over the traced serving
window."""

from portbench.metrics import layers

UNIT, LAYER, MOVES, SOURCE = "count", layers.SERVE, "serve_p95_ms", "device_trace"


def read(c):
    if not getattr(c, "requests", None):
        return None
    return c.trace.kernel_launches() / c.requests
