"""Host us a request inside the program's ``mmlrec.serve.copy_in`` span
(the packed arrays copied to the device), over the traced serving
window."""

from portbench.metrics import layers, program

UNIT, LAYER, SOURCE = "us", layers.SERVE, "program_counter"
MOVES = "serve_p95_ms"


def read(c):
    if not getattr(c, "requests", None):
        return None
    seconds = program.span_s(c, "mmlrec.serve.copy_in")
    return None if seconds is None else 1e6 * seconds / c.requests
