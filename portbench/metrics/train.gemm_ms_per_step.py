"""Device ms a training step in the matrix products: the kernels of cuBLAS
and CUTLASS (the experts', gates' and towers' einsums of ``ops/layers.py``,
forward and backward) by their names as the profiler shows them, over the
window's steps."""

import re

from portbench.metrics import layers

UNIT, LAYER, MOVES, SOURCE = "ms", layers.STEP, "train_examples_per_s", "device_trace"
#: a matrix product's kernel: cuBLAS's and CUTLASS's gemm and gemv kernels
#: (``sm90_xmma_gemm_*``, ``cutlass_80_simt_sgemm_*``, ``gemmSN_*``,
#: ``gemv2T_kernel``) and cuBLAS's split-K reduction
GEMM = re.compile(r"gemm|gemv|splitKreduce", re.IGNORECASE)


def read(c):
    if getattr(c, "steps", None) is None:
        return None
    found = [s for name, s in c.trace.seconds.items() if GEMM.search(name)]
    if not found:
        return None
    return 1e3 * sum(found) / c.steps
