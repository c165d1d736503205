"""Bytes and operations of the logical operations that the port's
hand-written kernels run, counted from each operation's shapes (each input
byte read once, each output byte written once, distinct table rows only),
not from the kernel that runs it: the same work reads the same whatever
implements it.

A family's module ``arith/families/<model name>.py`` lists which of them
its training step and its forward run, with which shapes, and the
floating-point work of its forward beyond its matmuls.
"""

from __future__ import annotations

import importlib
from typing import Dict, List, Tuple

from ..reference.dims import Dims
from ..reference.model import family
from .peaks import least_seconds

Op = Tuple[str, float, float]  # (logical operation, bytes, flops)


def embed_concat(rows: int, d: Dims, distinct: float) -> Op:
    """The DNN input of ``rows`` examples: their ids, the ``distinct``
    table rows they name, the dense block in; the concatenation out."""
    width = d.n_sparse * d.emb + d.n_dense
    nbytes = 4 * (rows * d.n_sparse + distinct * d.emb + rows * d.n_dense + rows * width)
    return "embed_concat", nbytes, 0.0


def expert_mix(rows: int, tasks: int, experts: int, width: int) -> Op:
    """Per task a softmax over the experts' logits mixing their outputs."""
    nbytes = 4 * (rows * tasks * experts + rows * experts * width + rows * tasks * width)
    return "expert_mix", nbytes, rows * tasks * experts * (2.0 * width + 4.0)


def multihead_score(rows: int, tasks: int, hidden: int) -> Op:
    """Per task the tower's last hidden layer . the final weights, plus the
    bias, through the sigmoid."""
    nbytes = 4 * (rows * tasks * hidden + tasks * hidden + tasks + rows * tasks)
    return "multihead_score", nbytes, rows * tasks * (2.0 * hidden + 4.0)


def row_op(name: str, distinct: float, d: Dims) -> Op:
    """A gather or a write of the step's ``distinct`` logical table rows
    with their two Adam moments: the ids, and each row of the table and
    of both moments once in and once out."""
    per_row = 4 + 2 * (d.emb * 4 + 2 * d.emb * d.moment_bytes)
    return name, distinct * per_row, 0.0


def forward_matmul_flops(d: Dims) -> float:
    """Multiply-adds x 2 of one example's forward: every kernel of the
    family's parameters once (a stacked kernel [K, in, out] once per
    member), plus the family's own mixing work."""
    flops = 0.0
    for name, shape in family(d.model_name).param_shapes(d).items():
        if name.endswith("kernel"):
            n = 1
            for s in shape:
                n *= s
            flops += 2.0 * n
    return flops + _family(d).extra_flops(d)


def train_flops_per_example(d: Dims) -> float:
    """The forward's matmuls and the backward's two per matmul."""
    return 3.0 * forward_matmul_flops(d)


def _family(d: Dims):
    return importlib.import_module(f"portbench.arith.families.{d.model_name}")


def step_ops(d: Dims, batch: int, distinct_rows: float) -> List[Op]:
    """The logical operations of one two-phase training step."""
    return (_family(d).fused_ops(d, batch)
            + [row_op("row_gather", distinct_rows, d), row_op("row_write", distinct_rows, d)])


def forward_ops(d: Dims, rows: int, distinct_rows: float) -> List[Op]:
    """The logical operations of one forward (validation, serving)."""
    return [embed_concat(rows, d, distinct_rows)] + _family(d).fused_ops(d, rows)


def roofline_share(ops: List[Op], seconds: Dict[str, float]) -> float:
    """Sum of the least times of ``ops`` over the device seconds measured
    for them, over the operations a kernel of the trace ran (an operation
    no hand-written kernel ran is left out on both sides); None when none
    ran."""
    least: Dict[str, float] = {}
    for name, nbytes, flops in ops:
        least[name] = least.get(name, 0.0) + least_seconds(nbytes, flops)
    ran = [k for k in least if seconds.get(k, 0.0) > 0.0]
    if not ran:
        return None
    return 100.0 * sum(least[k] for k in ran) / sum(seconds[k] for k in ran)


def kernel_names() -> Dict[str, str]:
    """The hand-written kernels' function names -> their logical operation
    (``arith/kernels.json``)."""
    import json
    import os

    with open(os.path.join(os.path.dirname(__file__), "kernels.json")) as f:
        return json.load(f)["kernels"]


def row_op_names():
    import json
    import os

    with open(os.path.join(os.path.dirname(__file__), "kernels.json")) as f:
        return json.load(f)["row_ops"]
