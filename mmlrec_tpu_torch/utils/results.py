"""The results CSV with the reference's row schema (reference
main.py:128-178; the port of mmlrec_tpu/utils/results.py): one row per
(dataset, regime, model, seed) with ``type``, ``log_loss_i`` / ``auc_i`` per
head, ``total_auc`` for msl and mtmsl, and ``examples_per_s``.

Written with the ``csv`` module (the JAX package writes it through pandas,
which the port does not need): a header when the file is new, then one line
per row, the values as ``str`` gives them.
"""

from __future__ import annotations

import csv
import os
from typing import Dict


def append_result_row(path: str, row: Dict) -> None:
    if not path:
        return
    new = not os.path.exists(path)
    if new:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "a", newline="") as f:
        writer = csv.writer(f)
        if new:
            writer.writerow(list(row))
        writer.writerow(list(row.values()))
