"""Data helpers of the port.

Only the domain test mask is here so far; the CSV pipeline of
``mmlrec_tpu/data.py`` is still to be ported (ROADMAP A10).
"""

from __future__ import annotations

import numpy as np


def get_test_mask(domain_values, mask_values, num_domains) -> np.ndarray:
    """(reference utils/data_utils.py:96-100)"""
    dv = np.asarray(domain_values).reshape(-1, 1)
    mv = np.asarray(mask_values).reshape(1, -1)
    return (dv == mv).astype(np.float32)
