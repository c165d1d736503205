"""Data containers of the port (the in-memory part of ``mmlrec_tpu/data.py``).

``CTRDataset`` holds a train/test split as the CLI consumes it.  The CSV
pipeline (``ctrdataset``: reading the reference datasets, label encoding,
scaling, the native CSV loader) is ROADMAP A10b; the port's CLI trains on
synthetic data of a config's schema (``main.py --synthetic``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from .features import FeatureLayout


def get_test_mask(domain_values, mask_values, num_domains) -> np.ndarray:
    """(reference utils/data_utils.py:96-100)"""
    dv = np.asarray(domain_values).reshape(-1, 1)
    mv = np.asarray(mask_values).reshape(1, -1)
    return (dv == mv).astype(np.float32)


@dataclasses.dataclass
class CTRDataset:
    train_input: Dict[str, np.ndarray]
    test_input: Dict[str, np.ndarray]
    y_train: np.ndarray  # [N, num_label_columns] in label_columns order
    y_test: np.ndarray
    test_mask: Optional[np.ndarray]
    feature_columns: List  # SparseFeat / DenseFeat list
    layout: FeatureLayout
