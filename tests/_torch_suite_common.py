"""Helpers of the port's suite tests (tests/test_torch_seed_suite.py,
tests/test_torch_sweep.py): the JAX tests' sizes and the numpy init that
conditions a stacked-vs-solo comparison (test_torch_seed_suite.py's module
docstring says why)."""

import numpy as np
import torch

SIZES = dict(emb=4, n_sparse=4, n_dense=2, hidden=(16, 8), tower=(8,), gate=(8,), batch_size=64)
STD = 0.3


def numpy_init(model, seed):
    """Every parameter of ``model`` from numpy normal(0, STD), by seed."""
    rng = np.random.default_rng(seed + 100)
    with torch.no_grad():
        for _, p in model.named_parameters():
            p.copy_(torch.from_numpy(rng.normal(0, STD, p.shape).astype(np.float32)))
    return model
