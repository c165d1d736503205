"""Seeding (the port of mmlrec_tpu/utils/seeding.py).

PyTorch parameter init takes an explicit ``torch.Generator`` where the JAX
package threads a PRNGKey.  Its draws differ from ``jax.random`` for the
same seed: cross-framework tests make their inputs with numpy.
"""

from __future__ import annotations

import os
import random

import numpy as np
import torch


def make_generator(seed: int, device: str = "cpu") -> torch.Generator:
    """A generator for parameter init.  Weights are drawn on its device: the
    host by default (then moved to the model's device), or the card, where a
    table of several GB is drawn in place."""
    return torch.Generator(device=device).manual_seed(int(seed))


def set_seed(seed: int, device=None) -> torch.Generator:
    """Pin the host streams (``random``, ``PYTHONHASHSEED``, numpy's global
    one; reference main.py:23-35) and return ``make_generator(seed)`` on
    ``device``: the card by default, which raises when there is none."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' for a CPU generator")
        device = "cuda"
    random.seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)
    np.random.seed(seed)
    return make_generator(seed, str(device))
