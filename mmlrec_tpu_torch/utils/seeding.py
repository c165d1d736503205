"""Seeding (the port of mmlrec_tpu/utils/seeding.py).

PyTorch parameter init takes an explicit ``torch.Generator`` where the JAX
package threads a PRNGKey.  Its draws differ from ``jax.random`` for the
same seed: cross-framework tests make their inputs with numpy.
"""

from __future__ import annotations

import torch


def make_generator(seed: int) -> torch.Generator:
    """A CPU generator for parameter init (weights are drawn on the host and
    then moved to the model's device)."""
    return torch.Generator().manual_seed(int(seed))
