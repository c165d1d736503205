"""Seeding (the port of mmlrec_tpu/utils/seeding.py).

PyTorch parameter init takes an explicit ``torch.Generator`` where the JAX
package threads a PRNGKey.  Its draws differ from ``jax.random`` for the
same seed: cross-framework tests make their inputs with numpy.
"""

from __future__ import annotations

import torch


def make_generator(seed: int, device: str = "cpu") -> torch.Generator:
    """A generator for parameter init.  Weights are drawn on its device: the
    host by default (then moved to the model's device), or the card, where a
    table of several GB is drawn in place."""
    return torch.Generator(device=device).manual_seed(int(seed))
