"""Model registry of the port (mmlrec_tpu/models/__init__.py).

Only MMoE is ported so far; the other families are ROADMAP A5.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from ..config import ExperimentConfig
from ..features import FeatureLayout
from ..utils.seeding import make_generator
from .base import RecModel
from .mmoe import MMOE

MODEL_REGISTRY = {"mmoe": MMOE}


def get_model(
    model_name: str,
    layout: FeatureLayout,
    cfg: ExperimentConfig,
    init_std: float = 1e-4,
    *,
    generator: Optional[torch.Generator] = None,
    device: Union[str, torch.device, None] = None,
) -> RecModel:
    """Build ``model_name`` with weights drawn from ``generator`` (a CPU
    generator of seed 0 by default; a CUDA generator draws on the card) and
    place it on ``device``, in eval mode (``train.Trainer`` switches it to
    training for its steps).  ``device=None`` means the card, and raises
    when there is none rather than run on the CPU quietly."""
    name = model_name.lower()
    if name not in MODEL_REGISTRY:
        raise NotImplementedError(
            f"model {model_name!r} is not ported yet (ROADMAP A5); "
            f"ported: {sorted(MODEL_REGISTRY)}")
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain versions of the kernels on the CPU")
        device = "cuda"
    gen = generator if generator is not None else make_generator(0)
    model = MODEL_REGISTRY[name](layout, cfg, generator=gen, init_std=init_std)
    return model.to(device).eval()


__all__ = ["MMOE", "MODEL_REGISTRY", "RecModel", "get_model"]
