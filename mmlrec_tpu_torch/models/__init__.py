"""Model registry of the port (mmlrec_tpu/models/__init__.py).

Eleven of the JAX registry's sixteen names are ported; STAR, APG, PepNet,
SNR-Trans and MSSM are ROADMAP A5.  ``pcg`` is MMoE, as in the JAX registry:
the PCGrad method itself is the trainer's (ROADMAP A6).
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from ..config import ExperimentConfig
from ..features import FeatureLayout
from ..utils.seeding import make_generator
from .aitm import AITM
from .base import RecModel
from .cross_stitch import CrossStitch
from .esmm import ESCM, ESMM
from .hmoe import HMOE
from .mlp import MLP
from .mmoe import MMOE
from .ple import PLE
from .sharedbottom import SharedBottom

MODEL_REGISTRY = {
    "mmoe": MMOE,
    "esmm": ESMM,
    "sharedbottom": SharedBottom,
    "ple": PLE,
    "pcg": MMOE,
    "mlp": MLP,
    "cross_stitch": CrossStitch,
    "aitm": AITM,
    "escm": ESCM,
    "escm_dr": ESCM,
    "hmoe": HMOE,
}
#: names of the JAX registry that the port does not build yet
UNPORTED = ("snr_trans", "mssm", "star", "apg", "pepnet")


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
    if name in UNPORTED:
        raise NotImplementedError(
            f"model {model_name!r} is not ported yet (ROADMAP A5); "
            f"ported: {sorted(MODEL_REGISTRY)}")
    if name not in MODEL_REGISTRY:
        raise KeyError(f"unknown model {model_name!r}; available: {sorted(MODEL_REGISTRY)}")
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain versions of the kernels on the CPU")
        device = "cuda"
    gen = generator if generator is not None else make_generator(0)
    model = MODEL_REGISTRY[name](layout, cfg, generator=gen, init_std=init_std)
    return model.to(device).eval()


__all__ = ["AITM", "CrossStitch", "ESCM", "ESMM", "HMOE", "MLP", "MMOE", "MODEL_REGISTRY",
           "PLE", "RecModel", "SharedBottom", "UNPORTED", "get_model"]
