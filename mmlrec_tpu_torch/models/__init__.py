"""Model registry of the port (mmlrec_tpu/models/__init__.py).

All sixteen names of the JAX registry are ported.  ``pcg`` is MMoE, as in
the JAX registry: the PCGrad method itself is the trainer's
(``train/pcgrad.py``).
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from ..config import ExperimentConfig
from ..features import FeatureLayout
from ..utils.seeding import make_generator
from .aitm import AITM
from .apg import APG
from .base import RecModel
from .cross_stitch import CrossStitch
from .esmm import ESCM, ESMM
from .hmoe import HMOE
from .mlp import MLP
from .mmoe import MMOE
from .pepnet import PepNet
from .ple import PLE
from .sharedbottom import SharedBottom
from .snr import MSSM, SNRTrans
from .star import STAR

MODEL_REGISTRY = {
    "mmoe": MMOE,
    "esmm": ESMM,
    "sharedbottom": SharedBottom,
    "ple": PLE,
    "snr_trans": SNRTrans,
    "mssm": MSSM,
    "star": STAR,
    "pcg": MMOE,
    "apg": APG,
    "mlp": MLP,
    "cross_stitch": CrossStitch,
    "aitm": AITM,
    "escm": ESCM,
    "escm_dr": ESCM,
    "hmoe": HMOE,
    "pepnet": PepNet,
}
#: names of the JAX registry that the port does not build: none
UNPORTED = ()


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


__all__ = ["AITM", "APG", "CrossStitch", "ESCM", "ESMM", "HMOE", "MLP", "MMOE", "MODEL_REGISTRY",
           "MSSM", "PLE", "PepNet", "RecModel", "STAR", "SNRTrans", "SharedBottom", "UNPORTED",
           "get_model"]
