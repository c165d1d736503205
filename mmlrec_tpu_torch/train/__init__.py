"""Training of the port (mmlrec_tpu/train): the two-phase SparseAdam step."""

from .trainer import Trainer

__all__ = ["Trainer"]
