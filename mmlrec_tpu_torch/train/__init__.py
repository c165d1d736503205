"""Training of the port (mmlrec_tpu/train): the dense-table fit and the
two-phase SparseAdam step, validation on the host or the device, and
checkpoints."""

from .trainer import Trainer, resolve_table_container

__all__ = ["Trainer", "resolve_table_container"]
