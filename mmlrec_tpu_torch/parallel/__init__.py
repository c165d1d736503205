"""Data parallelism on torch.distributed (the port of mmlrec_tpu/parallel):
the mesh, the batch and variable placement, and the multi-process helpers
(``parallel.multihost``)."""

from .mesh import create_mesh, shard_batch, shard_variables, variable_shardings

__all__ = ["create_mesh", "shard_batch", "shard_variables", "variable_shardings"]
