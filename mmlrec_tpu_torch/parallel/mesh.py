"""Device mesh and the parallel fit on ``torch.distributed`` (the port of
``mmlrec_tpu/parallel/mesh.py``).

The JAX package runs one process over a ``(data, model)`` mesh: ``jit``
partitions the global program (GSPMD), so whatever couples the examples of
a batch stays global by construction.  Here a mesh is one process per rank
(a ``torch.distributed`` process group, ``DeviceMesh`` with the dims
``("data", "model")``), each rank runs the step on its rows of the global
batch, and every computation that couples the rows is made global by hand:
the gradients (one all-reduce SUM a step over ``data``, ``Trainer``),
BatchNorm and DomainBatchNorm statistics (``ops.layers.all_reduce_sum``),
dropout masks (drawn for the global batch, ``ops.layers.dropout``), the
per-task gradients and CKA's Gram terms, the staged dataset's row fetch
(``distributed_take``) and the eval predictions (an all-gather).

With ``model > 1`` the fused embedding table is row-sharded over the
``model`` dimension (``shard_variables``, ``TableShard``): the rank of
model index m holds rows ``[m R / M, (m + 1) R / M)`` of its R physical
rows, and ranks that share a data index compute the same dense work on the
same rows.  The table's exchange and updates are
``parallel/shard_embedding.py`` and ``parallel/explicit_step.py``.
``create_mesh`` takes any shape whose product is the world size.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

AXES = ("data", "model")


class DataGroup(NamedTuple):
    """The mesh's ``data`` dimension as this rank sees it."""

    group: object  # the torch.distributed process group of the dimension
    rank: int
    world: int


def _collective(new: str, old: str):
    """``torch.distributed.<new>``, or the older name of the same
    collective where this torch has no ``<new>`` yet."""
    return getattr(dist, new, None) or getattr(dist, old)


def reduce_scatter(out: torch.Tensor, inp: torch.Tensor, group) -> None:
    """``out`` = this rank's slice (rows ``[r * len(out), ...)``) of the
    sum of every rank's ``inp``."""
    _collective("reduce_scatter_single", "reduce_scatter_tensor")(
        out, inp, op=dist.ReduceOp.SUM, group=group)


def all_gather(out: torch.Tensor, inp: torch.Tensor, group) -> None:
    """``out`` = every rank's ``inp`` concatenated along dim 0, in rank order."""
    _collective("all_gather_single", "all_gather_into_tensor")(out, inp, group=group)


def create_mesh(data: Optional[int] = None, model: int = 1, *, device: str = "cuda"):
    """A ``DeviceMesh`` of shape ``(data, model)`` over the process group's
    ranks (mesh.py:31-43); ``data`` defaults to world // model.  Raises
    ValueError when ``data * model`` differs from the world size, as the
    JAX mesh does for the devices it sees.

    ``device="cuda"`` (the default) raises without a card; a mesh on the
    card takes NCCL, one rank per card, so it also raises ValueError when
    the world exceeds the cards.  ``device="cpu"`` takes gloo, whose
    collectives also move CUDA tensors (two ranks on one card).  Without a
    process group a group of one process is made, the mesh of a one-device
    host."""
    from torch.distributed.device_mesh import init_device_mesh

    kind = torch.device(device).type
    if kind == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' for a gloo mesh")
    if not dist.is_initialized():
        if kind == "cuda":  # the card the communicator binds to
            torch.cuda.set_device(torch.cuda.current_device())
        dist.init_process_group("nccl" if kind == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0, world_size=1)
    n = dist.get_world_size()
    if data is None:
        data = n // model
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} processes")
    if kind == "cuda" and n > torch.cuda.device_count():
        raise ValueError(f"mesh {data}x{model} on the card needs {n} cards (NCCL takes one "
                         f"rank a card), {torch.cuda.device_count()} are visible")
    return init_device_mesh(kind, (data, model), mesh_dim_names=AXES)


def data_group(mesh) -> DataGroup:
    """This rank's view of the mesh's ``data`` dimension."""
    return DataGroup(mesh.get_group("data"), mesh.get_local_rank("data"),
                     mesh.size(mesh.mesh_dim_names.index("data")))


def model_size(mesh) -> int:
    return mesh.size(mesh.mesh_dim_names.index("model"))


class TableShard(NamedTuple):
    """The fused table's row shard that this rank holds: model index
    ``index`` of ``count`` shards, and the ``model`` process group the
    lookups all-reduce over."""

    index: int
    count: int
    group: object


def table_shard(mesh) -> TableShard:
    """This rank's view of the mesh's ``model`` dimension as a table shard."""
    return TableShard(mesh.get_local_rank("model"), model_size(mesh), mesh.get_group("model"))


def _is_embedding_table(name: str) -> bool:
    return any(k == "table" or k.startswith("table_") for k in name.split("."))


def variable_shardings(variables: Dict[str, torch.Tensor], mesh) -> Dict[str, tuple]:
    """The placement of each tensor by name, as a PartitionSpec would give
    it (mesh.py:51-61): ``("model", None, ...)`` for an embedding table
    whose rows divide by the ``model`` size when it is above 1, ``()``
    (replicated) for everything else."""
    n_model = model_size(mesh)

    def spec(name, t):
        if (n_model > 1 and _is_embedding_table(name) and t.dim() >= 1
                and t.shape[0] % n_model == 0):
            return ("model",) + (None,) * (t.dim() - 1)
        return ()

    return {k: spec(k, t) for k, t in variables.items()}


def shard_variables(variables: Dict[str, torch.Tensor], mesh) -> Dict[str, torch.Tensor]:
    """Place ``variables`` on the mesh and return them.  Every rank draws
    them from the same seed; they are then made bitwise equal by one
    broadcast from rank 0 of their bytes (every dtype at once), in place.
    With ``model > 1`` the fused table (``embeddings.fused.table``), row-
    sharded by ``variable_shardings``, comes back as this rank's rows, a
    copy (mesh.py:64-68); every other tensor stays replicated, the other
    embedding tables included (the same values as their row shards would
    hold)."""
    tensors = [t for t in variables.values() if t.numel()]
    if dist.get_world_size() > 1 and tensors:
        with torch.no_grad():
            flat = torch.cat([t.detach().reshape(-1).view(torch.uint8) for t in tensors])
            dist.broadcast(flat, src=0)
            off = 0
            for t in tensors:
                nbytes = t.numel() * t.element_size()
                t.copy_(flat[off:off + nbytes].view(t.dtype).view(t.shape))
                off += nbytes
    specs = variable_shardings(variables, mesh)
    shard = table_shard(mesh)
    out = dict(variables)
    for k, t in variables.items():
        if specs[k] and k.endswith("fused.table"):
            rows = t.shape[0] // shard.count
            out[k] = t.detach()[shard.index * rows:(shard.index + 1) * rows].clone()
    return out


def distributed_take(local: torch.Tensor, idx: torch.Tensor, dp: DataGroup) -> torch.Tensor:
    """Rows ``idx`` [B] (global row numbers, the same on every rank, B
    divisible by the world) of a dataset whose rank t holds the contiguous
    rows ``[t * N / n, (t + 1) * N / n)`` as ``local``; returns this rank's
    slice of the batch, rows ``[r * B / n, (r + 1) * B / n)``
    (mesh.py:71-113).

    Each rank takes the batch rows it owns (zeros elsewhere) and one
    reduce-scatter (sum) both adds the one-owner contributions and routes
    batch slice t to rank t: B * D * (n - 1) / n elements on the wire a
    rank.  An integer ``local`` (the trainer stages the float columns as
    the int32 of their bits) makes every sum exact, so the result is
    bitwise ``index_select`` on the whole dataset."""
    rows_local = local.shape[0]
    rel = idx - dp.rank * rows_local
    owned = (rel >= 0) & (rel < rows_local)
    rows = local.index_select(0, torch.clamp(rel, 0, rows_local - 1))
    contrib = torch.where(owned[:, None], rows, torch.zeros((), dtype=rows.dtype,
                                                             device=rows.device))
    out = torch.empty((idx.shape[0] // dp.world,) + tuple(local.shape[1:]), dtype=local.dtype,
                      device=local.device)
    reduce_scatter(out, contrib, dp.group)
    return out


def batch_rows(n_rows: int, dp: DataGroup) -> Optional[slice]:
    """This rank's rows of a global batch of ``n_rows``: its slice when the
    batch divides by the world, None (the whole batch, replicated)
    otherwise (mesh.py:116-129)."""
    if n_rows % dp.world:
        return None
    per = n_rows // dp.world
    return slice(dp.rank * per, (dp.rank + 1) * per)


def shard_batch(batch: Sequence, mesh) -> tuple:
    """The leading (batch) axis of each entry split over the ``data``
    dimension: this rank's rows when the batch divides by its size, the
    whole batch (replicated, every rank computing all of it) otherwise;
    None entries stay None.  Arrays and tensors keep their kind and device."""
    dp = data_group(mesh)

    def part(x):
        if x is None or np.ndim(x) == 0:
            return x
        rows = batch_rows(len(x), dp)
        return x if rows is None else x[rows]

    return tuple(part(x) for x in batch)
