"""Multi-process helpers (the port of ``mmlrec_tpu/parallel/multihost.py``).

In JAX one process drives every device of a host and ``jax.distributed``
joins hosts; here every rank is a process of its own, so the process group
these helpers set up is what any mesh stands on, on one host or several.
Each process joins the group (``initialize_distributed``), builds the same
mesh (``create_mesh``) and feeds its local shard of each global batch
(``host_local_batch_to_global``); the trainer's collectives do the rest.
``spawn_ranks`` starts such processes on one host, one a card.
"""

from __future__ import annotations

import os
import queue
import socket
from typing import Any, Callable, Dict, Optional, Sequence

import torch
import torch.distributed as dist

from .mesh import all_gather, data_group


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    backend: Optional[str] = None,
) -> None:
    """Join the process group: ``init_process_group`` at
    ``tcp://<coordinator_address>`` (``host:port``) as rank ``process_id``
    of ``num_processes``, or from the environment torchrun sets when no
    address is given.  ``backend``: NCCL when there is a card, else gloo.
    A no-op for one process, and when the group exists (multihost.py:27-39)."""
    if dist.is_initialized():
        return
    if num_processes is None and coordinator_address is None:
        num_processes = int(os.environ.get("WORLD_SIZE", "1"))
    if num_processes is None or num_processes <= 1:
        return
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    if coordinator_address is None:
        dist.init_process_group(backend, init_method="env://")
    else:
        dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                                world_size=num_processes, rank=process_id)


def host_local_batch_to_global(batch: Sequence, mesh, device=None,
                               global_batch_size: Optional[int] = None) -> tuple:
    """This process's local shard of a global batch (numpy arrays or
    tensors; None entries stay None) on ``device`` (the card by default),
    the rank's part of the batch the trainer's step takes.  One all-gather
    of the shards' row counts checks that they are equal, and add up to
    ``global_batch_size`` when it is given: the global batch is then the
    shards in rank order."""
    dev = torch.device(device or "cuda")
    dp = data_group(mesh)
    out = tuple(None if x is None else torch.as_tensor(x).to(dev) for x in batch)
    rows = next((len(x) for x in out if x is not None and x.dim()), 0)
    coll = torch.device("cpu") if dist.get_backend(dp.group) == "gloo" else dev
    counts = torch.zeros(dp.world, dtype=torch.int64, device=coll)
    all_gather(counts, torch.tensor([rows], dtype=torch.int64, device=coll), dp.group)
    counts = counts.tolist()
    if len(set(counts)) != 1:
        raise ValueError(f"the processes' local batches differ in rows: {counts}")
    if global_batch_size is not None and sum(counts) != global_batch_size:
        raise ValueError(f"the local batches add up to {sum(counts)} rows, the global "
                         f"batch has {global_batch_size}")
    for x in out:
        if x is not None and x.dim() and len(x) != rows:
            raise ValueError(f"a local batch entry has {len(x)} rows, another {rows}")
    return out


def local_batch_size(global_batch_size: int) -> int:
    """This process's share of a global batch."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    return global_batch_size // world


def free_port() -> int:
    """A TCP port on localhost that nothing listens on, for the group's
    coordinator."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_entry(work: Callable, payload: Any, rank: int, world: int, port: int,
                cuda: bool, results) -> None:
    """One rank of ``spawn_ranks``: join the group, run ``work(payload,
    rank, world)`` and send (rank, its outcome, error or None) back."""
    try:
        if cuda:
            torch.cuda.set_device(rank)
        initialize_distributed(f"localhost:{port}", world, rank,
                               backend="nccl" if cuda else "gloo")
        results.put((rank, work(payload, rank, world), None))
    except Exception as e:  # reported by the parent, which raises it
        results.put((rank, None, f"{type(e).__name__}: {e}"))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_ranks(work: Callable, payload: Any, world: int, cuda: bool, label: str) -> Any:
    """Start ``world`` processes on this host, rank r on card r over NCCL
    (``cuda``) or over gloo on the CPU, each running ``work(payload, rank,
    world)`` (a module-level function, since the processes are spawned),
    and wait for them.  Returns rank 0's outcome; raises RuntimeError,
    prefixed with ``label``, with the first failure a rank reports or when
    a rank ends without a report."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_entry, args=(work, payload, rank, world, port, cuda,
                                                   results))
             for rank in range(world)]
    for p in procs:
        p.start()
    reports: Dict[int, Any] = {}
    try:
        while len(reports) < world:  # drained before any join
            try:
                rank, out, error = results.get(timeout=1.0)
            except queue.Empty:
                lost = [r for r, p in enumerate(procs) if p.exitcode is not None
                        and r not in reports]
                if lost:
                    raise RuntimeError(f"{label}: rank(s) {lost} ended without "
                                       "a report") from None
                continue
            reports[rank] = out
            if error is not None:
                raise RuntimeError(f"{label}: rank {rank} failed: {error}")
    finally:
        for p in procs:
            p.join(timeout=0 if len(reports) < world else None)
            if p.is_alive():
                p.terminate()
                p.join()
    return reports[0]
