"""The two-phase step on a ``(data, model)`` mesh (the port of
``mmlrec_tpu/parallel/explicit_step.py``).

Every collective is placed by hand.  Per step (explicit_step.py:1-40):

1. the forward fetch: this rank's rows of the table for its rows of the
   batch, ``owned_gather``: one all-reduce over ``model``;
2. the dense gradients and the loss: one all-reduce over ``data``
   (``Trainer._reduce_grads``, the data-parallel step's);
3. the exchange: ``(flat_ids, row cotangents)`` of every data rank, one
   all-gather each over ``data`` (the ids' gather does not wait for the
   backward); with ``grad_exchange_chunks`` C > 1 the cotangents travel as
   C all-gathers of tiles issued at once (``async_op``), and the duplicate
   sum of tile c runs while the later tiles are on the wire;
4. the table's SparseAdam: owner-local on each rank's shard
   (``parallel/shard_embedding.py``), no collective.

The rows are injected as a leaf that requires gradient, as JAX's
``value_and_grad`` over ``rows``; the gathered ids are the global batch's
in its order (the batch is split contiguously over ``data``), so the
global dedup metadata applies as it is: the host's, built from the global
batch, or with ``device_metadata`` computed in the step from the gathered
ids.  The L2 penalty: the dense parameters' on data rank 0 alone, the
touched rows' term with this data rank's slice of ``rep``, so the data
ranks' totals add up to the one process's and no model rank adds its own.

The JAX trainer runs this body only with ``explicit_collective_embedding``;
without it GSPMD partitions the single-device two-phase step (the table
row-sharded, the scatter update).  The port has no partitioner: its mesh
runs this exchange on either path, with the plain sharded update
(``sharded_two_phase_sparse_adam``) where JAX's GSPMD path keeps its own,
and ``grad_exchange_chunks`` read on the explicit path only, as in JAX.
A batch that every rank computes whole (one that does not divide by
``data``) gathers nothing over ``data``.
"""

from __future__ import annotations

import warnings

import torch

from ..train.sparse_embedding import device_step_metadata
from .mesh import _collective, all_gather
from .shard_embedding import (
    owned_gather,
    sharded_two_phase_sparse_adam,
    sharded_two_phase_sparse_adam_folded,
    sharded_two_phase_sparse_adam_pallas,
)

_ROUTE = ("accperm", "resid_pos", "resid_slot", "gdup_pos", "gdup_tgt")


def _gathered(t: torch.Tensor, dp) -> torch.Tensor:
    out = t.new_empty((dp.world * t.shape[0],) + tuple(t.shape[1:]))
    all_gather(out, t.contiguous(), dp.group)
    return out


def _add_rows(acc: torch.Tensor, index: torch.Tensor, values: torch.Tensor) -> None:
    """``acc.at[index].add(values)`` in place, deterministic: one row after
    another in position order on the CPU; on the card the indices sorted
    and each target's values summed, then added."""
    if acc.device.type == "cpu":
        acc.index_add_(0, index.long(), values)
    else:
        acc.index_put_((index.long(),), values, accumulate=True)


def exchange_rows(g_rows: torch.Tensor, inv: torch.Tensor, dp, chunks: int = 1):
    """(row cotangents of the global batch; their duplicate sums, or None)
    from this rank's ``g_rows`` [k_loc, D]: one all-gather, or
    with ``chunks`` C > 1 the pipelined exchange (explicit_step.py:170-205):
    C tiled all-gathers of ``[k_loc / C, D]`` issued together, tile c's rows
    added at ``inv`` of their global positions (rank s's tile row j sits at
    ``s k_loc + c L + j``) as soon as it lands.  ``k_loc % C != 0`` warns
    and takes the single all-gather, as JAX does.  The pipelined exchange
    returns the sums in place of the rows, as JAX passes them on."""
    k_loc, dim = g_rows.shape
    if chunks > 1 and k_loc % chunks:
        warnings.warn(
            f"grad_exchange_chunks={chunks} ignored: the local row count k_loc={k_loc} "
            "(batch/shard x n_sparse) is not divisible by it; falling back to the single "
            f"all-gather.  Pick a divisor of {k_loc}.", stacklevel=2)
    if chunks <= 1 or k_loc % chunks:
        return _gathered(g_rows, dp), None
    L = k_loc // chunks
    gather = _collective("all_gather_single", "all_gather_into_tensor")
    tiles, works = [], []
    for c in range(chunks):
        buf = g_rows.new_empty((dp.world * L, dim))
        works.append(gather(buf, g_rows[c * L:(c + 1) * L].contiguous(), group=dp.group,
                            async_op=True))
        tiles.append(buf)
    g_sum = g_rows.new_zeros((dp.world * k_loc, dim))
    shard_pos = torch.arange(dp.world, device=g_rows.device)[:, None] * k_loc
    step = torch.arange(L, device=g_rows.device)[None, :]
    for c, (buf, work) in enumerate(zip(tiles, works)):
        work.wait()
        pos = (shard_pos + c * L + step).reshape(-1)
        _add_rows(g_sum, inv.index_select(0, pos), buf)
    return g_sum, g_sum


def mesh_two_phase_step(trainer, ids, dense, y, dmask, weight, meta=None):
    """One two-phase step of ``trainer`` on a mesh: ``ids``... are this
    rank's rows of the global batch, ``meta`` the global batch's host
    metadata (None with ``device_metadata``); returns (total loss, data
    loss, probs) as ``Trainer._train_step_two_phase`` does, the loss the
    global one."""
    from ..train.trainer import _grads

    shard, dp = trainer._table_shard, trainer._shard()
    table = trainer.table
    B, F = ids.shape[0], len(trainer.layout.sparse_slots)
    P, D = trainer._emb_pack_factor, trainer._emb_dim
    stacked = trainer.table_container == "stacked"
    k_loc = B * F
    with torch.no_grad():
        flat_local = (ids[:, :F] + trainer._fused_offsets[None, :]).reshape(-1)
        fwd = table[: table.shape[0] // 2] if stacked else table
        rows = owned_gather(fwd, flat_local, D, P, shard.index, shard.group)
        flat_all = _gathered(flat_local, dp) if dp is not None else flat_local
        if trainer.device_metadata:
            K = flat_all.shape[0]
            meta = device_step_metadata(flat_all, P, -(-K // 256) * 256,
                                        trainer._emb_phys_rows)
        elif meta is None:
            meta = trainer._flat_metadata(flat_all.cpu().numpy())
        inv, rep = meta[0], meta[1]
        rep_local = rep[dp.rank * k_loc:(dp.rank + 1) * k_loc] if dp is not None else rep
    rows = rows.view(B, F, D).requires_grad_(True)
    rest = trainer.rest_params()
    with torch.enable_grad():
        total, data_loss, probs = trainer._loss_terms_injected(
            rows, rep_local, ids, dense, y, dmask, weight)
        grads = _grads(total, [*rest.values(), rows])
    report = total.detach()
    if trainer._escm and dp is not None and dp.rank:
        report = torch.zeros_like(report)  # the global loss, counted by rank 0
    g_rest, report = trainer._reduce_grads(dict(zip(rest, grads[:-1])), report)
    g_rows = grads[-1].reshape(k_loc, D)
    lr = trainer.cfg.optim_config.lr
    with torch.no_grad():
        g_sum = None
        if dp is not None:
            g_rows, g_sum = exchange_rows(g_rows, inv, dp, trainer._exchange_chunks)
        if trainer.table_update == "scatter":
            _, trainer.table_opt = sharded_two_phase_sparse_adam(
                table, g_rows, flat_all, inv, rep, trainer.table_opt, lr, shard.index,
                pack_factor=P, g_sum=g_sum)
        else:
            pids, pinv, nuniq, prep = meta[2:6]
            route = dict(zip(_ROUTE, meta[6:]))
            update = (sharded_two_phase_sparse_adam_folded if stacked
                      else sharded_two_phase_sparse_adam_pallas)
            extra = {"update_space": trainer.update_space} if stacked else {}
            _, trainer.table_opt = update(
                table, g_rows, flat_all, inv, rep, pids, pinv, nuniq, prep, trainer.table_opt,
                lr, shard.index, pack_factor=P, g_sum=g_sum, **route, **extra)
        trainer.opt_state = trainer.tx.step(rest, g_rest, trainer.opt_state)
    return report, data_loss.detach(), probs.detach()
