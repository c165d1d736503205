"""The row-sharded table's shard-local math (the port of
``mmlrec_tpu/parallel/shard_embedding.py``).

A table of ``R`` physical rows is row-sharded over the mesh's ``model``
dimension: the rank of model index ``m`` holds rows ``[m r, (m + 1) r)``,
``r = R / n_model``, of the table and of its moments (``mu`` / ``nu``, the
packed ``monu`` container), and the stacked container holds the
shard-major ``[table_m; monu_m]`` of ``[2r, W]``
(``train/sparse_embedding.py`` ``split_stacked_planes``).  Ids are logical
and global; ``pack_factor`` translates them to physical rows.

Every function here is plain tensor math on ONE shard, which it is told
explicitly (``shard_index``): none reads a process group.  The only
collective of the table's exchange is the caller's, after
``owned_gather_partial``: one all-reduce SUM over the ``model`` group
(``owned_gather`` does both).  Everything else is owner-local: a shard
updates the rows it owns and drops the others, with no collective.  So one
process can run every shard in turn, which the tests and ``chip_smoke.py``
do.

The updates:

* ``sharded_two_phase_sparse_adam``: the scatter route (rep-masked row adds,
  ``train/sparse_embedding.py`` ``two_phase_sparse_adam``) on a shard.  The
  moment rows come from the shard alone: a position the shard does not own
  computes a value that is dropped, so no all-reduce is needed (the JAX
  function reduces them over ``model`` all the same);
* ``sharded_two_phase_sparse_adam_pallas``: the write-kernel update of the
  split container (f32 / bf16 / f16 split moments: one B3 launch of
  (table, mu, nu); packed bf16 moments: one B3 launch of (table, monu),
  with the scatter or the gather dedup route), each shard writing its
  window of the sorted unique rows (``owned_bounds``);
* ``sharded_two_phase_sparse_adam_folded``: the stacked container, in
  position space (B1 pair gather of the clipped local ids, B2 write of the
  window) or slot space (B1 pair gather of the window, B2 write of it);
* ``sharded_sparse_adam_row_update``: ``sparse_embedding_update``'s row
  update of the dense-table fit, from the shard's gradient, which
  ``owned_rows`` builds global and owner-local.

The two write-kernel updates ARE the one-shard updates (``two_phase_sparse_adam_unique``,
``two_phase_sparse_adam_slot``), given the shard's old rows (zeros where it
owns none), its local ``pids`` and its window (``bounds``): per owned lane
the op chain is the one-shard update's on the same inputs, and a slot
inside a shard's window gathers only owned contributors (every contributor
of a slot shares its physical row), so the rows a shard writes are the
one-shard update's rows.  The window comes from device values
(``owned_bounds``): no step reads a value on the host.

A non-owned row must be DROPPED, never wrapped: ``owned_scatter_add`` sends
it to row 0 with an addend of -0.0, the identity of IEEE addition (``x +
(-0.0)`` is ``x`` for every ``x``, -0.0 included), and the writes see local
ids outside ``[0, r)`` only in slots outside their window.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist

from ..ops.row_gather import rows_gather_dual
from ..train.sparse_embedding import (
    SparseAdamFoldedState,
    SparseAdamPackedState,
    SparseAdamState,
    _adam_rows,
    _segment_sum,
    _sub_rows,
    _widen,
    sparse_adam_rows,
)


def _phys(flat_ids: torch.Tensor, P: int) -> torch.Tensor:
    return torch.div(flat_ids, P, rounding_mode="floor") if P > 1 else flat_ids


def _local(flat_ids: torch.Tensor, P: int, shard_index: int, r: int):
    """(local physical row of each logical id, owned mask) for the shard
    of model index ``shard_index`` holding ``r`` rows."""
    local = _phys(flat_ids, P).long() - shard_index * r
    return local, (local >= 0) & (local < r)


def local_rows(shard: torch.Tensor, flat_ids: torch.Tensor, pack_factor: int,
               shard_index: int, fill: float = 0.0) -> torch.Tensor:
    """[K, W] super-rows of the logical ids from the shard: the owned ones
    as stored, ``fill`` at the others (shard_embedding.py:329-338)."""
    r = shard.shape[0]
    local, owned = _local(flat_ids, pack_factor, shard_index, r)
    got = shard.index_select(0, local.clamp(0, r - 1))
    return torch.where(owned[:, None], got, torch.full((), fill, dtype=got.dtype,
                                                       device=got.device))


def owned_gather_partial(shard: torch.Tensor, flat_ids: torch.Tensor, dim: int,
                         pack_factor: int, shard_index: int) -> torch.Tensor:
    """This shard's part of ``owned_gather`` (shard_embedding.py:47-73):
    [K] logical ids -> [K, dim], each owned id's row, -0.0 elsewhere, so the
    sum over the ``model`` ranks is each row's bits exactly (the JAX
    function fills +0.0, which turns a stored -0.0 into +0.0)."""
    sup = local_rows(shard, flat_ids, pack_factor, shard_index, fill=-0.0)
    if pack_factor == 1:
        return sup
    return sup.reshape(-1, dim).index_select(0, _sub_rows(flat_ids, pack_factor))


def owned_gather(shard: torch.Tensor, flat_ids: torch.Tensor, dim: int, pack_factor: int,
                 shard_index: int, group=None) -> torch.Tensor:
    """The rows of the logical ids from a row-sharded table: this shard's
    part, summed over the ``model`` process ``group`` by one all-reduce
    (none without a group or at one rank)."""
    rows = owned_gather_partial(shard, flat_ids, dim, pack_factor, shard_index)
    if group is not None and dist.get_world_size(group) > 1:
        dist.all_reduce(rows, group=group)
    return rows


def owned_scatter_add(shard: torch.Tensor, flat_ids: torch.Tensor, delta: torch.Tensor,
                      pack_factor: int, shard_index: int) -> torch.Tensor:
    """In place ``shard.at[owned rows of the logical ids].add(delta)``,
    ``delta`` [K, dim] the same on every shard; a non-owned id is dropped
    (shard_embedding.py:76-101): it adds -0.0 to row 0.  ``index_add_``, so
    exact where each lane takes at most one addend that is not a zero, as
    the scatter route's rep-masked deltas are."""
    r = shard.shape[0]
    local, owned = _local(flat_ids, pack_factor, shard_index, r)
    wide = _widen(delta, flat_ids, pack_factor).to(shard.dtype)
    wide = torch.where(owned[:, None], wide, torch.full((), -0.0, dtype=shard.dtype,
                                                        device=shard.device))
    return shard.index_add_(0, torch.where(owned, local, 0), wide)


def owned_bounds(pids: torch.Tensor, nuniq: torch.Tensor, shard_index: int,
                 r: int) -> torch.Tensor:
    """[2] int32 (lo, hi): the shard's contiguous window of the sorted
    unique physical rows ``pids`` (slots from ``nuniq`` on are pads),
    computed on the device (shard_embedding.py:380-391); (0, 0) when the
    shard owns none."""
    Kp = pids.shape[0]
    base = shard_index * r
    slots = torch.arange(Kp, dtype=torch.int32, device=pids.device)
    owned = (pids >= base) & (pids < base + r) & (slots < nuniq.reshape(-1)[0])
    lo = torch.argmax(owned.to(torch.int32)).to(torch.int32)  # the first owned slot
    cnt = owned.sum(dtype=torch.int32)
    return torch.stack([lo, lo + cnt]).contiguous()


def _local_pids(pids: torch.Tensor, shard_index: int, r: int) -> torch.Tensor:
    """The slots' rows in the shard: outside ``[0, r)`` only outside its
    window, where no kernel stores."""
    return (pids - shard_index * r).to(torch.int32)


def sharded_two_phase_sparse_adam(
    table_shard: torch.Tensor,
    g_rows: torch.Tensor,  # [K, D] global row cotangents
    flat_ids: torch.Tensor,  # [K] global logical ids
    inv: torch.Tensor,
    rep: torch.Tensor,
    state: SparseAdamState,  # this shard's moments
    lr: float,
    shard_index: int,
    pack_factor: int = 1,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    g_sum: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, SparseAdamState]:
    """The scatter route on a shard (shard_embedding.py:104-156): the
    gradient sums at the first occurrences (or ``g_sum``, the exchange's
    duplicate-reduced rows), the moment rows read from the shard, the
    table, mu and nu each receiving the rep-masked delta at the rows the
    shard owns.  In place; returns (table shard, state)."""
    if not isinstance(state, SparseAdamState):
        raise TypeError("the scatter update takes split moments (SparseAdamState)")
    dim = g_rows.shape[-1]
    mdt = state.mu.dtype
    P = pack_factor
    count = state.count.add_(1)
    t = count.to(torch.float32)
    if g_sum is None:
        g_sum = _segment_sum(g_rows, inv)

    def moment_rows(m):
        sup = local_rows(m, flat_ids, P, shard_index)
        return sup if P == 1 else sup.reshape(-1, dim).index_select(0, _sub_rows(flat_ids, P))

    mu_rows, nu_rows = moment_rows(state.mu), moment_rows(state.nu)
    new_mu, new_nu, d_table = _adam_rows(mu_rows.float(), nu_rows.float(), g_sum, t, lr,
                                         b1, b2, eps)
    r = rep[:, None]
    owned_scatter_add(table_shard, flat_ids, d_table * r, P, shard_index)
    r_m = r.to(mdt)
    owned_scatter_add(state.mu, flat_ids, (new_mu.to(mdt) - mu_rows) * r_m, P, shard_index)
    owned_scatter_add(state.nu, flat_ids, (new_nu.to(mdt) - nu_rows) * r_m, P, shard_index)
    return table_shard, SparseAdamState(mu=state.mu, nu=state.nu, count=count)


def sharded_two_phase_sparse_adam_pallas(
    table_shard: torch.Tensor,
    g_rows: torch.Tensor,  # [K, D] global row cotangents
    flat_ids: torch.Tensor,  # [K] global logical ids
    inv: torch.Tensor,
    rep: torch.Tensor,
    pids: torch.Tensor,  # [Kp] unique physical rows (sorted), then pads
    pinv: torch.Tensor,  # [K] slot of each id's physical row
    nuniq: torch.Tensor,  # [1] int32 unique count
    prep: torch.Tensor,  # [K] 1.0 at each physical row's first occurrence
    state,  # SparseAdamState or SparseAdamPackedState of this shard
    lr: float,
    shard_index: int,
    pack_factor: int = 1,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    g_sum: Optional[torch.Tensor] = None,
    accperm: Optional[torch.Tensor] = None,
    resid_pos: Optional[torch.Tensor] = None,
    resid_slot: Optional[torch.Tensor] = None,
    gdup_pos: Optional[torch.Tensor] = None,
    gdup_tgt: Optional[torch.Tensor] = None,
):
    """The write-kernel update of the split container on a shard
    (shard_embedding.py:394-603): the one-shard update
    (``two_phase_sparse_adam_unique``) with the shard's old rows (zeros
    where it owns none: those reach only slots outside its window), its
    local ``pids`` and its window: ONE launch of B3 with ``bounds``.  Packed
    bf16 moments: (table, monu), the slots accumulated as int32 by one
    scatter at ``pinv`` or by the gather route (``accperm``...); split
    moments of any dtype: (table, mu, nu).  In place; returns (table
    shard, state)."""
    from ..train.sparse_embedding import two_phase_sparse_adam_unique

    packed = isinstance(state, SparseAdamPackedState)
    if not (packed or isinstance(state, SparseAdamState)):
        raise TypeError(f"unknown SparseAdam state {type(state).__name__}")
    r_local = table_shard.shape[0]

    def rows(a):
        return local_rows(a, flat_ids, pack_factor, shard_index)

    return two_phase_sparse_adam_unique(
        table_shard, g_rows, flat_ids, inv, rep, _local_pids(pids, shard_index, r_local), pinv,
        state, lr, pack_factor=pack_factor, b1=b1, b2=b2, eps=eps, n_real=nuniq,
        sup=rows(table_shard), sup_c=rows(state.monu) if packed else None,
        sup_moments=None if packed else (rows(state.mu), rows(state.nu)), prep=prep,
        bounds=owned_bounds(pids, nuniq, shard_index, r_local), g_sum=g_sum, accperm=accperm,
        resid_pos=resid_pos, resid_slot=resid_slot, gdup_pos=gdup_pos, gdup_tgt=gdup_tgt)


def sharded_two_phase_sparse_adam_folded(
    fat_shard: torch.Tensor,  # [2r, W]: this shard's [table_m; monu_m]
    g_rows: torch.Tensor,  # [K, D] global row cotangents
    flat_ids: torch.Tensor,  # [K] global logical ids
    inv: torch.Tensor,
    rep: torch.Tensor,
    pids: torch.Tensor,
    pinv: torch.Tensor,
    nuniq: torch.Tensor,
    prep: torch.Tensor,
    state: SparseAdamFoldedState,
    lr: float,
    shard_index: int,
    pack_factor: int = 1,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    g_sum: Optional[torch.Tensor] = None,
    accperm: Optional[torch.Tensor] = None,
    resid_pos: Optional[torch.Tensor] = None,
    resid_slot: Optional[torch.Tensor] = None,
    gdup_pos: Optional[torch.Tensor] = None,
    gdup_tgt: Optional[torch.Tensor] = None,
    update_space: str = "position",
):
    """The stacked container's update on a shard (shard_embedding.py:
    159-377): the shard's ``[2r, W]`` slice is its own ``[2, r, W]``
    stacked container, both planes of every owned row local, so the update
    needs no collective.  Position space: B1 fetches every position's
    (table, monu) pair at its clipped local id (non-owned positions zeroed)
    and the one-shard update (``two_phase_sparse_adam_unique``) writes the
    shard's window through B2.  Slot space (the gather route): B1 fetches
    only the window's slot pairs (``bounds``) and
    ``two_phase_sparse_adam_slot`` writes the window through B2.  In place;
    returns (fat shard, state)."""
    from ..train.sparse_embedding import two_phase_sparse_adam_slot, two_phase_sparse_adam_unique

    if not isinstance(state, SparseAdamFoldedState):
        raise TypeError("the stacked container takes SparseAdamFoldedState")
    if update_space not in ("position", "slot"):
        raise ValueError(f"update_space must be position|slot, got {update_space!r}")
    r_local, W = fat_shard.shape[0] // 2, fat_shard.shape[1]
    stacked = fat_shard.view(2, r_local, W)
    bounds = owned_bounds(pids, nuniq, shard_index, r_local)
    lpids = _local_pids(pids, shard_index, r_local)
    route = (accperm, resid_pos, resid_slot, gdup_pos, gdup_tgt)
    common = dict(pack_factor=pack_factor, b1=b1, b2=b2, eps=eps, bounds=bounds, g_sum=g_sum)
    if update_space == "slot":
        if accperm is None:
            raise ValueError("slot space needs the gather route (accperm...)")
        pair = rows_gather_dual(stacked, lpids.clamp(0, r_local - 1), bounds=bounds)
        return two_phase_sparse_adam_slot(fat_shard, g_rows, flat_ids, rep, lpids, nuniq,
                                          pair[0], pair[1], state, lr, *route, **common)
    local, owned = _local(flat_ids, pack_factor, shard_index, r_local)
    pair = rows_gather_dual(stacked, local.clamp(0, r_local - 1).to(torch.int32))
    return two_phase_sparse_adam_unique(
        fat_shard, g_rows, flat_ids, inv, rep, lpids, pinv, state, lr, n_real=nuniq,
        sup=torch.where(owned[:, None], pair[0], 0.0),
        sup_c=torch.where(owned[:, None], pair[1], 0.0), prep=prep,
        **dict(zip(("accperm", "resid_pos", "resid_slot", "gdup_pos", "gdup_tgt"), route)),
        **common)


def sharded_sparse_adam_row_update(
    table_shard: torch.Tensor,
    g_shard: torch.Tensor,  # [r, W] the shard's gradient, global (``owned_rows``)
    rows: torch.Tensor,  # [K] the global batch's physical rows (duplicates OK)
    state: SparseAdamState,  # this shard's moments
    lr: float,
    shard_index: int,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
) -> Tuple[torch.Tensor, SparseAdamState]:
    """``sparse_adam_row_update`` on a shard: the owned rows of the table
    and its moments are set to the one-chip update's values, the others
    are dropped, and the count moves on every shard.

    ``index_copy_`` of different values to one row is undefined on the
    card, so a dropped position is sent to the first owned position's row
    and computes that row's values, the same bits; when the shard owns no
    row every position writes row 0's own values back.  No boolean mask
    and no host read: the step stays capturable.  In place; returns (table
    shard, state)."""
    if not isinstance(state, SparseAdamState):
        raise TypeError("sparse_embedding_update takes split moments (SparseAdamState)")
    r = table_shard.shape[0]
    local = rows.long() - shard_index * r
    owned = (local >= 0) & (local < r)
    some = owned.any()
    first = torch.argmax(owned.to(torch.int32)).reshape(1)  # 0 when none is owned
    target = torch.where(owned, local, torch.where(some, local.index_select(0, first), 0))
    count = state.count.add_(1)
    new = sparse_adam_rows(table_shard, g_shard, target, state, count.to(torch.float32), lr,
                           b1, b2, eps)
    for arr, value in zip((table_shard, state.mu, state.nu), new):
        arr.index_copy_(0, target, torch.where(some, value, arr.index_select(0, target)))
    return table_shard, SparseAdamState(mu=state.mu, nu=state.nu, count=count)


class _OwnedRows(torch.autograd.Function):
    """``owned_gather`` as a differentiable lookup of the dense-table fit
    (the JAX GSPMD step of a row-sharded table, tests/test_sharding.py:
    48-58).  Forward: the shard's part and one all-reduce over ``model``.
    Backward: the table shard's gradient, built owner-local: the row
    cotangents and ids of the ``data`` group's ranks (one all-gather each,
    in rank order, which is the global batch's order) scatter-added at the
    rows this shard owns, in position order (``scatter_add_rows``), as one
    process's embed-concat backward adds them; the other rows are dropped.
    A batch that every rank computes whole needs no all-gather."""

    @staticmethod
    def forward(ctx, plane, flat_ids, dim, pack_factor, shard, dp):
        ctx.save_for_backward(flat_ids)
        ctx.info = (tuple(plane.shape), dim, pack_factor, shard.index, dp)
        return owned_gather(plane, flat_ids, dim, pack_factor, shard.index, shard.group)

    @staticmethod
    def backward(ctx, grad):
        from ..ops.kernels import scatter_add_rows
        from .mesh import all_gather

        (flat_ids,) = ctx.saved_tensors
        (r, W), dim, P, index, dp = ctx.info
        grad = grad.contiguous()
        if dp is not None and dp.world > 1:
            ids_all = flat_ids.new_empty((dp.world * flat_ids.shape[0],))
            g_all = grad.new_empty((dp.world * grad.shape[0], grad.shape[1]))
            all_gather(ids_all, flat_ids.contiguous(), dp.group)
            all_gather(g_all, grad, dp.group)
            flat_ids, grad = ids_all, g_all
        local = flat_ids.long() - index * r * P  # outside [0, r P): dropped
        d_plane = scatter_add_rows(grad, local, r * P).view(r, W)
        return d_plane, None, None, None, None, None


def owned_rows(plane: torch.Tensor, flat_ids: torch.Tensor, dim: int, pack_factor: int,
               shard, dp=None) -> torch.Tensor:
    """[K] logical ids -> [K, dim] rows of the row-sharded table whose
    shard (``plane``, [r, W]) this rank holds: ``shard`` is the mesh's
    ``TableShard``, ``dp`` the data group the step's batch is split over
    (None: every rank holds the whole batch).  Differentiable w.r.t.
    ``plane`` (``_OwnedRows``)."""
    return _OwnedRows.apply(plane, flat_ids, dim, pack_factor, shard, dp)
