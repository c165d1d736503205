"""Row-sparse SparseAdam for the fused embedding table: the two-phase step's
table update (the port of ``mmlrec_tpu/train/sparse_embedding.py``).

The step gathers the batch's table rows, differentiates the loss w.r.t.
those rows only, and updates only the touched rows and their Adam moments
here; no ``[V, D]`` gradient, moment or update buffer exists.  Untouched
rows' moment decay is deferred, as in every production sparse optimizer
(torch.optim.SparseAdam).

Ported:

* the moment layouts: split f32 moments (``SparseAdamState``), packed bf16
  pairs (``SparseAdamPackedState``) and the stacked (folded) container at
  one shard, with the conversions between them (``to_split_state``,
  ``to_runtime_state``, pack/unpack);
* the dedup metadata, from one stable sort: in the step on the device
  (``device_step_metadata``) or per batch on the host
  (``batch_step_metadata``: numpy, or one pass of ``native/step_metadata.cpp``
  through ``mmlrec_tpu_torch.native``);
* the updates: the scatter route (``two_phase_sparse_adam``: rep-masked
  row adds) and ``two_phase_sparse_adam_unique`` on the write-kernel path
  with the scatter dedup route, for packed moments (one write of (table,
  monu) or of the stacked pair) and for split f32 moments (one write of
  (table, mu, nu)).

Split bf16 or f16 moments, the ``"unique"`` update (XLA's unique-indices
scatter), the gather dedup route and slot space are ROADMAP A4; the
shard-major layouts A9.

Bit layout of a packed container lane: mu in the low 16 bits, nu in the
high 16 (pinned by tests/test_sparse_embedding.py::test_monu_pack_bit_layout
of the JAX package).  Every pack and unpack is same-shape int32 bit math on
``tensor.view(torch.int32)``, so it is exact on any device.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..ops.kernels import scatter_add_rows
from ..ops.row_gather import rows_gather_hbm
from ..ops.row_scatter import bf16_bits_rne as _bf16_bits
from ..ops.row_scatter import bits_as_bf16 as _bits_as_bf16
from ..ops.row_scatter import rows_write, rows_write_dual


class SparseAdamState(NamedTuple):
    """Split Adam moments of the table (sparse_embedding.py:38-41): f32 in
    the trainer; a checkpoint's split form of packed moments holds them as
    bfloat16."""

    mu: torch.Tensor  # [V, W]
    nu: torch.Tensor  # [V, W]
    count: torch.Tensor  # int32 scalar


class SparseAdamPackedState(NamedTuple):
    """Both bf16 Adam moments packed as (mu, nu) pairs into the f32 lanes of
    ONE ``[V, W]`` container (sparse_embedding.py:44-58)."""

    monu: torch.Tensor  # [V, W] float32 container of bf16 (mu, nu) pairs
    count: torch.Tensor  # int32 scalar


class SparseAdamFoldedState(NamedTuple):
    """Packed-moment state whose container is FOLDED into the table param:
    ``[2Vp, W]`` with table rows in ``[0, Vp)`` and the container in
    ``[Vp, 2Vp)`` (``table_container="stacked"``, sparse_embedding.py:61-71).
    Only the step counter is separate."""

    count: torch.Tensor  # int32 scalar


_LOW16 = 0xFFFF
_HIGH16 = -65536  # 0xFFFF0000 as int32


def _bf16_as_bits(x: torch.Tensor) -> torch.Tensor:
    """bfloat16 -> its 16 bits as int32 in [0, 65535]."""
    return x.contiguous().view(torch.int16).to(torch.int32) & _LOW16


def unpack_monu(container: torch.Tensor):
    """[..., W] f32 container -> (mu, nu) bfloat16 [..., W]."""
    ci = container.contiguous().view(torch.int32)
    return _bits_as_bf16(ci & _LOW16), _bits_as_bf16((ci >> 16) & _LOW16)


def unpack_monu_f32(container: torch.Tensor):
    """[..., W] f32 container -> (mu, nu) float32 [..., W]: bf16 -> f32 is
    exactly ``bits << 16``."""
    ci = container.contiguous().view(torch.int32)
    return (ci << 16).view(torch.float32), (ci & _HIGH16).view(torch.float32)


def pack_monu(mu_bf16: torch.Tensor, nu_bf16: torch.Tensor) -> torch.Tensor:
    """(mu, nu) [..., W] -> [..., W] f32 container; inputs that are not
    bfloat16 are rounded to it first (RNE)."""
    mu_u = _bf16_as_bits(mu_bf16) if mu_bf16.dtype == torch.bfloat16 else _bf16_bits(mu_bf16.float())
    nu_u = _bf16_as_bits(nu_bf16) if nu_bf16.dtype == torch.bfloat16 else _bf16_bits(nu_bf16.float())
    return ((nu_u << 16) | mu_u).view(torch.float32)


def pack_monu_rounded(mu_f32: torch.Tensor, nu_f32: torch.Tensor) -> torch.Tensor:
    """f32 moments -> container, with the round to bf16 (RNE) inside."""
    return ((_bf16_bits(nu_f32) << 16) | _bf16_bits(mu_f32)).view(torch.float32)


def init_sparse_adam(table: torch.Tensor, dtype: Optional[torch.dtype] = None,
                     packed: bool = False):
    """Zero moments for ``table`` (sparse_embedding.py:129-148): split
    moments of ``dtype`` (the table's by default), or ``packed`` bf16 pairs
    in one f32 container."""
    count = torch.zeros((), dtype=torch.int32, device=table.device)
    if packed:
        return SparseAdamPackedState(
            monu=torch.zeros(table.shape, dtype=torch.float32, device=table.device),
            count=count)
    dt = dtype or table.dtype
    return SparseAdamState(mu=torch.zeros(table.shape, dtype=dt, device=table.device),
                           nu=torch.zeros(table.shape, dtype=dt, device=table.device),
                           count=count)


def to_split_state(st):
    """The checkpoints' layout of the moments (sparse_embedding.py:198-209):
    packed pairs unpack to split bf16 moments; bit-exact."""
    if isinstance(st, SparseAdamPackedState):
        mu, nu = unpack_monu(st.monu)
        return SparseAdamState(mu=mu, nu=nu, count=st.count)
    return st


def to_runtime_state(st, packed: bool):
    """Inverse of ``to_split_state`` for a runtime that packs its moments
    (sparse_embedding.py:212-220)."""
    if packed and isinstance(st, SparseAdamState):
        return SparseAdamPackedState(monu=pack_monu(st.mu, st.nu), count=st.count)
    return st


def _one_shard(n_shards: int) -> None:
    if n_shards != 1:
        raise NotImplementedError(
            "the shard-major stacked layout (n_shards > 1) is not ported yet (ROADMAP A9)")


def split_stacked_planes(fat: torch.Tensor, n_shards: int = 1):
    """Folded [2Vp, W] container -> (table [Vp, W], monu [Vp, W]) views."""
    _one_shard(n_shards)
    Vp = fat.shape[0] // 2
    return fat[:Vp], fat[Vp:]


def fold_stacked_planes(table: torch.Tensor, monu: torch.Tensor, n_shards: int = 1):
    """Inverse of split_stacked_planes: (table, monu) -> [2Vp, W]."""
    _one_shard(n_shards)
    return torch.cat([table, monu])


def stacked_table_rows(phys: torch.Tensor, Vp: int, n_shards: int = 1):
    """Physical table rows -> rows of the folded container (identity at one
    shard)."""
    _one_shard(n_shards)
    return phys


def device_step_metadata(flat_ids: torch.Tensor, pack_factor: int, Kp: int, n_phys_rows: int):
    """In-step dedup metadata from one stable sort (sparse_embedding.py:
    515-577): ``(inv, rep, pids, pinv, nuniq, prep)`` for ``flat_ids`` [K]
    int32 logical row ids.

    * inv[k]: position of the first occurrence of flat_ids[k];
      rep[k]: 1.0 at first occurrences;
    * pids [Kp]: the unique physical rows (flat // P) ascending, then pads
      equal to ``n_phys_rows`` (one past the last row: the write kernels
      drop them); pinv[k]: the slot of k's physical row; nuniq [1]: the
      unique count; prep[k]: 1.0 at each physical row's first occurrence.

    Bitwise equal to the JAX function; ``nuniq`` stays a device tensor."""
    K = flat_ids.shape[0]
    P = pack_factor
    dev = flat_ids.device
    k = torch.arange(K, dtype=torch.int32, device=dev)
    svals, order = torch.sort(flat_ids.to(torch.int32), stable=True)
    newv = torch.ones(K, dtype=torch.bool, device=dev)
    newv[1:] = svals[1:] != svals[:-1]
    # original index of each run's first element, spread over the run
    start_pos = torch.cummax(torch.where(newv, k, 0), dim=0).values
    fs_sorted = order.to(torch.int32)[start_pos.long()]
    inv = torch.zeros(K, dtype=torch.int32, device=dev).index_copy_(0, order, fs_sorted)
    rep = torch.zeros(K, dtype=torch.float32, device=dev).index_copy_(0, order, newv.float())
    if P > 1:
        psvals = torch.div(svals, P, rounding_mode="floor")
        pnew = torch.ones(K, dtype=torch.bool, device=dev)
        pnew[1:] = psvals[1:] != psvals[:-1]
    else:
        psvals, pnew = svals, newv
    pgrp = torch.cumsum(pnew.to(torch.int32), dim=0, dtype=torch.int32) - 1
    pinv = torch.zeros(K, dtype=torch.int32, device=dev).index_copy_(0, order, pgrp)
    prep = torch.zeros(K, dtype=torch.float32, device=dev).index_copy_(0, order, pnew.float())
    nuniq = pnew.sum(dtype=torch.int32).reshape(1)
    # every member of a physical run writes the run's row at its slot:
    # duplicate indices carry equal values, so the result is exact
    pids = torch.full((Kp,), n_phys_rows, dtype=torch.int32, device=dev)
    pids.index_put_((pgrp.long(),), psvals.to(torch.int32))
    return inv, rep, pids, pinv, nuniq, prep


#: host metadata calls by source since the last reset: the single pass of
#: ``native/step_metadata.cpp`` or the numpy formulation
metadata_calls: Dict[str, int] = {"native": 0, "numpy": 0}


def reset_metadata_calls() -> None:
    for k in metadata_calls:
        metadata_calls[k] = 0


def batch_dedup_metadata(flat_ids: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(inv, rep) [steps, K] of ``flat_ids`` [steps, K] (sparse_embedding.py:
    274-283): inv[b, j] is the position of the first occurrence of
    flat_ids[b, j] in batch b, rep[b, j] 1.0 iff j is that occurrence."""
    return batch_step_metadata(flat_ids)[:2]


def _native_step_metadata(comp, idx_bits, pack_factor, Kp):
    """The single pass of native/step_metadata.cpp over the sorted composite
    (sparse_embedding.py:294-325, without the gather-route lists);
    output-identical to the numpy formulation."""
    from ..native import step_metadata_fill

    steps, K = comp.shape
    comp = np.ascontiguousarray(comp)
    inv = np.empty((steps, K), np.int32)
    rep = np.empty((steps, K), np.float32)
    pids = np.empty((steps, Kp), np.int32)
    pinv = np.empty((steps, K), np.int32)
    nuniq = np.empty((steps, 1), np.int32)
    prep = np.empty((steps, K), np.float32)
    step_metadata_fill(comp, idx_bits, pack_factor, Kp, inv, rep, pids, pinv, nuniq, prep)
    return inv, rep, pids, pinv, nuniq, prep


def batch_step_metadata(
    flat_ids: np.ndarray,
    pack_factor: Optional[int] = None,
    n_phys_rows: Optional[int] = None,
    chunk: int = 256,
    want_route: bool = False,
    use_native: Optional[bool] = None,
):
    """Host dedup metadata of ``flat_ids`` [steps, K] logical ids from ONE
    sort (sparse_embedding.py:328-512): ``(inv, rep)``, and with
    ``pack_factor`` and ``n_phys_rows`` also ``(pids [steps, Kp], pinv,
    nuniq [steps, 1], prep)``, Kp = K rounded up to ``chunk``.

    The sort is of the composite ``value << idx_bits | position``, so equal
    ids keep their order (a stable sort) and the first of each run is the
    first occurrence.  ``pids`` holds the batch's unique physical rows
    ascending, then DISTINCT rows the batch does not touch (the tail pads;
    the write kernel skips them through ``nuniq``), which needs
    ``n_phys_rows`` > Kp.

    With the physical metadata, the single pass of
    ``native/step_metadata.cpp`` runs when its library loads
    (``use_native`` None); when it does not, numpy runs, unless
    ``use_native=True`` asked for the library, which then raises.  The
    gather-route lists (``want_route``) are ROADMAP A4."""
    if want_route:
        raise NotImplementedError(
            "the gather dedup route's lists (want_route) are not ported yet (ROADMAP A4)")
    steps, K = flat_ids.shape
    flat = np.asarray(flat_ids, np.int64)
    idx_bits = max(1, int(K - 1).bit_length())
    assert int(flat.max(initial=0)) < (1 << (63 - idx_bits)), "id overflow"
    comp = np.sort((flat << idx_bits) | np.arange(K, dtype=np.int64), axis=1)
    want_phys = pack_factor is not None
    if want_phys:
        if n_phys_rows is None:
            raise ValueError("n_phys_rows required with pack_factor")
        Kp = -(-K // chunk) * chunk
        if n_phys_rows <= Kp:
            raise ValueError(
                f"unique-update metadata needs n_phys_rows > {Kp}, got {n_phys_rows}")
        if use_native is not False:
            from ..native import NativeUnavailable

            try:
                out = _native_step_metadata(comp, idx_bits, pack_factor, Kp)
                metadata_calls["native"] += 1
                return out
            except NativeUnavailable:
                if use_native:
                    raise
    metadata_calls["numpy"] += 1
    order = (comp & ((1 << idx_bits) - 1)).astype(np.int32)
    svals = comp >> idx_bits
    newv = np.ones((steps, K), bool)
    newv[:, 1:] = svals[:, 1:] != svals[:, :-1]
    inv = np.empty((steps, K), np.int32)
    rep = np.zeros((steps, K), np.float32)
    pos = np.arange(K, dtype=np.int32)[None, :]
    # original index of each run's first element, spread over the run
    start_pos = np.maximum.accumulate(np.where(newv, pos, 0), axis=1)
    fs_sorted = np.take_along_axis(order, start_pos, axis=1)
    np.put_along_axis(inv, order, fs_sorted, axis=1)
    np.put_along_axis(rep, order, newv.astype(np.float32), axis=1)
    if not want_phys:
        return inv, rep
    psvals = svals // pack_factor  # still sorted
    pnew = np.ones((steps, K), bool)
    pnew[:, 1:] = psvals[:, 1:] != psvals[:, :-1]
    pgrp = np.cumsum(pnew, axis=1, dtype=np.int32) - 1  # slot of each sorted position
    pids = np.empty((steps, Kp), np.int32)
    pinv = np.empty((steps, K), np.int32)
    nuniq = np.empty((steps, 1), np.int32)
    prep = np.empty((steps, K), np.float32)
    np.put_along_axis(pinv, order, pgrp, axis=1)
    np.put_along_axis(prep, order, pnew.astype(np.float32), axis=1)
    nuniq[:, 0] = pnew.sum(axis=1, dtype=np.int32)
    for b in range(steps):
        u = psvals[b][pnew[b]]
        U = len(u)
        pids[b, :U] = u
        if U < Kp:
            # distinct untouched rows at the tail: the first non-members of
            # u in [0, Kp]
            present = np.zeros(Kp + 1, bool)
            present[u[u <= Kp]] = True
            pids[b, U:] = np.flatnonzero(~present)[: Kp - U]
    return inv, rep, pids, pinv, nuniq, prep


def _segment_sum(g_rows: torch.Tensor, inv: torch.Tensor) -> torch.Tensor:
    """``zeros.at[inv].add(g_rows)``, deterministic on both devices (see
    ``ops.kernels.scatter_add_rows``)."""
    return scatter_add_rows(g_rows, inv, g_rows.shape[0])


def _sub_rows(flat_ids: torch.Tensor, P: int) -> torch.Tensor:
    """Row of each logical id's sub-row in the ``[K * P, dim]`` view of its
    gathered super-rows."""
    k = torch.arange(flat_ids.shape[0], device=flat_ids.device)
    return k * P + torch.remainder(flat_ids, P)


def gather_rows(table: torch.Tensor, flat_ids: torch.Tensor, dim: int, pack_factor: int):
    """[K] logical ids -> [K, dim] rows of a (lane-packed) table
    (sparse_embedding.py:622-629; the one-hot product there selects the same
    values exactly)."""
    if pack_factor == 1:
        return table.index_select(0, flat_ids.long())
    P = pack_factor
    sup = table.index_select(0, torch.div(flat_ids, P, rounding_mode="floor").long())
    return sup.reshape(-1, dim).index_select(0, _sub_rows(flat_ids, P))


def _own_mask(flat_ids: torch.Tensor, P: int, dim: int) -> torch.Tensor:
    """[K, P * dim]: the lanes of each logical id's sub-row."""
    lanes = torch.arange(P * dim, dtype=torch.int32, device=flat_ids.device) // dim
    return lanes[None, :] == torch.remainder(flat_ids, P)[:, None]


def _widen(delta: torch.Tensor, flat_ids: torch.Tensor, P: int) -> torch.Tensor:
    """[K, dim] logical delta -> [K, P * dim] with exact zeros in the other
    sub-rows' lanes (the one-hot widening of sparse_embedding.py:638-641)."""
    if P == 1:
        return delta
    dim = delta.shape[-1]
    return torch.where(_own_mask(flat_ids, P, dim), delta.repeat(1, P), 0.0)


def _scatter_add_rows(arr: torch.Tensor, flat_ids: torch.Tensor, delta: torch.Tensor,
                      pack_factor: int) -> torch.Tensor:
    """In place ``arr.at[logical rows].add(delta)`` for plain or lane-packed
    layouts (sparse_embedding.py:632-642).  Per lane at most one row of the
    batch adds a value that is not zero (duplicates carry rep-masked zeros,
    ids sharing a physical row own disjoint lanes), so the sum is exact in
    any order, float atomics on the card included."""
    P = pack_factor
    rows = torch.div(flat_ids, P, rounding_mode="floor") if P > 1 else flat_ids
    return arr.index_add_(0, rows.long(), _widen(delta, flat_ids, P))


def _check_split(state: "SparseAdamState") -> None:
    if state.mu.dtype != torch.float32 or state.nu.dtype != torch.float32:
        raise NotImplementedError(
            f"split {state.mu.dtype} moments are not ported yet (ROADMAP A4); the "
            "split layout runs float32 moments (bfloat16 ones ride packed)")


def _adam_rows(mu_f, nu_f, g_sum, t, lr, b1, b2, eps):
    """(new_mu, new_nu, table delta) of the narrow [K, dim] Adam chain."""
    new_mu = b1 * mu_f + (1.0 - b1) * g_sum
    new_nu = b2 * nu_f + (1.0 - b2) * g_sum * g_sum
    mu_hat = new_mu / (1.0 - b1 ** t)
    nu_hat = new_nu / (1.0 - b2 ** t)
    return new_mu, new_nu, -lr * mu_hat / (torch.sqrt(nu_hat) + eps)


def two_phase_sparse_adam(
    table: torch.Tensor,
    g_rows: torch.Tensor,  # [K, D] cotangent w.r.t. the gathered rows
    flat_ids: torch.Tensor,  # [K] logical row ids (duplicates OK)
    inv: torch.Tensor,  # [K] first-occurrence positions
    rep: torch.Tensor,  # [K] 1.0 at first occurrences
    state: SparseAdamState,
    lr: float,
    pack_factor: int = 1,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
) -> Tuple[torch.Tensor, SparseAdamState]:
    """SparseAdam of the touched rows through rep-masked row adds, the
    scatter route (sparse_embedding.py:645-686): the gradient sums land at
    each id's first occurrence, the moments' rows are gathered, and table,
    mu and nu each receive ``old + delta`` as an ADD of the masked delta,
    so ``mu`` becomes ``mu + (new_mu - mu)``, rounded as the JAX scatter
    rounds it.  ``table``, the moments and the count are updated in place
    and returned with the state."""
    if not isinstance(state, SparseAdamState):
        raise TypeError("the scatter update takes split moments (SparseAdamState)")
    _check_split(state)
    dim = g_rows.shape[-1]
    count = state.count.add_(1)  # in place: a captured step reads it
    t = count.to(torch.float32)
    g_sum = _segment_sum(g_rows, inv)
    mu_rows = gather_rows(state.mu, flat_ids, dim, pack_factor)
    nu_rows = gather_rows(state.nu, flat_ids, dim, pack_factor)
    new_mu, new_nu, d_table = _adam_rows(mu_rows, nu_rows, g_sum, t, lr, b1, b2, eps)
    r = rep[:, None]
    _scatter_add_rows(table, flat_ids, d_table * r, pack_factor)
    _scatter_add_rows(state.mu, flat_ids, (new_mu - mu_rows) * r, pack_factor)
    _scatter_add_rows(state.nu, flat_ids, (new_nu - nu_rows) * r, pack_factor)
    return table, SparseAdamState(mu=state.mu, nu=state.nu, count=count)


def two_phase_sparse_adam_unique(
    table: torch.Tensor,
    g_rows: torch.Tensor,  # [K, D] cotangent w.r.t. the gathered rows
    flat_ids: torch.Tensor,  # [K] int32 logical row ids (duplicates OK)
    inv: torch.Tensor,  # [K] first-occurrence positions
    rep: torch.Tensor,  # [K] 1.0 at first occurrences
    pids: torch.Tensor,  # [Kp] unique physical rows, pads = n_phys_rows
    pinv: torch.Tensor,  # [K] slot of each logical id's physical row in pids
    state,
    lr: float,
    pack_factor: int = 1,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    use_pallas: bool = True,
    n_real: Optional[torch.Tensor] = None,  # [1] int32: pids[n_real:] are padding
    sup: Optional[torch.Tensor] = None,  # [K, W] phase-1 table super-rows
    sup_c: Optional[torch.Tensor] = None,  # [K, W] container rows (dual gather)
    prep: Optional[torch.Tensor] = None,  # [K] 1.0 at each physical row's first occurrence
    monu_gather: str = "xla",  # "xla" | "pallas": moment-container gather
) -> Tuple[torch.Tensor, object]:
    """SparseAdam of the touched rows with one write per physical row
    (sparse_embedding.py:812-1065, the packed write-kernel path with the
    scatter dedup route: ``accperm is None``, ``gdup_pos is None``).

    The Adam chain runs at full lane width [K, W] on the unpacked moments;
    each owned lane then rides as a wrapping int32 delta ``new - old`` and
    each physical row's first occurrence adds its old row, accumulated with
    an INTEGER scatter-add at ``pinv``: per lane the sum is the new bits
    where owned and the old bits elsewhere, exact in any order.  The sums
    are written with one launch: ``rows_write_dual`` into the stacked
    container (``SparseAdamFoldedState``), or ``rows_write`` into (table,
    monu) (``SparseAdamPackedState``).  ``table`` (and the split
    container) and the count are updated IN PLACE and returned with the
    state.
    """
    folded = isinstance(state, SparseAdamFoldedState)
    split = isinstance(state, SparseAdamState)
    if not (folded or split or isinstance(state, SparseAdamPackedState)):
        raise TypeError(f"unknown SparseAdam state {type(state).__name__}")
    if not use_pallas:
        raise NotImplementedError(
            "the unique table update (XLA's unique-indices scatter) is not ported "
            "yet (ROADMAP A4); use the write kernel (use_pallas=True)")
    if n_real is None or prep is None:
        raise ValueError("the write-kernel update needs n_real and prep")
    if monu_gather not in ("xla", "pallas"):
        raise ValueError(f"monu_gather must be xla|pallas, got {monu_gather!r}")
    K, dim = g_rows.shape
    P = pack_factor
    W = table.shape[1]
    Kp = pids.shape[0]
    count = state.count.add_(1)  # in place: a captured step reads it
    t = count.to(torch.float32)
    g_sum = _segment_sum(g_rows, inv)
    r = rep[:, None]
    gids = torch.div(flat_ids, P, rounding_mode="floor") if P > 1 else flat_ids
    if split:
        _check_split(state)
        return _unique_split(table, g_sum, flat_ids, gids, r, pids, pinv, state, count, t,
                             lr, P, b1, b2, eps, n_real, sup, prep)
    own_mask = _own_mask(flat_ids, P, dim) if P > 1 else None

    def own_sel(x):
        return torch.where(own_mask, x, 0.0) if P > 1 else x

    if folded:
        Vp = table.shape[0] // 2
        monu_src, monu_ids = table, gids + Vp
    else:
        monu_src, monu_ids = state.monu, gids
    if sup_c is None:
        sup_c = (rows_gather_hbm(monu_src, monu_ids) if monu_gather == "pallas"
                 else monu_src.index_select(0, monu_ids.long()))
    if sup is None:
        sup = table.index_select(0, gids.long())
    # packed Adam at full lane width; non-owned lanes compute values that
    # the own selects below discard
    mu_w, nu_w = unpack_monu_f32(sup_c)
    g_w = own_sel(g_sum.repeat(1, P)) if P > 1 else g_sum
    new_mu_w = b1 * mu_w + (1.0 - b1) * g_w
    new_nu_w = b2 * nu_w + (1.0 - b2) * g_w * g_w
    mu_hat_w = new_mu_w / (1.0 - b1 ** t)
    nu_hat_w = new_nu_w / (1.0 - b2 ** t)
    d_table_w = -lr * mu_hat_w / (torch.sqrt(nu_hat_w) + eps) * r
    vals_c = pack_monu_rounded(new_mu_w, new_nu_w)
    r_w = r.expand(K, W)
    own = torch.where(own_mask, r_w, 0.0) if P > 1 else r_w
    owned = own > 0
    prep_i = prep.to(torch.int32)[:, None]
    old_i = sup_c.contiguous().view(torch.int32)
    new_i = vals_c.view(torch.int32)
    contrib_monu_i = torch.where(owned, new_i - old_i, 0) + prep_i * old_i
    old_ti = sup.contiguous().view(torch.int32)
    new_t = sup + own_sel(d_table_w)
    contrib_t_i = torch.where(owned, new_t.view(torch.int32) - old_ti, 0) + prep_i * old_ti
    if folded:
        accd = torch.zeros((2, Kp, W), dtype=torch.int32, device=table.device)
        accd.index_add_(1, pinv.long(), torch.stack([contrib_t_i, contrib_monu_i]))
        rows_write_dual(table.view(2, Vp, W), pids, accd.view(torch.float32), n_real=n_real)
        return table, SparseAdamFoldedState(count=count)
    acc2 = torch.zeros((Kp, 2 * W), dtype=torch.int32, device=table.device)
    acc2.index_add_(0, pinv.long(), torch.cat([contrib_t_i, contrib_monu_i], dim=1))
    acc2 = acc2.view(torch.float32)
    rows_write((table, state.monu), pids, (acc2[:, :W], acc2[:, W:]), n_real=n_real)
    return table, SparseAdamPackedState(monu=state.monu, count=count)


def _unique_split(table, g_sum, flat_ids, gids, r, pids, pinv, state, count, t, lr, P,
                  b1, b2, eps, n_real, sup, prep):
    """The write-kernel update of split f32 moments (sparse_embedding.py:
    1085-1132): the narrow Adam chain at the logical rows, then ONE f32
    accumulation of three [Kp, W] buffers at each physical row's slot, where
    the first occurrence of a physical row adds the old (table, mu, nu) row
    and each owner its masked delta, and ONE launch of the write kernel
    (B3) over (table, mu, nu).  Per lane the slot sums old + delta, at most
    one of them past zero besides the old value, so the order of the adds
    is immaterial."""
    dim = g_sum.shape[-1]
    W = table.shape[1]
    Kp = pids.shape[0]
    if sup is None:
        sup = table.index_select(0, gids.long())
    sup_mu = state.mu.index_select(0, gids.long())
    sup_nu = state.nu.index_select(0, gids.long())
    if P > 1:
        sub = _sub_rows(flat_ids, P)
        mu_f = sup_mu.reshape(-1, dim).index_select(0, sub)
        nu_f = sup_nu.reshape(-1, dim).index_select(0, sub)
    else:
        mu_f, nu_f = sup_mu, sup_nu
    new_mu, new_nu, d_table = _adam_rows(mu_f, nu_f, g_sum, t, lr, b1, b2, eps)
    pr = prep[:, None]
    contrib = torch.cat([
        _widen(d_table * r, flat_ids, P) + sup * pr,
        _widen((new_mu - mu_f) * r, flat_ids, P) + sup_mu * pr,
        _widen((new_nu - nu_f) * r, flat_ids, P) + sup_nu * pr,
    ], dim=1)
    acc3 = torch.zeros((Kp, 3 * W), dtype=torch.float32, device=table.device)
    acc3.index_add_(0, pinv.long(), contrib)
    rows_write((table, state.mu, state.nu), pids,
               (acc3[:, :W], acc3[:, W:2 * W], acc3[:, 2 * W:]), n_real=n_real)
    return table, SparseAdamState(mu=state.mu, nu=state.nu, count=count)
