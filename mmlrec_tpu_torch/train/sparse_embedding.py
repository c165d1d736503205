"""Row-sparse SparseAdam for the fused embedding table: the two-phase step's
table update (the port of ``mmlrec_tpu/train/sparse_embedding.py``).

The step gathers the batch's table rows, differentiates the loss w.r.t.
those rows only, and updates only the touched rows and their Adam moments
here; no ``[V, D]`` gradient, moment or update buffer exists.  Untouched
rows' moment decay is deferred, as in every production sparse optimizer
(torch.optim.SparseAdam).

Ported: the packed bf16 moment layout and its pack/unpack, the stacked
(folded) container at one shard, the in-step dedup metadata
(``device_step_metadata``) and ``two_phase_sparse_adam_unique`` on the
write-kernel path with the scatter dedup route.  Host metadata
(``batch_step_metadata``), the gather route, slot space, f32 moments and
the scatter/unique updates are ROADMAP A4; the shard-major layouts A9.

Bit layout of a packed container lane: mu in the low 16 bits, nu in the
high 16 (pinned by tests/test_sparse_embedding.py::test_monu_pack_bit_layout
of the JAX package).  Every pack and unpack is same-shape int32 bit math on
``tensor.view(torch.int32)``, so it is exact on any device.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..ops.kernels import scatter_add_rows
from ..ops.row_gather import rows_gather_hbm
from ..ops.row_scatter import bf16_bits_rne as _bf16_bits
from ..ops.row_scatter import bits_as_bf16 as _bits_as_bf16
from ..ops.row_scatter import rows_write, rows_write_dual


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


def init_sparse_adam(table: torch.Tensor, packed: bool = False):
    """Zero packed moments for ``table`` (sparse_embedding.py:129-148); the
    split (unpacked) moment layout is ROADMAP A4."""
    if not packed:
        raise NotImplementedError(
            "unpacked SparseAdam moments (f32 or split bf16) are not ported "
            "yet (ROADMAP A4); use table_opt_dtype='bfloat16' with "
            "table_update='pallas'")
    return SparseAdamPackedState(
        monu=torch.zeros(table.shape, dtype=torch.float32, device=table.device),
        count=torch.zeros((), dtype=torch.int32, device=table.device),
    )


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


def _segment_sum(g_rows: torch.Tensor, inv: torch.Tensor) -> torch.Tensor:
    """``zeros.at[inv].add(g_rows)``, deterministic on both devices (see
    ``ops.kernels.scatter_add_rows``)."""
    return scatter_add_rows(g_rows, inv, g_rows.shape[0])


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
    container) are updated IN PLACE and returned with the new state.
    """
    folded = isinstance(state, SparseAdamFoldedState)
    if not (folded or isinstance(state, SparseAdamPackedState)):
        raise NotImplementedError(
            "unpacked SparseAdam moments are not ported yet (ROADMAP A4)")
    if not use_pallas:
        raise NotImplementedError(
            "the scatter and unique table updates are not ported yet (ROADMAP A4)")
    if n_real is None or prep is None:
        raise ValueError("the write-kernel update needs n_real and prep")
    if monu_gather not in ("xla", "pallas"):
        raise ValueError(f"monu_gather must be xla|pallas, got {monu_gather!r}")
    K, dim = g_rows.shape
    P = pack_factor
    W = table.shape[1]
    Kp = pids.shape[0]
    count = state.count + 1
    t = count.to(torch.float32)
    g_sum = _segment_sum(g_rows, inv)
    r = rep[:, None]
    gids = torch.div(flat_ids, P, rounding_mode="floor") if P > 1 else flat_ids
    own_mask = (
        (torch.arange(W, dtype=torch.int32, device=table.device) // dim)[None, :]
        == torch.remainder(flat_ids, P)[:, None]
        if P > 1 else None
    )  # [K, W]: the lanes of each logical id's sub-row

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
