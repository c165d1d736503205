"""Row-sparse SparseAdam for the fused embedding table: the two-phase step's
table update (the port of ``mmlrec_tpu/train/sparse_embedding.py``).

The step gathers the batch's table rows, differentiates the loss w.r.t.
those rows only, and updates only the touched rows and their Adam moments
here; no ``[V, D]`` gradient, moment or update buffer exists.  Untouched
rows' moment decay is deferred, as in every production sparse optimizer
(torch.optim.SparseAdam).

Ported, the whole of the JAX module at one shard:

* the moment layouts: split moments of any float dtype (``SparseAdamState``:
  f32, bf16 or f16), packed bf16 pairs (``SparseAdamPackedState``) and the
  stacked (folded) container, with the conversions between them
  (``to_split_state``, ``to_runtime_state``, pack/unpack);
* the dedup metadata, from one stable sort: in the step on the device
  (``device_step_metadata``) or per batch on the host
  (``batch_step_metadata``, ``epoch_step_metadata``: numpy, or one pass of
  ``csrc/step_metadata_host.cpp`` through ``mmlrec_tpu_torch.native``,
  which also writes the upload form), with the gather route's lists
  (``want_route``: accperm, the pruned residuals, the logical duplicates);
* the updates: the dense-gradient row update of ``sparse_embedding_update``
  (``sparse_adam_row_update``); the scatter route (``two_phase_sparse_adam``:
  rep-masked row adds, the moments in their own dtype);
  ``two_phase_sparse_adam_unique``, on the write-kernel path (packed moments:
  one write of (table, monu) or of the stacked pair; split moments: one
  write of (table, mu, nu)) or as the unique update (row adds at distinct
  rows), with the scatter or the gather dedup route; and slot space
  (``two_phase_sparse_adam_slot``) on the stacked container.

The row-sharded table's shard-major stacked layout (``n_shards > 1``)
is here too; its shard-local updates are ``parallel/shard_embedding.py``.

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


#: ``table_opt_dtype`` -> the storage dtype of the table's split moments
MOMENT_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                 "float16": torch.float16}


class SparseAdamState(NamedTuple):
    """Split Adam moments of the table (sparse_embedding.py:38-41), stored in
    ``table_opt_dtype`` (f32, bf16 or f16; the update's arithmetic is f32);
    a checkpoint's split form of packed moments holds them as bfloat16."""

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


def split_stacked_planes(fat: torch.Tensor, n_shards: int = 1):
    """Folded [2Vp, W] container -> (table [Vp, W], monu [Vp, W])
    (sparse_embedding.py:151-172).  ``n_shards == 1`` is the plane-major
    layout (table rows in [0, Vp), the container in [Vp, 2Vp)): two views.
    ``n_shards > 1`` is the shard-major layout of a row-sharded table:
    rows [d 2r, (d + 1) 2r), r = Vp / n_shards, hold [table_d; monu_d], so
    each rank of model index d holds its own stacked container; the planes
    come back as copies."""
    Vp, W = fat.shape[0] // 2, fat.shape[1]
    if n_shards == 1:
        return fat[:Vp], fat[Vp:]
    v = fat.reshape(n_shards, 2, Vp // n_shards, W)
    return v[:, 0].reshape(Vp, W), v[:, 1].reshape(Vp, W)


def fold_stacked_planes(table: torch.Tensor, monu: torch.Tensor, n_shards: int = 1):
    """Inverse of split_stacked_planes: (table, monu) -> [2Vp, W] in the
    plane-major (``n_shards == 1``) or the shard-major layout."""
    if n_shards == 1:
        return torch.cat([table, monu])
    Vp, W = table.shape
    r = Vp // n_shards
    return torch.stack([table.reshape(n_shards, r, W), monu.reshape(n_shards, r, W)],
                       dim=1).reshape(2 * Vp, W)


def stacked_table_rows(phys: torch.Tensor, Vp: int, n_shards: int = 1):
    """Physical table rows -> their rows in the folded container: the
    identity at one shard, ``(p // r) 2r + p % r`` shard-major."""
    if n_shards == 1:
        return phys
    r = Vp // n_shards
    return torch.div(phys, r, rounding_mode="floor") * (2 * r) + torch.remainder(phys, r)


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


def _quantized_cap(need: int) -> int:
    """The route lists' width: 256 * 2^k, the least that holds ``need``
    (sparse_embedding.py:285-291), so that few distinct widths exist."""
    cap = 256
    while cap < need:
        cap *= 2
    return cap


#: the entries of the full metadata tuple, in order
_META_NAMES = ("inv", "rep", "pids", "pinv", "nuniq", "prep", "accperm", "resid_pos",
              "resid_slot", "gdup_pos", "gdup_tgt")
_MASKS = ("rep", "prep")
#: the 2-byte pad of resid_slot and gdup_tgt (``staging.MetaCodec``'s slot16)
_U16_DROP = 65535


def _array(out: Optional[dict], name: str, shape: tuple, dtype) -> np.ndarray:
    """An uninitialised array, ``out[name]`` where it has this shape and
    dtype (the caller's buffers, kept from call to call)."""
    a = None if out is None else out.get(name)
    if a is None or a.shape != shape or a.dtype != dtype:
        a = np.empty(shape, dtype)
        if out is not None:
            out[name] = a
    return a


def _native_step_metadata(source, idx_bits, pack_factor, Kp, want_route, r_cap_min, widths,
                          out):
    """The port's pass (csrc/step_metadata_host.cpp) over ``source``
    (``native.HostMetaSource``): one call, or under the gather route a sort
    with the counts that size its lists and then the fill, on a composite
    buffer ``out`` keeps.  Each entry in its width (``widths``; None: the
    raw int32 / float32 arrays); width 0 builds nothing and gives the
    codec's dead ``[steps, 1]`` uint8 zeros."""
    from ..native import host_metadata_fill, host_metadata_sort

    steps, K = source.steps, source.K
    n = len(_META_NAMES) if want_route else 6 if pack_factor else 2
    widths = tuple(widths or (4,) * n)
    R_cap = G_cap = 0
    comp = None
    if want_route:
        comp = _array(out, "comp", (steps, K), np.int64)
        n_resid, n_ldup = host_metadata_sort(source, idx_bits, pack_factor, comp)
        R_cap = _quantized_cap(max(int(n_resid.max(initial=0)), int(r_cap_min)))
        G_cap = _quantized_cap(max(int(n_ldup.max(initial=0)), int(r_cap_min)))
    cols = dict(pids=Kp, accperm=Kp, nuniq=1, resid_pos=R_cap, resid_slot=R_cap,
                gdup_pos=G_cap, gdup_tgt=G_cap)
    outs, meta = [None] * len(_META_NAMES), []
    for i, (name, width) in enumerate(zip(_META_NAMES, widths)):
        if width == 0:
            meta.append(_array(out, name, (steps, 1), np.uint8))
            meta[-1].fill(0)
            continue
        dtype = ({4: np.float32, 1: np.uint8} if name in _MASKS
                 else {4: np.int32, 2: np.uint16})[width]
        outs[i] = _array(out, name, (steps, cols.get(name, K)), dtype)
        meta.append(outs[i])
    drops = ((_U16_DROP if widths[8] == 2 else Kp, _U16_DROP if widths[10] == 2 else K)
             if want_route else (0, 0))
    host_metadata_fill(source, idx_bits, pack_factor or 1, comp, Kp or 0, R_cap, G_cap, drops,
                       outs)
    return tuple(meta)


def _step_metadata(source, flat, pack_factor, n_phys_rows, chunk, want_route, r_cap_min,
                   use_native, widths=None, out=None):
    """(metadata, whether the native pass built it) of ``source``'s steps:
    the pass where its library loads (``use_native`` None), else numpy
    over the flat ids ``flat()`` in the raw form."""
    steps, K = source.steps, source.K
    idx_bits = max(1, int(K - 1).bit_length())
    Kp = None
    if pack_factor is not None:
        if n_phys_rows is None:
            raise ValueError("n_phys_rows required with pack_factor")
        Kp = -(-K // chunk) * chunk
        if n_phys_rows <= Kp:
            raise ValueError(
                f"unique-update metadata needs n_phys_rows > {Kp}, got {n_phys_rows}")
    if use_native is not False:
        from ..native import NativeUnavailable

        try:
            meta = _native_step_metadata(source, idx_bits, pack_factor, Kp, want_route,
                                         r_cap_min, widths, out)
            metadata_calls["native"] += 1
            return meta, True
        except NativeUnavailable:
            if use_native:
                raise
    return _numpy_step_metadata(flat(), idx_bits, pack_factor, Kp, want_route,
                                r_cap_min), False


def batch_step_metadata(
    flat_ids: np.ndarray,
    pack_factor: Optional[int] = None,
    n_phys_rows: Optional[int] = None,
    chunk: int = 256,
    want_route: bool = False,
    r_cap_min: int = 0,
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

    ``want_route`` adds the gather route's lists: ``accperm`` [steps, Kp]
    (each slot's first physical contributor, pads 0), ``resid_pos`` /
    ``resid_slot`` [steps, R_cap] (the positions that are logical-first but
    not physical-first, the only other ones whose contribution can be
    nonzero, and their slots; padded with (0, Kp), slot Kp drops) and
    ``gdup_pos`` / ``gdup_tgt`` [steps, G_cap] (each non-first logical
    occurrence and its first occurrence, padded with (0, K), target K
    drops).  R_cap and G_cap are ``_quantized_cap`` of the call's largest
    count and of ``r_cap_min``, the caller's monotone floor.

    The port's pass (``mmlrec_tpu_torch/csrc/step_metadata_host.cpp``)
    runs when its library loads (``use_native`` None), for every form; when
    it does not, numpy runs, unless ``use_native=True`` asked for the
    library, which then raises.  Both give the same bits."""
    from ..native import HostMetaSource

    flat = np.asarray(flat_ids)
    return _step_metadata(HostMetaSource(flat), lambda: flat, pack_factor, n_phys_rows, chunk,
                          want_route, r_cap_min, use_native)[0]


def epoch_step_metadata(ids: np.ndarray, rows: np.ndarray, offsets: np.ndarray,
                        pack_factor: Optional[int] = None, n_phys_rows: Optional[int] = None,
                        want_route: bool = False, r_cap_min: int = 0,
                        widths: Optional[tuple] = None, out: Optional[dict] = None,
                        use_native: Optional[bool] = None):
    """``batch_step_metadata`` of the steps whose flat ids are
    ``ids[rows[b], :F] + offsets`` (F = len(offsets)) for ``rows`` [steps,
    B], read inside the native pass.  With the pass, each entry comes in
    its width of ``widths`` (an upload form: see ``_native_step_metadata``)
    in ``out``'s buffers where they fit; without it, numpy gives the raw
    form.  Returns (metadata, whether the pass built it)."""
    from ..native import HostMetaSource

    def flat():
        F = len(offsets)
        return (ids[rows.reshape(-1), :F].astype(np.int64) + offsets).reshape(len(rows), -1)

    return _step_metadata(HostMetaSource(ids, rows, offsets), flat, pack_factor, n_phys_rows,
                          256, want_route, r_cap_min, use_native, widths, out)


def _numpy_step_metadata(flat, idx_bits, pack_factor, Kp, want_route, r_cap_min):
    """The numpy formulation of ``batch_step_metadata``."""
    steps, K = flat.shape
    flat = np.asarray(flat, np.int64)
    assert int(flat.max(initial=0)) < (1 << (63 - idx_bits)), "id overflow"
    comp = np.sort((flat << idx_bits) | np.arange(K, dtype=np.int64), axis=1)
    want_phys = pack_factor is not None
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
    if want_route:
        # a position that is neither logical-first nor physical-first adds
        # an exact zero to every plane of the update, so the residuals are
        # the logical-first positions that are not physical-first (each
        # physical run starts at a logical first occurrence)
        resid = newv & ~pnew
        R_cap = _quantized_cap(max(int(resid.sum(axis=1).max(initial=0)), int(r_cap_min)))
        G_cap = _quantized_cap(max(int((K - newv.sum(axis=1)).max(initial=0)),
                                   int(r_cap_min)))
        accperm = np.zeros((steps, Kp), np.int32)
        resid_pos = np.zeros((steps, R_cap), np.int32)
        resid_slot = np.full((steps, R_cap), Kp, np.int32)  # Kp = drop
        gdup_pos = np.zeros((steps, G_cap), np.int32)
        gdup_tgt = np.full((steps, G_cap), K, np.int32)  # K = drop
    for b in range(steps):
        u = psvals[b][pnew[b]]
        U = len(u)
        pids[b, :U] = u
        if want_route:
            ob = order[b]
            accperm[b, :U] = ob[pnew[b]]
            R = int(resid[b].sum())
            resid_pos[b, :R] = ob[resid[b]]
            resid_slot[b, :R] = pgrp[b][resid[b]]
            dup = ~newv[b]  # the non-first logical occurrences, in sorted order
            L = int(dup.sum())
            gdup_pos[b, :L] = ob[dup]
            gdup_tgt[b, :L] = fs_sorted[b][dup]
        if U < Kp:
            # distinct untouched rows at the tail: the first non-members of
            # u in [0, Kp]
            present = np.zeros(Kp + 1, bool)
            present[u[u <= Kp]] = True
            pids[b, U:] = np.flatnonzero(~present)[: Kp - U]
    if want_route:
        return (inv, rep, pids, pinv, nuniq, prep, accperm, resid_pos, resid_slot,
                gdup_pos, gdup_tgt)
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


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded f32 square root, as XLA computes it.  The CPU
    build's vectorised f32 ``torch.sqrt`` is one ulp off on some inputs;
    the f64 root rounded to f32 is exact (53 >= 2 x 24 + 2 bits), so the
    CPU takes that.  The card's ``sqrtf`` is IEEE already."""
    if x.device.type == "cpu":
        return torch.sqrt(x.double()).float()
    return torch.sqrt(x)


def _adam_rows(mu_f, nu_f, g_sum, t, lr, b1, b2, eps):
    """(new_mu, new_nu, table delta) of the narrow [K, dim] Adam chain."""
    new_mu = b1 * mu_f + (1.0 - b1) * g_sum
    new_nu = b2 * nu_f + (1.0 - b2) * g_sum * g_sum
    mu_hat = new_mu / (1.0 - b1 ** t)
    nu_hat = new_nu / (1.0 - b2 ** t)
    return new_mu, new_nu, -lr * mu_hat / (_sqrt(nu_hat) + eps)


def _spread_drops(index: torch.Tensor, n: int) -> torch.Tensor:
    """``index`` in ``[0, n]`` with each drop value ``n`` sent to a scratch
    row of its own, ``n + j`` for entry j: the lists' pads (up to most of
    a list at its floor width) would otherwise all add into one row, one
    after another."""
    j = torch.arange(index.shape[0], dtype=torch.long, device=index.device)
    return torch.where(index >= n, n + j, index.long())


def _scatter_into(base: torch.Tensor, index: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """``base.at[index].add(values, mode="drop")`` on int32 planes by
    ``index_add_``, for ``index`` in ``[0, len(base)]``: the drops land in
    scratch rows that are sliced away.  Integer adds, so exact in any
    order, atomics on the card included."""
    n = base.shape[0]
    out = torch.cat([base, base.new_zeros((index.shape[0],) + tuple(base.shape[1:]))])
    return out.index_add_(0, _spread_drops(index, n), values)[:n]


def _gdup_sum(g_rows, gdup_pos, gdup_tgt) -> torch.Tensor:
    """The gradient sums by the gather route (sparse_embedding.py:870-877):
    ``g_rows.at[gdup_tgt].add(g_rows[gdup_pos], mode="drop")``: each first
    occurrence gets its duplicates added in position order, as the
    inv-scatter adds them; the other positions keep their own rows, which
    every consumer masks.  The sums run from zeros with the first
    occurrences ahead of their duplicates (``scatter_add_rows``, in
    position order on both devices): 0 + g_first + d1 + ... has the bits of
    g_first + d1 + ..., and on the card, where ``index_put_`` adds a
    target's values first and then their sum to the old row, the old row
    is the zero, so every sum is the inv-scatter's of the scatter route."""
    K, G = g_rows.shape[0], gdup_tgt.shape[0]
    dup = g_rows.index_select(0, gdup_pos.long())
    first = torch.arange(K, dtype=torch.long, device=g_rows.device)
    index = torch.cat([first, _spread_drops(gdup_tgt, K)])
    return scatter_add_rows(torch.cat([g_rows, dup]), index, K + G)[:K]


def _route_rows(c: torch.Tensor, accperm, resid_pos, resid_slot) -> torch.Tensor:
    """An int32 plane [K, X] accumulated at its slots by the gather route
    (sparse_embedding.py:1018-1020): ``c[accperm].at[resid_slot].add(
    c[resid_pos], mode="drop")`` -> [Kp, X].  Integer adds, so bitwise
    equal to ``zeros[Kp].at[pinv].add(c)`` wherever the dropped positions
    contribute zeros."""
    return _scatter_into(c.index_select(0, accperm.long()), resid_slot,
                         c.index_select(0, resid_pos.long()))


def sparse_adam_row_update(
    table: torch.Tensor,
    g_table: torch.Tensor,  # [V, W] dense gradient of the table
    flat_ids: torch.Tensor,  # [K] rows touched this batch (duplicates OK)
    state: SparseAdamState,
    lr: float,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
) -> Tuple[torch.Tensor, SparseAdamState]:
    """SparseAdam of the touched rows from the dense table gradient, the
    ``sparse_embedding_update`` step (sparse_embedding.py:222-271): the
    moments are read in their dtype, the math is f32, and each touched row
    of the table and its moments is set once per occurrence (duplicates
    write equal values).  ``table``, the moments and the count are updated
    in place and returned with the state."""
    count = state.count.add_(1)  # in place: a captured step reads it
    rows = flat_ids.long()
    new = sparse_adam_rows(table, g_table, rows, state, count.to(torch.float32), lr, b1, b2, eps)
    for arr, value in zip((table, state.mu, state.nu), new):
        arr.index_copy_(0, rows, value)
    return table, SparseAdamState(mu=state.mu, nu=state.nu, count=count)


def sparse_adam_rows(table, g_table, rows, state: SparseAdamState, t, lr, b1, b2, eps):
    """(table, mu, nu) rows [K, W] after SparseAdam's step ``t`` at the
    physical ``rows``: the moments read and returned in their dtype, the
    math in f32 (``sparse_adam_row_update``)."""
    mdt = state.mu.dtype
    g = g_table.index_select(0, rows)
    mu_rows = b1 * state.mu.index_select(0, rows).float() + (1.0 - b1) * g
    nu_rows = b2 * state.nu.index_select(0, rows).float() + (1.0 - b2) * g * g
    mu_hat = mu_rows / (1.0 - b1 ** t)
    nu_hat = nu_rows / (1.0 - b2 ** t)
    update = lr * mu_hat / (_sqrt(nu_hat) + eps)
    return table.index_select(0, rows) - update, mu_rows.to(mdt), nu_rows.to(mdt)


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
    each id's first occurrence, the moments' rows are gathered in their
    dtype ``mdt``, and table, mu and nu each receive ``old + delta`` as an
    ADD of the masked delta: the table's in f32, the moments' as
    ``(new.to(mdt) - old) * rep`` computed and added in ``mdt``, as the JAX
    scatter does it.  ``table``, the moments and the count are updated in
    place and returned with the state."""
    if not isinstance(state, SparseAdamState):
        raise TypeError("the scatter update takes split moments (SparseAdamState)")
    dim = g_rows.shape[-1]
    mdt = state.mu.dtype
    count = state.count.add_(1)  # in place: a captured step reads it
    t = count.to(torch.float32)
    g_sum = _segment_sum(g_rows, inv)
    mu_rows = gather_rows(state.mu, flat_ids, dim, pack_factor)
    nu_rows = gather_rows(state.nu, flat_ids, dim, pack_factor)
    new_mu, new_nu, d_table = _adam_rows(mu_rows.float(), nu_rows.float(), g_sum, t, lr,
                                         b1, b2, eps)
    r = rep[:, None]
    _scatter_add_rows(table, flat_ids, d_table * r, pack_factor)
    r_m = r.to(mdt)
    _scatter_add_rows(state.mu, flat_ids, (new_mu.to(mdt) - mu_rows) * r_m, pack_factor)
    _scatter_add_rows(state.nu, flat_ids, (new_nu.to(mdt) - nu_rows) * r_m, pack_factor)
    return table, SparseAdamState(mu=state.mu, nu=state.nu, count=count)


def two_phase_sparse_adam_slot(
    table: torch.Tensor,  # [2Vp, W] stacked table + moment container
    g_rows: torch.Tensor,  # [K, D] cotangent w.r.t. the gathered rows
    flat_ids: torch.Tensor,  # [K] int32 logical row ids (duplicates OK)
    rep: torch.Tensor,  # [K] 1.0 at first occurrences
    pids: torch.Tensor,  # [Kp] unique physical rows
    n_real: torch.Tensor,  # [1] int32: pids[n_real:] are padding
    sup_slot: torch.Tensor,  # [Kp, W] old table rows at the slots
    monu_slot: torch.Tensor,  # [Kp, W] old container rows at the slots
    state: SparseAdamFoldedState,
    lr: float,
    accperm: torch.Tensor,  # [Kp] each slot's first physical contributor
    resid_pos: torch.Tensor,  # [R_cap] the pruned residual positions
    resid_slot: torch.Tensor,  # [R_cap] their slots (Kp = drop)
    gdup_pos: torch.Tensor,  # [G_cap] the non-first logical occurrences
    gdup_tgt: torch.Tensor,  # [G_cap] their first occurrences (K = drop)
    pack_factor: int = 1,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    bounds: Optional[torch.Tensor] = None,  # [2] int32: write slots [lo, hi) only
    g_sum: Optional[torch.Tensor] = None,  # [K, D] the gradient sums, when given
) -> Tuple[torch.Tensor, SparseAdamFoldedState]:
    """Slot-space SparseAdam of the stacked container
    (sparse_embedding.py:689-809): the masked wide gradient and a [K, P]
    lane-ownership plane are routed to the slots as int32 (one nonzero
    contributor per (slot, lane), so the f32 bits land exactly), and the
    wide-lane Adam chain runs on the slot rows that phase 1 gathered by
    ``pids``.  Per owned lane it is the position path's op chain on the
    same inputs; every other lane keeps its old bits through selects (so
    -0.0 and NaN payloads survive), and the pad slots, which hold the
    gather's poison, are never written (``n_real``).  One launch of the
    dual write.  The container and the count are updated in place.  A row
    shard (``parallel/shard_embedding.py``) passes its local ``pids``, its
    window as ``bounds`` and, from the pipelined exchange, ``g_sum``."""
    if not isinstance(state, SparseAdamFoldedState):
        raise TypeError("slot space runs on the stacked container (SparseAdamFoldedState)")
    K, dim = g_rows.shape
    P = pack_factor
    W = table.shape[1]
    Vp = table.shape[0] // 2
    Kp = pids.shape[0]
    count = state.count.add_(1)  # in place: a captured step reads it
    t = count.to(torch.float32)
    if g_sum is None:
        g_sum = _gdup_sum(g_rows, gdup_pos, gdup_tgt)
    rep_b = (rep > 0)[:, None]
    if P > 1:
        gw = torch.where(_own_mask(flat_ids, P, dim) & rep_b, g_sum.repeat(1, P), 0.0)
        lanes = torch.arange(P, dtype=torch.int32, device=flat_ids.device)
        ow = ((lanes[None, :] == torch.remainder(flat_ids, P)[:, None]) & rep_b)
    else:
        gw = torch.where(rep_b, g_sum, 0.0)
        ow = rep_b
    g_slot = _route_rows(gw.view(torch.int32), accperm, resid_pos, resid_slot)
    g_slot = g_slot.view(torch.float32)
    ow_slot = _route_rows(ow.to(torch.int32), accperm, resid_pos, resid_slot)
    n_own = ow_slot.shape[1]
    touched = (ow_slot > 0)[:, :, None].expand(Kp, n_own, W // n_own).reshape(Kp, W)
    mu_w, nu_w = unpack_monu_f32(monu_slot)
    new_mu_w = b1 * mu_w + (1.0 - b1) * g_slot
    new_nu_w = b2 * nu_w + (1.0 - b2) * g_slot * g_slot
    mu_hat_w = new_mu_w / (1.0 - b1 ** t)
    nu_hat_w = new_nu_w / (1.0 - b2 ** t)
    d_w = -lr * mu_hat_w / (_sqrt(nu_hat_w) + eps)
    new_t = torch.where(touched, sup_slot + d_w, sup_slot)
    new_monu = torch.where(touched, pack_monu_rounded(new_mu_w, new_nu_w), monu_slot)
    rows_write_dual(table.view(2, Vp, W), pids, torch.stack([new_t, new_monu]), n_real=n_real,
                    bounds=bounds)
    return table, SparseAdamFoldedState(count=count)


def two_phase_sparse_adam_unique(
    table: torch.Tensor,
    g_rows: torch.Tensor,  # [K, D] cotangent w.r.t. the gathered rows
    flat_ids: torch.Tensor,  # [K] int32 logical row ids (duplicates OK)
    inv: torch.Tensor,  # [K] first-occurrence positions
    rep: torch.Tensor,  # [K] 1.0 at first occurrences
    pids: torch.Tensor,  # [Kp] unique physical rows, then pads
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
    accperm: Optional[torch.Tensor] = None,  # [Kp] gather route (want_route lists)
    resid_pos: Optional[torch.Tensor] = None,  # [R_cap]
    resid_slot: Optional[torch.Tensor] = None,  # [R_cap] (Kp = drop)
    gdup_pos: Optional[torch.Tensor] = None,  # [G_cap]
    gdup_tgt: Optional[torch.Tensor] = None,  # [G_cap] (K = drop)
    bounds: Optional[torch.Tensor] = None,  # [2] int32: write slots [lo, hi) only
    g_sum: Optional[torch.Tensor] = None,  # [K, D] the gradient sums, when given
    sup_moments: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,  # split [K, W] rows
) -> Tuple[torch.Tensor, object]:
    """SparseAdam of the touched rows with one update per physical row
    (sparse_embedding.py:812-1141).

    The gradient sums come from the inv-scatter, or with ``gdup_pos`` from
    the gather route's duplicate lists (``inv`` is then not read).  Packed
    moments (the stacked container or ``SparseAdamPackedState``): the Adam
    chain runs at full lane width [K, W] on the unpacked moments; each owned
    lane rides as a wrapping int32 delta ``new - old`` and each physical
    row's first occurrence adds its old row, accumulated at the slots as
    integers, by one scatter at ``pinv`` or, with ``accperm``, by the gather
    route per plane (``pinv`` is then not read): per lane the sum is the new
    bits where owned and the old bits elsewhere, exact in any order.  The
    sums are written with one launch: ``rows_write_dual`` into the stacked
    container, or ``rows_write`` into (table, monu).  Split moments
    (``SparseAdamState`` of dtype ``mdt``): the narrow Adam chain, one f32
    accumulation of (table, mu, nu) at the slots and one ``rows_write``.
    ``use_pallas=False`` is the unique update (XLA's unique-indices
    scatter): the accumulated deltas added at the distinct rows ``pids``,
    pads included, with ``index_add_``.  ``table`` (and the moments) and the
    count are updated in place and returned with the state.

    A row shard (``parallel/shard_embedding.py``) passes its local ``pids``,
    its window as ``bounds`` (the write-kernel path), its old rows
    (``sup``, ``sup_c``, ``sup_moments``: zeros where it owns no row) and,
    from the pipelined exchange, ``g_sum``.
    """
    folded = isinstance(state, SparseAdamFoldedState)
    split = isinstance(state, SparseAdamState)
    if not (folded or split or isinstance(state, SparseAdamPackedState)):
        raise TypeError(f"unknown SparseAdam state {type(state).__name__}")
    if folded and not use_pallas:
        raise ValueError("table_container='stacked' requires the write kernel (use_pallas)")
    if use_pallas and (n_real is None or prep is None):
        raise ValueError("the write-kernel update needs n_real and prep")
    if monu_gather not in ("xla", "pallas"):
        raise ValueError(f"monu_gather must be xla|pallas, got {monu_gather!r}")
    K, dim = g_rows.shape
    P = pack_factor
    W = table.shape[1]
    Kp = pids.shape[0]
    count = state.count.add_(1)  # in place: a captured step reads it
    t = count.to(torch.float32)
    if g_sum is None:
        g_sum = (_gdup_sum(g_rows, gdup_pos, gdup_tgt) if gdup_pos is not None
                 else _segment_sum(g_rows, inv))
    r = rep[:, None]
    gids = torch.div(flat_ids, P, rounding_mode="floor") if P > 1 else flat_ids
    if split:
        return _unique_split(table, g_sum, flat_ids, gids, r, pids, pinv, state, count, t,
                             lr, P, b1, b2, eps, use_pallas, n_real, sup, prep, bounds,
                             sup_moments)
    own_mask = _own_mask(flat_ids, P, dim) if P > 1 else None

    def own_sel(x):
        return torch.where(own_mask, x, 0.0) if P > 1 else x

    def route(c):
        return _route_rows(c, accperm, resid_pos, resid_slot)

    if folded:
        Vp = table.shape[0] // 2
        monu_src, monu_ids = table, gids + Vp
    else:
        monu_src, monu_ids = state.monu, gids
    if sup_c is None:
        sup_c = (rows_gather_hbm(monu_src, monu_ids) if monu_gather == "pallas"
                 else monu_src.index_select(0, monu_ids.long()))
    # packed Adam at full lane width; non-owned lanes compute values that
    # the own selects below discard
    mu_w, nu_w = unpack_monu_f32(sup_c)
    g_w = own_sel(g_sum.repeat(1, P)) if P > 1 else g_sum
    new_mu_w = b1 * mu_w + (1.0 - b1) * g_w
    new_nu_w = b2 * nu_w + (1.0 - b2) * g_w * g_w
    mu_hat_w = new_mu_w / (1.0 - b1 ** t)
    nu_hat_w = new_nu_w / (1.0 - b2 ** t)
    d_table_w = -lr * mu_hat_w / (_sqrt(nu_hat_w) + eps) * r
    vals_c = pack_monu_rounded(new_mu_w, new_nu_w)
    r_w = r.expand(K, W)
    own = torch.where(own_mask, r_w, 0.0) if P > 1 else r_w
    owned = own > 0
    if not use_pallas:
        # the unique update of packed moments (sparse_embedding.py:1066-1083)
        pl = pinv.long()
        acc_vals = torch.zeros((Kp, W), dtype=torch.int32, device=table.device).index_add_(
            0, pl, torch.where(owned, vals_c.view(torch.int32), 0)).view(torch.float32)
        acc_mask = torch.zeros((Kp, W), device=table.device).index_add_(0, pl, own)
        acc_t = torch.zeros((Kp, W), device=table.device).index_add_(0, pl, own_sel(d_table_w))
        table.index_add_(0, pids.long(), acc_t)
        old = state.monu.index_select(0, pids.long())
        state.monu.index_copy_(0, pids.long(), torch.where(acc_mask > 0, acc_vals, old))
        return table, SparseAdamPackedState(monu=state.monu, count=count)
    if sup is None:
        sup = table.index_select(0, gids.long())
    prep_i = prep.to(torch.int32)[:, None]
    old_i = sup_c.contiguous().view(torch.int32)
    new_i = vals_c.view(torch.int32)
    contrib_monu_i = torch.where(owned, new_i - old_i, 0) + prep_i * old_i
    old_ti = sup.contiguous().view(torch.int32)
    new_t = sup + own_sel(d_table_w)
    contrib_t_i = torch.where(owned, new_t.view(torch.int32) - old_ti, 0) + prep_i * old_ti
    if folded:
        if accperm is not None:  # per plane: no stacked [2, K, W] copy
            accd = torch.stack([route(contrib_t_i), route(contrib_monu_i)])
        else:
            accd = torch.zeros((2, Kp, W), dtype=torch.int32, device=table.device)
            accd.index_add_(1, pinv.long(), torch.stack([contrib_t_i, contrib_monu_i]))
        rows_write_dual(table.view(2, Vp, W), pids, accd.view(torch.float32), n_real=n_real,
                        bounds=bounds)
        return table, SparseAdamFoldedState(count=count)
    if accperm is not None:
        acc_t = route(contrib_t_i).view(torch.float32)
        acc_monu = route(contrib_monu_i).view(torch.float32)
    else:
        acc2 = torch.zeros((Kp, 2 * W), dtype=torch.int32, device=table.device)
        acc2.index_add_(0, pinv.long(), torch.cat([contrib_t_i, contrib_monu_i], dim=1))
        acc2 = acc2.view(torch.float32)
        acc_t, acc_monu = acc2[:, :W], acc2[:, W:]
    rows_write((table, state.monu), pids, (acc_t, acc_monu), n_real=n_real, bounds=bounds)
    return table, SparseAdamPackedState(monu=state.monu, count=count)


def _unique_split(table, g_sum, flat_ids, gids, r, pids, pinv, state, count, t, lr, P,
                  b1, b2, eps, use_pallas, n_real, sup, prep, bounds=None, sup_moments=None):
    """The update of split moments of dtype ``mdt`` (sparse_embedding.py:
    1085-1141): the narrow Adam chain at the logical rows, the moments'
    deltas as ``new.to(mdt).float() - old``.  With the write kernel, ONE f32
    accumulation of three [Kp, W] buffers at each physical row's slot, where
    the first occurrence of a physical row adds the old (table, mu, nu) row
    and each owner its masked delta (per lane at most one of them past zero
    besides the old value, so the order of the adds is immaterial), and ONE
    launch of the write kernel (B3) over (table, mu, nu), the moments
    rounded to ``mdt``.  Without it (the unique update), each buffer holds
    the deltas alone and is added at the distinct rows ``pids``."""
    dim = g_sum.shape[-1]
    W = table.shape[1]
    Kp = pids.shape[0]
    mdt = state.mu.dtype
    gl = gids.long()
    if sup_moments is None:
        sup_moments = (state.mu.index_select(0, gl), state.nu.index_select(0, gl))
    sup_mu, sup_nu = (m.float() for m in sup_moments)
    if P > 1:
        sub = _sub_rows(flat_ids, P)
        mu_f = sup_mu.reshape(-1, dim).index_select(0, sub)
        nu_f = sup_nu.reshape(-1, dim).index_select(0, sub)
    else:
        mu_f, nu_f = sup_mu, sup_nu
    new_mu, new_nu, d_table = _adam_rows(mu_f, nu_f, g_sum, t, lr, b1, b2, eps)
    deltas = (d_table * r, (new_mu.to(mdt).float() - mu_f) * r,
              (new_nu.to(mdt).float() - nu_f) * r)
    if not use_pallas:
        pl, rows = pinv.long(), pids.long()
        for arr, d in zip((table, state.mu, state.nu), deltas):
            acc = torch.zeros((Kp, W), device=table.device).index_add_(
                0, pl, _widen(d, flat_ids, P))
            arr.index_add_(0, rows, acc.to(arr.dtype))
        return table, SparseAdamState(mu=state.mu, nu=state.nu, count=count)
    if sup is None:
        sup = table.index_select(0, gl)
    pr = prep[:, None]
    contrib = torch.cat([_widen(d, flat_ids, P) + old * pr
                         for d, old in zip(deltas, (sup, sup_mu, sup_nu))], dim=1)
    acc3 = torch.zeros((Kp, 3 * W), dtype=torch.float32, device=table.device)
    acc3.index_add_(0, pinv.long(), contrib)
    rows_write((table, state.mu, state.nu), pids,
               (acc3[:, :W], acc3[:, W:2 * W].to(mdt), acc3[:, 2 * W:].to(mdt)),
               n_real=n_real, bounds=bounds)
    return table, SparseAdamState(mu=state.mu, nu=state.nu, count=count)
