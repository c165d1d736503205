"""Row writes and updates of the embedding table, with their plain versions.

The counterpart of ``mmlrec_tpu/ops/pallas_scatter.py``:

* ``rows_write`` replaces ``pallas_rows_write`` (:194):
  ``arrays[a][ids[k]] = values[a][k]`` over several ``[V, D_a]`` arrays;
* ``rows_write_dual`` replaces ``pallas_rows_write_dual`` (:532):
  ``stacked[:, ids[k]] = values[:, k]`` on the ``[2, V, W]`` (table,
  moment) container;
* ``rows_write_pipelined`` replaces ``pallas_rows_write_pipelined`` (:349):
  ``rows_write``'s contract with the values staged in double buffers;
* ``rows_update`` / ``rows_add`` replace ``pallas_rows_update`` (:397) and
  ``pallas_rows_add`` (:479): a fused read-modify-write (see there).

For the writes, only slots in the window ``[lo, hi)`` are written (``n_real`` gives
``[0, n_real)``, ``bounds`` gives ``[lo, hi)``, neither gives every slot),
and an id outside ``[0, V)`` after wrapping a negative id once is dropped,
as the JAX references' ``mode="drop"`` scatters do.  Ids must be unique
inside the window.

The JAX functions are functional with ``input_output_aliases``: the big
array is donated and comes back updated.  Here the wrappers write INTO the
given arrays and return them, so no copy of a multi-GB table is made.  Call
them under ``torch.no_grad()`` on parameters.

Routing as in ``ops/kernels.py``: CPU tensors take the plain version;
tensors on one CUDA device launch a kernel of ``csrc/row_kernels.cu``
(``rows_write_kernel`` for the first two) or raise; each launch adds one to
``launch_counts``.  Bound on the H100 by bytes: each written row is read
once from the values and written once into the array.  Design: one warp
per slot, 16-byte copies; the window and the id's range are checked before
the id becomes an address, so the device metadata's pad slots (id = V,
one past the last row) are never stored.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from . import cuda_build
from .cuda_build import launch_counts
from .row_gather import LIBRARY, _check_ids, _check_window, _unit, window, window_pointers

launch_counts.update(rows_write=0, rows_write_dual=0, rows_write_pipelined=0, rows_update=0)

MAX_ARRAYS = 8  # kMaxArrays in the CUDA source
_FIELDS = 9  # long longs per array in WriteArgs
_UPDATE_FIELDS = 11  # long longs per array in UpdateArgs
_PIPELINE_BYTES = 20 * 1024  # shared memory of one of the two value buffers
_BLOCKS_PER_SM = 4  # persistent blocks of the pipelined write
_KINDS = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}
_LANE_ELEMS = 8  # kLaneElems (MMLREC_UPDATE_LANE_ELEMS) in the CUDA source


def _kept_slots(ids: torch.Tensor, V: int, n_real=None, bounds=None):
    """(slot positions, resolved row ids) of the slots a write stores."""
    K = ids.shape[0]
    lo, hi = window(K, n_real, bounds, device=ids.device)
    k = torch.arange(K, device=ids.device)
    idx = ids.long()
    idx = torch.where(idx < 0, idx + V, idx)
    keep = (k >= lo) & (k < hi) & (idx >= 0) & (idx < V)
    slots = keep.nonzero().squeeze(1)
    return slots, idx[slots]


def _check_values(name: str, a: torch.Tensor, v: torch.Tensor, shape) -> None:
    if v.dtype != a.dtype:
        raise TypeError(f"{name}: values {v.dtype} do not match the array's {a.dtype}")
    if tuple(v.shape) != tuple(shape):
        raise ValueError(f"{name}: values {list(v.shape)}, expected {list(shape)}")


def _write_args(entries):
    """The flat WriteArgs of the CUDA source.  entries: (dst, src, rows,
    row_bytes, src_row, dst_plane, src_plane, planes) per array, addresses
    and strides in bytes."""
    args = (ctypes.c_longlong * (_FIELDS * MAX_ARRAYS + 1))()
    for i, (dst, src, rows, row_bytes, src_row, dst_plane, src_plane, planes) in enumerate(entries):
        unit = _unit(row_bytes, dst, src, src_row, dst_plane, src_plane)
        args[_FIELDS * i:_FIELDS * (i + 1)] = [
            dst, src, rows, row_bytes, src_row, dst_plane, src_plane, planes, unit]
    args[_FIELDS * MAX_ARRAYS] = len(entries)
    return args


def _write_launch(name: str, entries, ids, n_real, bounds, device) -> None:
    K = ids.shape[0]
    if K == 0:
        return
    args = _write_args(entries)
    lo_p, hi_p = window_pointers(n_real, bounds)
    ids = ids.contiguous()
    cuda_build.launch(LIBRARY, name, LIBRARY.load().mmlrec_rows_write, ctypes.addressof(args),
                      ids.data_ptr(), K, lo_p, hi_p, device=device)


def _row_major(name: str, v: torch.Tensor) -> None:
    if v.stride(-1) != 1:
        raise ValueError(f"{name}: value rows must be contiguous")


# ----------------------------------------------------------------------
# B3: write rows of several arrays
# ----------------------------------------------------------------------
def rows_write_plain(arrays, ids, values, *, n_real=None, bounds=None):
    """In place ``arrays[a][ids[k]] = values[a][k]`` for the kept slots
    (the reference path of pallas_scatter.py:39-48)."""
    slots, rows = _kept_slots(ids, arrays[0].shape[0], n_real, bounds)
    for a, v in zip(arrays, values):
        a.index_copy_(0, rows, v.index_select(0, slots))
    return tuple(arrays)


def rows_write(
    arrays: Sequence[torch.Tensor],
    ids: torch.Tensor,
    values: Sequence[torch.Tensor],
    *,
    n_real: Optional[torch.Tensor] = None,
    bounds: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, ...]:
    """Write ``values[a][k]`` into row ``ids[k]`` of ``arrays[a]`` (each
    ``[V, D_a]``, any widths and dtypes) for every slot in the window, in
    place and in one launch; returns the arrays.  Replaces
    ``mmlrec_tpu/ops/pallas_scatter.py::pallas_rows_write`` (:194)."""
    name = "rows_write"
    arrays, values = tuple(arrays), tuple(values)
    if not _write_on_cuda(name, arrays, ids, values, n_real, bounds):
        return rows_write_plain(arrays, ids, values, n_real=n_real, bounds=bounds)
    _write_launch(name, _write_entries(name, arrays, values), ids, n_real, bounds,
                  arrays[0].device)
    return arrays


def _write_on_cuda(name, arrays, ids, values, n_real, bounds) -> bool:
    """The checks that rows_write and rows_write_pipelined share; False for
    CPU tensors."""
    _check_ids(name, ids)
    if not arrays or len(arrays) != len(values):
        raise ValueError(f"{name}: {len(arrays)} arrays, {len(values)} value blocks")
    V, K = arrays[0].shape[0], ids.shape[0]
    for a, v in zip(arrays, values):
        if a.dim() != 2 or a.shape[0] != V:
            raise ValueError(f"{name}: every array must be [{V}, D], got {list(a.shape)}")
        _check_values(name, a, v, (K, a.shape[1]))
    window_t = [t for t in (n_real, bounds) if t is not None]
    if not cuda_build.on_cuda(name, *arrays, ids, *values, *window_t):
        return False
    if len(arrays) > MAX_ARRAYS:
        raise ValueError(f"{name}: at most {MAX_ARRAYS} arrays in one launch")
    return True


def _write_entries(name, arrays, values):
    entries = []
    for a, v in zip(arrays, values):
        if not a.is_contiguous():
            raise ValueError(f"{name}: the CUDA kernel needs contiguous arrays")
        _row_major(name, v)
        es = a.element_size()
        entries.append((a.data_ptr(), v.data_ptr(), a.shape[0], a.shape[1] * es,
                        v.stride(0) * es, 0, 0, 1))
    return entries


# ----------------------------------------------------------------------
# B2: write (table, moment) row pairs of the stacked container
# ----------------------------------------------------------------------
def rows_write_dual_plain(stacked, ids, values, *, n_real=None, bounds=None):
    """In place ``stacked[:, ids[k]] = values[:, k]`` for the kept slots
    (the reference path of pallas_scatter.py:488-495)."""
    slots, rows = _kept_slots(ids, stacked.shape[1], n_real, bounds)
    stacked.index_copy_(1, rows, values.index_select(1, slots))
    return stacked


def rows_write_dual(
    stacked: torch.Tensor,
    ids: torch.Tensor,
    values: torch.Tensor,
    *,
    n_real: Optional[torch.Tensor] = None,
    bounds: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Write ``values[:, k]`` into row ``ids[k]`` of both planes of
    ``stacked`` ([2, V, W]) for every slot in the window, in place; returns
    ``stacked``.  Replaces
    ``mmlrec_tpu/ops/pallas_scatter.py::pallas_rows_write_dual`` (:532)."""
    name = "rows_write_dual"
    _check_ids(name, ids)
    if stacked.dim() != 3 or stacked.shape[0] != 2:
        raise ValueError(f"{name}: expected a [2, V, W] container, got {list(stacked.shape)}")
    V, W = stacked.shape[1:]
    _check_values(name, stacked, values, (2, ids.shape[0], W))
    window_t = [t for t in (n_real, bounds) if t is not None]
    if not cuda_build.on_cuda(name, stacked, ids, values, *window_t):
        return rows_write_dual_plain(stacked, ids, values, n_real=n_real, bounds=bounds)
    if not stacked.is_contiguous():
        raise ValueError(f"{name}: the CUDA kernel needs a contiguous container")
    _row_major(name, values)
    es = stacked.element_size()
    entry = (stacked.data_ptr(), values.data_ptr(), V, W * es, values.stride(1) * es,
             stacked.stride(0) * es, values.stride(0) * es, 2)
    _write_launch(name, [entry], ids, n_real, bounds, stacked.device)
    return stacked


# ----------------------------------------------------------------------
# B10: the write of B3 with its values staged in double buffers
# ----------------------------------------------------------------------
def rows_write_pipelined_plain(arrays, ids, values, *, n_real=None, bounds=None):
    """The contract is ``rows_write``'s (the reference path of
    pallas_scatter.py:371-372 is the same function for both)."""
    return rows_write_plain(arrays, ids, values, n_real=n_real, bounds=bounds)


def rows_write_pipelined(
    arrays: Sequence[torch.Tensor],
    ids: torch.Tensor,
    values: Sequence[torch.Tensor],
    *,
    n_real: Optional[torch.Tensor] = None,
    bounds: Optional[torch.Tensor] = None,
    chunk: int = 256,
) -> Tuple[torch.Tensor, ...]:
    """``rows_write`` with a software pipeline: same arguments, same result,
    in place; ``K % chunk == 0`` as the JAX function asserts.  Replaces
    ``mmlrec_tpu/ops/pallas_scatter.py::pallas_rows_write_pipelined`` (:349).

    Bound by bytes like ``rows_write``.  Design: persistent blocks (4 per
    SM) walk over chunks of slots; the values of a block's next chunk
    arrive in one shared-memory buffer (``cp.async``, one commit group per
    chunk) while the rows of the current chunk are stored from the other.
    The kernel's chunk is as many slots of ``chunk`` as fit 20 KB per buffer
    (16 slots for two arrays of 512-byte rows)."""
    name = "rows_write_pipelined"
    arrays, values = tuple(arrays), tuple(values)
    _check_ids(name, ids)
    K = ids.shape[0]
    if chunk < 1 or K % chunk:
        raise ValueError(f"{name}: {K} ids are not a multiple of chunk={chunk}")
    if not _write_on_cuda(name, arrays, ids, values, n_real, bounds):
        return rows_write_pipelined_plain(arrays, ids, values, n_real=n_real, bounds=bounds)
    if K == 0:
        return arrays
    entries = _write_entries(name, arrays, values)
    per_slot = sum(-(-e[3] // 16) * 16 for e in entries)  # row_bytes, 16-byte regions
    slots = min(chunk, _PIPELINE_BYTES // max(per_slot, 1))
    if slots < 1:
        raise ValueError(f"{name}: rows of {per_slot} bytes in all exceed the kernel's stage")
    if slots >= 8:
        slots -= slots % 8  # whole rounds of the block's 8 warps
    device = arrays[0].device
    blocks = _BLOCKS_PER_SM * torch.cuda.get_device_properties(device).multi_processor_count
    args = _write_args(entries)
    lo_p, hi_p = window_pointers(n_real, bounds)
    ids = ids.contiguous()
    cuda_build.launch(LIBRARY, name, LIBRARY.load().mmlrec_rows_write_pipelined,
                      ctypes.addressof(args), ids.data_ptr(), K, slots, blocks, lo_p, hi_p,
                      device=device)
    return arrays


# ----------------------------------------------------------------------
# B8: fused read-modify-write of rows of several arrays
# ----------------------------------------------------------------------
def bf16_bits_rne(x: torch.Tensor) -> torch.Tensor:
    """f32 -> the 16 bits of its round-to-nearest-even bf16, as int32 in
    [0, 65535], computed in integer math.  Matches XLA's convert bit for
    bit: denormals keep their bits, a NaN becomes the quiet NaN of its sign
    (0x7FC0 / 0xFFC0).  (``tensor.to(torch.bfloat16)`` rounds the same way
    but writes 0xFFFF for a NaN on the CPU.)"""
    b = x.contiguous().view(torch.int32)
    rounded = ((b + 0x7FFF + ((b >> 16) & 1)) >> 16) & 0xFFFF
    nan = (b & 0x7FFFFFFF) > 0x7F800000
    quiet = ((b >> 16) & 0x8000) | 0x7FC0
    return torch.where(nan, quiet, rounded)


def bits_as_bf16(bits: torch.Tensor) -> torch.Tensor:
    """int32 holding 16 bits in its low half -> bfloat16 with those bits."""
    return ((bits << 16) >> 16).to(torch.int16).view(torch.bfloat16)


def _bf16_as_f32(x: torch.Tensor) -> torch.Tensor:
    """bfloat16 -> float32, exactly ``bits << 16``."""
    return (x.contiguous().view(torch.int16).to(torch.int32) << 16).view(torch.float32)


def _as_f32(x: torch.Tensor) -> torch.Tensor:
    return _bf16_as_f32(x) if x.dtype == torch.bfloat16 else x


def rows_update_plain(arrays, ids, deltas, *, modes=None, masks=None, n_real=None):
    """In place, for every slot ``k < n_real`` and row ``clip(ids[k], 0,
    V - 1)``: "add" stores ``old + delta`` (f32 sum, rounded to the array's
    type), "set" stores ``where(mask != 0, delta, old)`` (the reference
    path of pallas_scatter.py:51-73)."""
    modes = tuple(modes) if modes is not None else ("add",) * len(arrays)
    K, V = ids.shape[0], arrays[0].shape[0]
    hi = n_real.reshape(-1)[0] if n_real is not None else K
    slots = (torch.arange(K, device=ids.device) < hi).nonzero().squeeze(1)
    rows = ids.long().clamp(0, max(V - 1, 0)).index_select(0, slots)
    for i, (a, d, mode) in enumerate(zip(arrays, deltas, modes)):
        old = a.index_select(0, rows)
        d = d.index_select(0, slots)
        if mode == "set":
            new = torch.where(masks[i].index_select(0, slots) != 0, d, old)
        else:
            new = _as_f32(old) + _as_f32(d)
            if a.dtype == torch.bfloat16:
                new = bits_as_bf16(bf16_bits_rne(new))
        a.index_copy_(0, rows, new)
    return tuple(arrays)


def update_lane_run(width: int, elem_size: int, delta_elem_size: int, array_addr: int,
                    delta_addr: int, delta_row_bytes: int, mask_addr: int = 0,
                    mask_row_bytes: int = 0) -> int:
    """How many consecutive elements a lane owns per access for one array of
    a ``rows_update``, from its shape and addresses alone: 1 on the path of
    one element a lane, more on the kernel's wide path.

    On the wide path a lane makes one access per operand: 4 elements of a
    4-byte pair, ``_LANE_ELEMS`` where a 2-byte (bfloat16) operand takes
    part.  So the row width must be a multiple of that run, and every row
    address of an operand (its base and its row stride; the array's rows are
    ``width`` elements apart) a multiple of that operand's access,
    ``min(16, run x element size)`` bytes.  The mask of a "set" array has the
    array's element size."""
    run = _LANE_ELEMS if 2 in (elem_size, delta_elem_size) else 4
    if width % run:
        return 1

    def aligned(size: int, *addresses: int) -> bool:
        access = min(16, run * size)
        return all(a % access == 0 for a in addresses)

    wide = (aligned(elem_size, array_addr, mask_addr, mask_row_bytes)
            and aligned(delta_elem_size, delta_addr, delta_row_bytes))
    return run if wide else 1


def update_lanes_per_slot(widths: Sequence[int], runs: Sequence[int]) -> int:
    """How many neighbouring lanes take one slot of a ``rows_update``: the
    smallest power of two that covers the widest row in one pass (``width /
    run`` lanes per array), at most a warp.  Fewer lanes per slot mean more
    slots per warp, each warp carrying more bytes through its chain of
    dependent loads (the id, then the rows)."""
    need = max(-(-w // r) for w, r in zip(widths, runs))
    lanes = 1
    while lanes < min(need, 32):
        lanes *= 2
    return lanes


def rows_update(
    arrays: Sequence[torch.Tensor],
    ids: torch.Tensor,
    deltas: Sequence[torch.Tensor],
    *,
    modes: Optional[Sequence[str]] = None,
    masks: Optional[Sequence[Optional[torch.Tensor]]] = None,
    n_real: Optional[torch.Tensor] = None,
    chunk: int = 256,
) -> Tuple[torch.Tensor, ...]:
    """Fused read-modify-write over several ``[V, D_a]`` arrays, in place
    and in one launch; returns the arrays.  Replaces
    ``mmlrec_tpu/ops/pallas_scatter.py::pallas_rows_update`` (:397).

    Per array, mode "add" (the default) performs ``arrays[a][ids[k]] +=
    deltas[a][k]``: the sum in f32, stored in the array's dtype (float32 or
    bfloat16; the deltas may be either), rounded to bfloat16 as XLA rounds
    (nearest even, NaN to the quiet NaN of its sign).  Mode "set" performs
    ``where(masks[a][k] != 0, deltas[a][k], old_row)`` with no arithmetic on
    the payload: the array may be an opaque 32-bit lane container (float32
    or int32), with deltas and masks of its dtype; the mask is compared as
    a value (``-0.0`` is zero).

    ``ids`` [K] int32 must be unique below ``n_real`` and are clipped to
    ``[0, V - 1]``; ``K % chunk == 0`` as the JAX function asserts.
    ``n_real`` ([1] int32, on the device) marks ``ids[n_real:]`` as padding:
    those slots are skipped exactly, and the host never reads the count.

    Bound by bytes: per slot and array the old row and the delta (and the
    mask) are read and the row is written, 3 or 4 times the row's bytes.
    Design: a group of lanes takes one slot and walks the arrays, the
    smallest power of two that covers the widest row in one pass
    (``update_lanes_per_slot``: a warp for a 128-wide float32 row).  A lane
    owns a run of consecutive elements and makes one wide access per
    operand, for every pair of element types: 16 bytes of each operand of a
    4-byte pair; where a bfloat16 operand takes part, ``_LANE_ELEMS``
    elements, the sums in f32, rounded and packed into one store; a bfloat16
    "set" is a select on packed 16-bit lanes.  An array takes that path when
    its width is a multiple of the run and every row address is aligned to
    its access (``update_lane_run``); any other array takes the path of one
    element a lane.  Both give the same bits."""
    name = "rows_update"
    arrays, deltas = tuple(arrays), tuple(deltas)
    n = len(arrays)
    modes = tuple(modes) if modes is not None else ("add",) * n
    masks = tuple(masks) if masks is not None else (None,) * n
    _check_ids(name, ids)
    if not arrays or len(deltas) != n or len(modes) != n or len(masks) != n:
        raise ValueError(f"{name}: {n} arrays, {len(deltas)} deltas, {len(modes)} modes, "
                         f"{len(masks)} masks")
    K, V = ids.shape[0], arrays[0].shape[0]
    if chunk < 1 or K % chunk:
        raise ValueError(f"{name}: {K} ids are not a multiple of chunk={chunk}")
    for a, d, mode, m in zip(arrays, deltas, modes, masks):
        if a.dim() != 2 or a.shape[0] != V:
            raise ValueError(f"{name}: every array must be [{V}, D], got {list(a.shape)}")
        if tuple(d.shape) != (K, a.shape[1]):
            raise ValueError(f"{name}: deltas {list(d.shape)}, expected {[K, a.shape[1]]}")
        if mode == "add":
            cuda_build.check_dtype(name, a, (torch.float32, torch.bfloat16), "an 'add' array")
            cuda_build.check_dtype(name, d, (torch.float32, torch.bfloat16), "an 'add' delta")
        elif mode == "set":
            cuda_build.check_dtype(name, a, tuple(_KINDS), "a 'set' array")
            if m is None:
                raise ValueError(f"{name}: a 'set' array needs its mask")
            if d.dtype != a.dtype or m.dtype != a.dtype or m.shape != d.shape:
                raise TypeError(f"{name}: a 'set' array's values and mask must have its "
                                f"dtype {a.dtype} and the shape {list(d.shape)}")
        else:
            raise ValueError(f"{name}: mode must be 'add' or 'set', got {mode!r}")
    if n_real is not None:
        _check_window(n_real, 1, "n_real")
    tensors = [*arrays, ids, *deltas, *(m for m in masks if m is not None)]
    if n_real is not None:
        tensors.append(n_real)
    if not cuda_build.on_cuda(name, *tensors):
        return rows_update_plain(arrays, ids, deltas, modes=modes, masks=masks, n_real=n_real)
    if n > MAX_ARRAYS:
        raise ValueError(f"{name}: at most {MAX_ARRAYS} arrays in one launch")
    if K == 0 or V == 0:
        return arrays
    args = (ctypes.c_longlong * (_UPDATE_FIELDS * MAX_ARRAYS + 1))()
    runs = []
    for i, (a, d, mode, m) in enumerate(zip(arrays, deltas, modes, masks)):
        if not a.is_contiguous():
            raise ValueError(f"{name}: the CUDA kernel needs contiguous arrays")
        _row_major(name, d)
        width, es = a.shape[1], a.element_size()
        d_row = d.stride(0) * d.element_size()
        m_ptr = m_row = 0
        if mode == "set":
            _row_major(name, m)
            m_ptr, m_row = m.data_ptr(), m.stride(0) * m.element_size()
        runs.append(update_lane_run(width, es, d.element_size(), a.data_ptr(), d.data_ptr(),
                                    d_row, m_ptr, m_row))
        args[_UPDATE_FIELDS * i:_UPDATE_FIELDS * (i + 1)] = [
            a.data_ptr(), d.data_ptr(), m_ptr, V, width, d_row, m_row,
            int(mode == "set"), _KINDS[a.dtype], _KINDS[d.dtype], int(runs[-1] > 1)]
    args[_UPDATE_FIELDS * MAX_ARRAYS] = n
    ids = ids.contiguous()
    lanes = update_lanes_per_slot([a.shape[1] for a in arrays], runs)
    cuda_build.launch(LIBRARY, name, LIBRARY.load().mmlrec_rows_update, ctypes.addressof(args),
                      ids.data_ptr(), K, n_real.data_ptr() if n_real is not None else 0, lanes,
                      device=arrays[0].device)
    return arrays


def rows_add(arrays, ids, deltas, *, n_real=None, chunk: int = 256):
    """``arrays[a][ids[k]] += deltas[a][k]`` for every array in one launch:
    the all-"add" form of ``rows_update`` (the kernel and the launch count
    are its).  Replaces ``pallas_scatter.py::pallas_rows_add`` (:479)."""
    return rows_update(arrays, ids, deltas, n_real=n_real, chunk=chunk)
