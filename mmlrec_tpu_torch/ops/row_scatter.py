"""Row writes of the two-phase SparseAdam step, with their plain versions.

The counterpart of ``mmlrec_tpu/ops/pallas_scatter.py``:

* ``rows_write`` replaces ``pallas_rows_write`` (:194):
  ``arrays[a][ids[k]] = values[a][k]`` over several ``[V, D_a]`` arrays;
* ``rows_write_dual`` replaces ``pallas_rows_write_dual`` (:532):
  ``stacked[:, ids[k]] = values[:, k]`` on the ``[2, V, W]`` (table,
  moment) container.

Only slots in the window ``[lo, hi)`` are written (``n_real`` gives
``[0, n_real)``, ``bounds`` gives ``[lo, hi)``, neither gives every slot),
and an id outside ``[0, V)`` after wrapping a negative id once is dropped,
as the JAX references' ``mode="drop"`` scatters do.  Ids must be unique
inside the window.

The JAX functions are functional with ``input_output_aliases``: the big
array is donated and comes back updated.  Here the wrappers write INTO the
given arrays and return them, so no copy of a multi-GB table is made.  Call
them under ``torch.no_grad()`` on parameters.

Routing as in ``ops/kernels.py``: CPU tensors take the plain version;
tensors on one CUDA device launch ``rows_write_kernel`` of
``csrc/row_kernels.cu`` or raise; each launch adds one to
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
from .row_gather import LIBRARY, _check_ids, _unit, window, window_pointers

launch_counts.update(rows_write=0, rows_write_dual=0)

MAX_ARRAYS = 8  # kMaxArrays in the CUDA source
_FIELDS = 9  # long longs per array in WriteArgs


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


def _write_launch(name: str, entries, ids, n_real, bounds, device) -> None:
    """entries: (dst, src, rows, row_bytes, src_row, dst_plane, src_plane,
    planes) per array, addresses and strides in bytes."""
    K = ids.shape[0]
    if K == 0:
        return
    args = (ctypes.c_longlong * (_FIELDS * MAX_ARRAYS + 1))()
    for i, (dst, src, rows, row_bytes, src_row, dst_plane, src_plane, planes) in enumerate(entries):
        unit = _unit(row_bytes, dst, src, src_row, dst_plane, src_plane)
        args[_FIELDS * i:_FIELDS * (i + 1)] = [
            dst, src, rows, row_bytes, src_row, dst_plane, src_plane, planes, unit]
    args[_FIELDS * MAX_ARRAYS] = len(entries)
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
        return rows_write_plain(arrays, ids, values, n_real=n_real, bounds=bounds)
    if len(arrays) > MAX_ARRAYS:
        raise ValueError(f"{name}: at most {MAX_ARRAYS} arrays in one launch")
    entries = []
    for a, v in zip(arrays, values):
        if not a.is_contiguous():
            raise ValueError(f"{name}: the CUDA kernel needs contiguous arrays")
        _row_major(name, v)
        es = a.element_size()
        entries.append((a.data_ptr(), v.data_ptr(), V, a.shape[1] * es,
                        v.stride(0) * es, 0, 0, 1))
    _write_launch(name, entries, ids, n_real, bounds, arrays[0].device)
    return arrays


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
