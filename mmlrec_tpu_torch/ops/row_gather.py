"""Row gathers of the embedding table, with their plain versions.

The counterpart of ``mmlrec_tpu/ops/pallas_gather.py``:

* ``rows_gather_dual`` replaces ``pallas_rows_gather_dual`` (:171): one
  row from each plane of the stacked ``[2, V, W]`` (table, moment)
  container per id, with an optional ``[lo, hi)`` window;
* ``rows_gather_hbm`` replaces ``pallas_rows_gather_hbm`` (:90):
  ``table[ids]``;
* ``row_gather`` replaces ``pallas_row_gather`` (:39): ``table[ids]`` with
  the rows staged in fast memory and stored as blocks.

The wrappers route as ``ops/kernels.py`` does: CPU tensors take the plain
version; tensors on one CUDA device launch a kernel of
``csrc/row_kernels.cu`` or raise; each launch adds one to
``launch_counts``.  The kernels take 4-byte element types (float32, int32).

All are bound by bytes on the H100: every gathered row is read once and
written once (2 x 512 B per id for the dual gather at 128 lanes).  Design
of ``rows_gather_kernel`` (the first two): a grid sized to the card
(``gather_grid``: a few blocks an SM) whose warps stride over the window
alone; a warp's pass loads its slots' ids, one per lane, then issues every
16-byte load of both planes of ``_GATHER_SLOTS_PER_PASS`` rows before its
first store.  The window is read from device memory, so the caller never
synchronises on the step's unique-row count.  As under Mosaic
(pallas_gather.py:186-192), the kernel stores nothing outside the window:
those slots of its output hold whatever ``torch.empty`` left there, and no
caller reads them (``tests/test_torch_gather_window.py``).  The plain
version poisons them, as JAX's reference path does, so that a CPU test
that consumes one fails loudly.  ``row_gather`` is the other design of the
single-array gather, as it is in the JAX package: a block brings a chunk
of rows into shared memory with ``cp.async`` and stores the chunk as one
contiguous stretch.  Pure data movement: bit-identical to the plain
versions inside the window, poison pattern included.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from . import cuda_build
from .cuda_build import launch_counts

_p, _i, _ll, _u = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_uint
# every list ends with the stream: a pointer left to ctypes' default conversion
# would be cut to 32 bits
LIBRARY = cuda_build.CudaLibrary("row_kernels.cu", {
    "mmlrec_rows_gather": [_p, _p, _ll, _ll, _ll, _ll, _i, _ll, _u, _p, _i, _p, _p, _i, _p],
    "mmlrec_rows_write": [_p, _p, _i, _p, _p, _p],
    "mmlrec_row_gather_staged": [_p, _p, _ll, _ll, _ll, _u, _p, _i, _i, _p],
    "mmlrec_rows_write_pipelined": [_p, _p, _i, _i, _i, _p, _p, _p],
    "mmlrec_rows_update": [_p, _p, _i, _p, _i, _p],
})
launch_counts.update(rows_gather_dual=0, rows_gather_hbm=0, row_gather=0)

_GATHER_DTYPES = (torch.float32, torch.int32)
_GATHER_SLOTS_PER_PASS = 4  # kGatherPass (MMLREC_GATHER_SLOTS_PER_PASS) in the CUDA source
_GATHER_BLOCKS_PER_SM = 8  # blocks of rows_gather_kernel an SM (tools/tune_kernels.py)
_GATHER_WARPS = 8  # kThreads / 32 in the CUDA source


def gather_grid(n_slots: int, row_units: int, sms: int) -> int:
    """Blocks of a ``rows_gather_kernel`` launch: as many as cover the
    ``n_slots`` slots in one pass of every warp, at most
    ``_GATHER_BLOCKS_PER_SM`` a streaming multiprocessor (the warps stride
    over the rest).  A row of
    ``row_units`` units takes the fewest lanes (a power of two, at most 32)
    that cover it, and a pass of a warp takes ``min(_GATHER_SLOTS_PER_PASS,
    lanes)`` groups of ``32 / lanes`` rows, as the C entry computes them."""
    lanes = 1
    while lanes < row_units and lanes < 32:
        lanes *= 2
    per_pass = min(_GATHER_SLOTS_PER_PASS, lanes) * (32 // lanes)
    per_block = _GATHER_WARPS * per_pass
    return max(1, min(-(-n_slots // per_block), sms * _GATHER_BLOCKS_PER_SM))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _poison(dtype: torch.dtype):
    """The fill of a skipped or missing slot: NaN, or int-min for integers
    (pallas_gather.py:221; jnp.take's fill value)."""
    return float("nan") if dtype.is_floating_point else torch.iinfo(dtype).min


def _poison_bits(dtype: torch.dtype) -> int:
    return int(torch.tensor(_poison(dtype), dtype=dtype).view(torch.int32)) & 0xFFFFFFFF


def window(K: int, n_real=None, bounds=None, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(lo, hi) as 0-d int32 tensors: ``bounds`` ([2] (lo, hi)) wins over
    ``n_real`` ([1]: slots [0, n_real)); neither means [0, K)."""
    if bounds is not None:
        b = bounds.reshape(2)
        return b[0], b[1]
    zero = torch.zeros((), dtype=torch.int32, device=device)
    if n_real is not None:
        return zero, n_real.reshape(-1)[0]
    return zero, torch.full((), K, dtype=torch.int32, device=device)


def window_pointers(n_real=None, bounds=None) -> Tuple[int, int]:
    """Device addresses of lo and hi for the kernels (0 = the default)."""
    if bounds is not None:
        _check_window(bounds, 2, "bounds")
        return bounds.data_ptr(), bounds.data_ptr() + 4
    if n_real is not None:
        _check_window(n_real, 1, "n_real")
        return 0, n_real.data_ptr()
    return 0, 0


def _check_window(t: torch.Tensor, n: int, what: str) -> None:
    if t.dtype != torch.int32 or t.numel() != n or not t.is_contiguous():
        raise ValueError(f"{what} must be a contiguous int32 tensor of {n} values")


def take_fill(src: torch.Tensor, ids: torch.Tensor, dim: int) -> torch.Tensor:
    """``jnp.take(src, ids, axis=dim)`` in its default fill mode: an id in
    [-V, 0) wraps once, any other id outside [0, V) gives the poison row."""
    V = src.shape[dim]
    idx = ids.long()
    idx = torch.where(idx < 0, idx + V, idx)
    valid = (idx >= 0) & (idx < V)
    got = src.index_select(dim, idx.clamp(0, max(V - 1, 0)))
    shape = [1] * src.dim()
    shape[dim] = -1
    return torch.where(valid.reshape(shape), got, _poison(src.dtype))


def _unit(row_bytes: int, *addresses: int) -> int:
    """The widest copy (16 or 4 bytes) that every address and the row size
    allow."""
    for u in (16, 4):
        if row_bytes % u == 0 and all(a % u == 0 for a in addresses):
            return u
    return 1


def _check_ids(name: str, ids: torch.Tensor) -> None:
    if ids.dtype != torch.int32 or ids.dim() != 1:
        raise TypeError(f"{name}: ids must be a 1-D int32 tensor, got {ids.dtype}{list(ids.shape)}")


def _overlap(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether the bytes of two contiguous tensors overlap."""
    a0, b0 = a.data_ptr(), b.data_ptr()
    return a0 < b0 + b.numel() * b.element_size() and b0 < a0 + a.numel() * a.element_size()


def _gather_launch(name, src, ids, out, planes, n_real=None, bounds=None):
    """Launch rows_gather_kernel into ``out`` (contiguous, [planes, K, W]
    or [K, W]): slots in the window get their rows, no other byte of
    ``out`` is stored."""
    K = ids.shape[0]
    rows, W = src.shape[-2], src.shape[-1]
    row_bytes = W * src.element_size()
    src_plane = rows * row_bytes
    out_plane = K * row_bytes
    if K == 0 or row_bytes == 0:
        return out
    if _overlap(src, out):  # the kernel reads src through the read-only path
        raise ValueError(f"{name}: the output must not overlap the source")
    ids = ids.contiguous()
    lo_p, hi_p = window_pointers(n_real, bounds)
    unit = _unit(row_bytes, src.data_ptr(), out.data_ptr())
    blocks = gather_grid(K, row_bytes // unit, _sm_count(src.device.index))
    cuda_build.launch(
        LIBRARY, name, LIBRARY.load().mmlrec_rows_gather, src.data_ptr(),
        out.data_ptr(), rows, row_bytes, src_plane, out_plane, planes, unit,
        _poison_bits(src.dtype), ids.data_ptr(), K, lo_p, hi_p, blocks,
        device=src.device)
    return out


# ----------------------------------------------------------------------
# B1: dual (table, moment) row-pair gather
# ----------------------------------------------------------------------
def rows_gather_dual_plain(stacked, ids, *, n_real=None, bounds=None):
    """``jnp.take(stacked, ids, axis=1)``, poisoned outside the window
    (the reference path of pallas_gather.py:215-222, which poisons where
    Mosaic leaves the slots uninitialised, so that a CPU test that consumes
    one fails loudly)."""
    got = take_fill(stacked, ids, 1)
    if n_real is None and bounds is None:
        return got
    K = ids.shape[0]
    lo, hi = window(K, n_real, bounds, device=ids.device)
    k = torch.arange(K, device=ids.device)
    valid = ((k >= lo) & (k < hi))[None, :, None]
    return torch.where(valid, got, _poison(got.dtype))


def rows_gather_dual(
    stacked: torch.Tensor,
    ids: torch.Tensor,
    *,
    n_real: Optional[torch.Tensor] = None,
    bounds: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """stacked [2, V, W], ids [K] int32 -> pairs [2, K, W]; duplicates
    allowed.  ``n_real`` ([1] int32) or ``bounds`` ([2] int32 (lo, hi))
    restrict the fetch to slots in the window.  The slots outside it are
    undefined, as under Mosaic (pallas_gather.py:186-192): the kernel
    stores nothing there, the plain version fills the poison (NaN /
    int-min); callers must not consume them.  Replaces
    ``mmlrec_tpu/ops/pallas_gather.py::pallas_rows_gather_dual`` (:171)."""
    name = "rows_gather_dual"
    cuda_build.check_dtype(name, stacked, _GATHER_DTYPES, "stacked")
    _check_ids(name, ids)
    if stacked.dim() != 3 or stacked.shape[0] != 2:
        raise ValueError(f"{name}: expected a [2, V, W] container, got {list(stacked.shape)}")
    window_t = [t for t in (n_real, bounds) if t is not None]
    if not cuda_build.on_cuda(name, stacked, ids, *window_t):
        return rows_gather_dual_plain(stacked, ids, n_real=n_real, bounds=bounds)
    if not stacked.is_contiguous():
        raise ValueError(f"{name}: the CUDA kernel needs a contiguous container")
    out = torch.empty((2, ids.shape[0], stacked.shape[2]), dtype=stacked.dtype,
                      device=stacked.device)
    return _gather_launch(name, stacked, ids, out, 2, n_real, bounds)


# ----------------------------------------------------------------------
# B4: single-array row gather
# ----------------------------------------------------------------------
def rows_gather_hbm_plain(table, ids):
    """``jnp.take(table, ids, axis=0)`` (pallas_gather.py:112-113)."""
    return take_fill(table, ids, 0)


def rows_gather_hbm(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """table [V, W], ids [K] int32 -> rows [K, W]; duplicates allowed.
    Replaces ``mmlrec_tpu/ops/pallas_gather.py::pallas_rows_gather_hbm``
    (:90)."""
    name = "rows_gather_hbm"
    cuda_build.check_dtype(name, table, _GATHER_DTYPES, "table")
    _check_ids(name, ids)
    if table.dim() != 2:
        raise ValueError(f"{name}: expected a [V, W] table, got {list(table.shape)}")
    if not cuda_build.on_cuda(name, table, ids):
        return rows_gather_hbm_plain(table, ids)
    if not table.is_contiguous():
        raise ValueError(f"{name}: the CUDA kernel needs a contiguous table")
    out = torch.empty((ids.shape[0], table.shape[1]), dtype=table.dtype,
                      device=table.device)
    return _gather_launch(name, table, ids, out, 1)


# ----------------------------------------------------------------------
# B9: single-array row gather, staged in shared memory
# ----------------------------------------------------------------------
_STAGE_BYTES = 16 * 1024  # shared memory of one block's chunk of rows


def row_gather_plain(table, ids):
    """``jnp.take(table, ids, axis=0)`` (pallas_gather.py:49)."""
    return take_fill(table, ids, 0)


def row_gather(table: torch.Tensor, ids: torch.Tensor, *, chunk: int = 256) -> torch.Tensor:
    """table [V, D], ids [K] int32 with ``K % chunk == 0`` -> rows [K, D];
    duplicates allowed, out-of-range ids as ``jnp.take``'s fill mode.
    Replaces ``mmlrec_tpu/ops/pallas_gather.py::pallas_row_gather`` (:39).

    ``chunk`` is the JAX function's contract on K.  The kernel stages as
    many consecutive slots of a chunk per block as fit 16 KB of shared
    memory (32 rows of 512 bytes), so that several blocks share an SM."""
    name = "row_gather"
    cuda_build.check_dtype(name, table, _GATHER_DTYPES, "table")
    _check_ids(name, ids)
    if table.dim() != 2:
        raise ValueError(f"{name}: expected a [V, D] table, got {list(table.shape)}")
    K = ids.shape[0]
    if chunk < 1 or K % chunk:
        raise ValueError(f"{name}: {K} ids are not a multiple of chunk={chunk}")
    if not cuda_build.on_cuda(name, table, ids):
        return row_gather_plain(table, ids)
    if not table.is_contiguous():
        raise ValueError(f"{name}: the CUDA kernel needs a contiguous table")
    rows, D = table.shape
    row_bytes = D * table.element_size()
    out = torch.empty((K, D), dtype=table.dtype, device=table.device)
    if K == 0 or row_bytes == 0:
        return out
    if row_bytes > 3 * _STAGE_BYTES:
        raise ValueError(f"{name}: rows of {row_bytes} bytes exceed the kernel's stage")
    slots = max(1, min(chunk, _STAGE_BYTES // row_bytes))
    ids = ids.contiguous()
    unit = _unit(row_bytes, table.data_ptr(), out.data_ptr())
    cuda_build.launch(
        LIBRARY, name, LIBRARY.load().mmlrec_row_gather_staged, table.data_ptr(),
        out.data_ptr(), rows, row_bytes, unit, _poison_bits(table.dtype),
        ids.data_ptr(), K, slots, device=table.device)
    return out
