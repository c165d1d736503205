"""The probe scripts of ``benchmarks/`` with hand-written CUDA kernels.

Three scripts of the JAX package measured, with Pallas kernels of their
own, what the TPU's DMA issue rate costs the 40 M-row table update.  Each
sub-command here is one script, with its variants and shapes; its Pallas
kernels are the CUDA kernels of ``csrc/probe_kernels.cu``, each with a
plain PyTorch version beside it, which CPU tensors take:

* ``dma-issue-floor`` (``benchmarks/probe_dma_issue_floor.py``): P1
  ``rows_write``, K rows written into a ``[rows, 128]`` f32 table as K / R
  runs of R contiguous rows, R = 1, 2, 4, 8, 16: what writing sorted runs
  of unique rows (the Zipf head) buys against one row at a time; then P2
  ``pairs_write``, K row pairs written into a stacked ``[2, dual_rows,
  128]`` container: one pair write against two row writes;
* ``row-gather-scan`` (``benchmarks/probe_row_gather_scan.py``): K rows
  gathered from the table by ``index_select`` (the script's ``xla``), by
  B9's staged ``row_gather`` (``vmem``), by P3 ``rows_gather`` (``hbm``),
  the script's ``base`` (a ``[K, 128]`` fill: what its sum fold costs), and
  by P4 ``pairs_gather`` from the stacked container (``dual``);
* ``row-windows`` (``benchmarks/probe_pallas_row_windows.py``): P5
  ``window_add``, K windows of k = 2, 3 consecutive rows of a
  row-interleaved ``[k * window_rows, 128]`` f32 array read, added to and
  written back: the SparseAdam update with a table row and its moment rows
  side by side, against B8's split arrays.

Ids are drawn from ``--seed`` as the scripts draw them (run starts and pair
ids distinct, gather ids sorted with repeats, window ids a permutation's
head); values and deltas with the scripts' numpy generators; the
multi-gigabyte tables on the device, uniform in [0, 1) as the scripts'.

Checks: each kernel against its plain version on the same inputs, bitwise
over the whole output or array (a write: the kernel into a copy of the
array and the plain version into the array, two sets of fresh ids each,
after every time of its sub-command).

Timing: ``LAUNCHES`` launches, each with its own preset ids, captured in
one CUDA graph and replayed (``tools/timing.device_ms``): the device time a
launch.  It stands in for the scripts' scan marginal (t32 - t16) / 16, in
which every scan step sees fresh ids.  The values (P1's ``[K, 128]``, 33.5
MB at the default K, fit the H100's 50 MB L2; P2's ``[2, K, 128]`` do not)
and the deltas are reused by every launch, as in the scripts.  Each line
gives the µs a launch, ns a row (a pair for P2 and P4, a window for P5),
the byte bound (each input read once, each output written once, over 3.35
TB/s), the plain version's µs and that of one PyTorch call computing the
same function (``index_copy_``, ``index_select``, ``index_add_`` on the
expanded row index, built outside the timed window).

    python -m mmlrec_tpu_torch.tools.probe_rows dma-issue-floor|row-gather-scan|row-windows \\
        [--rows 10000000] [--dual-rows 6000000] [--window-rows 2500000] [--k 65536] \\
        [--seed 0] [--device cuda|cpu]

Prints the script's lines, then one JSON line with the script's metric in
ns a row per variant and every variant's numbers.  Runs on the card, and
raises RuntimeError without one; ``--device cpu`` runs the plain versions
at the sizes given, with their checks and without times.  Only one probe's
arrays are alive at a time (P2 and P4: 6.14 GB at the defaults, and a copy
of a written array while its check runs).

Ids lie in [0, rows) (a run start in [0, rows - run]).  An id past the end
makes a plain version raise (IndexError on the CPU, a device-side assert on
the card); a negative one it counts from the end, as PyTorch indexing does.
A kernel stops on either (the launch fails, and the error shows at the next
synchronisation), so it never answers where its plain version raises.
"""

from __future__ import annotations

import argparse
import ctypes
import itertools
import json
import math
import subprocess
import sys
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..ops import cuda_build
from ..ops.cuda_build import launch_counts
from ..ops.row_gather import row_gather
from .timing import device_ms

_p, _i, _ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# every list ends with the stream (a pointer left to ctypes' default
# conversion would be cut to 32 bits)
LIBRARY = cuda_build.CudaLibrary("probe_kernels.cu", {
    "mmlrec_probe_rows_write": [_p, _ll, _ll, _i, _p, _p, _i, _p],
    "mmlrec_probe_pairs_write": [_p, _ll, _ll, _p, _p, _i, _p],
    "mmlrec_probe_rows_gather": [_p, _ll, _ll, _p, _p, _i, _p],
    "mmlrec_probe_pairs_gather": [_p, _ll, _ll, _p, _p, _i, _p],
    "mmlrec_probe_window_add": [_p, _ll, _i, _ll, _p, _p, _i, _p],
})
launch_counts.update(probe_rows_write=0, probe_pairs_write=0, probe_rows_gather=0,
                     probe_pairs_gather=0, probe_window_add=0)

ROWS, DUAL_ROWS, WINDOW_ROWS, K = 10_000_000, 6_000_000, 2_500_000, 65_536  # the scripts'
RUNS = (1, 2, 4, 8, 16)  # probe_dma_issue_floor.py's R
WINDOWS = (2, 3)  # probe_pallas_row_windows.py's k
ROW_BYTES = 128 * 4  # the scripts' rows: 128 f32 lanes
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
LAUNCHES = 16  # launches a timed graph replays, each with its own ids
REPS = 11  # timed replays of each graph
CHECK_SETS = 2  # id sets a write's check applies, one after the other


# ----------------------------------------------------------------------
# the kernels' wrappers and their plain versions
# ----------------------------------------------------------------------
def _check(name: str, ids: torch.Tensor, *arrays: torch.Tensor) -> None:
    if ids.dtype != torch.int32 or ids.dim() != 1:
        raise TypeError(f"{name}: ids must be a 1-D int32 tensor, got {ids.dtype}{list(ids.shape)}")
    for a in arrays:
        if a.dtype != torch.float32:
            raise TypeError(f"{name}: the arrays must be float32, got {a.dtype}")


def _check_cuda(name: str, ids: torch.Tensor, *arrays: torch.Tensor) -> None:
    """What the kernels take: contiguous arrays, 16-byte aligned, of rows
    that are whole 16-byte words."""
    if not ids.is_contiguous():
        raise ValueError(f"{name}: the CUDA kernel needs contiguous ids")
    for a in arrays:
        if not a.is_contiguous() or a.data_ptr() % 16 or (a.shape[-1] * a.element_size()) % 16:
            raise ValueError(f"{name}: the CUDA kernel needs contiguous, 16-byte aligned arrays "
                             f"of rows that are a multiple of 16 bytes, got {list(a.shape)}")


def _launch(name: str, fn: str, device: torch.device, *args) -> None:
    cuda_build.launch(LIBRARY, name, getattr(LIBRARY.load(), fn), *args, device=device)


def _expand(ids: torch.Tensor, width: int, scale: int = 1) -> torch.Tensor:
    """The rows ``scale * ids[j] + r`` for r < ``width``, in order: int64."""
    r = torch.arange(width, device=ids.device)
    return (ids.long()[:, None] * scale + r).reshape(-1)


def rows_write_plain(table, ids, values, run=1):
    """``table[ids[j] + r] = values[j * run + r]`` for r < run, in place
    (probe_dma_issue_floor.py:46-65)."""
    table[_expand(ids, run)] = values
    return table


def rows_write(table: torch.Tensor, ids: torch.Tensor, values: torch.Tensor,
               run: int = 1) -> torch.Tensor:
    """P1: table [V, W], ids [n] int32 run starts, values [n * run, W] ->
    table, written in place.  Runs must not overlap (the script draws
    distinct multiples of 2 * run); a run outside the table raises (see
    the module's docstring on ids).  Replaces
    ``benchmarks/probe_dma_issue_floor.py::_kernel_rows`` (:46, :88)."""
    name = "probe_rows_write"
    _check(name, ids, table, values)
    if table.dim() != 2 or values.shape != (ids.shape[0] * run, table.shape[1]) or run < 1:
        raise ValueError(f"{name}: table {list(table.shape)}, {ids.shape[0]} runs of {run}, "
                         f"values {list(values.shape)}")
    if not cuda_build.on_cuda(name, table, ids, values):
        return rows_write_plain(table, ids, values, run)
    _check_cuda(name, ids, table, values)
    if ids.shape[0]:
        _launch(name, "mmlrec_probe_rows_write", table.device, table.data_ptr(), table.shape[0],
                table.shape[1] * 4, run, values.data_ptr(), ids.data_ptr(), ids.shape[0])
    return table


def pairs_write_plain(stacked, ids, values):
    """``stacked[:, ids] = values``, in place (probe_dma_issue_floor.py:106-123)."""
    stacked[:, ids.long()] = values
    return stacked


def pairs_write(stacked: torch.Tensor, ids: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """P2: stacked [2, V, W], ids [n] int32 distinct, values [2, n, W] ->
    stacked, written in place; an id outside the container raises (see
    the module's docstring on ids).  Replaces
    ``benchmarks/probe_dma_issue_floor.py::_kernel_dual`` (:106, :144)."""
    name = "probe_pairs_write"
    _check(name, ids, stacked, values)
    if stacked.dim() != 3 or stacked.shape[0] != 2 or values.shape != (
            2, ids.shape[0], stacked.shape[2]):
        raise ValueError(f"{name}: stacked {list(stacked.shape)}, {ids.shape[0]} ids, values "
                         f"{list(values.shape)}")
    if not cuda_build.on_cuda(name, stacked, ids, values):
        return pairs_write_plain(stacked, ids, values)
    _check_cuda(name, ids, stacked, values)
    if ids.shape[0]:
        _launch(name, "mmlrec_probe_pairs_write", stacked.device, stacked.data_ptr(),
                stacked.shape[1], stacked.shape[2] * 4, values.data_ptr(), ids.data_ptr(),
                ids.shape[0])
    return stacked


def rows_gather_plain(table, ids):
    """``table[ids]`` (probe_row_gather_scan.py:46-60)."""
    return table[ids.long()]


def rows_gather(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """P3: table [V, W], ids [n] int32, repeats allowed -> rows [n, W]; an
    id outside the table raises (see the module's docstring on ids).
    Replaces ``benchmarks/probe_row_gather_scan.py::_hbm_gather_kernel``
    (:46, :77)."""
    name = "probe_rows_gather"
    _check(name, ids, table)
    if table.dim() != 2:
        raise ValueError(f"{name}: expected a [V, W] table, got {list(table.shape)}")
    if not cuda_build.on_cuda(name, table, ids):
        return rows_gather_plain(table, ids)
    _check_cuda(name, ids, table)
    out = torch.empty((ids.shape[0], table.shape[1]), dtype=table.dtype, device=table.device)
    if ids.shape[0]:
        _launch(name, "mmlrec_probe_rows_gather", table.device, table.data_ptr(), table.shape[0],
                table.shape[1] * 4, out.data_ptr(), ids.data_ptr(), ids.shape[0])
    return out


def pairs_gather_plain(stacked, ids):
    """``stacked[:, ids]`` (probe_row_gather_scan.py:87-105)."""
    return stacked[:, ids.long()]


def pairs_gather(stacked: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """P4: stacked [2, V, W], ids [n] int32, repeats allowed -> pairs
    [2, n, W]; an id outside the container raises (see the module's
    docstring on ids).  Replaces
    ``benchmarks/probe_row_gather_scan.py::_dual_gather_kernel`` (:87, :122)."""
    name = "probe_pairs_gather"
    _check(name, ids, stacked)
    if stacked.dim() != 3 or stacked.shape[0] != 2:
        raise ValueError(f"{name}: expected a [2, V, W] container, got {list(stacked.shape)}")
    if not cuda_build.on_cuda(name, stacked, ids):
        return pairs_gather_plain(stacked, ids)
    _check_cuda(name, ids, stacked)
    out = torch.empty((2, ids.shape[0], stacked.shape[2]), dtype=stacked.dtype,
                      device=stacked.device)
    if ids.shape[0]:
        _launch(name, "mmlrec_probe_pairs_gather", stacked.device, stacked.data_ptr(),
                stacked.shape[1], stacked.shape[2] * 4, out.data_ptr(), ids.data_ptr(),
                ids.shape[0])
    return out


def window_add_plain(arr, ids, deltas, k):
    """``arr[k * ids[j] + r] += deltas[j * k + r]`` for r < k, in place
    (probe_pallas_row_windows.py:28-47: one f32 add an element)."""
    rows = _expand(ids, k, k)
    arr[rows] = arr[rows] + deltas
    return arr


def window_add(arr: torch.Tensor, ids: torch.Tensor, deltas: torch.Tensor, k: int) -> torch.Tensor:
    """P5: arr [k * V, W] f32 (V windows of k rows), ids [n] int32 distinct
    windows, deltas [n * k, W] -> arr, added to in place; a window outside
    the array raises (see the module's docstring on ids).  Replaces
    ``benchmarks/probe_pallas_row_windows.py::_kernel`` (:28, :66)."""
    name = "probe_window_add"
    _check(name, ids, arr, deltas)
    if (k < 1 or arr.dim() != 2 or arr.shape[0] % k
            or deltas.shape != (ids.shape[0] * k, arr.shape[1])):
        raise ValueError(f"{name}: arr {list(arr.shape)}, {ids.shape[0]} windows of {k}, "
                         f"deltas {list(deltas.shape)}")
    if not cuda_build.on_cuda(name, arr, ids, deltas):
        return window_add_plain(arr, ids, deltas, k)
    _check_cuda(name, ids, arr, deltas)
    if ids.shape[0]:
        _launch(name, "mmlrec_probe_window_add", arr.device, arr.data_ptr(), arr.shape[0] // k,
                k, arr.shape[1] * 4, deltas.data_ptr(), ids.data_ptr(), ids.shape[0])
    return arr


# ----------------------------------------------------------------------
# the scripts' draws
# ----------------------------------------------------------------------
def draw_run_starts(rng: np.random.Generator, rows: int, k: int, run: int) -> np.ndarray:
    """k / run distinct sorted run starts, multiples of 2 * run
    (probe_dma_issue_floor.py:210-217)."""
    return np.sort(rng.choice(rows // (2 * run), k // run, replace=False)
                   ).astype(np.int32) * (2 * run)


def draw_distinct(rng: np.random.Generator, rows: int, k: int) -> np.ndarray:
    """k distinct sorted rows (probe_dma_issue_floor.py:239-243)."""
    return np.sort(rng.choice(rows, k, replace=False)).astype(np.int32)


def draw_sorted(rng: np.random.Generator, rows: int, k: int) -> np.ndarray:
    """k sorted rows with repeats (probe_row_gather_scan.py:177-179)."""
    return np.sort(rng.integers(0, rows, k).astype(np.int32))


def draw_windows(rng: np.random.RandomState, windows: int, k: int) -> np.ndarray:
    """k distinct windows, a permutation's head (probe_pallas_row_windows.py:93)."""
    return rng.permutation(windows)[:k].astype(np.int32)


# ----------------------------------------------------------------------
# the sub-commands
# ----------------------------------------------------------------------
def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and torch.equal(a.view(torch.int32), b.view(torch.int32))


def _held(what: str, got: torch.Tensor, want: torch.Tensor) -> None:
    """A kernel's output (or array) against its plain version's, bitwise."""
    if not _same_bits(got, want):
        raise AssertionError(f"probe_rows: {what} differs from the plain version")
    print(f"{what}: bitwise equal to the plain version", flush=True)


def _release(device: torch.device) -> None:
    """Give freed arrays' blocks back to the card, so that each probe is
    timed on a card that holds only its own arrays."""
    if device.type == "cuda":
        torch.cuda.empty_cache()


def _held_write(what: str, array: torch.Tensor, sets: List[torch.Tensor],
                kernel: Callable, plain: Callable) -> None:
    """A write's check: the kernel into a copy of ``array``, the plain
    version into ``array``, the first CHECK_SETS id sets one after the
    other; the whole arrays compared.  The sub-commands make these checks
    after every time, on arrays of their own: after such a copy, even
    released, random rows of a large array ran measurably slower on the
    H100 in most runs."""
    got = array.clone()
    for ids in sets[:CHECK_SETS]:
        kernel(got, ids)
        plain(array, ids)
    _held(what, got, array)
    del got
    _release(array.device)


def _us(ms: Optional[float]) -> Optional[float]:
    return None if ms is None else ms * 1e3


class _Probe:
    """One sub-command's timing: every variant's launches replay over the
    same preset id sets, each launch its own set."""

    def __init__(self, device: torch.device, card: str, sets: int):
        self.device, self.card, self.sets = device, card, sets
        self.entries: Dict[str, Dict] = {}

    def time(self, fn: Callable[[int], object]) -> Optional[float]:
        """Device ms a launch of ``fn(i)`` cycling over the sets; None off the card."""
        if self.device.type != "cuda":
            return None
        order = itertools.cycle(range(self.sets))
        return device_ms(lambda: fn(next(order)), reps=REPS, inner=self.sets)

    def record(self, variant: str, label: str, per: int, nbytes: float, kernel, plain=None,
               library=None, library_name: Optional[str] = None) -> Dict:
        """Time a variant (and its plain version and library call where
        given); ``per``: the rows (pairs, windows) a launch, for ns a row."""
        ms = self.time(kernel)
        plain_ms = self.time(plain) if plain is not None else None
        library_ms = self.time(library) if library is not None else None
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        entry = dict(us=_us(ms), ns_per_row=None if ms is None else ms * 1e6 / per,
                     bytes=nbytes, bound_us=bound_ms * 1e3, bound_by="bytes",
                     plain_us=_us(plain_ms), library_us=_us(library_ms), library=library_name,
                     launches_timed=self.sets)
        self.entries[variant] = entry
        if ms is None:
            print(f"[{variant:5s}] {label}: no times off the card ({nbytes / 1e6:.2f} MB a "
                  f"launch) [{self.card}]", flush=True)
            return entry
        extra = "".join(f"; {n} {t * 1e3:.2f} us" for n, t in (
            ("plain", plain_ms), (library_name, library_ms)) if t is not None)
        print(f"[{variant:5s}] {label}: {self.sets} launches of fresh ids replayed: "
              f"{ms * 1e3:.2f} us a launch, {entry['ns_per_row']:.4f} ns/row; bound "
              f"{bound_ms * 1e3:.2f} us ({nbytes / 1e6:.2f} MB){extra} [{self.card}]", flush=True)
        return entry

    def result(self, metric: str, **shape) -> Dict:
        line = {"metric": metric, **shape,
                **{v: e["ns_per_row"] for v, e in self.entries.items()},
                "variants": self.entries, "card": self.card, "device": self.device.type}
        print(json.dumps(line), flush=True)
        return line


def _ids(arrays: List[np.ndarray], device) -> List[torch.Tensor]:
    return [torch.from_numpy(a).to(device) for a in arrays]


def dma_issue_floor(args, device: torch.device, card: str) -> Dict:
    """P1 at every run length, then P2 (probe_dma_issue_floor.py:198-253);
    their checks after every time (see ``_held_write``)."""
    k, rows, n = args.k, args.rows, LAUNCHES
    rng = np.random.default_rng(args.seed)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    probe = _Probe(device, card, n)
    values = torch.from_numpy(rng.random((k, 128)).astype(np.float32)).to(device)
    table = torch.zeros((rows, 128), device=device)
    run_sets = {}
    for R in RUNS:
        sets = run_sets[R] = _ids([draw_run_starts(rng, rows, k, R) for _ in range(n)], device)
        index = [_expand(s, R) for s in sets]
        probe.record(f"R{R}", f"{k} rows as {k // R} runs of {R}", k,
                     k // R * 4 + 2 * k * ROW_BYTES,
                     lambda i: rows_write(table, sets[i], values, R),
                     lambda i: rows_write_plain(table, sets[i], values, R),
                     lambda i: table.index_copy_(0, index[i], values), "index_copy_")
    del table
    _release(device)
    values2 = torch.from_numpy(rng.random((2, k, 128)).astype(np.float32)).to(device)
    stacked = torch.zeros((2, args.dual_rows, 128), device=device)
    pair_sets = _ids([draw_distinct(rng, args.dual_rows, k) for _ in range(n)], device)
    index = [s.long() for s in pair_sets]
    probe.record("dual", f"{k} row pairs of [2, {args.dual_rows}, 128] (compare 2x R1)", k,
                 k * 4 + 4 * k * ROW_BYTES,
                 lambda i: pairs_write(stacked, pair_sets[i], values2),
                 lambda i: pairs_write_plain(stacked, pair_sets[i], values2),
                 lambda i: stacked.index_copy_(1, index[i], values2), "index_copy_")
    del stacked
    _release(device)
    table = torch.rand((rows, 128), generator=gen, device=device)
    for R in RUNS:
        _held_write(f"[R={R:2d}] the table after {CHECK_SETS} x {k // R} runs", table,
                    run_sets[R], lambda a, ids: rows_write(a, ids, values, R),
                    lambda a, ids: rows_write_plain(a, ids, values, R))
    del table
    _release(device)
    stacked = torch.rand((2, args.dual_rows, 128), generator=gen, device=device)
    _held_write(f"[dual] the container after {CHECK_SETS} x {k} row pairs", stacked, pair_sets,
                lambda a, ids: pairs_write(a, ids, values2),
                lambda a, ids: pairs_write_plain(a, ids, values2))
    del stacked
    _release(device)
    return probe.result("dma_issue_floor_ns_per_row", V=rows, K=k)


def row_gather_scan(args, device: torch.device, card: str) -> Dict:
    """xla, vmem (B9), hbm (P3), base, then dual (P4) (probe_row_gather_scan.py:168-223)."""
    k, n = args.k, LAUNCHES
    rng = np.random.default_rng(args.seed)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    probe = _Probe(device, card, n)
    draws = [draw_sorted(rng, args.dual_rows, k) for _ in range(n)]
    sets = _ids(draws, device)
    index = [s.long() for s in sets]
    distinct = float(np.mean([np.unique(d).size for d in draws]))  # repeats are read once
    gather_bytes = k * 4 + (distinct + k) * ROW_BYTES
    table = torch.rand((args.rows, 128), generator=gen, device=device)
    _held(f"[hbm  ] {k} rows gathered", rows_gather(table, sets[0]),
          rows_gather_plain(table, sets[0]))
    chunk = math.gcd(256, k)
    probe.record("xla", f"index_select of {k} rows from [{args.rows}, 128]", k, gather_bytes,
                 lambda i: table.index_select(0, sets[i]))
    probe.record("vmem", f"B9 row_gather, chunk {chunk}", k, gather_bytes,
                 lambda i: row_gather(table, sets[i], chunk=chunk))
    probe.record("hbm", "P3 rows_gather", k, gather_bytes,
                 lambda i: rows_gather(table, sets[i]),
                 lambda i: rows_gather_plain(table, sets[i]),
                 lambda i: table.index_select(0, index[i]), "index_select")
    probe.record("base", f"the [{k}, 128] fill alone", k, k * ROW_BYTES,
                 lambda i: torch.zeros((k, 128), device=device) + (table[0, 0] + sets[i][0]))
    del table
    _release(device)
    stacked = torch.rand((2, args.dual_rows, 128), generator=gen, device=device)
    _held(f"[dual ] {k} row pairs gathered", pairs_gather(stacked, sets[0]),
          pairs_gather_plain(stacked, sets[0]))
    probe.record("dual", f"P4 pairs_gather from [2, {args.dual_rows}, 128] (compare 2x hbm)", k,
                 k * 4 + 2 * (distinct + k) * ROW_BYTES,
                 lambda i: pairs_gather(stacked, sets[i]),
                 lambda i: pairs_gather_plain(stacked, sets[i]),
                 lambda i: stacked.index_select(1, index[i]), "index_select")
    del stacked
    _release(device)
    return probe.result("row_gather_scan_ns_per_row", V=args.rows, K=k)


def row_windows(args, device: torch.device, card: str) -> Dict:
    """P5 at k = 2, 3 (probe_pallas_row_windows.py:90-116); the checks
    after every time (see ``_held_write``)."""
    k, n, windows = args.k, LAUNCHES, args.window_rows
    rng = np.random.RandomState(args.seed)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    probe = _Probe(device, card, n)
    sets = _ids([draw_windows(rng, windows, k) for _ in range(n)], device)
    deltas = {}
    for w in WINDOWS:
        arr = torch.rand((w * windows, 128), generator=gen, device=device)
        d = deltas[w] = torch.from_numpy(rng.randn(k * w, 128).astype(np.float32)).to(device)
        index = [_expand(s, w, w) for s in sets]
        probe.record(f"k{w}", f"{k} windows of {w} rows of [{w * windows}, 128] "
                     f"({2 * w} rows moved an id)", k, k * 4 + 3 * k * w * ROW_BYTES,
                     lambda i: window_add(arr, sets[i], d, w),
                     lambda i: window_add_plain(arr, sets[i], d, w),
                     lambda i: arr.index_add_(0, index[i], d), "index_add_")
        del arr
        _release(device)
    for w in WINDOWS:
        arr = torch.rand((w * windows, 128), generator=gen, device=device)
        _held_write(f"[k={w}  ] the array after {CHECK_SETS} x {k} windows", arr, sets,
                    lambda a, ids: window_add(a, ids, deltas[w], w),
                    lambda a, ids: window_add_plain(a, ids, deltas[w], w))
        del arr
        _release(device)
    return probe.result("row_windows_ns_per_id", V=windows, K=k)


# in this order, the sub-commands without a write's check first
COMMANDS = {"row-gather-scan": row_gather_scan, "dma-issue-floor": dma_issue_floor,
            "row-windows": row_windows}


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m mmlrec_tpu_torch.tools.probe_rows",
                                 description="The probe scripts of benchmarks/ in CUDA")
    ap.add_argument("command", choices=tuple(COMMANDS))
    ap.add_argument("--rows", type=int, default=ROWS, help="rows of the [rows, 128] table")
    ap.add_argument("--dual-rows", type=int, default=DUAL_ROWS,
                    help="rows of each plane of the stacked [2, rows, 128] container")
    ap.add_argument("--window-rows", type=int, default=WINDOW_ROWS,
                    help="windows of the row-windows array ([k * windows, 128])")
    ap.add_argument("--k", type=int, default=K, help="rows touched a launch")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cpu: the plain versions, without times")
    args = ap.parse_args(argv)
    if args.k < 16 or args.k % 16:
        ap.error("--k must be a positive multiple of 16 (runs of up to 16 rows)")
    if args.rows < 2 * args.k or min(args.dual_rows, args.window_rows) < args.k:
        ap.error("--rows must be at least 2 * k, --dual-rows and --window-rows at least k")
    return args


def run(argv=None) -> Dict:
    """Run one sub-command; returns its JSON line as a dict."""
    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("probe_rows: no CUDA device is available; pass --device cpu to run "
                           "the plain versions (no times) on the CPU")
    if device.type == "cuda":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    else:
        card = f"{device.type}: plain versions, no times"
        print("(plain versions on the CPU: correctness only, no times)", flush=True)
    _release(device)
    with torch.no_grad():
        return COMMANDS[args.command](args, device, card)


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
