"""ctypes bindings of the host C++ the port calls: the CSV loader
(``native/fast_csv.cpp``), the step metadata's single pass of the JAX
package (``native/step_metadata.cpp``: ``sm_counts`` and ``sm_fill``, which
the tests hold the port against) and the port's own source,
``mmlrec_tpu_torch/csrc/step_metadata_host.cpp``, whose one pass a call
reads, sorts and fills the step metadata of every step that
``batch_step_metadata`` and the fit's epochs build.

Each library is compiled with ``g++`` at first use into ``build/native/``
of the checkout, keyed by a hash of its source and the flags (as
``ops/cuda_build.py`` keys the CUDA libraries), so a fresh checkout builds
it once and nothing is written into ``native/``.  When no compiler is there
or the build fails, the functions raise ``NativeUnavailable``:
``batch_step_metadata`` then runs its numpy version, and
``data.ctrdataset`` with ``backend="auto"`` its pandas-equivalent reader.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

NATIVE_DIR = Path(__file__).resolve().parents[1] / "native"
SOURCE = NATIVE_DIR / "step_metadata.cpp"
CSV_SOURCE = NATIVE_DIR / "fast_csv.cpp"
HOST_SOURCE = Path(__file__).resolve().parent / "csrc" / "step_metadata_host.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "native"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-pthread", "-shared")
#: the library each source builds into (``<name>_<hash>.so``)
LIBRARY_NAMES = {SOURCE: "libstepmeta", CSV_SOURCE: "libfastcsv", HOST_SOURCE: "libhostmeta"}

_I32P = ctypes.POINTER(ctypes.c_int32)
_I64P = ctypes.POINTER(ctypes.c_int64)
_F32P = ctypes.POINTER(ctypes.c_float)
_F64P = ctypes.POINTER(ctypes.c_double)
_SOURCE_ARGS = [ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64, ctypes.c_int64, _I64P, _I64P,
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32]
#: (restype, argtypes) of every function the port calls, the arguments in
#: the order of their C parameters.  ``sm_counts`` sizes the gather route's
#: lists, ``sm_fill`` fills every array of the step metadata; ``smh_sort``
#: sorts each step's composite and counts the route's lists, ``smh_fill``
#: fills the eleven outputs in the widths asked for; ``fc_load`` parses the
#: CSV pair into a handle that the other ``fc_*`` read and ``fc_free``
#: releases.
SIGNATURES = {
    "sm_counts": (None, [_I64P, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
                         ctypes.c_int32, _I64P, _I64P, ctypes.c_int32]),
    "sm_fill": (None, [_I64P, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
                       ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                       _I32P, _F32P, _I32P, _I32P, _I32P, _F32P,
                       _I32P, _I32P, _I32P, _I32P, _I32P, ctypes.c_int32]),
    "smh_sort": (ctypes.c_int32, _SOURCE_ARGS + [_I64P, _I64P, _I64P, ctypes.c_int32]),
    "smh_fill": (ctypes.c_int32, _SOURCE_ARGS + [_I64P] + [ctypes.c_int64] * 5
                 + [ctypes.c_void_p] * 11 + [_I32P, ctypes.c_int32]),
    "fc_load": (ctypes.c_void_p, [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p, _I32P,
                                  ctypes.c_int32]),
    "fc_error": (ctypes.c_char_p, [ctypes.c_void_p]),
    "fc_rows": (ctypes.c_int64, [ctypes.c_void_p]),
    "fc_train_rows": (ctypes.c_int64, [ctypes.c_void_p]),
    "fc_vocab": (ctypes.c_int32, [ctypes.c_void_p, ctypes.c_int32]),
    "fc_read_floats": (None, [ctypes.c_void_p, ctypes.c_int32, _F64P]),
    "fc_read_codes": (None, [ctypes.c_void_p, ctypes.c_int32, _I32P]),
    "fc_free": (None, [ctypes.c_void_p]),
}
#: the source that exports each function of ``SIGNATURES``
EXPORTED_BY = {name: {"sm": SOURCE, "smh": HOST_SOURCE, "fc": CSV_SOURCE}[name.split("_")[0]]
               for name in SIGNATURES}

_lock = threading.Lock()
_libs: Dict[Path, ctypes.CDLL] = {}


class NativeUnavailable(RuntimeError):
    pass


def library_path(source: Path = SOURCE) -> Path:
    content = source.read_bytes() + " ".join(CXX_FLAGS).encode()
    return BUILD_DIR / f"{LIBRARY_NAMES[source]}_{hashlib.sha256(content).hexdigest()[:16]}.so"


def _build(source: Path, out: Path) -> None:
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if not cxx:
        raise NativeUnavailable("no C++ compiler (g++) found")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    try:
        subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(source)],
                       check=True, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.SubprocessError) as e:
        raise NativeUnavailable(f"could not build {source.name}: {e}") from e
    os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing


def _load(source: Path) -> ctypes.CDLL:
    """The loaded library of ``source``, built first if its build is missing."""
    with _lock:
        if source in _libs:
            return _libs[source]
        out = library_path(source)
        if not out.exists():
            _build(source, out)
        try:
            lib = ctypes.CDLL(str(out))
        except OSError as e:
            raise NativeUnavailable(str(e)) from e
        for name, (restype, argtypes) in SIGNATURES.items():
            if EXPORTED_BY[name] == source:
                fn = getattr(lib, name)
                fn.restype = restype
                fn.argtypes = argtypes
        _libs[source] = lib
        return lib


def get_meta_lib() -> ctypes.CDLL:
    return _load(SOURCE)


def get_csv_lib() -> ctypes.CDLL:
    return _load(CSV_SOURCE)


def get_host_meta_lib() -> ctypes.CDLL:
    return _load(HOST_SOURCE)


# ---------------------------------------------------------------------------
# the CSV loader (native/fast_csv.cpp)
# ---------------------------------------------------------------------------

def load_csv_columns(
    train_path: str,
    test_path: Optional[str],
    columns: Sequence[str],
    kinds: Sequence[int],  # 0 = float, 1 = categorical
) -> Tuple[Dict[str, np.ndarray], Dict[str, int], int, int]:
    """(column arrays over the JOINT train + test rows, the categorical
    columns' vocab sizes, train_rows, total_rows), as
    ``mmlrec_tpu/native.py::load_csv_columns`` returns them: float columns
    as float64 (``strtod``; an empty or unparsable cell reads 0.0),
    categorical ones as int32 codes of the sorted unique values (numeric
    order where every value parses as a number, else byte order)."""
    lib = get_csv_lib()
    kinds_arr = (ctypes.c_int32 * len(kinds))(*kinds)
    handle = lib.fc_load(train_path.encode(), (test_path or "").encode(),
                         "\n".join(columns).encode(), kinds_arr, len(columns))
    if not handle:
        raise NativeUnavailable("fc_load returned null")
    try:
        err = lib.fc_error(handle)
        if err:
            raise NativeUnavailable(err.decode())
        rows = lib.fc_rows(handle)
        out: Dict[str, np.ndarray] = {}
        vocabs: Dict[str, int] = {}
        for i, (name, kind) in enumerate(zip(columns, kinds)):
            if kind == 0:
                buf = np.empty(rows, np.float64)
                lib.fc_read_floats(handle, i, buf.ctypes.data_as(_F64P))
            else:
                buf = np.empty(rows, np.int32)
                lib.fc_read_codes(handle, i, buf.ctypes.data_as(_I32P))
                vocabs[name] = int(lib.fc_vocab(handle, i))
            out[name] = buf
        return out, vocabs, int(lib.fc_train_rows(handle)), int(rows)
    finally:
        lib.fc_free(handle)


# ---------------------------------------------------------------------------
# the step metadata: the JAX package's single pass (native/step_metadata.cpp)
# and the port's own (csrc/step_metadata_host.cpp)
# ---------------------------------------------------------------------------

def _p(arr, ptr_t):
    return arr.ctypes.data_as(ptr_t) if arr is not None else None


def usable_threads(steps: int) -> int:
    """Threads for a pass over ``steps`` steps: the cores this process may
    run on (its affinity mask), less one for the calling process's other
    threads where more than one is usable, and at most one a step."""
    cores = len(os.sched_getaffinity(0))
    return max(1, min(steps, cores - 1 if cores > 1 else 1))


def step_metadata_counts(comp, idx_bits, pack_factor):
    """(n_resid, n_ldup) [steps] int64 of the sorted composite ``comp``
    [steps, K] (contiguous int64): per batch, the gather route's pruned
    residuals (logical-first, not physical-first) and the non-first logical
    occurrences."""
    lib = get_meta_lib()
    steps, K = comp.shape
    n_resid = np.empty(steps, np.int64)
    n_ldup = np.empty(steps, np.int64)
    lib.sm_counts(_p(comp, _I64P), steps, K, idx_bits, pack_factor,
                  _p(n_resid, _I64P), _p(n_ldup, _I64P), usable_threads(steps))
    return n_resid, n_ldup


def step_metadata_fill(comp, idx_bits, pack_factor, Kp, R_cap, G_cap,
                       inv, rep, pids, pinv, nuniq, prep,
                       accperm=None, resid_pos=None, resid_slot=None, gdup_pos=None,
                       gdup_tgt=None):
    """Fill the caller's (inv, rep, pids, pinv, nuniq, prep) from the sorted
    composite ``comp`` [steps, K] (contiguous int64), and with ``R_cap`` /
    ``G_cap`` above 0 the gather route's lists, which the caller pre-fills
    with their drop values (``resid_slot`` Kp, ``gdup_tgt`` K, zeros
    elsewhere)."""
    lib = get_meta_lib()
    steps, K = comp.shape
    lib.sm_fill(
        _p(comp, _I64P), steps, K, idx_bits, pack_factor, Kp, R_cap, G_cap,
        _p(inv, _I32P), _p(rep, _F32P), _p(pids, _I32P), _p(pinv, _I32P),
        _p(nuniq, _I32P), _p(prep, _F32P), _p(accperm, _I32P), _p(resid_pos, _I32P),
        _p(resid_slot, _I32P), _p(gdup_pos, _I32P), _p(gdup_tgt, _I32P),
        usable_threads(steps),
    )


class HostMetaSource:
    """Where the port's pass reads each step's ids: the rows ``rows``
    [steps, B] of the ids matrix ``src`` [N, S] (int32 or int64), its first
    ``len(offsets)`` columns plus ``offsets`` (int64), or, with neither,
    the flat ids ``src`` [steps, K] themselves.  Checks dtypes, contiguity
    and the rows' bounds before any pointer is passed."""

    def __init__(self, src: np.ndarray, rows: Optional[np.ndarray] = None,
                 offsets: Optional[np.ndarray] = None):
        if src.dtype not in (np.int32, np.int64):
            src = src.astype(np.int64)
        self.src = np.ascontiguousarray(src)
        if rows is None:
            self.rows = self.offsets = None
            self.steps, self.B, self.F = src.shape[0], 1, src.shape[1]
        else:
            self.rows = np.ascontiguousarray(rows, np.int64)
            self.offsets = np.ascontiguousarray(offsets, np.int64)
            self.steps, self.B = self.rows.shape
            self.F = len(self.offsets)
            if self.F > src.shape[1]:
                raise ValueError(f"{self.F} offsets for {src.shape[1]} id columns")
            if self.rows.size and (self.rows.min() < 0 or self.rows.max() >= len(src)):
                raise IndexError(f"rows outside the {len(src)} rows of the ids")
        self.K = self.B * self.F

    def args(self, idx_bits: int, pack_factor: int) -> tuple:
        return (self.src.ctypes.data_as(ctypes.c_void_p), self.src.itemsize,
                self.src.shape[1], self.F, _p(self.offsets, _I64P), _p(self.rows, _I64P),
                self.B, self.steps, idx_bits, pack_factor)


def _check_comp(source: HostMetaSource, comp: np.ndarray) -> None:
    if (comp.shape != (source.steps, source.K) or comp.dtype != np.int64
            or not comp.flags.c_contiguous):
        raise ValueError(f"composite {comp.shape} {comp.dtype}, not contiguous int64 "
                         f"({source.steps}, {source.K})")


def _checked(rc: int) -> None:
    if rc == 1:
        raise AssertionError("id overflow")
    if rc == 2:
        raise ValueError("negative id")


def host_metadata_sort(source: HostMetaSource, idx_bits: int, pack_factor: int,
                       comp: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Sort each step's composite into ``comp`` [steps, K] (contiguous
    int64) and count the gather route's lists: (n_resid, n_ldup) [steps]."""
    _check_comp(source, comp)
    n_resid = np.empty(source.steps, np.int64)
    n_ldup = np.empty(source.steps, np.int64)
    _checked(get_host_meta_lib().smh_sort(
        *source.args(idx_bits, pack_factor), _p(comp, _I64P), _p(n_resid, _I64P),
        _p(n_ldup, _I64P), usable_threads(source.steps)))
    return n_resid, n_ldup


def host_metadata_fill(source: HostMetaSource, idx_bits: int, pack_factor: int,
                       comp: Optional[np.ndarray], Kp: int, R_cap: int, G_cap: int,
                       drops: Tuple[int, int], outs: Sequence[Optional[np.ndarray]]) -> None:
    """Fill ``outs`` (inv, rep, pids, pinv, nuniq, prep, accperm,
    resid_pos, resid_slot, gdup_pos, gdup_tgt; None is not written), each
    in the width of its dtype, every entry of each row: from ``comp``
    sorted by ``host_metadata_sort``, or with ``comp`` None in the same
    call that reads and sorts each step.  ``drops`` are the pad values of
    resid_slot and gdup_tgt."""
    if comp is not None:
        _check_comp(source, comp)
    K = source.K
    cols = (K, K, Kp, K, 1, K, Kp, R_cap, R_cap, G_cap, G_cap)
    sizes = ((4, 2), (4, 1), (4,), (4, 2), (4,), (4, 1), (4, 2), (4, 2), (4, 2), (4, 2), (4, 2))
    if len(outs) != len(cols) or (outs[2] is None) != (outs[4] is None):
        raise ValueError(f"{len(outs)} outputs, not {len(cols)}, or pids without nuniq")
    widths = np.zeros(len(cols), np.int32)
    for i, a in enumerate(outs):
        if a is None:
            continue
        if (a.shape != (source.steps, cols[i]) or a.itemsize not in sizes[i]
                or not a.flags.c_contiguous):
            raise ValueError(f"output {i}: {a.shape} {a.dtype}, not ({source.steps}, {cols[i]}) "
                             f"of {sizes[i]} bytes, contiguous")
        widths[i] = a.itemsize
    _checked(get_host_meta_lib().smh_fill(
        *source.args(idx_bits, pack_factor), _p(comp, _I64P), Kp, R_cap, G_cap, *drops,
        *(None if a is None else a.ctypes.data_as(ctypes.c_void_p) for a in outs),
        _p(widths, _I32P), usable_threads(source.steps)))
