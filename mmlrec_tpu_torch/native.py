"""ctypes bindings of the host C++ the port calls: the CSV loader
(``native/fast_csv.cpp``) and the step metadata's single pass
(``native/step_metadata.cpp``), the port's own loader of what
``mmlrec_tpu/native.py`` binds.

The sources stay where the JAX package keeps them and are only read from
there: each library is compiled with ``g++`` at first use into
``build/native/`` of the checkout, keyed by a hash of its source and the
flags (as ``ops/cuda_build.py`` keys the CUDA libraries), so a fresh
checkout builds it once and nothing is written into ``native/``.  When no
compiler is there or the build fails, the functions raise
``NativeUnavailable``: ``batch_step_metadata`` then runs its numpy
version, and ``data.ctrdataset`` with ``backend="auto"`` its
pandas-equivalent reader.
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
BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "native"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-pthread", "-shared")
#: the library each source builds into (``<name>_<hash>.so``)
LIBRARY_NAMES = {SOURCE: "libstepmeta", CSV_SOURCE: "libfastcsv"}

_I32P = ctypes.POINTER(ctypes.c_int32)
_I64P = ctypes.POINTER(ctypes.c_int64)
_F32P = ctypes.POINTER(ctypes.c_float)
_F64P = ctypes.POINTER(ctypes.c_double)
#: (restype, argtypes) of every function the port calls, the arguments in
#: the order of their C parameters.  ``sm_counts`` sizes the gather route's
#: lists, ``sm_fill`` fills every array of the step metadata; ``fc_load``
#: parses the CSV pair into a handle that the other ``fc_*`` read and
#: ``fc_free`` releases.
SIGNATURES = {
    "sm_counts": (None, [_I64P, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
                         ctypes.c_int32, _I64P, _I64P, ctypes.c_int32]),
    "sm_fill": (None, [_I64P, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
                       ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                       _I32P, _F32P, _I32P, _I32P, _I32P, _F32P,
                       _I32P, _I32P, _I32P, _I32P, _I32P, ctypes.c_int32]),
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
EXPORTED_BY = {name: SOURCE if name.startswith("sm_") else CSV_SOURCE for name in SIGNATURES}

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
# the step metadata's single pass (native/step_metadata.cpp)
# ---------------------------------------------------------------------------

def _p(arr, ptr_t):
    return arr.ctypes.data_as(ptr_t) if arr is not None else None


def _threads(steps: int) -> int:
    return max(1, min(steps, os.cpu_count() or 1))


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
                  _p(n_resid, _I64P), _p(n_ldup, _I64P), _threads(steps))
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
        _threads(steps),
    )
