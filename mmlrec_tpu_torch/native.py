"""ctypes binding of the host step metadata's single pass
(``native/step_metadata.cpp``): the port's own loader of the step-metadata
part of ``mmlrec_tpu/native.py``.

The source stays where the JAX package keeps it and is only read from
there: the library is compiled with ``g++`` at first use into
``build/native/`` of the checkout, keyed by a hash of the source and the
flags (as ``ops/cuda_build.py`` keys the CUDA libraries), so a fresh
checkout builds it once and nothing is written into ``native/``.  When no
compiler is there or the build fails, the functions raise
``NativeUnavailable`` and ``batch_step_metadata`` runs its numpy version.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parents[1] / "native" / "step_metadata.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "native"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-pthread", "-shared")

_I32P = ctypes.POINTER(ctypes.c_int32)
_I64P = ctypes.POINTER(ctypes.c_int64)
_F32P = ctypes.POINTER(ctypes.c_float)
#: the ctypes argument lists of the functions the port calls, in the order
#: of their C parameters (both return void): ``sm_counts`` sizes the gather
#: route's lists, ``sm_fill`` fills every array
SIGNATURES = {
    "sm_counts": [_I64P, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
                  _I64P, _I64P, ctypes.c_int32],
    "sm_fill": [_I64P, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                _I32P, _F32P, _I32P, _I32P, _I32P, _F32P,
                _I32P, _I32P, _I32P, _I32P, _I32P, ctypes.c_int32],
}

_lock = threading.Lock()
_lib = None


class NativeUnavailable(RuntimeError):
    pass


def library_path() -> Path:
    content = SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()
    return BUILD_DIR / f"libstepmeta_{hashlib.sha256(content).hexdigest()[:16]}.so"


def _build(out: Path) -> None:
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if not cxx:
        raise NativeUnavailable("no C++ compiler (g++) found")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    try:
        subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                       check=True, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.SubprocessError) as e:
        raise NativeUnavailable(f"could not build {SOURCE.name}: {e}") from e
    os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing


def get_meta_lib() -> ctypes.CDLL:
    """The loaded library, built first if its build is missing."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        out = library_path()
        if not out.exists():
            _build(out)
        try:
            lib = ctypes.CDLL(str(out))
        except OSError as e:
            raise NativeUnavailable(str(e)) from e
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = None
        _lib = lib
        return _lib


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
