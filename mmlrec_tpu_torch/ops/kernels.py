"""Hand-written CUDA kernels of the serving path, with their plain versions.

The counterpart of ``mmlrec_tpu/ops/pallas_kernels.py``.  Each of the three
functions below is a wrapper that

* takes its plain PyTorch version when every tensor lies on the CPU (the
  CPU tests run this path; it is the reference the kernel is held to);
* launches its kernel from ``csrc/recsys_kernels.cu`` when every tensor lies
  on one CUDA device, or raises: a failed build or launch is an error, never
  a fallback to the plain version;
* checks dtype, shape and contiguity, allocates its output with
  ``torch.empty``, launches on the current stream, and adds one to
  ``launch_counts[name]`` per launch.

The kernels are forward only: a CUDA call whose inputs require grad while
grad mode is on raises NotImplementedError (backward kernels are ROADMAP
A3).

The shared library is built at first use with ``nvcc`` for ``sm_90a`` into
``build/torch_kernels/`` of the checkout, keyed by a hash of the source, and
loaded with ctypes.  Nothing is built or loaded at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import torch

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "recsys_kernels.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

#: launches of each kernel since the last reset_launch_counts()
launch_counts = {"embed_concat": 0, "gated_expert_mix": 0, "multihead_score": 0}

_LIB: Optional[ctypes.CDLL] = None
_EMBED_ROWS_PER_BLOCK = 16  # kEmbedRowsPerBlock in the CUDA source
_SMEM_LIMIT = 48 * 1024  # static launch limit without an opt-in attribute


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


# ----------------------------------------------------------------------
# build and load
# ----------------------------------------------------------------------
def library_path() -> Path:
    key = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"librecsys_kernels_{key}.so"


def build_kernels() -> Path:
    """Compile ``recsys_kernels.cu`` unless this source's build exists.

    Returns the library's path; the compiler's output (ptxas register and
    shared-memory report included) is kept beside it as ``.log``.
    """
    out = library_path()
    if out.exists():
        return out
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run(
        [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(_SRC)],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing
    return out


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build_kernels()))
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.mmlrec_embed_concat.argtypes = [p, ll, i, p, i, i, p, i, p, p]
        lib.mmlrec_gated_expert_mix.argtypes = [p, p, i, i, i, i, p, p]
        lib.mmlrec_multihead_score.argtypes = [p, p, p, p, i, i, i, p, p]
        for fn in (lib.mmlrec_embed_concat, lib.mmlrec_gated_expert_mix,
                   lib.mmlrec_multihead_score):
            fn.restype = ctypes.c_int
        lib.mmlrec_error_string.argtypes = [i]
        lib.mmlrec_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _on_cuda(name: str, *tensors: torch.Tensor) -> bool:
    """False for all-CPU inputs (plain version), True for inputs on one CUDA
    device (kernel); anything else raises."""
    devices = {t.device for t in tensors}
    if all(d.type == "cpu" for d in devices):
        return False
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError(
            f"{name}: inputs on {sorted(map(str, devices))}; they must all "
            "lie on the CPU or on one CUDA device")
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{name}: the CUDA kernel is forward only; run under "
            "torch.inference_mode() (backward kernels are ROADMAP A3)")
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{name}: the CUDA kernel needs contiguous inputs")
    return True


def _launch(name: str, fn, *args, device: torch.device) -> None:
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        code = fn(*args, stream)
    if code != 0:
        msg = _lib().mmlrec_error_string(code).decode()
        raise RuntimeError(f"{name}: kernel launch failed: {msg} ({code})")
    launch_counts[name] += 1


def _check_dtype(name: str, t: torch.Tensor, dtype: torch.dtype, what: str):
    if t.dtype != dtype:
        raise TypeError(f"{name}: {what} must be {dtype}, got {t.dtype}")


# ----------------------------------------------------------------------
# fused embedding gather + flatten + dense concat
# ----------------------------------------------------------------------
def embed_concat_plain(table, ids, dense):
    """concat(take(table, ids).reshape(B, F*D), dense), with jnp.take's fill
    mode: an id in [-V, 0) wraps once, any other id outside [0, V) gives a
    NaN row."""
    V, D = table.shape
    B, F = ids.shape
    idx = ids.long()
    idx = torch.where(idx < 0, idx + V, idx)
    valid = (idx >= 0) & (idx < V)
    rows = table[idx.clamp(0, max(V - 1, 0))]  # [B, F, D]
    rows = torch.where(valid[..., None], rows, rows.new_full((), float("nan")))
    return torch.cat([rows.reshape(B, F * D), dense], dim=1)


def embed_concat(table: torch.Tensor, ids: torch.Tensor, dense: torch.Tensor):
    """[V, D] f32 table, [B, F] int32 pre-offset ids, [B, Nd] f32 dense ->
    [B, F*D + Nd] f32.

    Replaces ``mmlrec_tpu/ops/pallas_kernels.py::fused_embed_concat`` (:43).
    Bound on the H100 by bytes: the gathered rows, the ids and the dense
    block are read once and the output written once (4.4 MB at the flagship
    batch, 1.3 us at 3.35 TB/s), so at serving batch sizes the launch itself
    dominates.  Design: one block per 16-row tile resolves its ids into
    shared memory once, then writes the tile's output row-major, so stores
    are contiguous and each D-float table row is read by D neighbouring
    threads.  Pure data movement: bit-identical to the plain version.
    """
    name = "embed_concat"
    _check_dtype(name, table, torch.float32, "table")
    _check_dtype(name, ids, torch.int32, "ids")
    _check_dtype(name, dense, torch.float32, "dense")
    if table.dim() != 2 or ids.dim() != 2 or dense.dim() != 2:
        raise ValueError(f"{name}: expected 2-D table, ids and dense")
    V, D = table.shape
    B, F = ids.shape
    if dense.shape[0] != B:
        raise ValueError(f"{name}: ids have {B} rows, dense {dense.shape[0]}")
    if not _on_cuda(name, table, ids, dense):
        return embed_concat_plain(table, ids, dense)
    if D < 1 or V < 1:
        raise ValueError(f"{name}: empty table {tuple(table.shape)}")
    if 8 * _EMBED_ROWS_PER_BLOCK * F > _SMEM_LIMIT:
        raise ValueError(f"{name}: {F} features exceed the kernel's tile")
    Nd = dense.shape[1]
    out = torch.empty((B, F * D + Nd), dtype=torch.float32, device=table.device)
    if B == 0 or out.shape[1] == 0:
        return out
    lib = _lib()
    _launch(name, lib.mmlrec_embed_concat, table.data_ptr(), V, D,
            ids.data_ptr(), B, F, dense.data_ptr(), Nd, out.data_ptr(),
            device=table.device)
    return out


# ----------------------------------------------------------------------
# gated expert mixing: softmax over gate logits fused with the expert mix
# ----------------------------------------------------------------------
def gated_expert_mix_plain(gate_logits, experts):
    """softmax(gate_logits, -1) @ experts: [B, T, E], [B, E, D] -> [B, T, D]."""
    return torch.einsum("bte,bed->btd", torch.softmax(gate_logits, dim=-1), experts)


def gated_expert_mix(gate_logits: torch.Tensor, experts: torch.Tensor):
    """[B, T, E] f32 gate logits, [B, E, D] f32 expert outputs -> [B, T, D].

    Replaces ``mmlrec_tpu/ops/pallas_kernels.py::gated_expert_mix`` (:123).
    Bound on the H100 by bytes (2*T*E*D FLOPs per 4*E*D bytes read: far
    below the f32 ridge), 12.7 MB at the flagship batch.  Design: one block
    per batch row; the first T threads compute the max-subtracted softmax of
    each task into shared memory, then each thread owns feature columns and
    accumulates the T mixes in f32, reading every expert row coalesced.
    The sums run in another order than the plain version's: equal to f32
    rounding.
    """
    name = "gated_expert_mix"
    _check_dtype(name, gate_logits, torch.float32, "gate_logits")
    _check_dtype(name, experts, torch.float32, "experts")
    if gate_logits.dim() != 3 or experts.dim() != 3:
        raise ValueError(f"{name}: expected [B, T, E] logits and [B, E, D] experts")
    B, T, E = gate_logits.shape
    if experts.shape[:2] != (B, E):
        raise ValueError(
            f"{name}: experts {tuple(experts.shape)} do not match logits "
            f"{tuple(gate_logits.shape)}")
    if not _on_cuda(name, gate_logits, experts):
        return gated_expert_mix_plain(gate_logits, experts)
    if E < 1 or 4 * T * E > _SMEM_LIMIT:
        raise ValueError(f"{name}: unsupported T={T}, E={E}")
    D = experts.shape[2]
    out = torch.empty((B, T, D), dtype=torch.float32, device=experts.device)
    if out.numel() == 0:
        return out
    lib = _lib()
    _launch(name, lib.mmlrec_gated_expert_mix, gate_logits.data_ptr(),
            experts.data_ptr(), B, T, E, D, out.data_ptr(),
            device=experts.device)
    return out


# ----------------------------------------------------------------------
# multi-head scoring: per-head final linear + bias + sigmoid in one pass
# ----------------------------------------------------------------------
def multihead_score_plain(tower, weights, bias, binary):
    z = torch.einsum("bth,th->bt", tower, weights) + bias[None]
    return binary * torch.sigmoid(z) + (1.0 - binary) * z


def multihead_score(
    tower: torch.Tensor,
    weights: torch.Tensor,
    bias: torch.Tensor,
    binary: Optional[torch.Tensor] = None,
):
    """tower [B, T, H], weights [T, H], bias [T] -> [B, T] f32 scores:
    ``binary * sigmoid(z) + (1 - binary) * z`` with ``z = tower . w + b``.

    ``binary`` [T] is 1 for a binary head and 0 for a regression head
    (``PredictionHeads``); None means all binary, which is exactly
    ``mmlrec_tpu/ops/pallas_kernels.py::multihead_score`` (:164), the kernel
    this replaces.  Bound on the H100 by bytes (2.1 MB at the flagship
    batch).  Design: one warp per (b, t) row, lanes striding over H with a
    shuffle reduction; lane 0 applies the head epilogue.
    """
    name = "multihead_score"
    for t, what in ((tower, "tower"), (weights, "weights"), (bias, "bias")):
        _check_dtype(name, t, torch.float32, what)
    if tower.dim() != 3:
        raise ValueError(f"{name}: expected [B, T, H] tower")
    B, T, H = tower.shape
    if binary is None:
        binary = torch.ones((T,), dtype=torch.float32, device=tower.device)
    _check_dtype(name, binary, torch.float32, "binary")
    if weights.shape != (T, H) or bias.shape != (T,) or binary.shape != (T,):
        raise ValueError(
            f"{name}: weights {tuple(weights.shape)}, bias {tuple(bias.shape)}"
            f", binary {tuple(binary.shape)} do not match tower {(B, T, H)}")
    if not _on_cuda(name, tower, weights, bias, binary):
        return multihead_score_plain(tower, weights, bias, binary)
    out = torch.empty((B, T), dtype=torch.float32, device=tower.device)
    if out.numel() == 0:
        return out
    lib = _lib()
    _launch(name, lib.mmlrec_multihead_score, tower.data_ptr(),
            weights.data_ptr(), bias.data_ptr(), binary.data_ptr(), B, T, H,
            out.data_ptr(), device=tower.device)
    return out
