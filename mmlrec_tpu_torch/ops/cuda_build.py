"""Build, load and launch the port's hand-written CUDA libraries.

Each ``csrc/*.cu`` file is one shared library with a plain C interface,
compiled at first use with ``nvcc`` for ``sm_90a`` into
``build/torch_kernels/`` of the checkout, keyed by a hash of its source, and
loaded with ctypes.  Nothing is built or loaded at import: the CPU tests
import every module of the package without nvcc or a card.

``build_all`` starts one ``nvcc`` per source, all at once, and waits for
them: the build counts against the time of a fresh checkout's first run.

Every wrapper adds one to ``launch_counts[name]`` where it launches its
kernel, and nowhere else, so a run can show which kernels its path went
through.  ``backward_counts[name]`` counts the calls of a kernel's plain
backward (the JAX package's backwards are plain too): no kernel is launched
there, so they are kept apart.  A CUDA graph launches its kernels when it
is replayed, not when it is captured: ``captured_launches`` takes what the
wrappers counted during a capture out of the counts and keeps it, and
``add_launches`` adds it back on every replay.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

#: launches of each kernel since the last reset_launch_counts()
launch_counts: Dict[str, int] = {}
#: calls of each kernel's plain backward since the last reset_launch_counts()
backward_counts: Dict[str, int] = {}


def reset_launch_counts() -> None:
    for counts in (launch_counts, backward_counts):
        for k in counts:
            counts[k] = 0


@contextlib.contextmanager
def captured_launches():
    """Around a CUDA graph capture: yields a dict that receives the
    launches and plain backwards the wrappers counted inside, which are
    taken out of the counts again (the capture ran nothing)."""
    before = (dict(launch_counts), dict(backward_counts))
    recorded: Dict[str, Dict[str, int]] = {}
    try:
        yield recorded
    finally:
        for key, counts, old in (("launch", launch_counts, before[0]),
                                 ("backward", backward_counts, before[1])):
            recorded[key] = {k: v - old.get(k, 0) for k, v in counts.items()
                             if v != old.get(k, 0)}
            for k in counts:
                counts[k] = old.get(k, 0)


def add_launches(recorded: Dict[str, Dict[str, int]]) -> None:
    """Count one replay of a graph whose capture recorded ``recorded``."""
    for key, counts in (("launch", launch_counts), ("backward", backward_counts)):
        for k, v in recorded.get(key, {}).items():
            counts[k] = counts.get(k, 0) + v


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return nvcc


class CudaLibrary:
    """One ``csrc/<source>`` file built into one ctypes-loaded library.

    ``signatures`` maps each exported C function to its ctypes argument
    types; every one returns an ``int`` CUDA error code (0 = launched).
    ``defines`` are extra ``-DNAME=value`` flags: a variant of the source
    with another tuning constant, built beside the default one
    (``tools/tune_kernels.py``).
    """

    def __init__(self, source: str, signatures: Dict[str, List],
                 defines: Sequence[str] = ()):
        self.source = CSRC / source
        self.signatures = signatures
        self.defines = tuple(defines)
        self._lib: Optional[ctypes.CDLL] = None

    def path(self) -> Path:
        content = self.source.read_bytes() + " ".join(self.defines).encode()
        key = hashlib.sha256(content).hexdigest()[:16]
        return BUILD_DIR / f"lib{self.source.stem}_{key}.so"

    def _start(self) -> Optional[subprocess.Popen]:
        """Start nvcc for this source unless its build exists."""
        out = self.path()
        if out.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, *self.defines, "-o", str(tmp), str(self.source)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        proc.tmp = tmp  # type: ignore[attr-defined]
        return proc

    def _finish(self, proc: Optional[subprocess.Popen]) -> Path:
        out = self.path()
        if proc is None:
            return out
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed on {self.source.name} ({proc.returncode}):\n{stderr}")
        out.with_suffix(".log").write_text(stdout + stderr)
        os.replace(proc.tmp, out)  # atomic: a concurrent build sees all or nothing
        return out

    def build(self) -> Path:
        """Compile the source unless its build exists; the compiler's output
        (ptxas registers and shared memory) is kept beside it as ``.log``."""
        return self._finish(self._start())

    def load(self) -> ctypes.CDLL:
        if self._lib is None:
            lib = ctypes.CDLL(str(self.build()))
            for name, argtypes in self.signatures.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.mmlrec_error_string.argtypes = [ctypes.c_int]
            lib.mmlrec_error_string.restype = ctypes.c_char_p
            self._lib = lib
        return self._lib


def build_all(libraries: Iterable[CudaLibrary]) -> List[Path]:
    """Build every library that is not built yet, one nvcc each, all
    started together."""
    libraries = list(libraries)
    procs = [lib._start() for lib in libraries]
    return [lib._finish(p) for lib, p in zip(libraries, procs)]


def on_cuda(name: str, *tensors: torch.Tensor, forward_only: bool = True) -> bool:
    """False for all-CPU inputs (plain version), True for inputs on one CUDA
    device (kernel); anything else raises.  ``forward_only`` kernels refuse
    inputs that require grad while grad mode is on."""
    devices = {t.device for t in tensors}
    if all(d.type == "cpu" for d in devices):
        return False
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError(
            f"{name}: inputs on {sorted(map(str, devices))}; they must all "
            "lie on the CPU or on one CUDA device")
    if forward_only and torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{name}: the CUDA kernel is forward only and has no backward; run "
            "under torch.no_grad()")
    return True


def under_vmap(*tensors: Optional[torch.Tensor]) -> bool:
    """True when any of ``tensors`` is batched by ``torch.func.vmap``: a
    wrapper then goes through its ``autograd.Function``, whose ``vmap`` rule
    folds the stack into one call of the kernel."""
    return any(t is not None and torch._C._functorch.is_batchedtensor(t) for t in tensors)


def needs_grad(t: torch.Tensor) -> bool:
    """``requires_grad`` of the tensor under any vmap levels (a batched
    tensor reports False whatever the tensor it wraps requires)."""
    while torch._C._functorch.is_batchedtensor(t):
        t = torch._C._functorch.get_unwrapped(t)
    return t.requires_grad


def stack_front(t: torch.Tensor, in_dim: Optional[int], size: int) -> torch.Tensor:
    """A vmap rule's operand with its stack axis first: moved there, or, for
    an operand the stack shares (``in_dim`` None), expanded to ``size``."""
    if in_dim is None:
        return t.unsqueeze(0).expand(size, *t.shape)
    return t.movedim(in_dim, 0)


def launch(library: CudaLibrary, name: str, fn, *args, device: torch.device) -> None:
    """Call ``fn(*args, stream)`` on ``device``'s current stream, raise if
    the launch was refused, and count it."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        code = fn(*args, stream)
    if code != 0:
        msg = library.load().mmlrec_error_string(code).decode()
        raise RuntimeError(f"{name}: kernel launch failed: {msg} ({code})")
    launch_counts[name] += 1


def check_dtype(name: str, t: torch.Tensor, dtypes: Sequence[torch.dtype], what: str):
    if t.dtype not in tuple(dtypes):
        raise TypeError(f"{name}: {what} must be one of {list(dtypes)}, got {t.dtype}")
