"""The traced run's reduction: the profiler (Kineto, CUPTI on the card)
around the window, then the device's operations and the host's, reduced in
memory to what the per-layer metrics read.  No trace file is written, and
the profiler's own per-event post-processing is skipped: its raw events
are read once, totalled by name and kept as arrays.

A CUDA graph's replay records each of its kernels, so a replayed step
reads like an eager one.  The window is the span of the harness's own
``portbench.window`` range on the host's clock, to which the profiler
aligns the device's.
"""

from __future__ import annotations

import contextlib
import re
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

WINDOW = "portbench.window"
_MEMORY_OPS = ("Memcpy", "Memset")


class Trace:
    """The window's device operations (totals by name, intervals) and its
    host operations (for naming the device's idle gaps)."""

    def __init__(self, device_ops, host_ops, window: Tuple[int, int]):
        self.window = window
        lo, hi = window
        names, starts, ends = device_ops
        starts, ends = np.clip(starts, lo, hi), np.clip(ends, lo, hi)
        inside = ends > starts
        self.starts, self.ends = starts[inside], ends[inside]
        self.seconds: Dict[str, float] = {}
        self.launches: Dict[str, int] = {}
        for name, s, e in zip((n for n, k in zip(names, inside) if k), self.starts, self.ends):
            self.seconds[name] = self.seconds.get(name, 0.0) + (e - s) / 1e9
            self.launches[name] = self.launches.get(name, 0) + 1
        self.host_names, self.host_starts, self.host_ends = host_ops

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def kernel_launches(self) -> int:
        return sum(n for k, n in self.launches.items() if not k.startswith(_MEMORY_OPS))

    def busy_intervals(self) -> Tuple[np.ndarray, np.ndarray]:
        """The union of the device operations' intervals, as (starts, ends)."""
        if not len(self.starts):
            return self.starts, self.ends
        order = np.argsort(self.starts, kind="stable")
        s, e = self.starts[order], np.maximum.accumulate(self.ends[order])
        new = np.concatenate([[True], s[1:] > e[:-1]])
        first = np.flatnonzero(new)
        last = np.concatenate([first[1:] - 1, [len(s) - 1]])
        return s[first], e[last]

    def busy_s(self) -> float:
        s, e = self.busy_intervals()
        return float((e - s).sum()) / 1e9

    def idle_gaps(self) -> List[Tuple[int, int]]:
        lo, hi = self.window
        s, e = self.busy_intervals()
        edges_lo = np.concatenate([[lo], e])
        edges_hi = np.concatenate([s, [hi]])
        keep = edges_hi > edges_lo
        return list(zip(edges_lo[keep].tolist(), edges_hi[keep].tolist()))

    def host_op_during(self, lo: int, hi: int) -> str:
        """The host operation that overlaps [lo, hi) the most, the shortest
        such on a tie (the innermost call)."""
        if not len(self.host_starts):
            return "host (no operation recorded)"
        overlap = np.minimum(self.host_ends, hi) - np.maximum(self.host_starts, lo)
        if overlap.max() <= 0:
            return "host (no operation recorded)"
        length = self.host_ends - self.host_starts
        best = np.lexsort((length, -overlap))[0]
        return self.host_names[best]

    def breakdown(self, top: int = 10) -> Dict[str, list]:
        ops = sorted(self.seconds.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.idle_gaps(), key=lambda g: g[0] - g[1])[:top]
        return {"device_ops": [[n, s] for n, s in ops],
                "idle_gaps": [[self.host_op_during(s, e), (e - s) / 1e9] for s, e in gaps]}

    def seconds_matching(self, names: Dict[str, str]) -> Dict[str, float]:
        """Device seconds by logical operation, for the kernels whose function
        name is a key of ``names`` (the profiler shows the name with its
        argument list)."""
        pats = [(re.compile(r"(^|[^A-Za-z0-9_])" + re.escape(k) + r"([^A-Za-z0-9_]|$)"), op)
                for k, op in names.items()]
        out: Dict[str, float] = {}
        for name, seconds in self.seconds.items():
            for pat, op in pats:
                if pat.search(name):
                    out[op] = out.get(op, 0.0) + seconds
                    break
        return out


@contextlib.contextmanager
def profiled(enabled: bool) -> Iterator[dict]:
    """Around a window: with ``enabled``, profile it (host and device) and
    leave its ``Trace`` under ``"trace"`` of the yielded dict; the window
    itself goes in a ``window()`` range inside."""
    box: Dict[str, Optional[Trace]] = {"trace": None}
    if not enabled:
        yield box
        return
    cuda = torch.cuda.is_available()
    prof = torch.autograd.profiler.profile(use_device="cuda" if cuda else None,
                                           use_kineto=True)
    prof.__enter__()
    try:
        yield box
    finally:
        if cuda:
            torch.cuda.synchronize()
        results = torch.autograd._disable_profiler()
    box["trace"] = _reduce(results.events())


def window():
    return torch.profiler.record_function(WINDOW)


def _reduce(events) -> Trace:
    names: List[str] = []
    starts: List[int] = []
    ends: List[int] = []
    host_names: List[str] = []
    host_starts: List[int] = []
    host_ends: List[int] = []
    span = None
    for e in events:
        name = e.name()
        if str(e.device_type()).endswith("CUDA"):
            if e.is_user_annotation() or name == WINDOW:
                continue
            names.append(name)
            starts.append(e.start_ns())
            ends.append(e.end_ns())
        elif name == WINDOW:
            span = (e.start_ns(), e.end_ns())
        else:
            host_names.append(name)
            host_starts.append(e.start_ns())
            host_ends.append(e.end_ns())
    if span is None:
        raise RuntimeError("the profile holds no window range")
    device = (names, np.asarray(starts, np.int64), np.asarray(ends, np.int64))
    host = (host_names, np.asarray(host_starts, np.int64), np.asarray(host_ends, np.int64))
    return Trace(device, host, span)
