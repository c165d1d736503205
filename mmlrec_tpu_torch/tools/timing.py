"""Timers for work on the card, shared by ``chip_smoke.py`` and the tools.

Three ways to time a call ``fn()`` that queues work on the current stream:

* ``device_ms``: the calls captured in one CUDA graph and replayed, so the
  host's launch rate is out of the way: the device time per call, for calls
  that can be captured (no host synchronisation inside);
* ``queued_ms``: the card first spins while the host queues the calls
  behind the spin, then CUDA events time them back to back: the device time
  of work that cannot be captured, or of a whole training step;
* ``eager_ms``: the calls launched eagerly back to back: at small sizes this
  is the host's launch rate, not the device's time.

All return milliseconds per call and need a CUDA device.
"""

from __future__ import annotations

import statistics
import time
from typing import Callable, Optional

import torch

from ..ops import cuda_build


def _event_ms(run: Callable[[], None], reps: int, inner: int) -> float:
    """Median over ``reps`` CUDA-event windows of ``run()``, per call of the
    ``inner`` calls that one ``run()`` makes."""
    per_call = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        end.synchronize()
        per_call.append(start.elapsed_time(end) / inner)
    return statistics.median(per_call)


def eager_ms(fn: Callable[[], object], reps: int = 31, inner: int = 20) -> float:
    """Time per call of ``fn`` launched eagerly from Python, back to back
    after a warm-up: at small sizes this is the host's launch rate."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(inner):
            fn()

    return _event_ms(run, reps, inner)


def device_ms(fn: Callable[[], object], reps: int = 31, inner: int = 20) -> float:
    """Device time per call of ``fn``: ``inner`` calls captured in one CUDA
    graph and replayed, so the host's launch rate is out of the way.  The
    launches the wrappers count during the capture are counted on every
    replay instead (``cuda_build.captured_launches``), so that
    ``launch_counts`` says what ran."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture, as capture needs
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with cuda_build.captured_launches() as recorded, torch.cuda.graph(graph):
        for _ in range(inner):
            fn()

    def replay():
        graph.replay()
        cuda_build.add_launches(recorded)

    for _ in range(3):
        replay()
    torch.cuda.synchronize()
    return _event_ms(replay, reps, inner)


def spin_cycles(spin_ms: float) -> int:
    """The ``torch.cuda._sleep`` argument that spins the card ``spin_ms``."""
    probe = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
    probe[0].record()
    torch.cuda._sleep(10_000_000)
    probe[1].record()
    probe[1].synchronize()
    return int(10_000_000 * spin_ms / probe[0].elapsed_time(probe[1]))


def queued_ms(fn: Callable[[], object], reps: int = 5, inner: int = 1,
              spin_ms: float = 100.0) -> Optional[float]:
    """Device time per call of ``fn``: the card first spins for ``spin_ms``
    (``torch.cuda._sleep``) while the host queues ``inner`` calls behind it,
    so the events from the end of the spin to the end of the last call time
    the calls' kernels back to back.  None if queueing took longer than 80%
    of the spin (the window would then include idle time)."""
    cycles = spin_cycles(spin_ms)
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        e0.record()
        t0 = time.perf_counter()
        for _ in range(inner):
            fn()
        queued = (time.perf_counter() - t0) * 1e3
        e1.record()
        e1.synchronize()
        if queued > 0.8 * spin_ms:
            return None
        times.append(e0.elapsed_time(e1) / inner)
    return statistics.median(times)
