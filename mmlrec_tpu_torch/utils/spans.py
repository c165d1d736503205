"""Named spans of the port's host work, for the profiler.

``span(name)`` is a ``torch.profiler.record_function`` range while a
profiler runs in the calling thread, and one shared no-op otherwise, so a
span site costs one check of the profiler's state when nothing profiles.
``timed(timing, key, name)`` also adds the block's host seconds to
``timing[key]``: the counter and the span measure the same interval.

Names start with ``mmlrec.`` and follow PERF.md's layers: ``mmlrec.fit.*``
is the fit loop (``train/fit_loop.py``, ``train/staging.py``),
``mmlrec.serve.*`` the serving entry (``serving.py``).  A span adds no
synchronisation, reads nothing back from the device and writes nothing to
disk: spans live in the profiler's memory, counters in the caller's dict
(``Trainer.fit_timing``).
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Optional

import torch

_OFF = contextlib.nullcontext()


def enabled() -> bool:
    """Whether a profiler records the calling thread."""
    return torch.autograd._profiler_enabled()


def span(name: str, on: Optional[bool] = None):
    """A profiler range named ``name``, or the shared no-op; ``on``
    overrides the calling thread's gate (a worker takes the gate its
    submitter read)."""
    if on is None:
        on = enabled()
    return torch.profiler.record_function(name) if on else _OFF


class timed:
    """``with timed(timing, key, name):`` adds the block's host seconds to
    ``timing[key]`` and opens ``span(name, on)`` around it."""

    __slots__ = ("timing", "key", "span", "clock")

    def __init__(self, timing: Dict[str, float], key: str, name: str,
                 on: Optional[bool] = None):
        self.timing, self.key, self.span = timing, key, span(name, on)

    def __enter__(self):
        self.span.__enter__()
        self.clock = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.timing[self.key] = self.timing.get(self.key, 0.0) + time.perf_counter() - self.clock
        return self.span.__exit__(*exc)
