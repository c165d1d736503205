"""CUDA-graph replay of the trainer's steps: the port's counterpart of the
JAX package's scanned programs (``_make_scan_runner``, trainer.py:1250-1280,
and ``_scanned_probs``, :1334-1350).

A step that reads its inputs from device buffers at a device counter and
updates all of its state in place can be captured once and replayed: the
host then issues one graph launch per step instead of a few hundred kernel
launches, and reads nothing back.  ``StepGraphs.run(key, body)`` runs
``body`` once: by replaying the graph captured under ``key``, or, the first
time, eagerly on a side stream (the warm-up the capture needs, and a real
step) and then capturing it for the next calls.  On the CPU it calls
``body``.

The generators the step draws its dropout masks and gates from (one, or
one per member of a stacked suite: ``layers.MemberGenerators``) are
registered with each graph: a replay takes each generator's seed and
offset at the time of the replay, so the trainer's reseed before each step
gives a replayed step the draws of the eager one.  ``captures`` counts the
graphs captured and ``capture_s`` sums the host seconds of their first runs
(eager warm-up and capture), each under the span ``capture_span``
(``mmlrec.fit.capture`` by default).
The wrappers' launch counts are recorded at capture and added on every
replay (``cuda_build``).
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Hashable, Optional, Sequence, Tuple, Union

import torch

from ..ops import cuda_build
from ..utils.spans import span


class StepGraphs:
    def __init__(self, device: torch.device,
                 generator: Union[torch.Generator, Sequence[torch.Generator], None] = None,
                 capture_span: str = "mmlrec.fit.capture"):
        self.device = torch.device(device)
        self.capture_span = capture_span
        self.generators = ([] if generator is None else
                           [generator] if isinstance(generator, torch.Generator)
                           else list(generator))
        self.graphs: Dict[Hashable, Tuple[torch.cuda.CUDAGraph, dict]] = {}
        #: replays since construction, by key
        self.replays: Dict[Hashable, int] = {}
        #: graphs captured since construction (a discarded key's again)
        self.captures = 0
        #: host seconds of the captures (each with its eager warm-up run)
        self.capture_s = 0.0

    def discard(self, kind: str) -> None:
        """Drop the graphs captured for ``kind`` (a key's first entry): the
        buffers they read were replaced, so the next run captures anew."""
        self.graphs = {k: v for k, v in self.graphs.items() if k[0] != kind}

    def run(self, key: Hashable, body: Callable[[], None]) -> None:
        if self.device.type != "cuda":
            body()
            return
        entry = self.graphs.get(key)
        if entry is not None:
            graph, launches = entry
            graph.replay()
            cuda_build.add_launches(launches)
            self.replays[key] = self.replays.get(key, 0) + 1
            return
        with span(self.capture_span):
            clock = time.perf_counter()
            current = torch.cuda.current_stream(self.device)
            side = torch.cuda.Stream(self.device)
            side.wait_stream(current)
            with torch.cuda.stream(side):
                body()
            current.wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            for gen in self.generators:
                if gen.device.type == "cuda":
                    graph.register_generator_state(gen)
            with cuda_build.captured_launches() as launches:
                # thread_local: the fit's worker threads keep uploading meanwhile
                with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                    body()
            self.graphs[key] = (graph, launches)
            self.replays.setdefault(key, 0)
            self.captures += 1
            self.capture_s += time.perf_counter() - clock
