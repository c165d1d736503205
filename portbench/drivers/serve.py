"""The serving driver: ``ServingBundle.predict`` from one client in a
closed loop (the bundle is a library call with no queue: each caller
waits for its reply).

Set-up draws served-magnitude weights from the seed into the program's
model, exports it with ``save_serving_bundle`` into ``TMPDIR``, loads the
bundle back on the card, draws the pool of rows and the requests, and
warms the bundle on requests that span the sizes the window sends.  The
window sends request after request for ``--seconds``; a request's latency
runs from the call to its probabilities back on the host as numpy.  The
window keeps the answers of a sample of the answered requests drawn from
the seed, and of the largest; after it the reference scores them on the
same weights and rows.
"""

from __future__ import annotations

import random
import shutil
import sys
import tempfile
import time
from types import SimpleNamespace
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import trace as tracing
from ..arith import ops as arith
from ..reference.model import family
from ..reference.train import matmul_precision
from ..traffic import gen
from . import common


def run(ctx) -> Dict:
    from mmlrec_tpu_torch.models import get_model
    from mmlrec_tpu_torch.serving import ServingBundle, save_serving_bundle
    from mmlrec_tpu_torch.train import resolve_table_container

    ctx.note("imported the program")
    d, spec, mix, dev = ctx.dims, ctx.spec, ctx.mix, ctx.device
    cfg = common.experiment_config(spec)
    lay = common.layout(d)
    resolve_table_container(cfg, lay, device=dev)
    model = get_model(cfg.model_config.model_name, lay, cfg, device=dev,
                      generator=gen.generator(ctx.seed, "weights", dev))
    dense = common.draw_dense(d, ctx.seed, dev)
    common.load_into(model, d, dense, ctx.seed)
    where = tempfile.mkdtemp(prefix="portbench-bundle-")
    try:
        save_serving_bundle(model, where)
        del model
        bundle = ServingBundle.load(where, device=dev)
    finally:
        shutil.rmtree(where, ignore_errors=True)

    ctx.note("exported and loaded the serving bundle")
    req = mix["requests"]
    pool_rows = int(mix["pool_rows"])
    pool, _ = gen.rows(spec["experiment"], d.vocabs, mix, pool_rows, ctx.seed, "pool", dev)
    sizes = gen.request_sizes(req, ctx.seed)
    offsets = gen.request_offsets(sizes, pool_rows, ctx.seed)
    requests = [common.column_slice(pool, int(o), int(o + s)) for o, s in zip(offsets, sizes)]
    by_size = np.argsort(sizes, kind="stable")
    warm = by_size[np.linspace(0, len(sizes) - 1, int(mix["warmup_sizes"])).astype(int)]
    for i in warm:
        bundle.predict(requests[i])

    ctx.note(f"drew the pool and warmed {len(warm)} request sizes")
    kept = Sample(int(mix["checked_requests"]), sizes, ctx.seed)
    rows_of = sizes.tolist()
    common.settle()
    setup_s = time.perf_counter() - ctx.t0
    latencies, sent, failed, served_rows = [], 0, 0, 0
    with tracing.profiled(ctx.trace) as box:
        with tracing.window():
            start = time.perf_counter()
            while time.perf_counter() - start < ctx.seconds:
                i = sent % len(requests)
                clock = time.perf_counter()
                try:
                    probs = bundle.predict(requests[i])
                except Exception as e:  # a failed request is counted and judged
                    failed += 1
                    print(f"request {sent} failed: {type(e).__name__}: {e}", file=sys.stderr)
                else:
                    latencies.append(time.perf_counter() - clock)
                    served_rows += rows_of[i]
                    kept.offer(sent, probs)
                sent += 1
            wall = time.perf_counter() - start
    device = common.device_info(dev, ctx.chips)
    del bundle
    common.free(dev)

    ctx.note(f"window {wall:.3f} s, {sent} requests; bundle freed")
    answers = kept.answers()
    numbers = check(ctx, d, dense, pool, sizes, offsets, answers)
    numbers["failed_requests"] = float(failed)
    e2e = {"setup_s": setup_s, "serve_examples_per_s": served_rows / wall,
           "serve_p95_ms": 1e3 * float(np.percentile(latencies, 95)) if latencies else None}
    out = dict(e2e=e2e, attempted=sent, failed=failed, numbers=numbers, device=device,
               trace=box["trace"], judged=(d, dense, pool, sizes, offsets, answers))
    if box["trace"] is not None:
        out["layer_ctx"] = SimpleNamespace(
            trace=box["trace"], requests=sent, examples=served_rows, rate=served_rows / wall,
            forward_flops_per_example=arith.forward_matmul_flops(d),
            ops=_window_ops(d, pool, sizes, offsets, sent))
    return out


def reference_probs(d, dense, table, ids, block: torch.Tensor, tf32: bool = False):
    """The reference's probabilities of rows with logical ``ids`` [n, F]
    (rows of ``table`` by position in the sorted ``table`` ids) and dense
    ``block``."""
    rows_needed, table_rows = table
    loc = torch.searchsorted(rows_needed, ids)
    x = torch.cat([table_rows[loc].flatten(1), block], dim=1)
    with matmul_precision(tf32), torch.no_grad():
        return family(d.model_name).forward(dense, x, d)


class Sample:
    """The answers the check reads, kept while the window runs: ``size``
    answered requests drawn uniformly from the seed (reservoir sampling,
    Vitter's algorithm R) and the first answered request of the largest
    size.  The window holds no other answer: holding every one grew the
    heap by about 0.7 GB a window, and the requests then read slower and
    less steadily (p95 1.53 against 0.98 ms on an H100's host, with twice
    the spread between runs)."""

    def __init__(self, size: int, sizes: np.ndarray, seed: int):
        self.size = size
        self.rows = sizes.tolist()
        self.rng = random.Random(gen.stream_seed(seed, "order") + 1)
        self.slots: List[Tuple[int, np.ndarray]] = []
        self.seen = 0
        self.largest: Optional[Tuple[int, int, np.ndarray]] = None

    def offer(self, k: int, answer: np.ndarray) -> None:
        """Request ``k`` answered ``answer``."""
        if len(self.slots) < self.size:
            self.slots.append((k, answer))
        else:
            j = self.rng.randrange(self.seen + 1)
            if j < self.size:
                self.slots[j] = (k, answer)
        self.seen += 1
        rows = self.rows[k % len(self.rows)]
        if self.largest is None or rows > self.largest[0]:
            self.largest = (rows, k, answer)

    def answers(self) -> Dict[int, np.ndarray]:
        """{request: answer} of the sample, the largest among them."""
        out = dict(self.slots)
        if self.largest is not None:
            out[self.largest[1]] = self.largest[2]
        return dict(sorted(out.items()))


def check(ctx, d, dense, pool, sizes, offsets, answers: Dict[int, np.ndarray],
          control: bool = False) -> Dict[str, float]:
    """The widest gap between the sampled ``answers`` ({request: answer})
    and the reference's probabilities; with ``control``, the reference in
    TF32 takes the program's place."""
    dev = ctx.device
    picks = sorted(answers)
    spans = [(int(offsets[k % len(sizes)]), int(offsets[k % len(sizes)] + sizes[k % len(sizes)]))
             for k in picks]
    ids = [common.fused_ids(pool, d, lo, hi).to(dev) for lo, hi in spans]
    if not ids:
        return {"prob_gap": float("inf")}
    needed = common.unique_rows(ids)
    table = (needed, common.table_rows(d, ctx.seed, dev, needed))
    gap = 0.0
    for k, i, (lo, hi) in zip(picks, ids, spans):
        block = common.dense_block(pool, d, lo, hi).to(dev)
        ref = reference_probs(d, dense, table, i, block)
        if control:
            got = reference_probs(d, dense, table, i, block, tf32=True).double()
        else:
            got = torch.from_numpy(np.asarray(answers[k], dtype=np.float64)).to(dev)
        gap = max(gap, float((got - ref.double()).abs().max()))
    return {"prob_gap": gap}


def _window_ops(d, pool, sizes, offsets, sent):
    """The logical operations of the window's forwards, with their shapes
    (each distinct request's table rows counted once per request)."""
    per_request = {}
    ops = []
    for k in range(sent):
        j = k % len(sizes)
        if j not in per_request:
            lo, hi = int(offsets[j]), int(offsets[j] + sizes[j])
            distinct = len(np.unique(common.fused_ids(pool, d, lo, hi).numpy()))
            per_request[j] = arith.forward_ops(d, int(sizes[j]), distinct)
        ops += per_request[j]
    return ops
