"""The training driver: ``Trainer.fit`` as the CLI builds the trainer from
the configuration (``mmlrec_tpu_torch/main.py::run_seeds``), on rows drawn
from the seed and staged by the fit.

Set-up draws the rows and the weights, builds one trainer and drives it
through its first three steps through the window's own call, feed and
shuffle: a one-batch fit, then a fit of two batches (its first step runs
eagerly and is captured, its second replays the captured graph, as every
later step of the window does; it validates, so every shape the window
uses is warm), reading the trainer's state after each fit.  The reference
takes the second fit's batches in the order the fit draws them from the
seed (``fit_batches``).  The window is one fit of the same trainer over
whole epochs, ``--seconds`` over the mix's ``epoch_seconds`` of them, so
that every run does the same work: its staging, syncs, per-epoch host
work and validation included.  After the window the program's state is
freed and the reference follows the first three steps from the same
weights and rows.
"""

from __future__ import annotations

import time
from types import SimpleNamespace
from typing import Dict, List

import numpy as np
import torch

from .. import trace as tracing
from ..arith import ops as arith
from ..reference.compare import training_numbers
from ..reference.dims import B1
from ..reference.model import TABLE
from ..reference.train import run_steps
from ..traffic import gen
from . import common

#: the steps the reference follows
CHECKED_STEPS = 3
#: the end-to-end names of the window's rate: a cell reports the one
#: ``BENCHMARK.json`` gives it, by the regime that sets its pace
RATES = ("train_examples_per_s", "host_bound.train_examples_per_s")


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def prelude(ctx) -> SimpleNamespace:
    """Set-up up to the window: the rows, the weights, the trainer, and its
    first steps with the state they left."""
    from mmlrec_tpu_torch.models import get_model
    from mmlrec_tpu_torch.train import Trainer, resolve_table_container

    ctx.note("imported the program")
    d, spec, mix, dev = ctx.dims, ctx.spec, ctx.mix, ctx.device
    cfg = common.experiment_config(spec)
    tc, oc, mc = cfg.training_config, cfg.optim_config, cfg.model_config
    batch = int(tc.train_batch_size)
    n = int(mix["train_batches"]) * batch
    val_rows = int(mix["val_rows"])
    x, y = gen.rows(spec["experiment"], d.vocabs, mix, n, ctx.seed, "train", dev)
    val = gen.rows(spec["experiment"], d.vocabs, mix, val_rows, ctx.seed, "val", dev) \
        if val_rows else None
    ctx.note(f"drew {n} training and {val_rows} validation rows")

    lay = common.layout(d)
    resolve_table_container(cfg, lay, device=dev)
    model = get_model(mc.model_name, lay, cfg, device=dev,
                      generator=gen.generator(ctx.seed, "weights", dev))
    dense = common.draw_dense(d, ctx.seed, dev)
    common.load_into(model, d, dense, ctx.seed)
    tr = Trainer(model, seed=ctx.seed, device=dev).compile(
        optimizer=oc.optimizer, loss=oc.loss, metrics=oc.metrics)
    ctx.note("built the trainer with the drawn weights")
    fit_kw = dict(batch_size=batch, validation_data=val, verbose=0,
                  shuffle="block" if tc.extra.get("shuffle_mode") == "block" else True)
    step_kw = dict(fit_kw, validation_data=None)  # validation moves no parameter

    # the first steps, on rows no other step has: step 1 alone (its state
    # holds its gradient), then steps 2 and 3 in one fit, the third a replay
    touched = common.unique_rows([common.fused_ids(x, d, 0, CHECKED_STEPS * batch).to(dev)])
    losses, states = [], []
    for lo, hi, kw in ((0, batch, step_kw), (batch, CHECKED_STEPS * batch, fit_kw)):
        tr.fit(common.column_slice(x, lo, hi), y[lo:hi], epochs=1, **kw)
        losses.append(tr.history[-1]["loss"] * batch)
        states.append(common.program_state(tr, d, touched))
    untouched = common.untouched_changed(model, d, ctx.seed, touched)
    ctx.note(f"ran the first {CHECKED_STEPS} steps and read their state")
    return SimpleNamespace(tr=tr, x=x, y=y, val=val, n=n, batch=batch, fit_kw=fit_kw,
                           dense=dense, touched=touched, losses=losses,
                           states=states, untouched=untouched)


def fit_batches(seed: int, n: int, batch: int, shuffle) -> List[np.ndarray]:
    """The rows of each step of a one-epoch staged fit over ``n`` rows (a
    multiple of ``batch``), as ``Trainer.fit`` documents its draws from
    ``np.random.default_rng(seed)``: ``"block"`` permutes the rows once
    and then the order of the batches, ``True`` permutes the rows."""
    rng = np.random.default_rng(seed)
    rows = rng.permutation(n)
    order = rng.permutation(n // batch) if shuffle == "block" else range(n // batch)
    return [rows[b * batch:(b + 1) * batch] for b in order]


def run(ctx) -> Dict:
    d, dev = ctx.dims, ctx.device
    p = prelude(ctx)
    tr, x, y, n, batch = p.tr, p.x, p.y, p.n, p.batch

    epochs = max(1, round(ctx.seconds / float(ctx.mix["epoch_seconds"])))
    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()
    common.settle()
    setup_s = time.perf_counter() - ctx.t0
    with tracing.profiled(ctx.trace) as box:
        _sync(dev)
        with tracing.window():
            clock = time.perf_counter()
            tr.fit(x, y, epochs=epochs, **p.fit_kw)
            _sync(dev)
            wall = time.perf_counter() - clock
    steps = epochs * (n // batch)
    rate = epochs * n / wall
    device = common.device_info(dev, ctx.chips)
    timing = [dict(t) for t in tr.fit_timing]
    p.tr = tr = None
    common.free(dev)

    sums = {k: sum(t.get(k, 0.0) for t in timing) for k in ("prep_s", "issue_s", "sync_s")}
    ctx.note(f"window of {epochs} epochs {wall:.3f} s (fit_timing sums: "
             + ", ".join(f"{k} {v:.3f}" for k, v in sums.items()) + "); program state freed")
    numbers = check(ctx, p)
    ctx.note("reference compared")
    out = dict(e2e={"setup_s": setup_s, **{name: rate for name in RATES}},
               attempted=steps, failed=0, numbers=numbers, device=device, trace=box["trace"])
    if box["trace"] is not None:
        out["layer_ctx"] = SimpleNamespace(
            trace=box["trace"], steps=steps, examples=epochs * n, rate=rate, fit_timing=timing,
            train_flops_per_example=arith.train_flops_per_example(d),
            ops=_window_ops(d, x, p.val, batch, n, epochs, ctx.seed))
    return out


def reference(ctx, p, tf32: bool = False, fault=None):
    """The reference over the first steps from the weights and rows the
    program had: (losses, step 1's gradient, the change) by leaf."""
    d, dev = ctx.dims, ctx.device
    table0 = common.table_rows(d, ctx.seed, dev, p.touched)
    rows = [np.arange(p.batch)] + [p.batch + r for r in fit_batches(
        ctx.seed, (CHECKED_STEPS - 1) * p.batch, p.batch, p.fit_kw["shuffle"])]
    batches = []
    for r in rows:
        part = {c: v[r] for c, v in p.x.items()}
        batches.append((torch.searchsorted(p.touched, common.fused_ids(part, d, 0, p.batch).to(dev)),
                        common.dense_block(part, d, 0, p.batch).to(dev),
                        torch.from_numpy(p.y[r]).to(dev)))
    ref = run_steps(d, p.dense, p.touched, table0, batches, tf32=tf32, fault=fault)
    change = {k: ref.params[k] - p.dense[k] for k in p.dense}
    change[TABLE] = ref.params[TABLE] - table0
    # each fit's loss as the program logs it: the mean over its steps
    return [ref.losses[0], sum(ref.losses[1:]) / (CHECKED_STEPS - 1)], ref.grads, change


def program(ctx, p):
    """What the program's first steps left: (losses, step 1's gradient from
    its Adam state, the change), in the reference's form."""
    table0 = common.table_rows(ctx.dims, ctx.seed, ctx.device, p.touched)
    s1, s3 = p.states
    grads = {k: s1[k + ".mu"] / (1.0 - B1) for k in p.dense}
    grads[TABLE] = s1[TABLE + ".mu"] / (1.0 - B1)
    change = {k: s3[k] - p.dense[k] for k in p.dense}
    change[TABLE] = s3[TABLE] - table0
    return p.losses, grads, change


def check(ctx, p) -> Dict[str, float]:
    """The numbers that compare the program's first steps with the
    reference's, and the table entries the steps should not have moved."""
    numbers = training_numbers(*_pairs(program(ctx, p), reference(ctx, p)))
    numbers["untouched_changed"] = float(p.untouched)
    return numbers


def _pairs(got, ref):
    return got[0], ref[0], got[1], ref[1], got[2], ref[2]


def _mean_distinct(ids: np.ndarray, batch: int, rng: np.random.Generator) -> float:
    """Mean distinct logical rows of a batch of ``ids`` [n, features] under a
    random partition into batches (the program draws its own; the mean is
    the same)."""
    order = rng.permutation(len(ids))
    counts = [len(np.unique(ids[order[s:s + batch]])) for s in range(0, len(ids), batch)]
    return float(np.mean(counts))


def _window_ops(d, x, val, batch, n, epochs, seed):
    """The logical operations the window's fit ran, with their shapes."""
    rng = np.random.default_rng(gen.stream_seed(seed, "order"))
    ids = common.fused_ids(x, d, 0, n).numpy()
    per_step = arith.step_ops(d, batch, _mean_distinct(ids, batch, rng))
    ops = [(name, b * epochs * (n // batch), f * epochs * (n // batch)) for name, b, f in per_step]
    if val is not None:
        vx = val[0]
        m = len(next(iter(vx.values())))
        vids = common.fused_ids(vx, d, 0, m).numpy()
        val_batches = -(-m // batch)
        per_eval = arith.forward_ops(d, batch, _mean_distinct(vids, batch, rng))
        ops += [(name, b * epochs * val_batches, f * epochs * val_batches)
                for name, b, f in per_eval]
    return ops
