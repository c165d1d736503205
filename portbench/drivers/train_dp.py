"""The data-parallel training driver: ``Trainer.fit`` under a mesh of
``data = chips`` ranks, one process a rank, each rank a card of its own
over NCCL (gloo on the CPU), started by the port's own launcher
(``mmlrec_tpu_torch/parallel/multihost.py::spawn_ranks``), as the CLI's
``--data_parallel`` starts its ranks.

Every rank draws the same rows and weights from the seed and builds the
same trainer on the mesh; the fit splits each global batch of the
configuration's ``train_batch_size`` rows over the ranks, all-reduces the
gradients and gathers the validation probabilities.  Set-up drives the
trainer through its first three steps as ``drivers/train.py`` does (step 1
alone, then steps 2 and 3 in one fit, the third a replay); the window is
one fit over whole epochs, timed on rank 0 between two barriers of all
ranks, and the rate is the global examples over that time.  Rank 0 alone
is traced, reads its state after the first steps and, once the program is
freed, compares them with the reference over the global batches in the
order the fit takes them (``train.reference``).  ``ranks_apart`` counts
the ranks whose dense parameters after the window differ from rank 0's
in any bit.

``python3 -m portbench.drivers.train_dp --workload <name> --seeds 12
--controls 3`` gives the readings the limits are set from, as
``portbench.calibrate`` does for the one-process cells: the program's on
every seed; on the first ``--controls`` the control (the reference in
TF32 in the program's place), the half-batch fault and the program with
one rank's gradient dropped from the reduction.  ``--cell <file>`` takes
a cell that ``BENCHMARK.json`` does not list yet from its file
(``with_cell``), as ``ae.train.dp4`` is held in
``tests/fixtures/ae.train.dp4.json``.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from .. import trace as tracing
from ..arith import ops as arith
from ..reference.compare import later_loss_gap, training_numbers, worst_leaves
from ..traffic import gen
from . import common, train

#: the rank whose gradient the calibration's fault drops from the reduction
DROPPED_RANK = 1


def _device(ctx, rank: int) -> str:
    return f"cuda:{rank}" if torch.device(ctx.device).type == "cuda" else "cpu"


@contextlib.contextmanager
def _drop_rank_gradient():
    """The fault, while the block runs: rank ``DROPPED_RANK`` sends zeros to
    the gradients' all-reduce, so the step takes the other ranks' rows
    alone."""
    from mmlrec_tpu_torch.train.trainer import Trainer

    reduce = Trainer._reduce_grads

    def dropped(self, grads, loss):
        if self._dp.rank == DROPPED_RANK:
            grads = {k: torch.zeros_like(v) for k, v in grads.items()}
        return reduce(self, grads, loss)

    Trainer._reduce_grads = dropped
    try:
        yield
    finally:
        Trainer._reduce_grads = reduce


def prelude(ctx, mesh) -> SimpleNamespace:
    """``train.prelude`` on a rank of ``mesh``: the rows, the weights, the
    trainer on the mesh and its first three steps, with rank 0's state."""
    from mmlrec_tpu_torch.models import get_model
    from mmlrec_tpu_torch.train import Trainer, resolve_table_container

    d, spec, mix, dev = ctx.dims, ctx.spec, ctx.mix, ctx.device
    cfg = common.experiment_config(spec)
    tc, oc, mc = cfg.training_config, cfg.optim_config, cfg.model_config
    batch = int(tc.train_batch_size)
    n = int(mix["train_batches"]) * batch
    val_rows = int(mix["val_rows"])
    x, y = gen.rows(spec["experiment"], d.vocabs, mix, n, ctx.seed, "train", dev)
    val = gen.rows(spec["experiment"], d.vocabs, mix, val_rows, ctx.seed, "val", dev) \
        if val_rows else None
    lay = common.layout(d)
    resolve_table_container(cfg, lay, device=dev, mesh=mesh)
    model = get_model(mc.model_name, lay, cfg, device=dev,
                      generator=gen.generator(ctx.seed, "weights", dev))
    dense = common.draw_dense(d, ctx.seed, dev)
    common.load_into(model, d, dense, ctx.seed)
    tr = Trainer(model, seed=ctx.seed, mesh=mesh, device=dev).compile(
        optimizer=oc.optimizer, loss=oc.loss, metrics=oc.metrics)
    fit_kw = dict(batch_size=batch, validation_data=val, verbose=0,
                  shuffle="block" if tc.extra.get("shuffle_mode") == "block" else True)
    step_kw = dict(fit_kw, validation_data=None)

    touched = common.unique_rows([common.fused_ids(x, d, 0, train.CHECKED_STEPS * batch).to(dev)])
    losses, states = [], []
    for lo, hi, kw in ((0, batch, step_kw), (batch, train.CHECKED_STEPS * batch, fit_kw)):
        tr.fit(common.column_slice(x, lo, hi), y[lo:hi], epochs=1, **kw)
        losses.append(tr.history[-1]["loss"] * batch)
        states.append(common.program_state(tr, d, touched))
    untouched = common.untouched_changed(model, d, ctx.seed, touched)
    ctx.note(f"rank {dist.get_rank()}: ran the first {train.CHECKED_STEPS} steps")
    return SimpleNamespace(tr=tr, x=x, y=y, val=val, n=n, batch=batch, fit_kw=fit_kw,
                           dense=dense, touched=touched, losses=losses,
                           states=states, untouched=untouched)


def _ranks_apart(tr) -> int:
    """Ranks whose dense parameters differ from rank 0's in any bit
    (counted on rank 0; 0 elsewhere)."""
    flat = torch.cat([p.detach().reshape(-1) for n, p in tr.model.named_parameters()
                      if n != "embeddings.fused.table"])
    every = [torch.empty_like(flat) for _ in range(dist.get_world_size())]
    dist.all_gather(every, flat)
    return sum(int(not torch.equal(every[0], other)) for other in every[1:])


def _peak_bytes(dev: str) -> int:
    """The largest ``max_memory_allocated`` of the ranks' cards."""
    mine = torch.tensor([torch.cuda.max_memory_allocated(dev) if dev != "cpu" else 0],
                        dtype=torch.int64, device=dev)
    every = [torch.empty_like(mine) for _ in range(dist.get_world_size())]
    dist.all_gather(every, mine)
    return max(int(t) for t in every)


def _rank_ops(d, x, val, batch: int, world: int, n: int, epochs: int, seed: int):
    """The logical operations rank 0 ran in the window: each step's at its
    ``batch / world`` rows, each validation batch's at its share."""
    rng = np.random.default_rng(gen.stream_seed(seed, "order"))
    local = batch // world
    steps = epochs * (n // batch)
    ids = common.fused_ids(x, d, 0, n).numpy()
    ops = [(name, b * steps, f * steps)
           for name, b, f in arith.step_ops(d, local, train._mean_distinct(ids, local, rng))]
    if val is not None:
        m = len(next(iter(val[0].values())))
        vids = common.fused_ids(val[0], d, 0, m).numpy()
        evals = epochs * -(-m // batch)
        ops += [(name, b * evals, f * evals)
                for name, b, f in arith.forward_ops(d, local, train._mean_distinct(vids, local, rng))]
    return ops


def _window(ctx, p, rank: int, world: int) -> Dict:
    """The timed fit on every rank; rank 0's outcome (None elsewhere)."""
    tr, dev = p.tr, ctx.device
    epochs = max(1, round(ctx.seconds / float(ctx.mix["epoch_seconds"])))
    if dev != "cpu":
        torch.cuda.reset_peak_memory_stats(dev)
    common.settle()
    with tracing.profiled(ctx.trace and rank == 0) as box:
        dist.barrier()
        train._sync(dev)
        setup_s = time.perf_counter() - ctx.t0
        with tracing.window():
            clock = time.perf_counter()
            tr.fit(p.x, p.y, epochs=epochs, **p.fit_kw)
            train._sync(dev)
            dist.barrier()
            wall = time.perf_counter() - clock
    apart = _ranks_apart(tr)
    peak = _peak_bytes(dev)
    timing = [dict(t) for t in tr.fit_timing]
    if rank:
        return None
    steps = epochs * (p.n // p.batch)
    rate = epochs * p.n / wall
    ctx.note(f"window of {epochs} epochs {wall:.3f} s on {world} ranks")
    out = dict(setup_s=setup_s, rate=rate, steps=steps, apart=apart, trace=box["trace"],
               device=common.device_info("cpu", world) if dev == "cpu" else dict(
                   platform="gpu", kind=torch.cuda.get_device_name(dev), count=world,
                   memory_peak_bytes=peak))
    if box["trace"] is not None:
        out["layer_ctx"] = SimpleNamespace(
            trace=box["trace"], steps=steps, examples=epochs * p.n, fit_timing=timing,
            # each card's share of its own peak: the global rate over the ranks
            rate=rate / world,
            train_flops_per_example=arith.train_flops_per_example(ctx.dims),
            ops=_rank_ops(ctx.dims, p.x, p.val, p.batch, world, p.n, epochs, ctx.seed))
    return out


def _numbers(ctx, p, controls: bool) -> List[Dict]:
    """Rank 0's readings against the reference: the program's, and with
    ``controls`` the control's and the half-batch fault's."""
    prog, ref = train.program(ctx, p), train.reference(ctx, p)
    rows = [{"side": "program", **training_numbers(*train._pairs(prog, ref)),
             "untouched_changed": float(p.untouched),
             "later_loss_gap": later_loss_gap(prog[0], ref[0]),
             "leaves": worst_leaves(prog[1], ref[1], prog[2], ref[2])}]
    for side, kw in ((("control", dict(tf32=True)), ("half_batch", dict(fault="half")))
                     if controls else ()):
        got = train.reference(ctx, p, **kw)
        rows.append({"side": side, **training_numbers(*train._pairs(got, ref)),
                     "later_loss_gap": later_loss_gap(got[0], ref[0]),
                     "leaves": worst_leaves(got[1], ref[1], got[2], ref[2])})
    return rows


def _job(ctx, mesh, rank: int, world: int, mode: str):
    """One job on a rank: ``"run"``, the first steps, the window and the
    numbers ``correct`` compares; ``"steps"`` / ``"controls"``, the first
    steps and their readings (with the control's and the half-batch
    fault's).  Rank 0's outcome, None elsewhere."""
    p = prelude(ctx, mesh)
    out = _window(ctx, p, rank, world) if mode == "run" else None
    p.tr = None
    common.free(ctx.device)
    dist.barrier()
    if rank:
        return None
    rows = _numbers(ctx, p, mode == "controls")
    if mode != "run":
        return rows
    out["numbers"] = {k: rows[0][k] for k in ("loss_gap", "grad_norm_gap", "change_norm_gap",
                                              "untouched_changed")}
    out["numbers"]["ranks_apart"] = float(out.pop("apart"))
    return out


def _rank_jobs(payload, rank: int, world: int) -> Optional[List]:
    """One rank: build the mesh and run each job ``(mode, seed, fault)`` in
    turn; rank 0's outcomes, None elsewhere."""
    from mmlrec_tpu_torch.parallel import create_mesh

    ctx, jobs = payload
    ctx.device = dev = _device(ctx, rank)
    mesh = create_mesh(data=world, device="cpu" if dev == "cpu" else "cuda")
    outs = []
    for mode, seed, fault in jobs:
        ctx.seed = seed
        with _drop_rank_gradient() if fault else contextlib.nullcontext():
            outs.append(_job(ctx, mesh, rank, world, mode))
    return None if rank else outs


def spawn(ctx, jobs):
    """Start ``ctx.chips`` ranks, run ``jobs`` on them and wait for them;
    rank 0's outcomes, or RuntimeError with the first failure a rank
    reports."""
    from mmlrec_tpu_torch.parallel.multihost import spawn_ranks

    world = int(ctx.chips)
    cuda = torch.device(ctx.device).type == "cuda"
    if cuda and world > torch.cuda.device_count():
        raise ValueError(f"{world} ranks need {world} cards, {torch.cuda.device_count()} found")
    return spawn_ranks(_rank_jobs, (ctx, jobs), world, cuda, f"{world} ranks")


def run(ctx, fault: bool = False) -> Dict:
    """One run of the cell; ``fault``: with one rank's gradient dropped."""
    ctx.note = _Note(ctx.t0)
    w = spawn(ctx, [("run", ctx.seed, fault)])[0]
    out = dict(e2e={"setup_s": w["setup_s"], **{name: w["rate"] for name in train.RATES}},
               attempted=w["steps"], failed=0, numbers=w["numbers"], device=w["device"],
               trace=w["trace"])
    if "layer_ctx" in w:
        out["layer_ctx"] = w["layer_ctx"]
    return out


class _Note:
    """``run.note`` for a rank: a line on standard error with the seconds
    since the harness's process began (the ranks share its clock)."""

    def __init__(self, t0: float):
        self.t0 = t0

    def __call__(self, message: str) -> None:
        print(f"[{time.perf_counter() - self.t0:8.2f} s] {message}", file=sys.stderr, flush=True)


def with_cell(path, bench: Optional[Dict] = None) -> Dict:
    """A copy of the benchmark (``bench``, else ``BENCHMARK.json``) with
    the cell of the file at ``path`` added: its ``workload`` entry, its name
    appended to the ``workloads`` of each metric named in ``joins``, and
    the per-layer metrics of ``adds``."""
    from ..run import benchmark

    bench = copy.deepcopy(bench or benchmark())
    cell = json.loads(Path(path).read_text())
    name = cell["workload"]["name"]
    bench["workloads"].append(cell["workload"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] in cell["joins"]:
            m["workloads"].append(name)
    bench["per_layer"] += cell["adds"]
    return bench


def cell_ctx(bench: Dict, workload: str, seed: int, seconds: float, device: str,
             scale: Optional[Dict] = None) -> SimpleNamespace:
    """The context ``run.run_cell`` gives a driver, for a cell of ``bench``."""
    from ..reference.dims import dims
    from ..run import cell_files, scaled

    cell, spec, mix, _, _ = cell_files(bench, workload)
    spec, mix = scaled(spec, mix, scale)
    t0 = time.perf_counter()
    return SimpleNamespace(seed=seed, seconds=seconds, trace=False, device=device,
                           chips=int(cell["chips"]), spec=spec, mix=mix, dims=dims(spec),
                           t0=t0, note=_Note(t0))


def readings(workload: str, seeds: List[int], controls: int, device: str = "cuda",
             scale: Optional[Dict] = None, bench: Optional[Dict] = None) -> List[Dict]:
    """The calibration's readings of a data-parallel cell of ``bench``
    (``BENCHMARK.json`` by default), one row a reading, from one start of
    the ranks."""
    from ..run import benchmark

    ctx = cell_ctx(bench or benchmark(), workload, seeds[0], 0.0, device, scale)
    jobs = [("controls" if i < controls else "steps", seed, False)
            for i, seed in enumerate(seeds)]
    jobs += [("steps", seed, True) for seed in seeds[:controls]]
    outs = spawn(ctx, jobs)
    rows = []
    for (_, seed, fault), got in zip(jobs, outs):
        for row in got[:1] if fault else got:
            row = dict(row, seed=seed, side="dropped_rank" if fault else row["side"])
            print(json.dumps(row), flush=True)
            rows.append(row)
    return rows


def main(argv=None) -> int:
    from ..calibrate import summary

    p = argparse.ArgumentParser(prog="python3 -m portbench.drivers.train_dp")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--controls", type=int, default=3)
    p.add_argument("--first-seed", type=int, default=3_000_000_017)
    p.add_argument("--cell", default=None,
                   help="the file of a cell BENCHMARK.json does not list yet (with_cell)")
    args = p.parse_args(argv)
    seeds = [args.first_seed + 7919 * i for i in range(args.seeds)]
    rows = readings(args.workload, seeds, args.controls,
                    bench=with_cell(args.cell) if args.cell else None)
    print(json.dumps({"summary": summary(rows), "workload": args.workload,
                      "card": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
