"""The one epoch loop of ``Trainer.fit`` and the stacked seed suite (JAX:
trainer.py:1523-1747, multi_seed.py:274-400), a solo fit being the case of
one member: each epoch its data path's ``staging.EpochSource`` draws and
issues the steps, then the loop reads every member's loss, train metrics and
validation and keeps each one's early stopping and best snapshot."""

from __future__ import annotations

import time
from typing import Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from ..utils.spans import span, timed
from . import device_metrics, staging
from .graphs import StepGraphs
from .metrics import COUNTED, regime_eval, regime_from_counts


class FitRun(NamedTuple):
    """What a fit's ``start`` hands the loop: its epoch source and graphs,
    one history a member, and ``state()``, the members' variables.
    ``stacked``: they carry a member axis, and the best snapshot starts as the
    first epoch's state and takes each improved member's slice
    (multi_seed.py:370-379); else it is a new copy at each new best.
    ``forward``: the validation forward over the member axis; ``progress``:
    where the fit starts, as ``Trainer._progress`` records it."""

    source: staging.EpochSource
    graphs: StepGraphs
    histories: List[List[Dict[str, float]]]
    state: Callable[[], Dict[str, torch.Tensor]]
    stacked: bool = False
    labels: Optional[List[str]] = None
    forward: Optional[Callable] = None
    progress: tuple = (0, 0.0, 0, None)
    max_steps: int = 0
    curves: bool = False


def fit(tr, owner, x, y, batch_size: int, epochs: int, validation_split: float,
        validation_data, verbose: int, epoch_callback, start) -> Optional[Dict]:
    """Fit ``owner`` (``tr`` or a suite on it) with ``start(ids, dense, y,
    dmask, val)``'s ``FitRun``; returns the best snapshot."""
    run = None
    try:
        with span("mmlrec.fit.stage"):
            with span("mmlrec.fit.pack"):  # the validation set: validation_data, or the tail
                ids, dense = tr.pack_inputs(x)
                y, dmask, val = tr._prepare_y(y), tr._domain_mask_from(x), None
                if validation_data is not None:
                    vx, vy = validation_data[:2]
                    val = (*tr.pack_inputs(vx), tr._prepare_y(vy), tr._domain_mask_from(vx))
                elif validation_split and 0.0 < validation_split < 1.0:
                    split = int(len(ids) * (1.0 - validation_split))
                    val = (ids[split:], dense[split:], y[split:],
                           dmask[split:] if dmask is not None else None)
                    ids, dense, y = ids[:split], dense[:split], y[:split]
                    dmask = dmask[:split] if dmask is not None else None
            run = start(ids, dense, y, dmask, val)
        owner.fit_timing = []
        return _epochs(tr, owner, run, val, batch_size, epochs, verbose, epoch_callback)
    finally:
        if run is not None:
            run.source.close()
            replays = run.graphs.replays
            owner.graph_replays = {
                "train": sum(v for k, v in replays.items() if k[0] != "eval"),
                "eval": sum(v for k, v in replays.items() if k[0] == "eval")}


def _epochs(tr, owner, run: FitRun, val, batch_size, epochs, verbose, epoch_callback):
    source, graphs, histories = run.source, run.graphs, run.histories
    S = len(histories)
    early_stop = tr.cfg.optim_config.early_stop
    first, auc0, count0, best = run.progress
    best_auc, stop_count = np.full(S, auc0, np.float64), np.full(S, count0, np.int64)
    stopped = np.zeros(S, bool)
    total_steps = examples_seen = 0
    train_time = 0.0
    program = val_metric = None
    for epoch in range(first, epochs):
        t0 = time.time()
        if tr._gate_warmup_epochs:
            tr._gate_warmup_active = epoch < tr._gate_warmup_epochs
            tr.model.set_gate_noise_off(tr._gate_warmup_active)
        steps = source.steps
        if run.max_steps:
            steps = min(steps, run.max_steps - total_steps)
            if steps <= 0:
                break
        timing = dict.fromkeys(staging.TIMING_KEYS, 0.0)
        owner.fit_timing.append(timing)
        captured = (graphs.captures, graphs.capture_s)
        with timed(timing, "prep_s", "mmlrec.fit.prep_wait"):
            source.prepare(epoch, steps, timing)
        with timed(timing, "issue_s", "mmlrec.fit.issue"):
            events = ([torch.cuda.Event(enable_timing=True) for _ in range(2)]
                      if tr.device.type == "cuda" else None)
            if events:
                events[0].record()
            out = source.run(steps, timing)
            if events:
                events[1].record()
            if out.probs is not None and tr._shard() is not None:
                out = out._replace(probs=tr._gather_batches(out.probs))
            # the train metrics' counts follow the steps on the device
            stats = train_counts(tr, out, run.curves) if tr.metric_fns else None
        total_steps += steps
        examples_seen += out.take
        with timed(timing, "sync_s", "mmlrec.fit.sync"):  # the epoch's first sync
            # one copy: float64 holds the counts exactly (EXACT_ROWS)
            read = torch.stack([out.loss[:, m].sum() for m in range(S)]).double()
            values = (read if stats is None else torch.cat([read, stats.double()])).tolist()
        if events:
            timing["steps_device_s"] = events[0].elapsed_time(events[1]) / 1e3
        epoch_time = time.time() - t0
        train_time += epoch_time
        logs = [{"loss": loss / max(source.n, 1), "epoch_s": epoch_time} for loss in values[:S]]
        if tr.metric_fns:
            with timed(timing, "metrics_s", "mmlrec.fit.train_metrics"):
                _train_metrics(tr, out, source.y, None if stats is None else values[S:], logs,
                               run.curves)
            timing["metrics_device"] = float(stats is not None)
        was_stopped = stopped.copy()
        if val is not None:
            with timed(timing, "val_s", "mmlrec.fit.validate"):
                if program is None:  # the validation set goes to the device once
                    ev = staging.prepare_eval_tensors(tr, val[0], val[1], val[3], batch_size)
                    program = _EvalProgram(tr, ev, None, graphs if tr._capturable else None,
                                           forward=run.forward)
                    if tr._use_device_eval():
                        val_metric = staging.prepare_metric_tensors(
                            tr, val[2], ev.ids.shape[0] * batch_size)
                probs = program.members()
                improved = np.zeros(S, bool)
                for m in range(S):
                    if val_metric is not None:
                        res = {k: float(v) for k, v in device_metrics.regime_metrics(
                            tr.metric_fns, val_metric[0], probs[m], val_metric[1],
                            tr.task_name, tr.num_domains).items()}
                    else:
                        preds = probs[m].cpu().numpy()[:len(val[0])].astype(np.float64)
                        res = regime_eval(tr.metric_fns, val[2], preds, tr.task_name,
                                          tr.num_domains)
                    logs[m].update({f"val_{k}": v for k, v in res.items()})
                    auc = res.get("auc", 0.0)
                    if was_stopped[m]:  # a member that has stopped keeps its best
                        continue
                    if auc > best_auc[m]:
                        best_auc[m], stop_count[m], improved[m] = auc, 0, True
                    else:
                        stop_count[m] += 1
                best = _snapshot(run, best, improved)
                stopped |= stop_count >= early_stop
        timing["captures"] = graphs.captures - captured[0]
        timing["capture_s"] = graphs.capture_s - captured[1]
        for m, history in enumerate(histories):
            # a member that stopped in an EARLIER epoch is done (a solo fit
            # would have broken out); the epoch where its patience runs out
            # is still logged, as the solo loop logs it
            if not was_stopped[m]:
                history.append(logs[m])
        if not run.stacked:  # what save_training_state records
            owner._progress = (epoch + 1, float(best_auc[0]), int(stop_count[0]), best)
        owner.best_variables = best
        if epoch_callback is not None:
            epoch_callback(epoch, owner)
        if verbose:
            print(f"Epoch {epoch + 1}/{epochs} - {epoch_time:.1f}s - "
                  + _verbose_line(logs, run.labels, val is not None))
        if val is not None and stopped.all():
            break
        if run.max_steps and total_steps >= run.max_steps:
            break

    if train_time > 0:
        # steady state: the first epoch (warm-up) is left out when more ran
        epoch_times = [h["epoch_s"] for h in histories[0]]
        warm_time = sum(epoch_times[1:])
        if len(epoch_times) > 1 and warm_time > 0:
            per_epoch = examples_seen / len(epoch_times)
            owner.throughput_examples_per_s = per_epoch * (len(epoch_times) - 1) / warm_time
        else:
            owner.throughput_examples_per_s = examples_seen / train_time
    owner.best_variables = best
    return best


def train_counts(tr, out: staging.EpochResult, curves: bool) -> Optional[torch.Tensor]:
    """Each member's train AUC and accuracy as exact counts on the device
    (``exact_train_stats`` over ``out.counted``) where they are bitwise the
    host's: counted metrics only, no batch curves, ``counts_exactly``."""
    if out.counted is None or curves or not set(tr.metric_fns) <= set(COUNTED):
        return None
    steps, S, B = out.probs.shape[:3]
    labels, members = out.counted
    probs = [tr._selected(out.probs[:, m].reshape(steps * B, -1)) for m in range(S)]
    if not device_metrics.counts_exactly(tr.task_name, tr.num_domains, probs[0].shape[1],
                                         labels.shape[1], steps * B):
        return None
    return torch.cat([device_metrics.exact_train_stats(
        labels.index_select(0, rows), p, weights, tr.task_name, tr.num_domains)
        for p, (rows, weights) in zip(probs, members)])


def _train_metrics(tr, out: staging.EpochResult, y, counts, logs, curves: bool) -> None:
    """Each member's train metrics: from ``train_counts``' counts, else over
    its probabilities on the host, with each batch's under ``curves``."""
    if counts is not None:
        per = len(counts) // len(logs)
        for m, member_logs in enumerate(logs):
            member_logs.update(regime_from_counts(tr.metric_fns, counts[m * per:(m + 1) * per]))
        return
    probs = out.probs.movedim(1, 0)
    probs = tr._selected(probs.reshape(probs.shape[0], -1, probs.shape[-1])).cpu().numpy()
    for m, (select, rows) in enumerate(out.rows):
        p, ym = probs[m][select], y[rows]
        logs[m].update(regime_eval(tr.metric_fns, ym, p, tr.task_name, tr.num_domains))
        if curves:
            logs[m].update(tr._batch_curve(p, ym, out.spans))


def _snapshot(run: FitRun, best, improved: np.ndarray):
    """The steps update the state in place: the snapshot owns its copy."""
    if run.stacked and best is not None:
        current = run.state()
        for m in np.flatnonzero(improved):
            for k, v in current.items():
                best[k][m].copy_(v[m].detach())
    elif run.stacked or improved.any():
        best = {k: v.detach().clone() for k, v in run.state().items()}
    return best


def _verbose_line(logs, labels, validated: bool) -> str:
    if labels is None:
        return " - ".join(f"{k}: {v:.4f}" for k, v in logs[0].items() if k != "epoch_s")
    return " | ".join(
        f"{label}: loss {member['loss']:.4f}"
        + (f" val_auc {member.get('val_auc', float('nan')):.4f}" if validated else "")
        for label, member in zip(labels, logs))


class _EvalProgram:
    """The forward over a fixed set of staged eval batches (``_scanned_probs``,
    trainer.py:1334-1350): a device counter picks the batch, the forward
    writes its probabilities into ``out`` at it, so one captured graph is
    replayed per batch on the card (eagerly without ``graphs``, in debug
    mode and on the CPU).  A fit keeps one for its validation set and
    replays it every epoch.  ``forward(ids, dense, dmask)`` stands in for
    the model's (a stacked suite's forward under vmap: ``out`` is then
    ``[steps, S, B, heads]``)."""

    def __init__(self, trainer, ev, best, graphs: Optional[StepGraphs], forward=None):
        self.trainer, self.ev, self.best, self.graphs = trainer, ev, best, graphs
        self.forward = forward
        self.counter = torch.zeros(1, dtype=torch.int64, device=trainer.device)
        self.out: Optional[torch.Tensor] = None
        self.key = ("eval", id(self))

    def body(self) -> None:
        ev, s = self.ev, self.counter
        args = tuple(None if a is None else a.index_select(0, s)[0]
                     for a in (ev.ids, ev.dense, ev.dmask))
        model = self.trainer.model
        with torch.no_grad():
            if self.forward is not None:
                p = self.forward(*args)
            else:
                p = (model(*args) if self.best is None
                     else torch.func.functional_call(model, self.best, args))
        if self.out is None:  # the first call is eager: the shape is known there
            self.out = torch.zeros((ev.ids.shape[0],) + tuple(p.shape), device=p.device)
        self.out.index_copy_(0, s, p[None])
        s.add_(1)

    def members(self) -> torch.Tensor:
        """Every batch's forward: [S, steps * batch, heads] selected
        probabilities on the device, S = 1 for the model's forward; under a
        mesh that split the batches, every rank's in the global order."""
        self.trainer.model.eval()
        self.counter.zero_()
        for _ in range(self.ev.ids.shape[0]):
            if self.trainer.debug or self.graphs is None:
                self.body()
            else:
                self.graphs.run(self.key, self.body)
        out = self.out
        if self.ev.split:
            out = self.trainer._gather_batches(out)
        if self.forward is None:
            out = out.unsqueeze(1)
        out = out.movedim(1, 0)
        return self.trainer._selected(out.reshape(out.shape[0], -1, out.shape[-1]))

    def run(self) -> torch.Tensor:
        """[steps * batch, heads]: the one member's ``members``."""
        return self.members()[0]
