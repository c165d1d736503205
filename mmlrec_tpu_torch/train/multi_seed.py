"""The seed suite (the port of ``mmlrec_tpu/train/multi_seed.py``): every
seed of the reference's seed loop (reference main.py:85-89) trained by one
object, each member's numerics those of a solo ``Trainer`` run of its seed.

**Stacked mode** (the dense-table fit): the S members' parameters,
BatchNorm statistics, flat optimizer state, GradNorm state and draw
generators carry a leading ``[S]`` axis, the staged dataset is shared, and
one step advances every member (JAX: multi_seed.py:95-155).  The step is the
trainer's own loss under ``torch.func.functional_call`` and
``torch.func.vmap`` over the members, one ``torch.autograd.grad`` of the
members' summed losses (each member's gradient is its own loss's), and the
flat optimizer over ``[S, N]`` buffers; it is captured as one CUDA graph
and replayed ``scan_steps`` at a time, as the solo step is
(``staging.drive_steps``).  The hand-written forward kernels take the stack
in ONE launch each: their ``autograd.Function``'s ``vmap`` rule folds the
members into the kernel's own axes (``ops/kernels.py``).

* Member s draws its initial weights as ``get_model`` draws them from
  ``make_generator(seeds[s], device)`` (``members[s]``, loadable before
  ``fit``: ``convert.load_jax_variables``), its epoch orders from
  ``np.random.default_rng(seeds[s])`` and its dropout masks and stochastic
  gates from its own generator, reseeded every step from its own master
  (``layers.MemberGenerators``), all as a solo ``Trainer(seed)`` fit does.
* Validation replays one captured stacked forward per batch; each member
  keeps its own early stopping (a member that has stopped logs no more
  epochs, multi_seed.py:382-387) and its own best snapshot.
* The stacked products (``bmm`` for ``mm``) and reductions may round
  otherwise than a solo run's: members equal solo runs within f32 rounding,
  not bitwise.

**Sequential-shared mode** (``two_phase_embedding`` or
``sparse_embedding_update``, 11 of the 13 shipped configs): a stacked
table cannot pay there (multi_seed.py:14-31: S copies of the production
table, and a per-row step whose traffic grows with S), so one ``Trainer``
fits the seeds one after another (``reset_for_seed``).  Each member is
bitwise a solo run.  JAX's reason for this mode was one compile for the
whole suite; here each fit captures its step graphs anew, and the suite
prints what the captures cost per seed (``capture_s``, from each fit's
``fit_timing``).
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..ops.layers import MemberGenerators
from ..utils.spans import span, timed
from . import device_metrics, staging
from .cagrad import cagrad_merge
from .graphs import StepGraphs
from .metrics import regime_eval
from .optimizers import Flat
from .pcgrad import pcgrad_merge
from .trainer import Trainer, _EvalProgram, _grads, _order_masked_row


class SeedSuiteTrainer:
    """The reference's seed loop as one object: ``fit()`` trains every
    seed; ``histories``, ``predict()`` and ``masked_test_metrics_device()``
    are per seed.  ``device=None`` means the card."""

    def __init__(self, model, seeds: Sequence[int] = (0, 2, 4, 8), *, device=None):
        self.seeds = [int(s) for s in seeds]
        self.labels = [f"seed{s}" for s in self.seeds]
        self.row_labels = [str(s) for s in self.seeds]  # result-CSV suffixes
        self.model = model
        extra = model.cfg.model_config.extra
        self.sequential = bool(extra.get("two_phase_embedding")
                               or extra.get("sparse_embedding_update"))
        if not self.sequential:
            # the stacked step materialises the matmul cotangent's one-hot
            # once per member: the embedding's "auto" budget takes the stack
            # width (ops/embedding.py), before any member is drawn
            extra["_grad_budget_div"] = len(self.seeds)
            fused = model.embeddings.fused
            if fused is not None:
                fused.grad_budget_divisor = len(self.seeds)
        #: the shared machinery (packing, loss terms, eval); the one trainer
        #: of the sequential mode
        self.tr = Trainer(model, seed=self.seeds[0], device=device)
        self.device = self.tr.device
        #: each member's initial model (stacked mode)
        self.members = [] if self.sequential else [self._draw(s) for s in self.seeds]
        self.histories: List[List[Dict[str, float]]] = [[] for _ in self.seeds]
        #: stacked {state-dict key: [S, ...]} of the last fit (stacked mode)
        self.variables: Optional[Dict[str, torch.Tensor]] = None
        self.best_variables: Optional[Dict[str, torch.Tensor]] = None
        #: per member, host seconds its fit spent capturing (sequential mode)
        self.capture_s: List[float] = []
        #: per epoch of the last stacked fit, ``Trainer.fit_timing``'s keys
        #: (``staging.TIMING_KEYS``; no metadata: ``meta_s`` is 0), and on
        #: the card the device span of the epoch's steps
        self.fit_timing: List[Dict[str, float]] = []
        self.graph_replays: Dict[str, int] = {"train": 0, "eval": 0}
        self._seq_best: List = []

    def _draw(self, seed: int):
        from ..models import get_model
        from ..utils.seeding import make_generator

        tr = self.tr
        return get_model(tr.model_name, tr.layout, tr.cfg,
                         generator=make_generator(seed, str(self.device)), device=self.device)

    # ------------------------------------------------------------------
    def compile(self, optimizer=None, loss=None, metrics=None):
        self.tr.compile(optimizer, loss, metrics)
        return self

    def _member_optimizer(self):
        """The compiled optimizer over member-stacked ``[S, N]`` flat
        buffers (hook: train/sweep.py gives each member its own
        hyperparameters)."""
        inner = self.tr.tx.inner if isinstance(self.tr.tx, Flat) else self.tr.tx
        return Flat(inner, members=len(self.seeds))

    # ------------------------------------------------------------------
    # sequential-shared mode
    # ------------------------------------------------------------------
    def _fit_one(self, si: int, x, y, batch_size, epochs, validation_data, verbose):
        tr = self.tr
        tr.fit(x, y, batch_size=batch_size, epochs=epochs,
               validation_data=validation_data, verbose=max(verbose - 1, 0))
        self.histories[si] = list(tr.history)
        self._seq_best[si] = tr.best_variables
        self.capture_s[si] = sum(t["capture_s"] for t in tr.fit_timing)
        if verbose:
            last = tr.history[-1] if tr.history else {}
            print(f"{self.labels[si]}: {len(tr.history)} epochs, "
                  f"loss {last.get('loss', float('nan')):.4f}"
                  + (f", val_auc {last['val_auc']:.4f}" if "val_auc" in last else "")
                  + f", its graphs captured in {self.capture_s[si]:.3f} s")

    def _fit_sequential(self, x, y, batch_size, epochs, validation_data, verbose):
        """The seeds one after another on the one trainer, each from
        ``reset_for_seed``: bitwise a solo fit of that seed."""
        S = len(self.seeds)
        self._seq_best, self.capture_s = [None] * S, [0.0] * S
        for si, seed in enumerate(self.seeds):
            self.tr.reset_for_seed(seed)
            self._fit_one(si, x, y, batch_size, epochs, validation_data, verbose)
        self.variables = None
        return self

    # ------------------------------------------------------------------
    # stacked mode
    # ------------------------------------------------------------------
    def _init_state(self):
        """The members' parameters (leaves that take the gradient) and
        persistent buffers stacked, by state-dict key."""
        persistent = set(self.model.state_dict())
        per = [dict(m.named_parameters()) for m in self.members]
        params = {k: torch.stack([p[k].detach() for p in per]).requires_grad_(True)
                  for k, _ in self.model.named_parameters()}
        per = [dict(m.named_buffers()) for m in self.members]
        buffers = {k: torch.stack([b[k] for b in per])
                   for k, _ in self.model.named_buffers() if k in persistent}
        return params, buffers

    def _member_loss(self, weight):
        """One member's (total, probs) on its batch, for vmap."""
        tr = self.tr

        def loss(params, buffers, ids, dense, y, dmask):
            total, _, probs = tr._loss_terms(params, ids, dense, y, dmask, weight,
                                             state={**params, **buffers})
            return total, probs

        return loss

    def _member_task_totals(self, weight):
        """One member's (T task totals, step loss terms, probs) of the
        per-task methods (``Trainer._per_task_totals``), for vmap."""
        tr = self.tr

        def totals(params, buffers, ids, dense, y, dmask):
            task, data_loss, probs = tr._per_task_totals(params, ids, dense, y, dmask, weight,
                                                         state={**params, **buffers})
            return torch.stack(task), data_loss, probs

        return totals

    def _stacked_step(self, ids, dense, y, dmask, weight):
        """One step of every member on its batch ([S, B, ...] each, the
        weights [B] shared): (totals [S], probs [S, B, H]), without a sync."""
        tr, P, Bn = self.tr, self._params, self._buffers
        vmap = torch.func.vmap
        dims = (0, 0, 0, 0, 0, None if dmask is None else 0)
        tensors = list(P.values())
        tr.model.train()
        try:
            with torch.enable_grad():
                if tr.per_task:
                    totals, data_loss, probs = vmap(self._member_task_totals(weight),
                                                    in_dims=dims)(P, Bn, ids, dense, y, dmask)
                    T = totals.shape[1]
                    task_grads = [dict(zip(P, _grads(totals[:, i].sum(), tensors,
                                                     retain=i < T - 1))) for i in range(T)]
                else:
                    total, probs = vmap(self._member_loss(weight), in_dims=dims)(
                        P, Bn, ids, dense, y, dmask)
                    grads = dict(zip(P, _grads(total.sum(), tensors)))
        finally:
            tr.model.eval()
        probs = probs.detach()
        with torch.no_grad():
            if tr.per_task:
                grads, total = self._merge_stacked(task_grads, data_loss.detach(), probs, y,
                                                   dmask, weight)
            self._tx.step(P, grads, self._opt_state)
        return total.detach(), probs

    def _merge_stacked(self, task_grads, data_loss, probs, y, dmask, weight):
        """``Trainer._merge_task_grads`` per member, under vmap: GradNorm
        moves each member's ``[S, T]`` state in place."""
        tr, vmap = self.tr, torch.func.vmap
        mc = tr.cfg.model_config
        if tr.per_task == "cagrad":
            alpha = float(mc.extra.get("cagrad_alpha", 0.5))
            return vmap(lambda g: cagrad_merge(g, alpha=alpha))(task_grads), data_loss
        if tr.per_task == "pcgrad":
            return vmap(pcgrad_merge)(task_grads), data_loss
        st = self.gn_state
        dims = (0, 0, 0, None if dmask is None else 0, None, 0)
        grads, total, new_w, init_losses = vmap(
            lambda g, p, yy, dm, w, s: tr._gradnorm_terms(g, p, yy, dm, w, s),
            in_dims=dims)(task_grads, probs, y, dmask, weight, st)
        st["task_weights"].copy_(new_w)
        st["initial_losses"].copy_(init_losses)
        st["gn_step"].add_(1)
        return grads, total

    def _reseed(self) -> None:
        """Each member's draws of this step from its own master, as a solo
        trainer's ``_reseed``."""
        for master, gen in zip(self._masters, self._gens):
            gen.manual_seed(int(torch.randint(0, 2**62, (), generator=master)))

    def _stacked_forward(self, variables):
        """forward(ids, dense, dmask) -> [S, B, heads] of the stacked
        ``variables``, the eval batch shared by every member."""
        tr = self.tr
        fn = torch.func.vmap(lambda v, i, d, m: tr._forward(v, i, d, m),
                             in_dims=(0, None, None, None))
        return lambda ids, dense, dmask: fn(variables, ids, dense, dmask)

    def _stacked_probs(self, ev, variables, graphs) -> torch.Tensor:
        """[S, steps * batch, heads] selected probabilities on the device."""
        out = _EvalProgram(self.tr, ev, None, graphs, forward=self._stacked_forward(variables)
                           ).collect()
        S = out.shape[1]
        probs = out.movedim(1, 0).reshape(S, -1, out.shape[-1])
        return probs[..., [0, 2]] if self.tr._escm else probs

    def _stacked_body(self, plan, steps: int, B: int):
        """The suite's staged step: at ``s = epoch_step % steps`` member m
        takes the rows ``arg[s, m]`` of the shared staged dataset."""
        S = len(self.seeds)

        def body():
            s = torch.remainder(plan.epoch_step, steps)
            idx = plan.arg.index_select(0, s)[0].reshape(-1)  # [S * B]
            w = plan.w2d.index_select(0, s)[0]
            rows = [None if a is None else a.index_select(0, idx).view(S, B, *a.shape[1:])
                    for a in plan.staged]
            total, probs = self._stacked_step(*rows, w)
            plan.loss.index_copy_(0, s, total[None])
            if self.tr.metric_fns:
                if plan.probs is None:  # the first call is eager: the shape is known there
                    plan.probs = torch.zeros((steps,) + tuple(probs.shape), device=self.device)
                plan.probs.index_copy_(0, s, probs[None])
            plan.epoch_step.add_(1)

        return body

    # ------------------------------------------------------------------
    def fit(self, x, y, batch_size: Optional[int] = None, epochs: int = 1,
            validation_data=None, verbose: int = 1, epoch_callback=None):
        """Train every member for ``epochs`` (``Trainer.fit``'s arguments;
        full shuffles).  ``epoch_callback(epoch, suite)`` runs after each
        epoch's logs (stacked mode)."""
        tr = self.tr
        if not hasattr(tr, "tx"):
            raise RuntimeError("call compile() before fit()")
        batch_size = batch_size or tr.cfg.training_config.train_batch_size
        if self.sequential:
            return self._fit_sequential(x, y, batch_size, epochs, validation_data, verbose)
        oc, dev, S = tr.cfg.optim_config, self.device, len(self.seeds)
        # the fit's set-up, as Trainer.fit's: the inputs packed, the
        # members' state, the dataset and the validation set staged
        with span("mmlrec.fit.stage"):
            with span("mmlrec.fit.pack"):
                ids, dense = tr.pack_inputs(x)
                y2 = tr._prepare_y(y)
                dmask = tr._domain_mask_from(x)
                val = None
                if validation_data is not None:
                    vx, vy = validation_data[:2]
                    val = (*tr.pack_inputs(vx), tr._prepare_y(vy), tr._domain_mask_from(vx))
            n = len(ids)
            steps = (n - 1) // batch_size + 1
            padded = steps * batch_size

            self._params, self._buffers = self._init_state()
            self._tx = self._member_optimizer()
            self._opt_state = self._tx.init(self._params)
            self.gn_state = None
            if tr.per_task == "gradnorm":
                T = tr.num_tasks
                self.gn_state = {"task_weights": torch.ones((S, T), device=dev),
                                 "initial_losses": torch.ones((S, T), device=dev),
                                 "gn_step": torch.zeros((S,), dtype=torch.int32, device=dev)}
            self._masters = [torch.Generator().manual_seed(s + 1) for s in self.seeds]
            self._gens = MemberGenerators(torch.Generator(device=dev) for _ in self.seeds)
            # the template model draws per member from now on (its trainer takes
            # no solo step in stacked mode)
            tr.model.set_dropout_generator(self._gens)
            rngs = [np.random.default_rng(s) for s in self.seeds]

            plan = staging.Plan()
            plan.staged = staging.stage_dataset(tr, ids, dense, y2, dmask)
            plan.epoch_step = torch.zeros(1, dtype=torch.int64, device=dev)
            plan.arg = torch.zeros(steps, S, batch_size, dtype=torch.int64, device=dev)
            plan.w2d = staging.to_device(tr, (np.arange(padded) < n).astype(np.float32)
                                         .reshape(steps, batch_size))
            plan.loss = torch.zeros(steps, S, device=dev)
            val_ev = val_metric = None
            if val is not None:
                val_ev = staging.prepare_eval_tensors(tr, val[0], val[1], val[3], batch_size)
                if tr._use_device_eval():
                    val_metric = staging.prepare_metric_tensors(tr, val[2],
                                                                val_ev.ids.shape[0] * batch_size)
        graphs = StepGraphs(dev, self._gens)
        body = self._stacked_body(plan, steps, batch_size)
        scan = tr._scan_steps

        best_auc, stop_count = np.zeros(S), np.zeros(S, np.int64)
        stopped = np.zeros(S, bool)
        best = None
        self.histories = [[] for _ in self.seeds]
        self.fit_timing = []
        val_program = None
        try:
            for epoch in range(epochs):
                t0 = time.time()
                if tr._gate_warmup_epochs:
                    tr._gate_warmup_active = epoch < tr._gate_warmup_epochs
                    tr.model.set_gate_noise_off(tr._gate_warmup_active)
                timing = dict.fromkeys(staging.TIMING_KEYS, 0.0)
                self.fit_timing.append(timing)
                captured = (graphs.captures, graphs.capture_s)
                with timed(timing, "prep_s", "mmlrec.fit.prep_wait"):
                    idx3 = np.zeros((steps, S, batch_size), np.int64)
                    for si, rng in enumerate(rngs):
                        # the stream a solo Trainer(seed) fit draws
                        flat = np.zeros(padded, np.int64)
                        flat[:n] = rng.permutation(n)
                        idx3[:, si] = flat.reshape(steps, batch_size)
                    with timed(timing, "upload_s", "mmlrec.fit.worker.upload"):
                        plan.arg.copy_(staging.to_device(tr, idx3))
                with timed(timing, "issue_s", "mmlrec.fit.issue"):
                    events = ([torch.cuda.Event(enable_timing=True) for _ in range(2)]
                              if dev.type == "cuda" else None)
                    if events:
                        events[0].record()
                    plan.epoch_step.zero_()
                    key = ("suite", batch_size, tr._gate_warmup_active)
                    for _ in range(steps):
                        self._reseed()
                        if scan and not tr.debug:
                            graphs.run(key, body)
                        else:
                            body()
                    if events:
                        events[1].record()
                with timed(timing, "sync_s", "mmlrec.fit.sync"):
                    losses = plan.loss.cpu().numpy()  # the epoch's first sync
                if events:
                    timing["steps_device_s"] = events[0].elapsed_time(events[1]) / 1e3
                epoch_time = time.time() - t0
                logs = [{"loss": float(losses[:, si].sum()) / max(n, 1), "epoch_s": epoch_time}
                        for si in range(S)]
                if tr.metric_fns:
                    with timed(timing, "metrics_s", "mmlrec.fit.train_metrics"):
                        probs_all = plan.probs.movedim(1, 0).reshape(S, padded, -1)
                        if tr._escm:
                            probs_all = probs_all[..., [0, 2]]
                        probs_all = probs_all.cpu().numpy()
                        for si in range(S):
                            rows = idx3[:, si].reshape(-1)[:n]
                            logs[si].update(regime_eval(tr.metric_fns, y2[rows], probs_all[si, :n],
                                                        tr.task_name, tr.num_domains))
                was_stopped = stopped.copy()
                if val is not None:
                    with timed(timing, "val_s", "mmlrec.fit.validate"):
                        if val_program is None:  # one program, replayed every epoch
                            val_program = _EvalProgram(tr, val_ev, None, graphs, forward=(
                                self._stacked_forward({**self._params, **self._buffers})))
                        out = val_program.collect()
                        pv = out.movedim(1, 0).reshape(S, -1, out.shape[-1])
                        if tr._escm:
                            pv = pv[..., [0, 2]]
                        improved = np.zeros(S, bool)
                        for si in range(S):
                            if val_metric is not None:
                                res = {k: float(v) for k, v in device_metrics.regime_metrics(
                                    tr.metric_fns, val_metric[0], pv[si], val_metric[1],
                                    tr.task_name, tr.num_domains).items()}
                            else:
                                preds = pv[si].cpu().numpy()[:len(val[0])].astype(np.float64)
                                res = regime_eval(tr.metric_fns, val[2], preds, tr.task_name,
                                                  tr.num_domains)
                            logs[si].update({f"val_{k}": v for k, v in res.items()})
                            auc = res.get("auc", 0.0)
                            if not was_stopped[si] and auc > best_auc[si]:
                                best_auc[si], stop_count[si], improved[si] = auc, 0, True
                            elif not was_stopped[si]:
                                stop_count[si] += 1
                        current = {**self._params, **self._buffers}
                        if best is None:  # the first epoch's snapshot, as multi_seed.py:370-379
                            best = {k: v.detach().clone() for k, v in current.items()}
                        else:
                            for si in np.flatnonzero(improved):
                                for k, v in current.items():
                                    best[k][si].copy_(v[si].detach())
                        stopped |= stop_count >= oc.early_stop
                timing["captures"] = graphs.captures - captured[0]
                timing["capture_s"] = graphs.capture_s - captured[1]
                for si in range(S):
                    # a member that stopped in an EARLIER epoch is done (a solo
                    # fit would have broken out); the epoch where its patience
                    # runs out is still logged, as the solo loop logs it
                    if val is None or not was_stopped[si]:
                        self.histories[si].append(logs[si])
                if verbose:
                    line = " | ".join(
                        f"{self.labels[si]}: loss {logs[si]['loss']:.4f}"
                        + (f" val_auc {logs[si].get('val_auc', float('nan')):.4f}"
                           if val is not None else "")
                        for si in range(S))
                    print(f"Epoch {epoch + 1}/{epochs} - {epoch_time:.1f}s - {line}")
                if epoch_callback is not None:
                    epoch_callback(epoch, self)
                if val is not None and stopped.all():
                    break
        finally:
            self.graph_replays = {
                "train": sum(v for k, v in graphs.replays.items() if k[0] != "eval"),
                "eval": sum(v for k, v in graphs.replays.items() if k[0] == "eval")}
        self.variables = {k: v.detach() for k, v in {**self._params, **self._buffers}.items()}
        self.best_variables = best if best is not None else self.variables
        return self

    def member_variables(self, i: int, best: bool = False) -> Dict[str, torch.Tensor]:
        """Member ``i``'s state by state-dict key after a stacked fit (its
        best snapshot with ``best``): loadable into ``members[i]``."""
        stacked = self.best_variables if best else self.variables
        return {k: v[i] for k, v in stacked.items()}

    # ------------------------------------------------------------------
    def _eval_tensors(self, x, batch_size):
        tr = self.tr
        ids, dense = tr.pack_inputs(x)
        return staging.prepare_eval_tensors(tr, ids, dense, tr._domain_mask_from(x), batch_size)

    def _eval_graphs(self, ev):
        from .trainer import EVAL_GRAPH_MIN_BATCHES

        return (StepGraphs(self.device) if ev.ids.shape[0] >= EVAL_GRAPH_MIN_BATCHES
                else None)

    def predict(self, x, batch_size: int = 256) -> np.ndarray:
        """[S, N, heads] float64 predictions from each member's best
        variables (ESCM: its [pCTR, pCTCVR] columns)."""
        tr = self.tr
        if self.sequential:
            preds = []
            for si in range(len(self.seeds)):
                tr.best_variables = self._seq_best[si]
                preds.append(tr.predict(x, batch_size=batch_size))
            return np.stack(preds)
        ev = self._eval_tensors(x, batch_size)
        probs = self._stacked_probs(ev, self.best_variables, self._eval_graphs(ev))
        return probs.cpu().numpy()[:, :ev.n].astype(np.float64)

    def masked_test_metrics_device(self, x, y, test_mask, batch_size: int = 256):
        """Per member, the final masked LogLoss / AUC row computed on the
        device (``Trainer.masked_test_metrics_device``): scalars reach the
        host, not the [S, N, heads] predictions."""
        tr = self.tr
        if self.sequential:
            rows = []
            for si in range(len(self.seeds)):
                tr.best_variables = self._seq_best[si]
                rows.append(tr.masked_test_metrics_device(x, y, test_mask, batch_size))
            return rows
        ev = self._eval_tensors(x, batch_size)
        total = ev.ids.shape[0] * batch_size
        y_dev, w_dev = staging.prepare_metric_tensors(tr, tr._prepare_y(y), total)
        tm_dev = staging.prepare_mask_tensor(tr, test_mask, total)
        probs = self._stacked_probs(ev, self.best_variables, self._eval_graphs(ev))
        rows = []
        for p in probs:
            out = device_metrics.masked_test_metrics_device(y_dev, p, w_dev, tm_dev,
                                                            tr.task_name, tr.num_domains)
            rows.append(_order_masked_row({k: float(v) for k, v in out.items()}))
        return rows
