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

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..ops.layers import MemberGenerators
from ..utils.spans import timed
from . import device_metrics, fit_loop, staging
from .cagrad import cagrad_merge
from .graphs import StepGraphs
from .optimizers import Flat
from .pcgrad import pcgrad_merge
from .fit_loop import _EvalProgram
from .trainer import EVAL_GRAPH_MIN_BATCHES, Trainer, _grads, _order_masked_row


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
        #: per epoch of the last stacked fit, as for ``Trainer.fit`` (one
        #: epoch loop: ``train/fit_loop.py``), ``staging.TIMING_KEYS``, no
        #: metadata (``meta_s`` 0), on the card the steps' device span
        self.fit_timing: List[Dict[str, float]] = []
        self.graph_replays: Dict[str, int] = {"train": 0, "eval": 0}
        #: member 0's examples a second in the last stacked fit
        self.throughput_examples_per_s: Optional[float] = None
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
        best = fit_loop.fit(tr, self, x, y, batch_size, epochs, 0.0, validation_data, verbose,
                            epoch_callback, lambda *data: self._start(batch_size, *data))
        self.variables = {k: v.detach() for k, v in {**self._params, **self._buffers}.items()}
        self.best_variables = best if best is not None else self.variables
        return self

    def _start(self, batch_size, ids, dense, y, dmask, val) -> fit_loop.FitRun:
        """The members' stacked state and the suite's epoch source."""
        tr, dev, S = self.tr, self.device, len(self.seeds)
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
        self.histories = [[] for _ in self.seeds]
        state = {**self._params, **self._buffers}
        graphs = StepGraphs(dev, self._gens)
        return fit_loop.FitRun(
            _StackedSource(self, graphs, ids, dense, y, dmask, batch_size), graphs,
            self.histories, lambda: state, stacked=True, labels=self.labels,
            forward=self._stacked_forward(state))

    def member_variables(self, i: int, best: bool = False) -> Dict[str, torch.Tensor]:
        """Member ``i``'s state by state-dict key after a stacked fit (its
        best snapshot with ``best``): loadable into ``members[i]``."""
        stacked = self.best_variables if best else self.variables
        return {k: v[i] for k, v in stacked.items()}

    # ------------------------------------------------------------------
    def _best_probs(self, x, batch_size):
        """The eval tensors of ``x`` and each member's [S, steps * batch,
        heads] selected probabilities from its best variables, on the device."""
        tr = self.tr
        ids, dense = tr.pack_inputs(x)
        ev = staging.prepare_eval_tensors(tr, ids, dense, tr._domain_mask_from(x), batch_size)
        graphs = StepGraphs(self.device) if ev.ids.shape[0] >= EVAL_GRAPH_MIN_BATCHES else None
        return ev, _EvalProgram(tr, ev, None, graphs,
                                forward=self._stacked_forward(self.best_variables)).members()

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
        ev, probs = self._best_probs(x, batch_size)
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
        ev, probs = self._best_probs(x, batch_size)
        total = ev.ids.shape[0] * batch_size
        y_dev, w_dev = staging.prepare_metric_tensors(tr, tr._prepare_y(y), total)
        tm_dev = staging.prepare_mask_tensor(tr, test_mask, total)
        rows = []
        for p in probs:
            out = device_metrics.masked_test_metrics_device(y_dev, p, w_dev, tm_dev,
                                                            tr.task_name, tr.num_domains)
            rows.append(_order_masked_row({k: float(v) for k, v in out.items()}))
        return rows


class _StackedSource(staging.Plan):
    """The stacked suite's epoch source: each epoch every member's
    permutation of the shared staged rows, drawn from its own
    ``default_rng(seed)`` as its solo fit draws it, into ``arg`` [steps, S,
    B]; then each batch one stacked step (``_stacked_body``)."""

    def __init__(self, suite: SeedSuiteTrainer, graphs: StepGraphs, ids, dense, y, dmask,
                 batch_size):
        tr, S = suite.tr, len(suite.seeds)
        super().__init__(tr, y, batch_size, None, (S,))
        self.suite, self.graphs, self.members = suite, graphs, S
        self.rngs = [np.random.default_rng(s) for s in suite.seeds]
        steps = self.steps
        self.staged = staging.stage_dataset(tr, ids, dense, y, dmask)
        self.arg = torch.zeros(steps, S, batch_size, dtype=torch.int64, device=tr.device)
        self.w2d = staging.to_device(tr, (np.arange(steps * batch_size) < self.n)
                                     .astype(np.float32).reshape(steps, batch_size))
        self.body = suite._stacked_body(self, steps, batch_size)

    def prepare(self, epoch, steps, timing) -> None:
        self.flat = np.zeros((self.members, steps * self.batch), np.int64)
        for flat, rng in zip(self.flat, self.rngs):  # the stream a solo Trainer(seed) fit draws
            flat[:self.n] = rng.permutation(self.n)
        idx3 = np.ascontiguousarray(self.flat.reshape(-1, steps, self.batch).transpose(1, 0, 2))
        with timed(timing, "upload_s", "mmlrec.fit.worker.upload"):
            self.arg.copy_(staging.to_device(self.trainer, idx3))

    def run(self, steps, timing) -> staging.EpochResult:
        tr, B, n = self.trainer, self.batch, self.n
        self.epoch_step.zero_()
        key = ("suite", B, tr._gate_warmup_active)
        for _ in range(steps):
            self.suite._reseed()
            if tr._scan_steps and not tr.debug:
                self.graphs.run(key, self.body)
            else:
                self.body()
        rows = tuple((slice(0, n), flat[:n]) for flat in self.flat)
        return self._result(steps, rows, n, [(min(B, n - s * B),) * 2 for s in range(steps)])
