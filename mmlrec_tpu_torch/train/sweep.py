"""Hyperparameter sweeps (the port of ``mmlrec_tpu/train/sweep.py``): a
grid of (seed, learning rate, ...) combinations trained by one object.

Each combination is a member of a ``SeedSuiteTrainer``: in stacked mode
its own stacked parameters, optimizer state and draw streams, and its
hyperparameters per-member f32 tensors of the flat optimizer
(``optimizers._Elementwise.inject``, as ``optax.inject_hyperparams`` makes
them optimizer-state leaves), so one step advances every combination.
Any update-time hyperparameter of the optimizer can vary (``lr`` and, by
explicit ``grid`` rows, adam's ``b1`` / ``b2`` / ``eps`` or rmsprop's
``decay``); init-time ones (accumulator seeds) are refused
(``_INIT_TIME_HPS``).

Two-phase and ``sparse_embedding_update`` configs run sequential-shared,
grouped by lr: before each group ``optim_config.lr`` is set and the
trainer recompiled (the table update reads that lr at each step), then
each seed of the group runs from ``reset_for_seed``.  A fit captures its
step graphs anew, so no graph captured at one lr is replayed at another.
A sequential grid varies the lr only.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from .multi_seed import SeedSuiteTrainer
from .optimizers import Flat, get_optimizer

#: grid-row key -> the port's hyperparameter name (optax calls the lr
#: ``learning_rate``)
_HP_ALIASES = {"learning_rate": "lr"}

#: hyperparameters consumed when the optimizer state is made (accumulator
#: seeds): varying them per combination after init would do nothing, so a
#: grid that varies them is refused; sweep them as separate suites
_INIT_TIME_HPS = {"initial_accumulator_value", "initial_scale"}


def injectable_optimizer(name: str, lr: float, device="cpu"):
    """``get_optimizer(name, lr)`` with every update-time hyperparameter an
    f32 tensor on ``device`` (sweep.py:38-54): the same torch-matching
    settings, the constants of its chain the plain optimizer's."""
    return get_optimizer(name, lr).inject({}, device)


class GridSweepTrainer(SeedSuiteTrainer):
    """Every (seed, hyperparameter) combination as one member.

    ``grid`` rows are ``{"seed": int, "lr": float, ...}``; or ``seeds`` and
    ``lrs`` give their cross product.  Everything else (fit, predict,
    histories, early stopping) is ``SeedSuiteTrainer``'s, over
    ``len(grid)`` members."""

    def __init__(self, model, seeds: Sequence[int] = (0,), lrs: Optional[Sequence[float]] = None,
                 grid: Optional[List[Dict]] = None, *, device=None):
        if grid is None:
            if lrs is None:
                raise ValueError("pass lrs=[...] or an explicit grid")
            grid = [{"seed": s, "lr": float(lr)} for s in seeds for lr in lrs]
        self.grid = list(grid)
        hp_keys = sorted({k for g in self.grid for k in g} - {"seed"})
        if not hp_keys:
            raise ValueError("grid rows vary no optimizer hyperparameter")
        bad = set(hp_keys) & _INIT_TIME_HPS
        if bad:
            raise ValueError(
                f"{sorted(bad)} are consumed when the optimizer state is made and cannot vary "
                "along the stacked grid (the stacked state is made once); sweep them as "
                "separate suites")
        missing = [(g, k) for g in self.grid for k in hp_keys if k not in g]
        if missing:
            raise ValueError(f"grid rows missing hyperparams: {missing[:3]}")
        self._hp_keys = hp_keys
        super().__init__(model, seeds=[g["seed"] for g in self.grid], device=device)
        if self.sequential and hp_keys != ["lr"]:
            raise NotImplementedError(
                "the two-phase / sparse table update reads only the learning rate from the "
                f"config, so sequential grids vary lr only (got {hp_keys}); sweep other "
                "hyperparameters as separate suites")
        tag = lambda g: "/".join(f"{k}{g[k]:g}" for k in hp_keys)  # noqa: E731
        self.labels = [f"s{g['seed']}/{tag(g)}" for g in self.grid]
        self.row_labels = [f"{g['seed']}_" + "_".join(f"{k}{g[k]:g}" for k in hp_keys)
                           for g in self.grid]

    def compile(self, optimizer=None, loss=None, metrics=None):
        name = optimizer or self.tr.cfg.optim_config.optimizer
        if not isinstance(name, str):
            raise ValueError("GridSweepTrainer needs an optimizer NAME to build the "
                             "injectable optimizer")
        self._compile_args = (name, loss, metrics)
        self.tr.compile(optimizer=name, loss=loss, metrics=metrics)
        return self

    def _member_optimizer(self):
        """The compiled optimizer with each member's hyperparameters
        (sweep.py:188-202); an unknown one raises KeyError."""
        inner = self.tr.tx.inner if isinstance(self.tr.tx, Flat) else self.tr.tx
        values = {_HP_ALIASES.get(k, k): [float(g[k]) for g in self.grid]
                  for k in self._hp_keys}
        return Flat(inner.inject(values, self.device), members=len(self.grid))

    def _fit_sequential(self, x, y, batch_size, epochs, validation_data, verbose):
        """Combinations one after another on the one trainer, grouped by lr
        (sweep.py:140-186): the config's lr set and the trainer recompiled
        per group; each combination bitwise a solo fit at its (seed, lr)."""
        tr = self.tr
        name, loss, metrics = getattr(self, "_compile_args", (None, None, None))
        oc = tr.cfg.optim_config
        orig_lr = oc.lr
        S = len(self.grid)
        self._seq_best, self.capture_s = [None] * S, [0.0] * S
        order = sorted(range(S), key=lambda i: (self.grid[i]["lr"], i))
        last_lr = None
        try:
            for gi in order:
                g = self.grid[gi]
                if g["lr"] != last_lr:
                    oc.lr = float(g["lr"])
                    tr.compile(optimizer=name, loss=loss, metrics=metrics)
                    last_lr = g["lr"]
                tr.reset_for_seed(g["seed"])
                self._fit_one(gi, x, y, batch_size, epochs, validation_data, verbose)
        finally:
            oc.lr = orig_lr
        self.variables = None
        return self

    def results(self) -> List[Dict]:
        """Per combination: its grid values, best val AUC and epochs run."""
        out = []
        for i, g in enumerate(self.grid):
            hist = self.histories[i]
            best = max((h.get("val_auc", 0.0) for h in hist), default=0.0)
            out.append({**g, "best_val_auc": best, "epochs": len(hist)})
        return out
