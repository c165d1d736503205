"""The two-phase step's fit-time resolution and host metadata (the port of
the table-update part of ``mmlrec_tpu/train/staging.py``).

Functions take the Trainer as their first argument, as there.  Staging the
dataset on the device, the per-epoch metadata stacks, their compaction and
the thread-ahead pool are ROADMAP A3: the port builds each batch's metadata
on the step's thread.
"""

from __future__ import annotations

import numpy as np

from .sparse_embedding import batch_step_metadata


def resolve_table_update(trainer, batch_size: int) -> None:
    """Enforce the unique-metadata headroom at fit time (staging.py:132-202):
    the write-kernel update needs the physical rows to exceed Kp, the
    padded per-batch id count, which depends on the fit's batch.  An update
    resolved from ``"auto"`` falls back to the scatter update; an explicit
    one raises, and so does the stacked container, whose moments live in
    the table (the JAX trainer undoes a stacked container that it opted into
    itself while no variables exist; the port builds the table with the
    model, so a stacked container is always initialised)."""
    if trainer.table_update == "scatter":
        return
    K = batch_size * len(trainer.layout.sparse_slots)
    Kp = -(-K // 256) * 256
    if trainer._emb_phys_rows > Kp:
        return
    stacked = trainer.table_container == "stacked"
    if not trainer._table_update_auto or stacked:
        raise ValueError(
            f"table_update={trainer.table_update!r}"
            + (" with table_container='stacked'" if stacked else "")
            + f" needs the physical table ({trainer._emb_phys_rows} rows) to exceed the "
            f"padded per-batch id count Kp={Kp}; use a larger vocabulary, a smaller batch, "
            "or table_update='scatter'")
    trainer.table_update = "scatter"
    trainer._packed_moments = False
    trainer._check_moment_layout()


def resolve_update_space(trainer, flat: np.ndarray) -> None:
    """Resolve ``update_space="auto"`` (staging.py:205-222).  Slot space
    rides the gather route's lists (ROADMAP A4), so the port's auto always
    resolves to position."""
    if trainer.update_space == "auto":
        trainer.update_space = "position"


def step_metadata(trainer, flat: np.ndarray) -> tuple:
    """Host metadata of flat [steps, K] logical ids (staging.py:225-260):
    (inv, rep) for the scatter update, plus (pids, pinv, nuniq, prep) for
    the write-kernel update, all from one sort."""
    resolve_update_space(trainer, flat)
    if trainer.table_update == "scatter":
        return batch_step_metadata(flat)
    return batch_step_metadata(flat, trainer._emb_pack_factor, trainer._emb_phys_rows,
                               want_route=trainer.dedup_route == "gather")
