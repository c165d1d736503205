"""Checkpoints of the port's Trainer (``mmlrec_tpu/train/checkpointing.py``).

Two kinds, in the JAX package's directories under ``save_config.save_path``:

* the model checkpoint (``save_checkpoint`` / ``restore_checkpoint``,
  ``{model}_{task}_seed{seed}/``): the best variables of the last fit (the
  current ones when it kept no snapshot), parameters and BatchNorm
  statistics;
* the training state (``save_training_state`` / ``restore_training_state``,
  ``{model}_{task}_seed{seed}_state/``): parameters, BatchNorm statistics,
  the dense optimizer's state, the table's SparseAdam state, GradNorm's
  task weights, first losses and step, the state of
  the generator that seeds each step's dropout, the epoch reached, the
  best snapshot and the early-stop bookkeeping, so that a fit resumed
  from it continues as the uninterrupted fit would have.

The format is the port's own: one ``torch.save`` of a flat dict of tensors
keyed like the state dict (``params/embeddings.fused.table``,
``opt_state/mu/<param>``, ``table_opt/nu``, ...), as ``serving.py`` writes
``params.pt``.  The JAX package writes orbax directories, which need JAX;
``convert.load_jax_train_state`` carries a JAX trainer's state over instead.

On disk the table is always in the SPLIT layout: a stacked container
(``[2Vp, W]`` with the packed moments in its bottom half) is saved as its
table plane and its moments unpacked to split bf16 ``mu``/``nu``, and packed
split moments unpack the same way, so a checkpoint restores into any
container and moment layout; every conversion is a slice or bit shift and
round-trips bitwise.  A trainer with f32 moments widens bf16 ones exactly
and a packed one rounds f32 ones to bf16 (RNE), as the JAX restore does.

A trainer whose table is row-sharded (a mesh with ``model > 1``) gathers
the shards of the table, of its moments (the stacked container
shard-major, ``split_stacked_planes``) and of the dense optimizer's state
of the table over ``model`` on every rank, so rank 0 writes the file one
process writes (checkpointing.py:54, 89); a restore takes each rank's rows
of it.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from ..parallel.mesh import all_gather
from .optimizers import load_state_
from .sparse_embedding import (
    MOMENT_DTYPES,
    SparseAdamFoldedState,
    SparseAdamState,
    fold_stacked_planes,
    pack_monu,
    split_stacked_planes,
    to_runtime_state,
    to_split_state,
    unpack_monu,
)

_TABLE = "embeddings.fused.table"
STATE_FILE = "state.pt"
VARIABLES_FILE = "variables.pt"


def _name(trainer) -> str:
    return f"{trainer.model_name}_{trainer.task_name}_seed{trainer.seed}"


def state_ckpt_dir(trainer, path: str) -> str:
    return os.path.abspath(os.path.join(path, _name(trainer) + "_state"))


def model_ckpt_dir(trainer, path: str) -> str:
    return os.path.abspath(os.path.join(path, _name(trainer)))


def _stacked(trainer) -> bool:
    return trainer.two_phase_embedding and trainer.table_container == "stacked"


def _shards(trainer) -> int:
    """The stacked container's shards (1: plane-major)."""
    return trainer.model.embeddings.fused.dual_shards


def _whole(trainer, t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """A row shard of the table (or of a table-shaped state) -> the whole,
    gathered over ``model`` as bytes (every dtype); other tensors as they
    are.  A collective: every rank calls it."""
    if t is None or not trainer._table_sharded():
        return t
    sh = trainer._table_shard
    raw = t.detach().contiguous().view(torch.uint8).reshape(t.shape[0], -1)
    out = raw.new_empty((sh.count * raw.shape[0], raw.shape[1]))
    all_gather(out, raw, sh.group)
    return out.view(t.dtype).view((-1,) + tuple(t.shape[1:]))


def _part(trainer, t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """Inverse of ``_whole``: this rank's rows of a whole table."""
    if t is None or not trainer._table_sharded():
        return t
    sh = trainer._table_shard
    rows = t.shape[0] // sh.count
    return t[sh.index * rows:(sh.index + 1) * rows]


def _map_table(trainer, fn, tree):
    """``fn`` on the table-shaped entries: the table in a variables dict,
    the moments of a SparseAdam state, the table's entries of each field
    of the dense optimizer's state."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: fn(trainer, v) if k == _TABLE else v for k, v in tree.items()}
    return tree._replace(**{f: fn(trainer, v) for f, v in tree._asdict().items()
                            if f != "count"})


def state_to_split_layout(trainer, state: Dict) -> Dict:
    """``state`` ({"params": {key: tensor}, "table_opt": state or None, ...})
    in the split layout of the disk."""
    out = dict(state)
    topt = state.get("table_opt")
    if isinstance(topt, SparseAdamFoldedState):
        table, monu = split_stacked_planes(state["params"][_TABLE], _shards(trainer))
        mu, nu = unpack_monu(monu)
        out["params"] = {**state["params"], _TABLE: table}
        out["table_opt"] = SparseAdamState(mu=mu, nu=nu, count=topt.count)
    elif topt is not None:
        out["table_opt"] = to_split_state(topt)
    return out


def state_to_runtime_layout(trainer, state: Dict) -> Dict:
    """Inverse of ``state_to_split_layout`` for this trainer: the table and
    moments refolded into a stacked container, packed for packed moments,
    else split in the trainer's ``table_opt_dtype``."""
    out = dict(state)
    topt = state.get("table_opt")
    if topt is None:
        return out
    if _stacked(trainer):
        fat = fold_stacked_planes(state["params"][_TABLE], pack_monu(topt.mu, topt.nu),
                                  _shards(trainer))
        out["params"] = {**state["params"], _TABLE: fat}
        out["table_opt"] = SparseAdamFoldedState(count=topt.count)
    elif trainer._packed_moments:
        out["table_opt"] = to_runtime_state(topt, packed=True)
    else:
        mdt = MOMENT_DTYPES[trainer._moment_dtype]
        out["table_opt"] = SparseAdamState(mu=topt.mu.to(mdt), nu=topt.nu.to(mdt),
                                           count=topt.count)
    return out


def _split_variables(trainer, variables: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Variables (a state dict) with a stacked table cut to its table plane."""
    variables = _map_table(trainer, _whole, variables)
    if _stacked(trainer) and _TABLE in variables:
        return {**variables, _TABLE: split_stacked_planes(variables[_TABLE], _shards(trainer))[0]}
    return dict(variables)


def _runtime_variables(trainer, variables: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Inverse of ``_split_variables``: a stacked trainer's table plane gets
    the trainer's current moment half back (no forward reads it)."""
    if _stacked(trainer) and _TABLE in variables:
        monu = split_stacked_planes(_whole(trainer, trainer.table.detach()), _shards(trainer))[1]
        variables = {**variables, _TABLE: fold_stacked_planes(variables[_TABLE], monu,
                                                              _shards(trainer))}
    return _map_table(trainer, _part, dict(variables))


def _save(payload: Dict[str, torch.Tensor], directory: str, filename: str) -> str:
    os.makedirs(directory, exist_ok=True)
    out = os.path.join(directory, filename)
    tmp = f"{out}.{os.getpid()}.tmp"
    torch.save({k: v.detach().cpu().clone() for k, v in payload.items()}, tmp)
    os.replace(tmp, out)  # a reader sees the old file or the new one, whole
    return directory


def _emit(trainer, payload: Dict[str, torch.Tensor], directory: str, filename: str) -> str:
    """``_save`` on the writing rank (rank 0 of a mesh; the only process
    without one); the others only return the directory."""
    if trainer.mesh is not None and dist.get_rank():
        return directory
    return _save(payload, directory, filename)


def load_tensors(directory: str, filename: str, device=None) -> Dict[str, torch.Tensor]:
    """The tensors a checkpoint directory holds, on ``device`` (the card by
    default: raises when there is none)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to load the "
                "checkpoint on the CPU")
        device = "cuda"
    path = os.path.join(directory, filename)
    if not os.path.exists(path):
        raise FileNotFoundError(f"no checkpoint at {path}")
    return torch.load(path, map_location=device, weights_only=True)


def _model_state(trainer) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """(parameters, BatchNorm statistics) of the trainer's model by key."""
    params = dict(trainer.model.named_parameters())
    state = trainer.model.state_dict()
    return ({k: v.detach() for k, v in params.items()},
            {k: v for k, v in state.items() if k not in params})


def save_training_state(trainer, path: str, epoch: Optional[int] = None) -> str:
    """Write the whole training state under ``path``; returns its directory."""
    if trainer.opt_state is None:
        raise ValueError("no training state; call fit() first")
    progress = getattr(trainer, "_progress", None)
    if epoch is None:
        epoch = progress[0] if progress else len(trainer.history)
    best_auc, early_stop_count, best = progress[1:] if progress else (0.0, 0, None)
    params, stats = _model_state(trainer)
    split = state_to_split_layout(trainer, {
        "params": _map_table(trainer, _whole, params),
        "table_opt": _map_table(trainer, _whole, trainer.table_opt)})
    payload = {f"params/{k}": v for k, v in split["params"].items()}
    payload.update({f"batch_stats/{k}": v for k, v in stats.items()})
    for field, value in trainer.opt_state._asdict().items():
        if isinstance(value, dict):
            payload.update({f"opt_state/{field}/{k}": v
                            for k, v in _map_table(trainer, _whole, dict(value)).items()})
        else:
            payload[f"opt_state/{field}"] = value
    if split["table_opt"] is not None:
        topt = split["table_opt"]
        payload.update({"table_opt/mu": topt.mu, "table_opt/nu": topt.nu,
                        "table_opt/count": topt.count})
    if trainer.gn_state is not None:
        payload.update({f"gradnorm/{k}": v for k, v in trainer.gn_state.items()})
    if best is not None:
        payload.update({f"best/{k}": v for k, v in _split_variables(trainer, best).items()})
    payload.update(rng=trainer._dropout_master.get_state(), epoch=torch.tensor(int(epoch)),
                   best_auc=torch.tensor(float(best_auc), dtype=torch.float64),
                   early_stop_count=torch.tensor(int(early_stop_count)))
    return _emit(trainer, payload, state_ckpt_dir(trainer, path), STATE_FILE)


def _section(payload: Dict[str, torch.Tensor], prefix: str) -> Dict[str, torch.Tensor]:
    return {k[len(prefix):]: v for k, v in payload.items() if k.startswith(prefix)}


def restore_training_state(trainer, path: str):
    """Load a ``save_training_state`` directory into ``trainer`` in place;
    returns (epoch, best val_auc, epochs without a new best, best snapshot
    or None), from which ``fit(resume_from=)`` continues."""
    if trainer.opt_state is None:
        trainer.init_state()
    payload = load_tensors(path, STATE_FILE, trainer.device)
    params = _section(payload, "params/")
    table_opt = None
    if trainer.table_opt is not None:  # two-phase, or sparse_embedding_update
        table_opt = SparseAdamState(mu=payload["table_opt/mu"], nu=payload["table_opt/nu"],
                                    count=payload["table_opt/count"])
    rt = state_to_runtime_layout(trainer, {"params": params, "table_opt": table_opt})
    trainer.model.load_state_dict({**_map_table(trainer, _part, rt["params"]),
                                   **_section(payload, "batch_stats/")})
    if table_opt is not None:
        trainer.table_opt = _map_table(trainer, _part, rt["table_opt"])
    fields = {}
    for field, value in trainer.opt_state._asdict().items():
        fields[field] = (_map_table(trainer, _part, _section(payload, f"opt_state/{field}/"))
                         if isinstance(value, dict) else payload[f"opt_state/{field}"])
    load_state_(trainer.opt_state, fields)  # in place: a flat state keeps its buffer
    gradnorm = _section(payload, "gradnorm/")
    if trainer.per_task == "gradnorm" and gradnorm:
        trainer.reset_gradnorm()
        for k, v in trainer.gn_state.items():
            v.copy_(gradnorm[k])
    trainer._dropout_master.set_state(payload["rng"].cpu())
    best = _section(payload, "best/")
    best = _runtime_variables(trainer, best) if best else None
    return (int(payload["epoch"]), float(payload["best_auc"]),
            int(payload["early_stop_count"]), best)


def save_checkpoint(trainer, path: str) -> str:
    """Write the best variables (the current ones without a snapshot) under
    ``path``; returns the checkpoint's directory."""
    variables = trainer.best_variables or trainer.model.state_dict()
    return _emit(trainer, _split_variables(trainer, variables), model_ckpt_dir(trainer, path),
                 VARIABLES_FILE)


def restore_checkpoint(trainer, path: str):
    """Load a ``save_checkpoint`` directory into the trainer's model; the
    trainer then predicts from it (its best snapshot is dropped)."""
    variables = load_tensors(path, VARIABLES_FILE, trainer.device)
    trainer.model.load_state_dict(_runtime_variables(trainer, variables))
    trainer.best_variables = None
    return trainer
