"""Load the JAX package's flax variables and training state into the port.

The port names its parameters as the flax modules do, so the flax path
``embeddings/fused/table`` is the state-dict key ``embeddings.fused.table``
(a varlen feature's ``embeddings/table_{name}`` is
``embeddings.table_{name}``) and every leaf keeps its layout (``[K, in, out]`` kernels, the lane-packed
``[rows/P, 128]`` table, the stacked ``[2Vp, 128]`` container).  Trees are
given as numpy arrays (or anything ``np.asarray`` takes); this module
imports no JAX.  ``table_to_ranks`` / ``ranks_to_table`` move a row-sharded
table (the shard-major stacked container included) between JAX's global
array and the rows each rank of a ``model > 1`` mesh holds.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch
from torch import nn


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, object]:
    flat = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            flat.update(_flatten(v, key))
        else:
            flat[key] = v
    return flat


def load_jax_variables(model: nn.Module, variables: Mapping) -> nn.Module:
    """Copy a flax ``{"params": ..., "batch_stats": ...}`` tree into ``model``
    in place: ``params`` into the parameters, ``batch_stats`` (BatchNorm's
    running ``mean`` and ``var``; absent or empty for a model without
    BatchNorm) into the persistent buffers.

    Raises ValueError on any other collection, any missing or extra leaf,
    and any leaf whose shape or dtype differs from the module's parameter or
    buffer.
    """
    others = sorted(set(variables) - {"params", "batch_stats"})
    if others:
        raise ValueError(f"unsupported variable collections {others}")
    persistent = set(model.state_dict())
    targets = {
        "params": dict(model.named_parameters()),
        "batch_stats": {k: b for k, b in model.named_buffers() if k in persistent},
    }
    arrays = {}
    for collection, wanted in targets.items():
        leaves = {k.replace("/", "."): v
                  for k, v in _flatten(variables.get(collection, {})).items()}
        missing = sorted(set(wanted) - set(leaves))
        extra = sorted(set(leaves) - set(wanted))
        if missing or extra:
            raise ValueError(f"{collection} mismatch: missing {missing}, extra {extra}")
        for key, t in wanted.items():
            a = np.asarray(leaves[key])
            if a.shape != tuple(t.shape) or a.dtype != np.float32:
                raise ValueError(
                    f"{key}: got {a.dtype}{list(a.shape)}, expected "
                    f"float32{list(t.shape)}")
            arrays[key] = (t, a)
    with torch.no_grad():
        for t, a in arrays.values():
            t.copy_(torch.as_tensor(np.array(a)))
    return model


def _flat_names(tree: Mapping) -> Dict[str, np.ndarray]:
    return {k.replace("/", "."): np.asarray(v) for k, v in _flatten(tree).items()}


def _moment_tensor(a: np.ndarray, device) -> torch.Tensor:
    """A float32, float16 or bfloat16 numpy array (JAX's ``ml_dtypes``
    bfloat16) as a torch tensor of the same bits."""
    a = np.array(a)  # an owned, writable copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def load_jax_train_state(trainer, params: Mapping, table_opt: Optional[Mapping],
                         opt_state: Mapping, batch_stats: Optional[Mapping] = None):
    """Carry a JAX Trainer's state into a port ``Trainer`` (compiled with the
    same optimizer).

    * ``params``: the flax params tree (the fused table included; fat for
      the stacked container, whose bottom half holds the moments);
    * ``table_opt``: for a two-phase trainer ``{"count": ...}``, plus
      ``"monu"`` ([Vp, W] f32 packed moments) for the split container with
      packed moments, or ``"mu"`` and ``"nu"`` ([Vp, W] each in the
      trainer's ``table_opt_dtype``, a JAX ``SparseAdamState``) for split
      moments, as for a ``sparse_embedding_update`` trainer; None for
      another dense-fit trainer, whose table is a parameter like any other;
    * ``opt_state``: the optax state by field name, each tree shaped as the
      parameters the optimizer covers (all of them for the dense fit, all
      but the table for the two-phase step; an ``optax.flatten`` state
      unravelled): ``{"count", "mu", "nu"}`` for adam, ``{"sum_of_squares"}``
      for adagrad, ``{"nu"}`` for rmsprop, ``{}`` for sgd;
    * ``batch_stats``: the flax ``batch_stats`` tree of a model with
      BatchNorm (its running means and variances), else None.

    Returns the trainer, ready to continue training from that state."""
    from .train.optimizers import load_state_
    from .train.sparse_embedding import SparseAdamPackedState, SparseAdamState

    load_jax_variables(trainer.model, {"params": params, "batch_stats": batch_stats or {}})
    trainer.init_state()
    dev = trainer.device

    def tensor(a, dtype=torch.float32):
        return torch.tensor(np.asarray(a), dtype=dtype, device=dev)

    if trainer.table_opt is None:
        if table_opt is not None:
            raise ValueError("a dense-fit trainer has no table_opt: its table's moments "
                             "are part of opt_state")
        covered = dict(trainer.model.named_parameters())
    else:
        covered = trainer.rest_params()
        count = tensor(np.asarray(table_opt["count"]).reshape(()), torch.int32)
        if trainer.table_container == "stacked":
            trainer.table_opt = trainer.table_opt._replace(count=count)
        else:
            names = ("monu",) if trainer._packed_moments else ("mu", "nu")
            kind = "packed" if trainer._packed_moments else trainer._moment_dtype
            if set(table_opt) != {"count", *names}:
                raise ValueError(f"table_opt has {sorted(table_opt)}, the trainer's {kind} "
                                 f"moments need {sorted(('count', *names))}")
            want = "float32" if trainer._packed_moments else trainer._moment_dtype
            moments = {}
            for name in names:
                a = np.asarray(table_opt[name])
                if a.shape != tuple(trainer.table.shape) or a.dtype.name != want:
                    raise ValueError(f"{name}: got {a.dtype}{list(a.shape)}, expected "
                                     f"{want}{list(trainer.table.shape)}")
                moments[name] = _moment_tensor(a, dev)
            state = SparseAdamPackedState if trainer._packed_moments else SparseAdamState
            trainer.table_opt = state(**moments, count=count)

    fields = trainer.opt_state._asdict()
    if set(opt_state) != set(fields):
        raise ValueError(f"opt_state has {sorted(opt_state)}, the trainer's "
                         f"{type(trainer.opt_state).__name__} needs {sorted(fields)}")
    loaded = {}
    for field, value in fields.items():
        if not isinstance(value, dict):  # the step counter
            loaded[field] = tensor(np.asarray(opt_state[field]).reshape(()), torch.int32)
            continue
        flat = _flat_names(opt_state[field])
        if set(flat) != set(covered):
            raise ValueError(f"opt_state[{field!r}] leaves {sorted(flat)} do not "
                             f"match the parameters {sorted(covered)}")
        for k, p in covered.items():
            if flat[k].shape != tuple(p.shape):
                raise ValueError(f"opt_state[{field!r}][{k}]: shape {flat[k].shape}")
        loaded[field] = {k: tensor(flat[k]) for k in covered}
    load_state_(trainer.opt_state, loaded)  # in place: a flat state keeps its buffer
    return trainer


def table_to_ranks(table, n_model: int) -> List[np.ndarray]:
    """A JAX trainer's table state as the ranks of a ``model = n_model``
    mesh hold it: each rank's contiguous rows, ``[R / n_model, W]``.  The
    shard-major stacked ``[2Vp, W]`` container of a mesh trainer
    (``stacked_shards = n_model``) splits the same way, rank m's rows being
    its ``[table_m; monu_m]``; so do the split ``mu`` / ``nu`` / ``monu``
    arrays.  ``np.asarray`` of a row-sharded JAX array gathers it."""
    a = np.asarray(table)
    if a.shape[0] % n_model:
        raise ValueError(f"{a.shape[0]} rows do not divide by model = {n_model}")
    return list(np.split(a, n_model))


def ranks_to_table(parts: Sequence) -> np.ndarray:
    """Inverse of ``table_to_ranks``: the ranks' rows in model order."""
    return np.concatenate([np.asarray(p) for p in parts])
