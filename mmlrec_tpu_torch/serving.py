"""Serving bundles of the port (mmlrec_tpu/serving.py).

A bundle is a directory of two files:

    <dir>/meta.json   the JAX bundle's schema (feature packing, batch and
                      mask contract) plus the experiment config and the
                      feature columns the model is rebuilt from
    <dir>/params.pt   ``torch.save`` of the model's state dict: parameters
                      and BatchNorm running statistics

The JAX bundle ships the traced program (``predict.jaxexport``, StableHLO)
and loads without model code.  PyTorch runs eagerly, so ``load`` rebuilds
the model from the config in ``meta.json`` and loads the weights into it;
the batch dimension is free, as in the JAX bundle's symbolic mode.

Under a profiler each ``predict`` is one span ``mmlrec.serve.predict``
holding ``mmlrec.serve.pack`` (the columns packed, the domain mask, the
padding) and, once a batch, ``mmlrec.serve.copy_in`` (the copies to the
device), ``mmlrec.serve.forward`` (the model's launches issued) and
``mmlrec.serve.copy_out`` (the wait for the device and the copy back);
``utils/spans.py``.
"""

from __future__ import annotations

import copy
import json
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from .config import ExperimentConfig
from .features import DenseFeat, FeatureLayout, SparseFeat, VarLenSparseFeat
from .utils.spans import span

_PARAMS_FILE = "params.pt"
_META_FILE = "meta.json"


def _packing_schema(layout) -> Dict:
    """Feature→packed-column schema, standalone-serializable so the loader
    can pack inputs without a FeatureLayout."""
    return {
        "sparse": [s.feature.name for s in layout.sparse_slots],
        "varlen": [
            {
                "name": s.feature.name,
                "maxlen": int(s.feature.maxlen),
                "length_name": s.feature.length_name,
            }
            for s in layout.varlen_slots
        ],
        "dense": [
            {"name": s.feature.name, "dim": int(s.feature.dimension)}
            for s in layout.dense_slots
        ],
    }


def _pack_from_schema(schema: Dict, x) -> tuple:
    """Standalone re-implementation of Trainer.pack_inputs driven by the
    bundle's schema (mmlrec_tpu/train/trainer.py:585-614 semantics)."""
    if isinstance(x, tuple) and len(x) == 2:
        return np.asarray(x[0], np.int32), np.asarray(x[1], np.float32)
    n = None
    ids_parts: List[np.ndarray] = []
    for name in schema["sparse"]:
        col = np.asarray(x[name]).reshape(-1, 1).astype(np.int32)
        ids_parts.append(col)
        n = len(col)
    for v in schema["varlen"]:
        seq = np.asarray(x[v["name"]]).reshape(n if n else -1, v["maxlen"])
        ids_parts.append(seq.astype(np.int32))
        if v["length_name"] is not None:
            ids_parts.append(
                np.asarray(x[v["length_name"]]).reshape(-1, 1).astype(np.int32)
            )
    dense_parts: List[np.ndarray] = []
    for d in schema["dense"]:
        dense_parts.append(
            np.asarray(x[d["name"]], np.float32).reshape(-1, d["dim"])
        )
    ids = (
        np.concatenate(ids_parts, axis=1)
        if ids_parts
        else np.zeros((n or 0, 0), np.int32)
    )
    dense = (
        np.concatenate(dense_parts, axis=1)
        if dense_parts
        else np.zeros((len(ids), 0), np.float32)
    )
    return ids, dense


def _domain_mask_from_meta(meta: Dict, x) -> Optional[np.ndarray]:
    col = meta.get("mask_column")
    if not meta["needs_mask"] or not col:
        return None
    vals = np.asarray(x[col])
    mask = np.zeros((len(vals), meta["num_domains"]), np.float32)
    for i, mv in enumerate(meta["mask_values"]):
        mask[:, i] = (vals == mv).astype(np.float32)
    return mask


def _sparse_spec(col: SparseFeat) -> Dict:
    return {"name": col.name, "vocabulary_size": int(col.vocabulary_size),
            "embedding_dim": int(col.embedding_dim), "embedding_name": col.embedding_name,
            "group_name": col.group_name}


def _sparse_from_spec(s: Dict) -> SparseFeat:
    return SparseFeat(s["name"], s["vocabulary_size"], s["embedding_dim"],
                      embedding_name=s["embedding_name"], group_name=s["group_name"])


def _feature_specs(layout: FeatureLayout) -> List[Dict]:
    """The layout's feature columns, in their order, as JSON."""
    specs = []
    for col in layout.feature_columns:
        if isinstance(col, SparseFeat):
            specs.append({"kind": "sparse", **_sparse_spec(col)})
        elif isinstance(col, DenseFeat):
            specs.append({"kind": "dense", "name": col.name,
                          "dimension": int(col.dimension)})
        else:
            specs.append({"kind": "varlen", "sparsefeat": _sparse_spec(col.sparsefeat),
                          "maxlen": int(col.maxlen), "combiner": col.combiner,
                          "length_name": col.length_name})
    return specs


def _layout_from_specs(specs: List[Dict]) -> FeatureLayout:
    cols = []
    for s in specs:
        if s["kind"] == "sparse":
            cols.append(_sparse_from_spec(s))
        elif s["kind"] == "varlen":
            cols.append(VarLenSparseFeat(_sparse_from_spec(s["sparsefeat"]), s["maxlen"],
                                         combiner=s["combiner"], length_name=s["length_name"]))
        else:
            cols.append(DenseFeat(s["name"], s["dimension"]))
    return FeatureLayout(cols)


def save_serving_bundle(model, path: str) -> Dict:
    """Write a model's weights, config and feature schema to ``path``.

    ``model`` is a port model (``get_model``) or a ``train.Trainer``: a
    trainer exports its ``best_variables`` (the best epoch's snapshot, not
    the last epoch's weights) when its fit kept one, as the JAX function
    does.  Returns the bundle's meta dict, in the JAX bundle's schema.
    """
    best, trainer = None, None
    if hasattr(model, "best_variables"):  # a Trainer
        trainer, model, best = model, model.model, model.best_variables
    cfg, layout = model.cfg, model.layout
    state = {**model.state_dict(), **(best or {})}
    if trainer is not None and trainer._table_sharded():
        # a row-sharded table's shards, gathered over ``model`` (every rank
        # calls this): the bundle is the single-device one, rank 0 writes it
        from .train.checkpointing import _map_table, _whole

        state = _map_table(trainer, _whole, state)
    state = {k: v.detach().cpu() for k, v in state.items()}
    fused = model.embeddings.fused
    if fused is not None and fused.dual_container:
        # the stacked training container carries the optimizer's moments in
        # the bottom half of the table: the bundle is the split model with
        # the table half only (serving.py:125-150 of the JAX package)
        cfg = copy.deepcopy(cfg)
        cfg.model_config.extra["table_container"] = "split"
        cfg.model_config.extra.pop("stacked_shards", None)
        key = "embeddings.fused.table"
        from .train.sparse_embedding import split_stacked_planes

        state[key] = split_stacked_planes(state[key], fused.dual_shards)[0].clone()
    mc, dc = cfg.model_config, cfg.data_config
    needs_mask = bool(mc.masked_loss) and mc.task_name in ("msl", "mtmsl")
    escm = mc.model_name in ("escm", "escm_dr")
    meta = {
        "format": 1,
        "model_name": mc.model_name,
        "task_name": mc.task_name,
        "num_domains": int(dc.num_domains),
        "num_heads": 2 if escm else int(cfg.num_tasks),
        "batch_mode": "symbolic",
        "batch_size": None,
        "needs_mask": needs_mask,
        "mask_column": dc.mask_column or None,
        "mask_values": list(dc.mask_values or []),
        "platforms": ["cuda", "cpu"],
        "packing": _packing_schema(layout),
        "features": _feature_specs(layout),
        "config": cfg.to_dict(),
    }
    if trainer is not None and trainer._table_sharded() and torch.distributed.get_rank():
        return meta
    os.makedirs(path, exist_ok=True)
    torch.save(state, os.path.join(path, _PARAMS_FILE))
    with open(os.path.join(path, _META_FILE), "w") as f:
        json.dump(meta, f, indent=1)
    return meta


class ServingBundle:
    """A loaded inference bundle: ``predict(x)`` on the model's device.

    ``x`` is the same dict-of-columns the Trainer takes (or a packed
    ``(ids, dense)`` tuple)."""

    def __init__(self, model, meta: Dict):
        self.model = model
        self.meta = meta
        self.device = next(model.parameters()).device

    @classmethod
    def load(cls, path: str, device=None) -> "ServingBundle":
        """Rebuild the model from ``meta.json`` on ``device`` (the card by
        default: raises when there is none) and load its weights."""
        from .models import get_model

        with open(os.path.join(path, _META_FILE)) as f:
            meta = json.load(f)
        cfg = ExperimentConfig.from_dict(meta["config"])
        layout = _layout_from_specs(meta["features"])
        model = get_model(meta["model_name"], layout, cfg, device=device)
        state = torch.load(os.path.join(path, _PARAMS_FILE),
                           map_location=next(model.parameters()).device,
                           weights_only=True)
        model.load_state_dict(state)
        return cls(model, meta)

    # ------------------------------------------------------------------
    def _run(self, ids: np.ndarray, dense: np.ndarray, dmask) -> np.ndarray:
        dev = self.device
        with torch.inference_mode():
            with span("mmlrec.serve.copy_in"):
                mask = None
                if self.meta["needs_mask"]:
                    mask = torch.from_numpy(dmask).to(dev)
                ids_d, dense_d = torch.from_numpy(ids).to(dev), torch.from_numpy(dense).to(dev)
            with span("mmlrec.serve.forward"):
                probs = self.model(ids_d, dense_d, mask)
            with span("mmlrec.serve.copy_out"):
                if self.meta["model_name"] in ("escm", "escm_dr"):
                    probs = probs[:, [0, 2]]  # [pCTR, pCTCVR] (reference basemodel.py:438-441)
                return probs.cpu().numpy()

    def predict(self, x, batch_size: Optional[int] = None) -> np.ndarray:
        """[N, num_heads] float64 probabilities (Trainer.predict contract,
        reference basemodel.py:395-457)."""
        with span("mmlrec.serve.predict"):
            with span("mmlrec.serve.pack"):
                ids, dense = _pack_from_schema(self.meta["packing"], x)
                dmask = _domain_mask_from_meta(self.meta, x)
                n = len(ids)
                if self.meta["batch_mode"] == "fixed":
                    batch_size = self.meta["batch_size"]
                if batch_size is not None:
                    steps = (n - 1) // batch_size + 1
                    pad = steps * batch_size - n
                    if pad:  # the last row repeated
                        ids, dense, dmask = [
                            None if a is None else np.concatenate([a, np.repeat(a[-1:], pad, 0)])
                            for a in (ids, dense, dmask)]
            if batch_size is None:  # one call, any batch
                return self._run(ids, dense, dmask)[:n].astype(np.float64)
            outs = [
                self._run(
                    ids[s * batch_size : (s + 1) * batch_size],
                    dense[s * batch_size : (s + 1) * batch_size],
                    None if dmask is None else dmask[s * batch_size : (s + 1) * batch_size],
                )
                for s in range(steps)
            ]
            return np.concatenate(outs)[:n].astype(np.float64)
