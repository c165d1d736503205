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

On the card a bundle serves each forward as the replay of a CUDA graph
captured for its row bucket (``ServingBundle``); on the CPU it runs the
model eagerly.

Under a profiler each ``predict`` is one span ``mmlrec.serve.predict``
holding ``mmlrec.serve.pack`` (the columns packed, the domain mask, the
padding; on the card into the bucket's staging) and, once a forward,
``mmlrec.serve.copy_in`` (the copies to the device; on the card the pad
rows of the staging), ``mmlrec.serve.forward`` (the model's launches
issued; on the card ``mmlrec.serve.replay``, the copies and the forward,
or ``mmlrec.serve.capture`` at a bucket's first request) and
``mmlrec.serve.copy_out`` (the wait for the device and the copy back);
``utils/spans.py``.
"""

from __future__ import annotations

import bisect
import copy
import json
import math
import os
import threading
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


def _rows_of(schema: Dict, x) -> int:
    """The rows of a request, as ``_pack_from_schema`` reads them."""
    if isinstance(x, tuple) and len(x) == 2:
        return len(x[0])
    for name in schema["sparse"]:
        return int(np.size(x[name]))
    for v in schema["varlen"]:
        return int(np.size(x[v["name"]])) // v["maxlen"]
    for d in schema["dense"]:
        return int(np.size(x[d["name"]])) // d["dim"]
    return 0


def _pack_from_schema(schema: Dict, x, out: Optional[tuple] = None) -> tuple:
    """Standalone re-implementation of Trainer.pack_inputs driven by the
    bundle's schema (mmlrec_tpu/train/trainer.py:585-614 semantics).  With
    ``out`` (ids, dense), arrays of the request's rows, the two
    concatenations are written into them."""
    if isinstance(x, tuple) and len(x) == 2:
        if out is None:
            return np.asarray(x[0], np.int32), np.asarray(x[1], np.float32)
        for dst, src in zip(out, x):
            np.copyto(dst, src, casting="unsafe")
        return out
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
    if out is not None:
        for dst, parts in zip(out, (ids_parts, dense_parts)):
            if parts:
                np.concatenate(parts, axis=1, out=dst)
        return out
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


def _domain_mask_from_meta(meta: Dict, x, out: Optional[np.ndarray] = None) -> Optional[np.ndarray]:
    """The [n, num_domains] domain mask a bundle that needs one takes, into
    ``out`` when given."""
    col = meta.get("mask_column")
    if not meta["needs_mask"] or not col:
        return None
    vals = np.asarray(x[col])
    if out is None:
        out = np.zeros((len(vals), meta["num_domains"]), np.float32)
    else:
        out[...] = 0.0
    for i, mv in enumerate(meta["mask_values"]):
        out[:, i] = (vals == mv).astype(np.float32)
    return out


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


#: the card's row buckets: the smallest, and how many there are an octave
#: above it (each rounded up to a multiple of 8 rows)
MIN_BUCKET_ROWS = 16
BUCKETS_PER_OCTAVE = 4
#: the largest bucket, unless the bundle's batch size is larger
MAX_BUCKET_ROWS = 4096
#: staging blocks start on 64-byte boundaries (16 four-byte elements)
_BLOCK_ALIGN = 16


def row_buckets(largest: int) -> List[int]:
    """The ladder of row buckets up to ``largest``, its last bucket."""
    ladder, k = [], 0
    while True:
        exact = MIN_BUCKET_ROWS * 2.0 ** (k / BUCKETS_PER_OCTAVE)
        rows = 8 * math.ceil(exact / 8)
        if rows >= largest:
            return ladder + [largest]
        if not ladder or rows > ladder[-1]:
            ladder.append(rows)
        k += 1


def row_chunks(n: int, step: int) -> List[tuple]:
    """(first row, rows) of each forward of an ``n``-row call, ``step`` rows
    a forward."""
    return [(lo, min(step, n - lo)) for lo in range(0, n, step)]


def staging_widths(meta: Dict) -> List[int]:
    """Columns of a bundle's packed ids, its dense values and, when it
    needs one, its domain mask."""
    schema = meta["packing"]
    ids = len(schema["sparse"]) + sum(
        v["maxlen"] + (v["length_name"] is not None) for v in schema["varlen"])
    widths = [ids, sum(d["dim"] for d in schema["dense"])]
    if meta["needs_mask"] and meta.get("mask_column"):
        widths.append(meta["num_domains"])
    return widths


def staging_blocks(flat, rows: int, widths, dtypes) -> list:
    """Views ``[rows, width]`` of the flat 4-byte array ``flat`` (numpy or
    torch), one a width with its dtype, back to back, each block starting
    on a 64-byte boundary; ``staging_size`` is the length ``flat`` needs."""
    views, at = [], 0
    for width, dtype in zip(widths, dtypes):
        views.append(flat[at:at + rows * width].view(dtype).reshape(rows, width))
        at += _aligned(rows * width)
    return views


def staging_size(rows: int, widths) -> int:
    return sum(_aligned(rows * w) for w in widths)


def _aligned(elements: int) -> int:
    return -(-elements // _BLOCK_ALIGN) * _BLOCK_ALIGN


def fill_staging(blocks, n: int, packed=None, lo: int = 0) -> None:
    """Rows ``[lo, lo + n)`` of the ``packed`` arrays (when given: else the
    blocks' first ``n`` rows are filled already) into the staging
    ``blocks``, then every row after them a copy of the last."""
    for i, block in enumerate(blocks):
        if packed is not None:
            block[:n] = packed[i][lo:lo + n]
        block[n:] = block[n - 1]


class _Bucket:
    """One row bucket on the card: a pinned host staging buffer of its
    inputs (ids int32, dense f32 and, when the bundle needs one, the domain
    mask f32) and the device buffer the graph reads, each one flat array so
    one copy moves them; a pinned buffer of the probabilities and the event
    the host waits on.  The graph holds both copies."""

    def __init__(self, rows: int, widths, heads: int, device: torch.device):
        self.rows = rows
        size = staging_size(rows, widths)
        self.host = torch.empty(size, dtype=torch.int32, pin_memory=True)
        self.dev = torch.empty(size, dtype=torch.int32, device=device)
        self.staging = staging_blocks(self.host.numpy(), rows, widths,
                                      (np.int32, np.float32, np.float32))
        self.inputs = staging_blocks(self.dev, rows, widths,
                                     (torch.int32, torch.float32, torch.float32))
        self.out_host = torch.empty((rows, heads), dtype=torch.float32, pin_memory=True)
        self.done = torch.cuda.Event()


class ServingBundle:
    """A loaded inference bundle: ``predict(x)`` on the model's device.

    ``x`` is the same dict-of-columns the Trainer takes (or a packed
    ``(ids, dense)`` tuple).

    On the card a forward of ``n`` rows runs in the smallest row bucket
    (``row_buckets``) of at least ``n`` rows, the rows after the request's
    a copy of its last: its inputs are packed into the bucket's pinned
    staging, and one replay of the CUDA graph captured for the bucket at
    its first request (``train/graphs.StepGraphs``, under
    ``mmlrec.serve.capture``; each replay under ``mmlrec.serve.replay``)
    copies them in, runs the forward and copies the probabilities out to
    pinned memory, whose event the host waits on.  A call above the
    largest bucket runs in forwards of the largest.  One lock a bundle holds the staging, the
    replay and the copy out for one call at a time.  The CPU, a model in
    training mode and a forward that draws from a generator run eagerly.
    ``captures``, ``replays`` and ``eager_forwards`` count the forwards
    each way."""

    def __init__(self, model, meta: Dict):
        self.model = model
        self.meta = meta
        self.device = next(model.parameters()).device
        self.eager_forwards = 0
        self._graphs = None
        self._draws = False
        if self.device.type == "cuda":
            from .train.graphs import StepGraphs

            self._start_buckets(StepGraphs(self.device, capture_span="mmlrec.serve.capture"))

    def _start_buckets(self, graphs) -> None:
        """The bucket path's state: ``graphs`` (a ``StepGraphs``), the ladder,
        the buckets made so far and the lock."""
        self._graphs = graphs
        self._ladder = row_buckets(max(MAX_BUCKET_ROWS, self.meta.get("batch_size") or 0,
                                       self.model.cfg.training_config.train_batch_size))
        self._widths = staging_widths(self.meta)
        self._buckets: Dict[int, _Bucket] = {}
        self._escm_cols = torch.tensor([0, 2], device=self.device)
        self._lock = threading.Lock()

    @property
    def captures(self) -> int:
        """Forwards that captured their bucket's graph (each ran eagerly)."""
        return self._graphs.captures if self._graphs is not None else 0

    @property
    def replays(self) -> int:
        return sum(self._graphs.replays.values()) if self._graphs is not None else 0

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
        self.eager_forwards += 1
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
            if self._graphs is not None and not (self.model.training or self._draws):
                with self._lock, torch.inference_mode():
                    return self._predict_replayed(x, batch_size)
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

    # ------------------------------------------------------------------
    def _predict_replayed(self, x, batch_size: Optional[int]) -> np.ndarray:
        """``predict`` on the card, a forward a bucket's graph."""
        meta = self.meta
        with span("mmlrec.serve.pack"):
            n = _rows_of(meta["packing"], x)
            if n == 0:
                return np.zeros((0, meta["num_heads"]), np.float64)
            if meta["batch_mode"] == "fixed":
                batch_size = meta["batch_size"]
            step = min(batch_size or self._ladder[-1], self._ladder[-1])
            packed = None
            if n <= step:  # one forward: packed straight into its bucket's staging
                blocks = [b[:n] for b in self._bucket(n).staging]
                _pack_from_schema(meta["packing"], x, out=blocks[:2])
                _domain_mask_from_meta(meta, x, out=blocks[2] if len(blocks) > 2 else None)
            else:
                packed = (*_pack_from_schema(meta["packing"], x),
                          _domain_mask_from_meta(meta, x))
        outs = []
        for lo, m in row_chunks(n, step):
            bucket = self._bucket(m)
            with span("mmlrec.serve.copy_in"):
                fill_staging(bucket.staging, m, packed, lo)
            with span("mmlrec.serve.forward"):
                self._forward(bucket)
            with span("mmlrec.serve.copy_out"):
                bucket.done.record()
                bucket.done.synchronize()
                outs.append(bucket.out_host[:m].numpy().astype(np.float64))
        return outs[0] if len(outs) == 1 else np.concatenate(outs)

    def _bucket(self, n: int) -> _Bucket:
        rows = self._ladder[bisect.bisect_left(self._ladder, n)]
        bucket = self._buckets.get(rows)
        if bucket is None:
            bucket = self._buckets[rows] = _Bucket(rows, self._widths, self.meta["num_heads"],
                                                   self.device)
        return bucket

    def _forward(self, bucket: _Bucket) -> None:
        """The staged inputs copied in, the forward and the probabilities
        copied out to ``bucket.out_host``, enqueued: the bucket's graph
        replayed, or at its first request run eagerly and captured."""
        graphs = self._graphs
        if bucket.rows in graphs.graphs:
            with span("mmlrec.serve.replay"):
                graphs.run(bucket.rows, None)
            return
        ids, dense, *mask = bucket.inputs

        def body():
            bucket.dev.copy_(bucket.host, non_blocking=True)
            probs = self.model(ids, dense, mask[0] if mask else None)
            if self.meta["model_name"] in ("escm", "escm_dr"):
                probs = probs.index_select(1, self._escm_cols)  # [pCTR, pCTCVR]
            bucket.out_host.copy_(probs, non_blocking=True)

        before = self._rng_states()
        graphs.run(bucket.rows, body)  # its eager run answers this request
        if any(not torch.equal(a, b) for a, b in zip(before, self._rng_states())):
            # a forward that draws: every later one runs eagerly
            graphs.graphs.pop(bucket.rows)
            self._draws = True

    def _rng_states(self) -> List[torch.Tensor]:
        """The states of the generators a forward could draw from: the
        card's default one and any a module holds."""
        gens = [torch.cuda.default_generators[self.device.index or 0]]
        gens += [m.dropout_generator for m in self.model.modules()
                 if getattr(m, "dropout_generator", None) is not None]
        return [g.get_state() for g in gens]
