"""Dataset staging, per-batch metadata and epoch execution for
``Trainer.fit`` (the port of ``mmlrec_tpu/train/staging.py``).

Everything between the host arrays and the step:

* the dataset staged on the device once per fit (``stage_dataset``; ids
  stay int32 in their own tensor, where the JAX package packs one f32
  matrix) and batches taken from it by index on the device;
* the two-phase step's fit-time resolution of ``table_update`` (with the
  stacked container's demotion) and ``update_space`` and its host metadata
  (``step_metadata``, and ``encoded_step_metadata`` of the epoch's rows:
  numpy or the native pass of ``csrc/step_metadata_host.cpp``, the gather
  route's lists included), with the upload compaction codec
  (``MetaCodec``: uint16 positions, uint8 masks, decoded on the device
  after the per-step slice; the native pass writes that form itself);
* ``make_device_plan``: the fit's data path as its epoch source for
  ``train/fit_loop.py``: ``BlockSource`` (fixed batches, a new order each
  epoch) or ``ShuffleSource`` (full shuffle, epoch e+1's indices and
  metadata built on a worker while epoch e runs: ``fs_host_prep``) over the
  staged dataset and the per-fit buffers the step reads (``Plan``), or
  ``StreamSource`` for a dataset over the cap, batches built by a
  prefetch worker.

``drive_steps`` is where ``scan_steps`` acts.  The JAX package runs L steps
as one ``lax.scan`` dispatch; here a step reads its batch, weights and
metadata from per-fit device buffers at ``epoch_step``, a device counter it
advances itself, so the same step is captured once as a CUDA graph per
(kind, batch, gate-warmup variant) and replayed L times per chunk without
the host reading anything (``graphs.StepGraphs``).  Losses and
probabilities go into device buffers that the fit reads once per epoch.
With ``scan_steps`` 0 the step runs eagerly; on the CPU every chunk runs as
eager steps.  Either way each step does the same operations on the same
values, so the paths are bitwise equal.

Uploads on the card come from pinned memory, without a sync; the worker
threads upload on a side stream and order the main stream after them with
an event.

Under a mesh (``trainer._dp``) rank r stages its contiguous rows of the
dataset, padded to divide by the ranks, as one int32 matrix (the ids, then
the bits of the f32 columns: staging.py:48-77), and a step fetches its
rows of the global batch with ``distributed_take``, whose sums are then
exact; this needs the batch to divide by the ranks, else the fit streams,
each batch's rows split by ``shard_batch`` or, when they do not divide,
every rank taking all of them (staging.py:716-719).  Eval batches are
split the same way, or whole (``prepare_eval_tensors``).
"""

from __future__ import annotations

import warnings
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..parallel.mesh import batch_rows, distributed_take, shard_batch
from ..utils.spans import enabled as span_on, timed
from .sparse_embedding import (SparseAdamPackedState, batch_step_metadata, epoch_step_metadata,
                               to_split_state)


# ---------------------------------------------------------------------------
# uploads
# ---------------------------------------------------------------------------


def to_device(trainer, a: Optional[np.ndarray]) -> Optional[torch.Tensor]:
    """A host array on the trainer's device; on the card through pinned
    memory and a copy that does not make the host wait."""
    if a is None:
        return None
    t = torch.from_numpy(np.ascontiguousarray(a))
    if trainer.device.type != "cuda":
        return t
    return t.pin_memory().to(trainer.device, non_blocking=True)


class Upload(NamedTuple):
    """Tensors uploaded on a side stream, and the event after their copies."""

    tensors: tuple
    event: Optional[torch.cuda.Event]


def upload_async(trainer, arrays) -> Upload:
    """Upload ``arrays`` (None entries stay None) from the calling thread:
    on the card on the trainer's side stream, recorded by an event that
    ``claim`` orders the main stream after."""
    if trainer.device.type != "cuda":
        return Upload(tuple(to_device(trainer, a) for a in arrays), None)
    stream = trainer._upload_stream
    with torch.cuda.stream(stream):
        out = tuple(to_device(trainer, a) for a in arrays)
        event = torch.cuda.Event()
        event.record(stream)
    return Upload(out, event)


def claim(up: Upload) -> tuple:
    """The uploaded tensors, usable on the current stream."""
    if up.event is not None:
        current = torch.cuda.current_stream()
        current.wait_event(up.event)
        for t in up.tensors:
            if t is not None:
                t.record_stream(current)  # the side stream must not reuse them early
    return up.tensors


# ---------------------------------------------------------------------------
# dataset staging
# ---------------------------------------------------------------------------


class Staged(NamedTuple):
    """The dataset on the device: ids [N, S] int32, dense [N, Dd], labels
    [N, T] and the domain mask [N, D] (or None), f32."""

    ids: torch.Tensor
    dense: torch.Tensor
    y: torch.Tensor
    dmask: Optional[torch.Tensor]


class RankStaged(NamedTuple):
    """Under a mesh: this rank's contiguous rows of the dataset as one int32
    matrix, the ids and then the int32 bits of the f32 dense features,
    labels and mask, and the widths of the four (the mask's 0 without one)."""

    rows: torch.Tensor
    widths: Tuple[int, int, int, int]


def stage_dataset(trainer, ids, dense, y, dmask):
    """Upload the dataset once (staging.py:48-77): whole on one device, as
    ``Staged``; under a mesh this rank's rows ``[r N / n, (r + 1) N / n)``
    of it padded with zero rows to N divisible by n (no index reaches a
    pad), as ``RankStaged``."""
    if trainer._dp is None:
        return Staged(*(to_device(trainer, a) for a in (ids, dense, y, dmask)))
    dp = trainer._dp
    floats = [a for a in (dense, y, dmask) if a is not None]
    packed = np.concatenate([np.asarray(ids, np.int32)]
                            + [np.ascontiguousarray(a, np.float32).view(np.int32)
                               for a in floats], axis=1)
    pad = (-len(packed)) % dp.world
    if pad:
        packed = np.concatenate([packed, np.zeros((pad, packed.shape[1]), np.int32)])
    per = len(packed) // dp.world
    widths = (ids.shape[1], dense.shape[1], y.shape[1], 0 if dmask is None else dmask.shape[1])
    return RankStaged(to_device(trainer, packed[dp.rank * per:(dp.rank + 1) * per]), widths)


def fetch_staged_rows(trainer, staged, idx: torch.Tensor) -> Staged:
    """Rows ``idx`` [B] of the staged dataset, taken on the device; under a
    mesh this rank's rows of the global batch, by ``distributed_take``
    (staging.py:95-101), bitwise the rows ``index_select`` would take."""
    if isinstance(staged, Staged):
        return Staged(*(None if a is None else a.index_select(0, idx) for a in staged))
    rows = distributed_take(staged.rows, idx, trainer._dp)
    S, Dd, T, Dm = staged.widths
    ids = rows[:, :S].contiguous()
    cols = rows[:, S:].view(torch.float32)
    dense, y = cols[:, :Dd].contiguous(), cols[:, Dd:Dd + T].contiguous()
    return Staged(ids, dense, y, cols[:, Dd + T:].contiguous() if Dm else None)


def split_staged(trainer, rows: Staged, weight: torch.Tensor) -> tuple:
    """(ids, dense, y, dmask, weight): the step's batch."""
    return (*rows, weight)


# ---------------------------------------------------------------------------
# table-update resolution + per-batch metadata
# ---------------------------------------------------------------------------


def resolve_table_update(trainer, batch_size: int) -> None:
    """Enforce the unique-metadata headroom at fit time (staging.py:132-202):
    the write-kernel update needs the physical rows to exceed Kp, the
    padded per-batch id count, which depends on the fit's batch.  An update
    resolved from ``"auto"`` falls back to the scatter update; an explicit
    one raises.  A stacked container raises too, unless
    ``resolve_table_container`` opted into it (``_table_container_auto``)
    and no step has run: then the fused table is rebuilt as the split one
    from the container's table plane (the same bits), with a warning, and
    the update demotes.  Packed moments that earlier fits left become split
    bfloat16 moments, bit for bit."""
    if trainer.table_update == "scatter":
        return
    K = batch_size * len(trainer.layout.sparse_slots)
    Kp = -(-K // 256) * 256
    if trainer._emb_phys_rows > Kp:
        return
    mc = trainer.cfg.model_config
    stacked = trainer.table_container == "stacked"
    if (stacked and mc.extra.get("_table_container_auto") and trainer._table_update_auto
            and trainer.opt_state is None):
        warnings.warn(
            f"table_container='stacked' was auto-engaged at the config batch size but "
            f"fit(batch_size={batch_size}) breaks the unique-metadata headroom (physical "
            f"rows {trainer._emb_phys_rows} <= Kp={Kp}); demoting to the split layout and "
            "the scatter update")
        mc.extra["table_container"] = "split"
        mc.extra.pop("_table_container_auto", None)
        trainer.model.embeddings.fused.to_split_container()
        trainer.table_container = "split"
        trainer.pair_gather = "split"
        trainer.dedup_route = "scatter"
    elif not trainer._table_update_auto or stacked:
        raise ValueError(
            f"table_update={trainer.table_update!r}"
            + (" with table_container='stacked'" if stacked else "")
            + f" needs the physical table ({trainer._emb_phys_rows} rows) to exceed the "
            f"padded per-batch id count Kp={Kp}; use a larger vocabulary, a smaller batch, "
            "or table_update='scatter'")
    trainer.table_update = "scatter"
    trainer._packed_moments = False
    if isinstance(trainer.table_opt, SparseAdamPackedState):
        trainer.table_opt = to_split_state(trainer.table_opt)


def resolve_update_space(trainer, flat: np.ndarray) -> None:
    """Resolve ``update_space="auto"`` from the FIRST metadata batch
    (staging.py:205-222): slot space when the container is stacked, the
    route is the gather route and at least 25% of the batch's ids repeat a
    physical row; else position.  Sticky for the trainer's life, so the
    captured step never flips within a fit."""
    if trainer.update_space != "auto":
        return
    if trainer.table_container != "stacked" or trainer.dedup_route != "gather":
        trainer.update_space = "position"
        return
    P = trainer._emb_pack_factor
    K = flat.shape[1]
    dup = 1.0 - len(np.unique(flat[0] // P if P > 1 else flat[0])) / K
    trainer.update_space = "slot" if dup >= 0.25 else "position"


def _update_kwargs(trainer) -> dict:
    """``batch_step_metadata``'s arguments for the fit's update: none for
    the scatter update's (inv, rep); the physical rows, and under the gather
    route its lists above the trainer's floor, for the others."""
    if trainer.table_update == "scatter":
        return {}
    return dict(pack_factor=trainer._emb_pack_factor, n_phys_rows=trainer._emb_phys_rows,
                want_route=trainer.dedup_route == "gather", r_cap_min=trainer._route_r_cap)


def _raise_route_floor(trainer, meta: tuple) -> None:
    if len(meta) > 6:
        trainer._route_r_cap = max(trainer._route_r_cap, meta[7].shape[1], meta[9].shape[1])


def step_metadata(trainer, flat: np.ndarray) -> tuple:
    """Host metadata of flat [steps, K] logical ids (staging.py:225-250):
    (inv, rep) for the scatter update, plus (pids, pinv, nuniq, prep) for
    the write-kernel and unique updates, plus the gather route's five lists
    under ``dedup_route="gather"``, all from one sort.  The route lists'
    widths never shrink: the trainer keeps the largest it has made
    (``_route_r_cap``, one floor for both), so the captured step's buffers
    change only when a batch needs more."""
    resolve_update_space(trainer, flat)
    meta = batch_step_metadata(flat, **_update_kwargs(trainer))
    _raise_route_floor(trainer, meta)
    return meta


def rows_step_metadata(trainer, ids: np.ndarray, rows: np.ndarray,
                       widths: Optional[tuple] = None, out: Optional[dict] = None):
    """``step_metadata`` of the steps whose rows of the host ids [N, S] are
    ``rows`` [steps, B], the ids read and offset inside the native pass
    (``epoch_step_metadata``; ``widths`` and ``out`` as there): (metadata,
    whether the pass built it)."""
    if trainer.update_space == "auto":
        resolve_update_space(trainer, flat_ids(trainer, ids[rows[0]], 1))
    meta, native = epoch_step_metadata(ids, rows, trainer._host_offsets, widths=widths,
                                       out=out, **_update_kwargs(trainer))
    _raise_route_floor(trainer, meta)
    return meta, native


def encoded_step_metadata(trainer, ids: np.ndarray, rows: np.ndarray,
                          out: Optional[dict] = None):
    """The upload form of ``rows_step_metadata`` under the fit's codec,
    and whether the native pass built it.  Once the fit's first build has
    fixed the codec the pass writes that form itself (``MetaCodec.widths``),
    into ``out``'s buffers where given; the first build and the numpy
    fallback are encoded here."""
    codec = trainer._meta_codec
    widths = codec.widths() if isinstance(codec, MetaCodec) else None
    meta, native = rows_step_metadata(trainer, ids, rows, widths, out)
    if widths is None or not native:
        meta = encode_meta(trainer, meta)
    return tuple(upload_form(a) for a in meta), native


def flat_ids(trainer, ids: np.ndarray, steps: int) -> np.ndarray:
    """[steps * B, S] host ids -> [steps, B * F] fused logical ids."""
    F = len(trainer.layout.sparse_slots)
    return (np.asarray(ids)[:, :F].astype(np.int64) + trainer._host_offsets).reshape(steps, -1)


# ---------------------------------------------------------------------------
# metadata upload compaction (staging.py:253-399)
# ---------------------------------------------------------------------------
#
# While K <= 65536 every position fits uint16 and the 0/1 masks fit uint8,
# so the stacks upload at a half or a quarter of their width and decode on
# the device right after the per-step slice.  A drop value that may equal
# 65536 (slot16) is stored as 65535 and remapped on decode: a real 65535
# never reaches it (see the JAX module).  uint16 travels as the int16 of
# the same bits and decodes as ``& 0xFFFF``.

_U16_MAX = 65535
_KIND_WIDTHS = {"idx16": 2, "slot16": 2, "mask8": 1, "raw": 4, "dead": 0}


class MetaCodec:
    """Per-fit encoder/decoder of the metadata tuple: ``encode`` maps the
    host [steps, X] stacks to their upload form (numpy, as the JAX codec
    makes them); ``decode`` maps one sliced device row back to the exact
    int32 / f32 arrays the step reads."""

    def __init__(self, kinds: Tuple[Tuple[str, int], ...]):
        # kinds[i] = (kind, sentinel remap), kind in
        # {"idx16", "mask8", "slot16", "raw", "dead"}
        self.kinds = kinds

    def widths(self) -> tuple:
        """Each entry's bytes an element in the upload form, 0 for a dead
        one: the native pass writes the form from these."""
        return tuple(_KIND_WIDTHS[kind] for kind, _ in self.kinds)

    def encode(self, meta: tuple) -> tuple:
        out = []
        for (kind, sent), a in zip(self.kinds, meta):
            if kind == "idx16":
                out.append(a.astype(np.uint16))
            elif kind == "slot16":
                out.append(np.where(a >= sent, _U16_MAX, a).astype(np.uint16))
            elif kind == "mask8":
                out.append(a.astype(np.uint8))
            elif kind == "dead":
                out.append(np.zeros((a.shape[0], 1), np.uint8))
            else:
                out.append(a)
        return tuple(out)

    def decode(self, sliced: tuple) -> tuple:
        out = []
        for (kind, sent), a in zip(self.kinds, sliced):
            if kind in ("idx16", "slot16"):
                a = a.to(torch.int32) & 0xFFFF
                out.append(torch.where(a == _U16_MAX, sent, a) if kind == "slot16" else a)
            elif kind == "mask8":
                out.append(a.to(torch.float32))
            elif kind == "dead":
                out.append(a.to(torch.int32))
            else:
                out.append(a)
        return tuple(out)


def meta_codec(trainer, meta: tuple) -> Optional[MetaCodec]:
    """The compaction codec of this fit's metadata layout (staging.py:
    329-371), or None when it cannot apply (K or Kp above 65,536) or
    ``model_config.extra['meta_compact']`` is false.  Under the gather
    route (the eleven-entry tuple) ``inv`` is dead (the duplicate lists
    replace its scatter) and so is ``pinv`` in position space (``accperm``
    replaces it); the drop values Kp and K ride as ``slot16``."""
    if not trainer.cfg.model_config.extra.get("meta_compact", True):
        return None
    K = meta[0].shape[1]
    if K > _U16_MAX + 1:
        return None
    n = len(meta)
    route = n > 6
    slot_mode = trainer.update_space == "slot"
    unique_update = trainer.table_update != "scatter"
    Kp = meta[2].shape[1] if unique_update else 0
    if unique_update and Kp > _U16_MAX + 1:
        return None
    kinds: List[Tuple[str, int]] = [("dead", 0) if route else ("idx16", 0), ("mask8", 0)]
    if unique_update:
        kinds += [("raw", 0), ("idx16", 0) if (slot_mode or not route) else ("dead", 0),
                  ("raw", 0), ("mask8", 0)]
        if route:
            kinds += [("idx16", 0), ("idx16", 0), ("slot16", Kp), ("idx16", 0), ("slot16", K)]
    assert len(kinds) == n, (len(kinds), n)
    return MetaCodec(tuple(kinds))


def encode_meta(trainer, meta: tuple) -> tuple:
    """The upload form of ``meta`` under the fit's codec (made from the
    first stacks, then kept: the step reads one encoded layout)."""
    if trainer._meta_codec == "unset":
        trainer._meta_codec = meta_codec(trainer, meta)
    return meta if trainer._meta_codec is None else trainer._meta_codec.encode(meta)


def upload_form(a: np.ndarray) -> np.ndarray:
    """uint16 travels as the int16 of the same bits."""
    return a.view(np.int16) if a.dtype == np.uint16 else a


def slice_dedup(trainer, dedup2d, s: torch.Tensor) -> Optional[tuple]:
    """Row ``s`` ([1] device index) of the per-epoch metadata stacks,
    decoded to the step's dtypes; None without stacks."""
    if dedup2d is None:
        return None
    sliced = tuple(a.index_select(0, s)[0] for a in dedup2d)
    codec = trainer._meta_codec
    return sliced if codec in (None, "unset") else codec.decode(sliced)


# ---------------------------------------------------------------------------
# the fit's data paths: one epoch source each (staging.py:407-518)
# ---------------------------------------------------------------------------


class EpochResult(NamedTuple):
    """An epoch of S members (1 but for a stacked suite): ``loss`` [steps,
    S] and ``probs`` [steps, S, B, heads] (or None) on the device; per
    member ``rows`` = (the flattened probabilities the host's train metrics
    read, their rows of the source's ``y``); a member's real rows ``take``;
    each batch's (probabilities, real rows) among those read, ``spans``;
    ``counted`` = (the staged labels, per member (label rows, weights))
    where one device stages the whole dataset, else None."""

    loss: torch.Tensor
    probs: Optional[torch.Tensor]
    rows: tuple
    take: int
    spans: list
    counted: Optional[tuple]


class EpochSource:
    """A fit's data path.  Each epoch ``prepare(epoch, steps, timing)``
    makes its draws from ``rng`` and ``run(steps, timing)`` issues its steps
    and returns an ``EpochResult``, ``timing`` the epoch's ``fit_timing``."""

    def __init__(self, trainer, y, batch_size: int, rng):
        self.trainer, self.y, self.batch, self.rng = trainer, y, batch_size, rng
        self.n = len(y)
        self.steps = (self.n - 1) // batch_size + 1

    def close(self) -> None:
        """Stop the worker a source may run."""


class Plan(EpochSource):
    """A staged path's per-fit buffers, which a captured step reads at
    ``epoch_step``: ``arg`` (the epoch's [steps, B] row indices, or [steps]
    batch starts in block mode), ``w2d`` [steps, B] and ``dedup`` (the
    encoded metadata stacks); it writes ``loss`` [steps], ``probs``."""

    staged = None  # Staged, or RankStaged under a mesh
    #: under a mesh, this rank's rows of a global batch (``batch_rows``)
    rank_rows: Optional[slice] = None
    arg = probs = arange_b = dedup = None

    def __init__(self, trainer, y, batch_size, rng, members: tuple = ()):
        super().__init__(trainer, y, batch_size, rng)
        dev = trainer.device
        if trainer._dp is not None:
            self.rank_rows = batch_rows(batch_size, trainer._dp)
        self.epoch_step = torch.zeros(1, dtype=torch.int64, device=dev)
        self.loss = torch.zeros(self.steps, *members, dtype=torch.float32, device=dev)
        self.w2d = torch.zeros(self.steps, batch_size, dtype=torch.float32, device=dev)

    def _result(self, steps, rows, take, spans) -> EpochResult:
        """One member's, unless ``loss`` has a member axis."""
        loss = self.loss[:steps]
        probs = self.probs[:steps] if self.trainer.metric_fns else None
        one = loss.dim() == 1
        counted = None
        if probs is not None and isinstance(self.staged, Staged):
            idx = self.arg[:steps]  # the staged row of each probability
            if self.arange_b is not None:  # block mode's batch starts
                idx = idx[:, None] + self.arange_b
            w = self.w2d[:steps].reshape(-1)
            counted = (self.staged.y, tuple((i.reshape(-1), w) for i in
                                            ([idx] if one else idx.unbind(1))))
        if one:
            loss, probs = loss[:, None], None if probs is None else probs.unsqueeze(1)
        return EpochResult(loss, probs, rows, take, spans, counted)


class BlockSource(Plan):
    """``shuffle="block"`` (staging.py:437-444, 625-655): the rows permuted
    once, the tail padded with row 0 at weight 0, the weights and, with
    host metadata, every batch's metadata staged once a fit; each epoch a
    new batch order, by which one index take each reorders them."""

    def __init__(self, trainer, ids, dense, y, dmask, batch_size, rng):
        pre = rng.permutation(len(ids))
        ids, dense, y = ids[pre], dense[pre], y[pre]
        dmask = dmask[pre] if dmask is not None else None
        super().__init__(trainer, y, batch_size, rng)
        steps, dev = self.steps, trainer.device
        self.block_w = np.ones((steps, batch_size), np.float32)
        pad_tail = steps * batch_size - self.n
        if pad_tail:
            self.block_w[-1, batch_size - pad_tail:] = 0.0

        def padded(a):
            return np.concatenate([a, np.repeat(a[:1], pad_tail, 0)]) if pad_tail else a

        ids = padded(ids)
        self.staged = stage_dataset(trainer, ids, padded(dense), padded(y),
                                    padded(dmask) if dmask is not None else None)
        self.block_w_dev = to_device(trainer, self.block_w)
        self.arg = torch.zeros(steps, dtype=torch.int64, device=dev)
        self.arange_b = torch.arange(batch_size, dtype=torch.int64, device=dev)
        self.block_dedup = None
        self.meta_native = 0.0  # the epochs' metadata: these stacks, from the pass or not
        if trainer.two_phase_embedding and not trainer.device_metadata:
            meta, native = encoded_step_metadata(
                trainer, ids, np.arange(steps * batch_size).reshape(steps, batch_size))
            self.block_dedup = tuple(to_device(trainer, a) for a in meta)
            self.dedup = tuple(_buffer_like(trainer, steps, a) for a in self.block_dedup)
            self.meta_native = float(native)

    def prepare(self, epoch, steps, timing) -> None:
        self.batch_order = self.rng.permutation(self.steps)[:steps]
        timing["meta_native"] = self.meta_native

    def run(self, steps, timing) -> EpochResult:
        tr, B, batch_order = self.trainer, self.batch, self.batch_order
        self.epoch_step.zero_()
        order = to_device(tr, batch_order.astype(np.int64))
        _rows_into(self.arg, steps, order * B)
        _rows_into(self.w2d, steps, self.block_w_dev.index_select(0, order))
        if self.block_dedup is not None:
            for buf, a in zip(self.dedup, self.block_dedup):
                _rows_into(buf, steps, a.index_select(0, order))
        drive_steps(tr, "slice", self, B, steps)
        valid = self.block_w[batch_order].reshape(-1) > 0
        host_rows = (np.arange(self.steps * B).reshape(self.steps, B)
                     [batch_order].reshape(-1)[valid])
        spans = [(int(c), int(c)) for c in self.block_w[batch_order].sum(axis=1)]
        return self._result(steps, ((valid, host_rows),), int(valid.sum()), spans)


class ShuffleSource(Plan):
    """A full shuffle, or the data order (staging.py:658-688): each epoch's
    row indices and host metadata from ``fs_host_prep``; with ``epochs`` a
    worker builds epoch e+1's while e runs, its permutation drawn at
    submission, in the synchronous loop's order (staging.py:489-515)."""

    def __init__(self, trainer, ids, dense, y, dmask, batch_size, rng, shuffle, epochs):
        super().__init__(trainer, y, batch_size, rng)
        self.ids, self.shuffle, self.epochs = ids, shuffle, epochs
        self.staged = stage_dataset(trainer, ids, dense, y, dmask)
        self.arg = torch.zeros(self.steps, batch_size, dtype=torch.int64,
                               device=trainer.device)
        self.arange_all = torch.arange(self.steps * batch_size, device=trainer.device)
        self.pool = ThreadPoolExecutor(max_workers=1) if epochs else None
        self.ahead = None
        # the metadata's host buffers, rewritten by each epoch's build: on
        # the card the upload copies them to pinned memory first, elsewhere
        # the uploaded tensors share them, so each build takes new ones
        self.meta_out = {} if trainer.device.type == "cuda" else None

    def prepare(self, epoch, steps, timing) -> None:
        if self.ahead is not None:
            self.prep, self.ahead = self.ahead.result(), None
        else:
            order = self.rng.permutation(self.n) if self.shuffle else np.arange(self.n)
            self.prep = fs_host_prep(self.trainer, self.ids, self.n, self.batch, order, steps,
                                     None, self.meta_out)
        if self.pool is not None and epoch + 1 < self.epochs:
            self.ahead = self.pool.submit(fs_host_prep, self.trainer, self.ids, self.n,
                                          self.batch, self.rng.permutation(self.n),
                                          self.steps, span_on(), self.meta_out)
        timing.update(self.prep.host)  # built for this epoch, wherever it ran

    def run(self, steps, timing) -> EpochResult:
        tr, B = self.trainer, self.batch
        idx_full, take, up, _ = self.prep
        self.epoch_step.zero_()
        idx2d, *meta = claim(up)
        _rows_into(self.arg, steps, idx2d)
        _rows_into(self.w2d, steps, (self.arange_all[:steps * B] < take).to(torch.float32)
                   .view(steps, B))
        if meta:
            if self.dedup is None or any(b.shape[1:] != a.shape[1:]
                                         for b, a in zip(self.dedup, meta)):
                # the first stacks, or route lists that outgrew the floor (a
                # later epoch of a full shuffle may need wider ones): new
                # buffers, on which the step is captured anew
                self.dedup = tuple(_buffer_like(tr, self.steps, a) for a in meta)
                tr._graphs.discard("gather")
            for buf, a in zip(self.dedup, meta):
                _rows_into(buf, steps, a)
        drive_steps(tr, "gather", self, B, steps)
        spans = [(min(B, take - s * B),) * 2 for s in range(steps)]
        return self._result(steps, ((slice(0, take), idx_full[:take]),), take, spans)

    def close(self) -> None:
        if self.pool is not None:
            self.pool.shutdown(wait=True, cancel_futures=True)
            self.pool = None


class StreamSource(EpochSource):
    """A dataset over the cap (staging.py:691-754), in a new permutation an
    epoch, or in data order for ``shuffle`` False or ``"block"``
    (trainer.py:1538).  One prefetch worker builds the batches (slices,
    host metadata, pinned upload on a side stream) ``prefetch_batches``
    ahead, in order; the last one's pads (row 0, weight 0) count in the
    train metrics, as JAX's do (staging.py:748-752)."""

    def __init__(self, trainer, ids, dense, y, dmask, batch_size, rng, shuffle):
        super().__init__(trainer, y, batch_size, rng)
        self.ids, self.dense, self.dmask, self.shuffle = ids, dense, dmask, shuffle

    def prepare(self, epoch, steps, timing) -> None:
        self.order = (self.rng.permutation(self.n) if self.shuffle is True
                      else np.arange(self.n))

    def run(self, steps, timing) -> EpochResult:
        tr, B, order, ids = self.trainer, self.batch, self.order, self.ids
        host_meta = tr.two_phase_embedding and not tr.device_metadata
        on = span_on()

        def make_batch(s):
            idx = order[s * B:(s + 1) * B]
            weight = np.ones(B, np.float32)
            pad = B - len(idx)
            if pad:
                weight[len(idx):] = 0.0
                idx = np.concatenate([idx, np.zeros(pad, np.int64)])
            idx_r, weight_r = (idx, weight) if tr.mesh is None else shard_batch(
                (idx, weight), tr.mesh)  # this rank's rows, or the whole batch
            arrays = [ids[idx_r], self.dense[idx_r], self.y[idx_r],
                      self.dmask[idx_r] if self.dmask is not None else None, weight_r]
            host = {"meta_s": 0.0, "upload_s": 0.0}
            native = False
            if host_meta:
                with timed(host, "meta_s", "mmlrec.fit.worker.metadata", on):
                    meta, native = rows_step_metadata(tr, ids, idx[None])
                    arrays += [a[0] for a in meta]
            with timed(host, "upload_s", "mmlrec.fit.worker.upload", on):
                up = upload_async(tr, arrays)
            return weight, up, host, native

        losses, probs, spans = [], [], []
        depth = max(int(tr._prefetch_batches), 1)
        natives = []
        with ThreadPoolExecutor(max_workers=1) as pool:
            pending = deque(pool.submit(make_batch, s) for s in range(min(depth, steps)))
            for s in range(steps):
                weight, up, host, native = pending.popleft().result()
                natives.append(native)
                for key, seconds in host.items():
                    timing[key] += seconds
                if s + depth < steps:
                    pending.append(pool.submit(make_batch, s + depth))
                batch = claim(up)
                tr._reseed()
                total, _, p = tr._step_on_batch(*batch[:5], meta=batch[5:] or None)
                losses.append(total)
                if tr.metric_fns:
                    probs.append(p)
                spans.append((len(weight), int(weight.sum())))
        timing["meta_native"] = float(host_meta and all(natives))
        take = min(self.n, steps * B)
        rows = np.zeros(steps * B, np.int64)
        rows[:take] = order[:take]
        return EpochResult(torch.stack(losses).unsqueeze(1),
                           torch.stack(probs).unsqueeze(1) if probs else None,
                           ((slice(None), rows),), take, spans, None)


def _buffer_like(trainer, rows: int, a: torch.Tensor) -> torch.Tensor:
    return torch.zeros((rows,) + tuple(a.shape[1:]), dtype=a.dtype, device=trainer.device)


def make_device_plan(trainer, ids, dense, y, dmask, batch_size, shuffle, rng, epochs,
                     initial_epoch, max_steps) -> EpochSource:
    """The fit's data path, decided once, as its epoch source: staged when
    the dataset's bytes x 2 are under ``trainer._device_data_bytes_cap``
    (4 GB; a mesh's batch must divide by its ranks, staging.py:427-437), in
    blocks or shuffled (the worker for two-phase fits of epochs > 1 whose
    ``max_steps``, if set, cannot cut an epoch short: the worker builds
    whole epochs), else streamed."""
    dataset_bytes = ids.nbytes + dense.nbytes + y.nbytes
    cap, dp = trainer._device_data_bytes_cap, trainer._dp
    staged = (dataset_bytes * 2 < cap if dp is None
              else batch_rows(batch_size, dp) is not None and dataset_bytes * 2 < cap * dp.world)
    if not staged:
        return StreamSource(trainer, ids, dense, y, dmask, batch_size, rng, shuffle)
    if shuffle == "block":
        return BlockSource(trainer, ids, dense, y, dmask, batch_size, rng)
    steps = (len(y) - 1) // batch_size + 1
    capped = max_steps and max_steps < (epochs - initial_epoch) * steps
    ahead = (shuffle is True and trainer.two_phase_embedding and not capped
             and trainer._prefetch_batches > 0 and epochs - initial_epoch > 1)
    return ShuffleSource(trainer, ids, dense, y, dmask, batch_size, rng, shuffle,
                         epochs if ahead else None)


# ---------------------------------------------------------------------------
# eval tensor staging (staging.py:526-586)
# ---------------------------------------------------------------------------


class EvalTensors(NamedTuple):
    """[steps, B, ...] device tensors of a fixed eval set and its row count;
    ``split``: they hold this rank's rows of each batch, [steps, B / n, ...]."""

    ids: torch.Tensor
    dense: torch.Tensor
    dmask: Optional[torch.Tensor]
    n: int
    split: bool = False


def prepare_eval_tensors(trainer, ids, dense, dmask, batch_size: int,
                         split: bool = True) -> EvalTensors:
    """Pad with the last row to whole batches and upload once; the mask only
    when the model reads it (``masked_loss``).  Under a mesh each batch's
    rows are split over the ranks when ``split`` and the batch divides by
    them, else every rank holds them all (eval_batch_spec, staging.py:
    526-560)."""
    n = len(ids)
    steps = (n - 1) // batch_size + 1
    pad = steps * batch_size - n
    if not (trainer.cfg.model_config.masked_loss and dmask is not None):
        dmask = None
    rows = batch_rows(batch_size, trainer._dp) if split and trainer._dp is not None else None

    def prep(a):
        if a is None:
            return None
        if pad:
            a = np.concatenate([a, np.repeat(a[-1:], pad, axis=0)])
        a = a.reshape(steps, batch_size, *a.shape[1:])
        return to_device(trainer, a if rows is None else a[:, rows])

    return EvalTensors(prep(ids), prep(dense), prep(dmask), n, rows is not None)


def prepare_metric_tensors(trainer, y, total: int):
    """(labels, weights) on the device for ``total`` staged rows: labels
    padded with their last row, weight 1 on the real rows and 0 on the pads
    (staging.py:563-573)."""
    y2 = np.asarray(y, np.float32)
    n = len(y2)
    if total > n:
        y2 = np.concatenate([y2, np.repeat(y2[-1:], total - n, axis=0)])
    return (to_device(trainer, y2),
            to_device(trainer, (np.arange(total) < n).astype(np.float32)))


def prepare_mask_tensor(trainer, test_mask, total: int):
    """The [N, D] test mask padded to the staged length with all-zero rows."""
    if test_mask is None:
        return None
    tm = np.asarray(test_mask, np.float32)
    if total > len(tm):
        tm = np.concatenate([tm, np.zeros((total - len(tm),) + tm.shape[1:], np.float32)])
    return to_device(trainer, tm)


# ---------------------------------------------------------------------------
# the steps and the epochs' host prep (staging.py:594-780)
# ---------------------------------------------------------------------------


#: the keys of each epoch's ``Trainer.fit_timing`` entry, every one present
#: (0 where its phase did not run); on the card also ``steps_device_s``.
#: ``meta_native`` is 1.0 in an epoch whose host step metadata the native
#: pass built (a block fit's, built once at staging, counts in each epoch);
#: ``metrics_device`` is 1.0 in an epoch whose train metrics were counted
#: on the device
TIMING_KEYS = ("prep_s", "meta_s", "upload_s", "meta_native", "issue_s", "sync_s", "metrics_s",
               "metrics_device", "val_s", "captures", "capture_s")


def drive_steps(trainer, kind: str, plan: Plan, batch_size: int, steps_this_epoch: int) -> None:
    """Run one epoch's steps on the staged path: chunks of ``scan_steps``
    graph replays (the whole epoch for ``true``), or eager steps for 0, in
    debug mode and on the CPU."""
    body = trainer._staged_step_body(kind, plan, batch_size)
    key = (kind, batch_size, trainer._gate_warmup_active)
    scan = trainer._scan_steps
    graphs = trainer._graphs if scan and not trainer.debug and trainer._capturable else None
    pos = 0
    while pos < steps_this_epoch:
        L = (steps_this_epoch - pos if scan < 0
             else min(scan, steps_this_epoch - pos) if scan else 1)
        for _ in range(L):
            trainer._reseed()
            if graphs is None:
                body()
            else:
                graphs.run(key, body)
        pos += L


def _rows_into(buffer: torch.Tensor, steps: int, values: torch.Tensor) -> None:
    buffer[:steps].copy_(values)


class HostPrep(NamedTuple):
    """A full-shuffle epoch's host prep: its padded row indices, the real
    rows among them, their upload, and the host seconds of building the
    metadata (``meta_s``) and of the upload (``upload_s``), with
    ``meta_native``."""

    idx: np.ndarray
    take: int
    upload: Upload
    host: dict


def fs_host_prep(trainer, ids, n, batch_size, order_e, steps_e, on=None, out=None) -> HostPrep:
    """Full-shuffle epoch host prep (staging.py:757-780): the padded index
    vector and, for the two-phase step with host metadata, the epoch's
    metadata stacks in their upload form (``encoded_step_metadata``, in
    ``out``'s buffers where given), uploaded from the calling thread (the
    worker, when threaded ahead) so the copies ride during the previous
    epoch's steps.  ``on``: the span gate the submitting thread read."""
    padded_e = steps_e * batch_size
    idx_e = np.zeros(padded_e, np.int64)
    take_e = min(n, padded_e)
    idx_e[:take_e] = order_e[:take_e]
    idx2d = idx_e.reshape(steps_e, batch_size)
    arrays = [idx2d]
    host = {"meta_s": 0.0, "upload_s": 0.0, "meta_native": 0.0}
    if trainer.two_phase_embedding and not trainer.device_metadata:
        with timed(host, "meta_s", "mmlrec.fit.worker.metadata", on):
            meta, native = encoded_step_metadata(trainer, ids, idx2d, out)
            arrays += meta
        host["meta_native"] = float(native)
    with timed(host, "upload_s", "mmlrec.fit.worker.upload", on):
        up = upload_async(trainer, arrays)
    return HostPrep(idx_e, take_e, up, host)
