"""Embedding stores, the port of ``mmlrec_tpu/ops/embedding.py``.

All sparse features that share an embedding dim live in ONE fused table with
per-feature row offsets, so the sparse side of a batch is one gather.  The
parameter keeps the JAX package's layout so that weights copy across
unchanged: ``[rows, D]`` unpacked, or lane-packed ``[rows/P, 128]`` from
2^18 fused rows on (``pack_factor_for``), with zeroed pad rows.  The
two-phase step's stacked container (``dual_container``) is ``[2Vp, W]``:
the table in the top half, its packed Adam moments in the bottom half.

Lane packing is a TPU layout only.  A row-major ``[rows/P, P*D]`` array is
the ``[rows, D]`` array in memory, so the port gathers from
``table.view(-1, D)`` at row ``ids + offsets`` for both layouts, which is
bit-identical to the JAX package's super-row gather plus one-hot sub-row
select (embedding.py:314-318).

The lookup is differentiable w.r.t. the table (the dense-table fit): the
gradient lands in the parameter through the same flat view.  As in the JAX
package (embedding.py:303-313) the unpacked table's cotangent is a one-hot
product per feature while the one-hot fits ``MATMUL_GRAD_BUDGET_BYTES``,
and a scatter-add otherwise and for the lane-packed table.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
from torch import nn

from ..features import FeatureLayout
from .initializers import normal_init
from .cuda_build import needs_grad, stack_front
from .kernels import embed_concat, take_fill


#: one-hot budget of the matmul backward: f32 [B, F, vmax] bytes
#: (mmlrec_tpu/ops/embedding.py:110)
MATMUL_GRAD_BUDGET_BYTES = 128 << 20


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _padded_normal_init(std: float, total_logical: int, pack_factor: int, dim: int):
    """normal(std) for the real vocab rows, EXACT ZERO for padding rows
    (mmlrec_tpu/ops/embedding.py:32-57: pad rows are never gathered and
    must not inflate the L2 penalty).  Logical row r lives at physical row
    r // P, lanes (r % P) * dim onwards, so the pads are the tail of the
    flat ``[rows * P, dim]`` view; the draw happens on the generator's
    device."""

    def init(gen: torch.Generator, shape) -> torch.Tensor:
        x = std * torch.randn(tuple(shape), generator=gen, dtype=torch.float32,
                              device=gen.device)
        x.view(-1, dim)[total_logical:] = 0.0
        return x

    return init


def pack_factor_for(
    total_rows: int,
    dim: int,
    *,
    pad_to: int = 128,
    pack_lanes: int = 128,
    pack_min_rows: int = 1 << 18,
    packed: bool | None = None,
) -> int:
    """Logical rows per physical table row (1 = unpacked); the JAX package's
    single source of truth for the lane-packing decision."""
    rows = _round_up(max(total_rows, 1), pad_to)
    packable = dim < pack_lanes and pack_lanes % dim == 0
    use_pack = (
        packable and rows >= pack_min_rows if packed is None else packed and packable
    )
    return pack_lanes // dim if use_pack else 1


def fused_table_geometry(layout):
    """(dim, pack_factor, physical_rows) of the fused table a FeatureLayout
    would build, or None when no fused path exists (non-uniform embedding
    dims or varlen features)."""
    if getattr(layout, "varlen_slots", None):
        return None
    dims = {int(s.feature.embedding_dim) for s in layout.sparse_slots}
    if len(dims) != 1:
        return None
    dim = dims.pop()
    total = int(sum(s.feature.vocabulary_size for s in layout.sparse_slots))
    P = pack_factor_for(total, dim)
    rows = _round_up(max(total, 1), 128)
    if P > 1:
        rows = _round_up(rows, P * 128)
    return dim, P, rows // P


def segment_sum_rows(values: torch.Tensor, index: torch.Tensor, n_rows: int) -> torch.Tensor:
    """``zeros([n_rows, D]).at[index].add(values)`` in fixed-shape tensor ops
    whose time does not grow with how often one index repeats: the rows
    sorted by index (stable), a segmented inclusive scan of log2(K) shifted
    adds (each position adds the one ``2^k`` before it when both carry the
    same index), and each index's total, at its segment's last position,
    written to its row once.  An index outside ``[0, n_rows)`` adds
    nothing.  Deterministic (no atomics), without a host read, so a
    captured step replays bitwise.  The card's ``index_put_`` with
    accumulate adds a repeated index's values one after another in one
    thread: with a behaviour sequence's padding id at half of a batch's
    204,800 positions it took 17.2 ms on an H100 (80GB HBM3, 700 W), this
    0.58 ms (``chip_smoke.py`` phase 14)."""
    K, D = values.shape
    idx = index.long()
    idx = torch.where((idx >= 0) & (idx < n_rows), idx, n_rows)
    key, order = torch.sort(idx, stable=True)
    x = values.index_select(0, order)
    shift = 1
    while shift < K:
        same = (key[shift:] == key[:-shift])[:, None]
        x = torch.cat([x[:shift], x[shift:] + torch.where(same, x[:-shift], 0.0)])
        shift *= 2
    last = torch.cat([key[1:] != key[:-1], torch.ones_like(key[:1], dtype=torch.bool)])
    out = values.new_zeros((n_rows + 2, D))
    # every real row is the target of one position; the rest go to row n_rows + 1
    out.index_put_((torch.where(last, key, n_rows + 1),), x)
    return out[:n_rows]


class _TakeRows(torch.autograd.Function):
    """``take_fill`` whose table cotangent is ``segment_sum_rows``, one
    deterministic formula on both devices, so a step that runs it replays
    bitwise (autograd's own backward of an index adds with atomics on the
    card).  Under ``torch.func.vmap`` the stack folds into one gather
    (``vmap``)."""

    @staticmethod
    def forward(table, ids):
        return take_fill(table, ids)

    @staticmethod
    def setup_context(ctx, inputs, output):
        table, ids = inputs
        ctx.save_for_backward(ids)
        ctx.n_rows = table.shape[0]

    @staticmethod
    def backward(ctx, grad_out):
        (ids,) = ctx.saved_tensors
        flat = ids.reshape(-1).long()
        flat = torch.where(flat < 0, flat + ctx.n_rows, flat)
        return segment_sum_rows(grad_out.reshape(flat.shape[0], -1), flat, ctx.n_rows), None

    @staticmethod
    def vmap(info, in_dims, table, ids):
        """S stacked gathers as ONE: the tables as one ``[S*V, D]`` table,
        member s's ids offset by ``s * V`` (an id in [-V, 0) wrapped first,
        any other id outside [0, V) sent past the stack: a NaN row, as
        alone), ids folded to ``[S*B, ...]``."""
        S = info.batch_size
        ids = stack_front(ids, in_dims[1], S)
        if in_dims[0] is None:
            out = _TakeRows.apply(table, ids)
            return out, 0
        table = stack_front(table, in_dims[0], S)
        V = table.shape[1]
        if S * V >= 2**31:
            raise ValueError(f"_TakeRows: {S} stacked tables of {V} rows pass int32 ids")
        idx = ids.long()
        idx = torch.where(idx < 0, idx + V, idx)
        idx = torch.where((idx >= 0) & (idx < V), idx, S * V)
        step = torch.arange(S, device=ids.device) * V
        idx = idx + step.view(S, *([1] * (ids.dim() - 1)))
        idx = torch.where(idx >= S * V, S * V, idx)
        out = _TakeRows.apply(table.reshape(S * V, *table.shape[2:]), idx)
        return out, 0


class FusedEmbedding(nn.Module):
    """One table for many categorical features with a shared dim
    (mmlrec_tpu/ops/embedding.py:159-318)."""

    def __init__(
        self,
        vocab_sizes: Tuple[int, ...],
        dim: int,
        *,
        generator: torch.Generator,
        init_std: float = 1e-4,
        dual_container: bool = False,
        dual_shards: int = 1,
        grad_mode: str = "auto",
        grad_budget_divisor: int = 1,
    ):
        super().__init__()
        if grad_mode not in ("auto", "matmul", "scatter"):
            raise ValueError(
                f"embedding_grad must be 'auto', 'matmul' or 'scatter'; got {grad_mode!r}")
        self.grad_mode = grad_mode
        self.grad_budget_divisor = int(grad_budget_divisor)
        self.vocab_sizes = tuple(int(v) for v in vocab_sizes)
        self.dim = int(dim)
        offsets = np.concatenate([[0], np.cumsum(self.vocab_sizes)[:-1]])
        self.register_buffer(
            "offsets", torch.as_tensor(offsets, dtype=torch.int32), persistent=False
        )
        total = int(sum(self.vocab_sizes))
        # physical [rows/P, P*dim]; row-major, so logical row r lives at
        # physical [r // P, (r % P)*dim : (r % P + 1)*dim]
        self.pack_factor = pack_factor_for(total, self.dim)
        rows = _round_up(max(total, 1), 128 * self.pack_factor)
        shape = (rows // self.pack_factor, self.pack_factor * self.dim)
        init = _padded_normal_init(init_std, total, self.pack_factor, self.dim)
        self.dual_container = bool(dual_container)
        self.dual_shards = int(dual_shards) if self.dual_container else 1
        #: the row shard this rank holds under a mesh with model > 1
        #: (``parallel.mesh.TableShard``, set by the trainer with the
        #: shard as ``table``), or None: the whole table
        self.shard = None
        if self.dual_container:
            # table_container="stacked" (embedding.py:245-276): [2Vp, W],
            # table rows drawn exactly as the split table, the two-phase
            # step's packed (mu, nu) container zeroed; plane-major (table
            # rows in [0, Vp)), or shard-major over ``dual_shards`` shards
            # (the stacked container of a row-sharded table, rows
            # [d 2r, (d + 1) 2r) holding [table_d; monu_d])
            if shape[0] % self.dual_shards:
                raise ValueError(
                    f"stacked container over {self.dual_shards} shards needs the physical "
                    f"row count {shape[0]} to divide evenly")
            base = init(generator, shape)
            if self.dual_shards > 1:
                from ..train.sparse_embedding import fold_stacked_planes

                fat = fold_stacked_planes(base, torch.zeros_like(base), self.dual_shards)
            else:
                fat = torch.zeros((2 * shape[0], shape[1]), dtype=torch.float32,
                                  device=generator.device)
                fat[: shape[0]] = base
            self.table = nn.Parameter(fat)
        else:
            self.table = nn.Parameter(init(generator, shape))

    def to_split_container(self) -> None:
        """Make a stacked container the split table: its table plane, the
        same bits, as the parameter ``[Vp, W]``; the moment plane goes."""
        if self.dual_container:
            from ..train.sparse_embedding import split_stacked_planes

            with torch.no_grad():
                shards = 1 if self.shard is not None else self.dual_shards
                plane = split_stacked_planes(self.table.detach(), shards)[0].clone()
            self.table = nn.Parameter(plane, requires_grad=self.table.requires_grad)
            self.dual_container, self.dual_shards = False, 1

    @property
    def phys_rows(self) -> int:
        """Physical table rows (Vp): the top half of a stacked container."""
        rows = self.table.shape[0]
        return rows // 2 if self.dual_container else rows

    def table_grad_mode(self, n_ids: int) -> str:
        """"matmul" or "scatter" for a batch of ``n_ids`` ids
        (embedding.py:303-313): the one-hot product on the unpacked table
        when asked for, or under "auto" while its f32 [B, F, vmax] one-hot
        fits the budget; the scatter-add otherwise."""
        if self.pack_factor > 1 or self.grad_mode == "scatter":
            return "scatter"
        onehot_bytes = int(n_ids) * int(max(self.vocab_sizes)) * 4
        budget = MATMUL_GRAD_BUDGET_BYTES // max(self.grad_budget_divisor, 1)
        return "matmul" if self.grad_mode == "matmul" or onehot_bytes <= budget else "scatter"

    def embed_concat(self, ids: torch.Tensor, dense: torch.Tensor) -> torch.Tensor:
        """ids int32 [B, F] (per-feature local ids), dense [B, Nd] ->
        [B, F*dim + Nd]: the gathered rows flattened, then the dense block,
        in one pass (the embed-concat kernel on CUDA), differentiable w.r.t.
        the table and the dense block."""
        flat_ids = ids.to(torch.int32) + self.offsets[None, :]
        if self.shard is not None:
            # a row shard (model > 1): the rows from every shard by one
            # all-reduce (``owned_rows``), then the kernel on them as a
            # table of their own, each row read once
            from ..parallel.shard_embedding import owned_rows
            from .layers import current_batch_shard

            rows = owned_rows(self.table[: self.phys_rows], flat_ids.reshape(-1), self.dim,
                              self.pack_factor, self.shard, current_batch_shard())
            local = torch.arange(rows.shape[0], dtype=torch.int32, device=ids.device)
            return embed_concat(rows, local.view(ids.shape), dense)
        if self.dual_shards > 1:
            # the shard-major container held whole: physical row p lives at
            # row (p // r) 2r + p % r (embedding.py:280-301)
            from ..train.sparse_embedding import stacked_table_rows

            P = self.pack_factor
            phys = torch.div(flat_ids, P, rounding_mode="floor")
            rows = stacked_table_rows(phys, self.phys_rows, self.dual_shards)
            return embed_concat(self.table.view(-1, self.dim),
                                rows * P + torch.remainder(flat_ids, P), dense)
        matmul_grad = None
        if (needs_grad(self.table) and torch.is_grad_enabled()
                and self.table_grad_mode(ids.numel()) == "matmul"):
            matmul_grad = (self.vocab_sizes, self.offsets)
        return embed_concat(self.table.view(-1, self.dim), flat_ids, dense,
                            matmul_grad=matmul_grad)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        """ids int32 [B, F] -> [B, F, dim]."""
        empty = self.table.new_empty((ids.shape[0], 0))
        return self.embed_concat(ids, empty).view(ids.shape[0], -1, self.dim)


class EmbeddingCollection(nn.Module):
    """Embedding bank for a FeatureLayout (mmlrec_tpu/ops/embedding.py:
    321-394): the fused table of the sparse features, plus one table
    ``table_{embedding_name}`` of ``(vocab, dim)`` per embedding name of the
    varlen features (behaviour sequences), drawn from ``normal(init_std)``
    in sorted name order.  A varlen feature that shares its name with a
    sparse feature still gets a table of its own, as in the JAX package
    (embedding.py:360-361).  A layout without sparse features has no fused
    table, only the varlen tables.

    Sparse features of more than one embedding dim raise ValueError: the
    JAX package builds a table per name for them and then fails to stack
    the lookups (``jnp.stack`` in ``sparse_embeddings``, embedding.py:
    386-390), so no model of such a layout runs there either."""

    def __init__(
        self, layout: FeatureLayout, *, generator: torch.Generator,
        init_std: float = 1e-4, dual_container: bool = False, dual_shards: int = 1,
        grad_mode: str = "auto", grad_budget_divisor: int = 1,
    ):
        super().__init__()
        names = [s.feature.embedding_name for s in layout.sparse_slots]
        dims = {layout.embedding_specs[n][1] for n in names}
        if len(dims) > 1:
            raise ValueError(
                f"sparse features of embedding dims {sorted(dims)}: the JAX package's "
                "per-feature lookups do not stack (ValueError: All input arrays must have "
                "the same shape, mmlrec_tpu/ops/embedding.py:386-390); use one dim")
        self.fused = None
        if names:
            self.fused = FusedEmbedding(
                tuple(layout.embedding_specs[n][0] for n in names),
                dims.pop(), generator=generator, init_std=init_std,
                dual_container=dual_container, dual_shards=dual_shards,
                grad_mode=grad_mode, grad_budget_divisor=grad_budget_divisor,
            )
        init = normal_init(init_std)
        for name in sorted({s.feature.embedding_name for s in layout.varlen_slots}):
            self.register_parameter(
                f"table_{name}", nn.Parameter(init(generator, layout.embedding_specs[name])))

    def sparse_embeddings(self, ids: torch.Tensor, rows=None) -> torch.Tensor:
        """ids [B, n_sparse] -> [B, n_sparse, D].  Injected ``rows`` [B, F, D]
        (the two-phase step's pre-gathered rows, embedding.py:377-383) are
        used verbatim and the table is not touched."""
        if rows is not None:
            return rows
        return self.fused(ids)

    def varlen_embedding(self, name: str, seq_ids: torch.Tensor) -> torch.Tensor:
        """seq_ids [B, T] -> [B, T, D] from ``table_{name}`` (embedding.py:
        392-394: ``jnp.take``'s fill mode; the table's cotangent by
        ``segment_sum_rows``)."""
        return _TakeRows.apply(getattr(self, f"table_{name}"), seq_ids)
