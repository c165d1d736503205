"""Hand-written CUDA kernels of the MMoE forward, with their plain versions.

The counterpart of ``mmlrec_tpu/ops/pallas_kernels.py``.  Each of the three
functions below is a wrapper that

* takes its plain PyTorch version when every tensor lies on the CPU (the
  CPU tests run this path; it is the reference the kernel is held to);
* launches its kernel from ``csrc/recsys_kernels.cu`` when every tensor lies
  on one CUDA device, or raises: a failed build or launch is an error, never
  a fallback to the plain version;
* checks dtype, shape and contiguity, allocates its output with
  ``torch.empty``, launches on the current stream, and adds one to
  ``launch_counts[name]`` per launch.

All three are differentiable: a ``torch.autograd.Function`` launches the
kernel forward and runs the named plain backward (``*_backward``) on the
saved tensors.  The JAX package has no backward kernel either: its training
path computes the mix and the score with XLA ops, and the backward of its
``embed_concat`` is plain ``jnp`` (pallas_kernels.py:82-88).  For
``embed_concat`` the Function also runs on the CPU (plain forward), so that
the CPU tests reach the same backward as the card.

The shared library is built at first use (``cuda_build``), keyed by a hash
of the source, and loaded with ctypes.  Nothing is built or loaded at import.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional, Sequence, Tuple

import torch

from . import cuda_build
from .cuda_build import (  # noqa: F401  (re-exported)
    BUILD_DIR,
    NVCC_FLAGS,
    backward_counts,
    launch_counts,
    reset_launch_counts,
    stack_front,
    under_vmap,
)

_p, _i, _ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
LIBRARY = cuda_build.CudaLibrary("recsys_kernels.cu", {
    "mmlrec_embed_concat": [_p, _ll, _i, _p, _i, _i, _p, _i, _p, _i, _p],
    "mmlrec_gated_expert_mix": [_p, _p, _i, _i, _i, _i, _p, _p],
    "mmlrec_multihead_score": [_p, _p, _p, _p, _i, _i, _i, _p, _i, _p],
    "mmlrec_empty_launch": [_i, _i, _p],
})
launch_counts.update(embed_concat=0, gated_expert_mix=0, multihead_score=0)
backward_counts.update(embed_concat=0, gated_expert_mix=0, multihead_score=0)

_EMBED_ROWS_PER_BLOCK = 8  # kEmbedRowsPerBlock (MMLREC_EMBED_TILE_ROWS) in the CUDA source
_SMEM_LIMIT = 48 * 1024  # static launch limit without an opt-in attribute
_SCORE_THREADS = 256  # kScoreThreads (MMLREC_SCORE_THREADS) in the CUDA source
_SCORE_ROWS_PER_GROUP = 0  # kScoreRowsPerGroup (MMLREC_SCORE_ROWS_PER_GROUP); 0: by the rule
_SCORE_MIN_LANES = 1  # kScoreMinLanes (MMLREC_SCORE_MIN_LANES)


# ----------------------------------------------------------------------
# build and load
# ----------------------------------------------------------------------
def library_path() -> Path:
    return LIBRARY.path()


def _lib() -> ctypes.CDLL:
    return LIBRARY.load()


def _on_cuda(name: str, *tensors: torch.Tensor) -> bool:
    on = cuda_build.on_cuda(name, *tensors, forward_only=False)  # all three have a backward
    if on and not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: the CUDA kernel needs contiguous inputs")
    return on


def _launch(name: str, fn, *args, device: torch.device) -> None:
    cuda_build.launch(LIBRARY, name, fn, *args, device=device)


def _check_dtype(name: str, t: torch.Tensor, dtype: torch.dtype, what: str):
    if t.dtype != dtype:
        raise TypeError(f"{name}: {what} must be {dtype}, got {t.dtype}")


def empty_launch(blocks: int = 1, threads: int = 32) -> None:
    """Launch a kernel that does nothing, through the same ctypes route as
    the real ones, on the current device's current stream: the probe that
    times what a launch alone costs on this card.  It is no
    kernel of any path and has no launch count."""
    code = _lib().mmlrec_empty_launch(blocks, threads, torch.cuda.current_stream().cuda_stream)
    if code != 0:
        raise RuntimeError(f"empty_launch: kernel launch failed ({code})")


# ----------------------------------------------------------------------
# fused embedding gather + flatten + dense concat
# ----------------------------------------------------------------------
def take_fill(table, ids):
    """``jnp.take(table, ids, axis=0)`` with its fill mode: [V, D] rows at
    ids of any shape -> [*ids.shape, D]; an id in [-V, 0) wraps once, any
    other id outside [0, V) gives a NaN row."""
    V = table.shape[0]
    idx = ids.long()
    idx = torch.where(idx < 0, idx + V, idx)
    valid = (idx >= 0) & (idx < V)
    rows = table[idx.clamp(0, max(V - 1, 0))]
    return torch.where(valid[..., None], rows, rows.new_full((), float("nan")))


def embed_concat_plain(table, ids, dense):
    """concat(take(table, ids).reshape(B, F*D), dense), with jnp.take's fill
    mode (``take_fill``)."""
    B, F = ids.shape
    return torch.cat([take_fill(table, ids).reshape(B, F * table.shape[1]), dense], dim=1)


def scatter_add_rows(values: torch.Tensor, index: torch.Tensor, n_rows: int) -> torch.Tensor:
    """``zeros([n_rows, D]).at[index].add(values)``, deterministic on both
    devices; an index outside ``[0, n_rows)`` adds nothing.  On the card,
    ``index_put_`` with accumulate sorts the indices (stable) and adds each
    segment in position order, where ``index_add_`` would race with float
    atomics.  On the CPU, ``index_add_`` adds the rows one after another in
    position order, as XLA's CPU scatter does (``index_put_`` there spreads
    the adds over threads with atomics once the input is large)."""
    idx = index.long()
    # strays go to a sacrificial last row: no mask, no host synchronisation
    idx = torch.where((idx >= 0) & (idx < n_rows), idx, n_rows)
    out = values.new_zeros((n_rows + 1, values.shape[1]))
    if values.device.type == "cpu":
        out.index_add_(0, idx, values)
    else:
        out.index_put_((idx,), values, accumulate=True)
    return out[:n_rows]


def onehot_matmul_rows(g: torch.Tensor, ids_local: torch.Tensor,
                       vocab_sizes: Sequence[int], n_rows: int) -> torch.Tensor:
    """The table cotangent as a one-hot product per feature (the backward of
    ``mmlrec_tpu/ops/embedding.py::take_rows_matmul_grad``, :142-153):
    ``g`` [B, F, D], ``ids_local`` [B, F] per-feature ids -> [n_rows, D],
    the features' blocks one after another and zero rows after them.  An id
    outside its feature's vocabulary adds nothing.  A library product: the
    JAX package computes this einsum outside any Pallas kernel."""
    vmax = int(max(vocab_sizes))
    lanes = torch.arange(vmax, device=g.device, dtype=ids_local.dtype)
    onehot = (ids_local[..., None] == lanes).to(g.dtype)  # [B, F, vmax]
    blocks = torch.einsum("bsv,bsd->svd", onehot, g)  # [F, vmax, D]
    parts = [blocks[s, :v] for s, v in enumerate(vocab_sizes)]
    pad = n_rows - int(sum(vocab_sizes))
    if pad:
        parts.append(g.new_zeros((pad, g.shape[-1])))
    return torch.cat(parts, dim=0)


def embed_concat_backward(grad_out, ids, n_rows: int, dim: int, matmul_grad=None,
                          members: int = 1):
    """Plain backward of the embed-concat (pallas_kernels.py:82-88):
    ``(d_table [n_rows, dim], d_dense [B, Nd])`` from the output's cotangent
    [B, F*dim + Nd] and the pre-offset ids [B, F].  ``d_table`` is the
    scatter-add of the row cotangents at ``ids`` (an id in [-n_rows, 0)
    wraps once, as in the forward; the forward's NaN rows add nothing), or,
    when ``matmul_grad`` gives ``(vocab_sizes, offsets [F])``, the one-hot
    product per feature.  ``members`` > 1: the call is a folded stack
    (``_EmbedConcat.vmap``), member s's rows ``[s * V, (s + 1) * V)`` of the
    table and its ids offset by ``s * V``; the scatter-add needs nothing
    more, the one-hot product runs per member."""
    B, F = ids.shape
    g_rows = grad_out[:, : F * dim]
    d_dense = grad_out[:, F * dim:]
    if matmul_grad is not None:
        vocab_sizes, offsets = matmul_grad
        V, b = n_rows // members, B // members
        g4 = g_rows.reshape(members, b, F, dim)
        parts = [onehot_matmul_rows(g4[s], ids[s * b:(s + 1) * b] - (offsets[None] + s * V),
                                    vocab_sizes, V) for s in range(members)]
        d_table = parts[0] if members == 1 else torch.cat(parts)
    else:
        flat = ids.reshape(-1).long()
        flat = torch.where(flat < 0, flat + n_rows, flat)
        d_table = scatter_add_rows(g_rows.reshape(B * F, dim), flat, n_rows)
    return d_table, d_dense


def embed_concat_vector_rows(batch: int, dim: int, width: int, table_addr: int,
                             dense_addr: int, out_addr: int) -> int:
    """How many leading batch rows the kernel's vector body handles (0: the
    scalar body takes all), from shapes and addresses alone.

    The vector body moves 16 bytes per access, so it needs whole ``float4``s
    of a table row (``dim % 4 == 0``), 16-byte-aligned starts of the table,
    the dense block and the output, and a tile image (``rows per tile x
    width`` f32) inside the static shared memory.  Tiles are
    ``_EMBED_ROWS_PER_BLOCK`` (a multiple of 4) batch rows; a last tile whose
    row count is no multiple of 4 takes the scalar body, every other tile
    starts and ends on a 16-byte boundary whatever ``width`` is."""
    if dim % 4 or any(a % 16 for a in (table_addr, dense_addr, out_addr)):
        return 0
    if 4 * _EMBED_ROWS_PER_BLOCK * width > _SMEM_LIMIT:
        return 0
    tail = batch % _EMBED_ROWS_PER_BLOCK
    return batch - (tail if tail % 4 else 0)


def embed_concat_grid(batch: int) -> Tuple[int, int]:
    """(blocks, threads per block) of the embed_concat launch at ``batch``
    rows, as the C entry computes them."""
    return (-(-batch // _EMBED_ROWS_PER_BLOCK), 256 if _EMBED_ROWS_PER_BLOCK >= 8 else 128)


class _EmbedConcat(torch.autograd.Function):
    """The embed-concat kernel forward (its plain version on the CPU),
    ``embed_concat_backward`` backward; under ``torch.func.vmap`` the stack
    folds into one call (``vmap``)."""

    @staticmethod
    def forward(table, ids, dense, matmul_grad, members):
        if table.device.type == "cuda":
            return _embed_concat_cuda(table, ids, dense)
        return embed_concat_plain(table, ids, dense)

    @staticmethod
    def setup_context(ctx, inputs, output):
        table, ids, _, matmul_grad, members = inputs
        ctx.save_for_backward(ids)
        ctx.table_shape = tuple(table.shape)
        ctx.matmul_grad = matmul_grad
        ctx.members = members

    @staticmethod
    def backward(ctx, grad_out):
        (ids,) = ctx.saved_tensors
        backward_counts["embed_concat"] += 1
        d_table, d_dense = embed_concat_backward(
            grad_out, ids, *ctx.table_shape, matmul_grad=ctx.matmul_grad, members=ctx.members)
        need_table, _, need_dense, _, _ = ctx.needs_input_grad
        return (d_table if need_table else None, None,
                d_dense if need_dense else None, None, None)

    @staticmethod
    def vmap(info, in_dims, table, ids, dense, matmul_grad, members):
        """S stacked calls as ONE: the tables viewed as one ``[S*V, D]``
        table (a lane-packed ``[S, V/P, 128]`` stack is that array in
        memory), member s's ids offset by ``s * V`` (an id in [-V, 0)
        wrapped first, any other id outside [0, V) sent past the stack: a
        NaN row, as alone), ids and dense folded to ``[S*B, ...]``; a table
        the stack shares is not copied."""
        S = info.batch_size
        ids = stack_front(ids, in_dims[1], S)
        dense = stack_front(dense, in_dims[2], S)
        B, F = ids.shape[1:]
        if in_dims[0] is None:
            flat_ids, members_f = ids.reshape(S * B, F), members
        else:
            table = stack_front(table, in_dims[0], S)
            V, D = table.shape[1:]
            if S * V >= 2**31:
                raise ValueError(f"embed_concat: {S} stacked tables of {V} rows pass int32 ids")
            # member s's id i is row s*V + i once wrapped as alone; an id the
            # member's table does not hold goes past the stack (a NaN row)
            idx = torch.where(ids < 0, ids + V, ids)
            step = torch.arange(S, dtype=ids.dtype, device=ids.device)[:, None, None] * V
            idx = torch.where((idx >= 0) & (idx < V), idx + step, S * V)
            flat_ids = idx.reshape(S * B, F)
            table, members_f = table.reshape(S * V, D), S * members
        out = _embed_concat_apply(table, flat_ids, dense.reshape(S * B, dense.shape[-1]),
                                  matmul_grad, members_f)
        return out.view(S, B, out.shape[-1]), 0


def _embed_concat_checks(table, ids, dense) -> bool:
    """Whether the call launches the kernel (its inputs on one card); what
    the kernel cannot take raises."""
    name = "embed_concat"
    on_cuda = _on_cuda(name, table, ids, dense)
    if on_cuda:
        if table.shape[1] < 1 or table.shape[0] < 1:
            raise ValueError(f"{name}: empty table {tuple(table.shape)}")
        if 8 * _EMBED_ROWS_PER_BLOCK * ids.shape[1] > _SMEM_LIMIT:
            raise ValueError(f"{name}: {ids.shape[1]} features exceed the kernel's tile")
    return on_cuda


def _embed_concat_apply(table, ids, dense, matmul_grad, members):
    """``_EmbedConcat`` on a folded stack: contiguous operands, checked as
    the wrapper checks them (a nested stack folds at its own level)."""
    if not under_vmap(table, ids, dense):
        table, ids, dense = table.contiguous(), ids.contiguous(), dense.contiguous()
        _embed_concat_checks(table, ids, dense)
    return _EmbedConcat.apply(table, ids, dense, matmul_grad, members)


def embed_concat(table: torch.Tensor, ids: torch.Tensor, dense: torch.Tensor,
                 *, matmul_grad: Optional[Tuple[Tuple[int, ...], torch.Tensor]] = None):
    """[V, D] f32 table, [B, F] int32 pre-offset ids, [B, Nd] f32 dense ->
    [B, F*D + Nd] f32.

    Replaces ``mmlrec_tpu/ops/pallas_kernels.py::fused_embed_concat`` (:43)
    and, when an input requires grad, ``embed_concat`` (:103, the
    ``custom_vjp``): the backward is plain (``embed_concat_backward``): the
    deterministic scatter-add, or the one-hot product per feature when
    ``matmul_grad`` gives the features' ``(vocab_sizes, offsets [F] int32)``.
    Bound on the H100 by bytes: the gathered rows, the ids and the dense
    block are read once and the output written once (4.4 MB at the flagship
    batch, 1.3 us at 3.35 TB/s), which is less than a launch alone takes, so
    the design is about latency.  One block per 8-row tile; every access to
    device memory is 16 bytes and a tile's loads are in flight together: a
    thread loads one ``float4`` of the dense block, its id and one ``float4``
    of that id's table row, writes them into a shared-memory image of the
    tile's output, and after one barrier the image is stored as one
    contiguous run of ``float4``.  That body needs ``D % 4 == 0`` and
    16-byte-aligned table, dense block and output
    (``embed_concat_vector_rows``); any other shape, and a last tile whose
    row count is no multiple of 4, takes the scalar body (ids resolved into
    shared memory, one float a thread).  Pure data movement: bit-identical
    to the plain version on either body.
    """
    name = "embed_concat"
    _check_dtype(name, table, torch.float32, "table")
    _check_dtype(name, ids, torch.int32, "ids")
    _check_dtype(name, dense, torch.float32, "dense")
    if table.dim() != 2 or ids.dim() != 2 or dense.dim() != 2:
        raise ValueError(f"{name}: expected 2-D table, ids and dense")
    B = ids.shape[0]
    if dense.shape[0] != B:
        raise ValueError(f"{name}: ids have {B} rows, dense {dense.shape[0]}")
    if under_vmap(table, ids, dense):
        return _EmbedConcat.apply(table, ids, dense, matmul_grad, 1)
    on_cuda = _embed_concat_checks(table, ids, dense)
    if torch.is_grad_enabled() and (table.requires_grad or dense.requires_grad):
        return _EmbedConcat.apply(table, ids, dense, matmul_grad, 1)
    if not on_cuda:
        return embed_concat_plain(table, ids, dense)
    return _embed_concat_cuda(table, ids, dense)


def _embed_concat_cuda(table, ids, dense):
    V, D = table.shape
    B, F = ids.shape
    Nd = dense.shape[1]
    out = torch.empty((B, F * D + Nd), dtype=torch.float32, device=table.device)
    if B == 0 or out.shape[1] == 0:
        return out
    vec = embed_concat_vector_rows(B, D, out.shape[1], table.data_ptr(),
                                   dense.data_ptr() if Nd else 0, out.data_ptr()) > 0
    lib = _lib()
    _launch("embed_concat", lib.mmlrec_embed_concat, table.data_ptr(), V, D,
            ids.data_ptr(), B, F, dense.data_ptr(), Nd, out.data_ptr(), int(vec),
            device=table.device)
    return out


# ----------------------------------------------------------------------
# gated expert mixing: softmax over gate logits fused with the expert mix
# ----------------------------------------------------------------------
def gated_expert_mix_plain(gate_logits, experts):
    """softmax(gate_logits, -1) @ experts: [B, T, E], [B, E, D] -> [B, T, D]."""
    return torch.einsum("bte,bed->btd", torch.softmax(gate_logits, dim=-1), experts)


def gated_expert_mix(gate_logits: torch.Tensor, experts: torch.Tensor):
    """[B, T, E] f32 gate logits, [B, E, D] f32 expert outputs -> [B, T, D].

    Replaces ``mmlrec_tpu/ops/pallas_kernels.py::gated_expert_mix`` (:123).
    Bound on the H100 by bytes (2*T*E*D FLOPs per 4*E*D bytes read: far
    below the f32 ridge), 12.7 MB at the flagship batch.  Design: one block
    per batch row; the first T threads compute the max-subtracted softmax of
    each task into shared memory, then each thread owns feature columns and
    accumulates the T mixes in f32, reading every expert row coalesced.
    The sums run in another order than the plain version's: equal to f32
    rounding.
    """
    name = "gated_expert_mix"
    _check_dtype(name, gate_logits, torch.float32, "gate_logits")
    _check_dtype(name, experts, torch.float32, "experts")
    if gate_logits.dim() != 3 or experts.dim() != 3:
        raise ValueError(f"{name}: expected [B, T, E] logits and [B, E, D] experts")
    B, T, E = gate_logits.shape
    if experts.shape[:2] != (B, E):
        raise ValueError(
            f"{name}: experts {tuple(experts.shape)} do not match logits "
            f"{tuple(gate_logits.shape)}")
    if under_vmap(gate_logits, experts):
        return _GatedExpertMix.apply(gate_logits, experts)
    if not _mix_checks(gate_logits, experts):
        return gated_expert_mix_plain(gate_logits, experts)
    if torch.is_grad_enabled() and (gate_logits.requires_grad or experts.requires_grad):
        return _GatedExpertMix.apply(gate_logits, experts)
    return _gated_expert_mix_cuda(gate_logits, experts)


def _mix_checks(gate_logits, experts) -> bool:
    """Whether the call launches the kernel; what it cannot take raises."""
    on_cuda = _on_cuda("gated_expert_mix", gate_logits, experts)
    T, E = gate_logits.shape[1:]
    if on_cuda and (E < 1 or 4 * T * E > _SMEM_LIMIT):
        raise ValueError(f"gated_expert_mix: unsupported T={T}, E={E}")
    return on_cuda


def _gated_expert_mix_cuda(gate_logits, experts):
    B, T, E = gate_logits.shape
    D = experts.shape[2]
    out = torch.empty((B, T, D), dtype=torch.float32, device=experts.device)
    if out.numel() == 0:
        return out
    lib = _lib()
    _launch("gated_expert_mix", lib.mmlrec_gated_expert_mix, gate_logits.data_ptr(),
            experts.data_ptr(), B, T, E, D, out.data_ptr(),
            device=experts.device)
    return out


def gated_expert_mix_backward(gate_logits, experts, grad_out):
    """Plain backward of the mix: (d_logits [B, T, E], d_experts [B, E, D])
    from the saved inputs and the output's cotangent [B, T, D]."""
    p = torch.softmax(gate_logits, dim=-1)
    d_experts = torch.einsum("bte,btd->bed", p, grad_out)
    d_p = torch.einsum("btd,bed->bte", grad_out, experts)
    d_logits = p * (d_p - (d_p * p).sum(dim=-1, keepdim=True))
    return d_logits, d_experts


class _GatedExpertMix(torch.autograd.Function):
    """The mix kernel forward (its plain version on the CPU, where only a
    stacked call comes here), ``gated_expert_mix_backward`` backward."""

    @staticmethod
    def forward(gate_logits, experts):
        if gate_logits.device.type == "cuda":
            return _gated_expert_mix_cuda(gate_logits, experts)
        return gated_expert_mix_plain(gate_logits, experts)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    @staticmethod
    def backward(ctx, grad_out):
        backward_counts["gated_expert_mix"] += 1
        return gated_expert_mix_backward(*ctx.saved_tensors, grad_out)

    @staticmethod
    def vmap(info, in_dims, gate_logits, experts):
        """S stacked calls as ONE: the stack folded into the batch,
        ``[S*B, T, E]`` logits against ``[S*B, E, D]`` experts."""
        S = info.batch_size
        g, e = (stack_front(t, d, S) for t, d in zip((gate_logits, experts), in_dims))
        B = g.shape[1]
        g, e = g.reshape(S * B, *g.shape[2:]), e.reshape(S * B, *e.shape[2:])
        if not under_vmap(g, e):
            g, e = g.contiguous(), e.contiguous()
            _mix_checks(g, e)
        out = _GatedExpertMix.apply(g, e)
        return out.view(S, B, *out.shape[1:]), 0


# ----------------------------------------------------------------------
# multi-head scoring: per-head final linear + bias + sigmoid in one pass
# ----------------------------------------------------------------------
def multihead_score_plain(tower, weights, bias, binary):
    z = torch.einsum("bth,th->bt", tower, weights) + bias[None]
    return binary * torch.sigmoid(z) + (1.0 - binary) * z


def multihead_score_vector_body(rows: int, hidden: int, tower_addr: int,
                                weights_addr: int) -> bool:
    """Whether the kernel's 16-byte body takes the call, from the shape and
    the addresses alone: whole ``float4``s of a row (``hidden % 4 == 0``),
    16-byte-aligned starts of ``tower`` and ``weights`` (every row then
    starts on a 16-byte boundary too), and ``rows = B * T`` small enough for
    the body's 32-bit thread arithmetic.  Anything else takes the scalar
    body."""
    return (hidden % 4 == 0 and tower_addr % 16 == 0 and weights_addr % 16 == 0
            and rows * 32 < 2**31)


def multihead_score_lanes(hidden: int) -> int:
    """Lanes of the group that takes a row on the vector body: the power of
    two that covers the row's ``hidden / 4`` ``float4``s, at most a warp, as
    the C entry computes it."""
    lanes = _SCORE_MIN_LANES
    while lanes < 32 and lanes * 4 < hidden:
        lanes *= 2
    return lanes


def multihead_score_rows_per_group(hidden: int) -> int:
    """Rows of one head that a group takes on the vector body: 1 while a
    group is narrower than a warp, 2 once a row takes a whole warp, so that
    a warp always carries two rows or more."""
    if _SCORE_ROWS_PER_GROUP:
        return _SCORE_ROWS_PER_GROUP
    return 2 if multihead_score_lanes(hidden) == 32 else 1


def multihead_score_grid(batch: int, tasks: int, hidden: int, vector: bool) -> Tuple[int, int]:
    """(blocks, threads per block) of the multihead_score launch, as the C
    entry computes them."""
    if vector:
        threads = (-(-batch // multihead_score_rows_per_group(hidden)) * tasks
                   * multihead_score_lanes(hidden))
    else:
        threads = batch * tasks * 32
    return -(-threads // _SCORE_THREADS), _SCORE_THREADS


def multihead_score(
    tower: torch.Tensor,
    weights: torch.Tensor,
    bias: torch.Tensor,
    binary: Optional[torch.Tensor] = None,
):
    """tower [B, T, H], weights [T, H], bias [T] -> [B, T] f32 scores:
    ``binary * sigmoid(z) + (1 - binary) * z`` with ``z = tower . w + b``.

    ``binary`` [T] is 1 for a binary head and 0 for a regression head
    (``PredictionHeads``); None means all binary, which is exactly
    ``mmlrec_tpu/ops/pallas_kernels.py::multihead_score`` (:164), the kernel
    this replaces.  Bound on the H100 by bytes (2.1 MB at the flagship
    batch, 0.64 us), which is less than a launch alone takes, so the design
    is about the chain of dependent steps.  A group of ``H / 4`` lanes takes
    a row (16 at H = 64: a warp carries two rows; at H >= 128 a warp takes
    two rows of one head); a lane asks for one ``float4`` of each row, the
    matching one of ``w[t]``, ``bias[t]`` and ``binary[t]`` before any
    arithmetic, log2(group) shuffle steps follow and the group's first lanes
    apply the head epilogue; a warp's results leave as one run.  That body needs ``H % 4 == 0`` and 16-byte-aligned
    ``tower`` and ``weights`` (``multihead_score_vector_body``); any other
    call takes the scalar body, a warp per row.  The sum runs in another
    order than the plain version's: equal to f32 rounding.
    """
    name = "multihead_score"
    for t, what in ((tower, "tower"), (weights, "weights"), (bias, "bias")):
        _check_dtype(name, t, torch.float32, what)
    if tower.dim() != 3:
        raise ValueError(f"{name}: expected [B, T, H] tower")
    B, T, H = tower.shape
    if binary is None:
        binary = torch.ones((T,), dtype=torch.float32, device=tower.device)
    _check_dtype(name, binary, torch.float32, "binary")
    if weights.shape != (T, H) or bias.shape != (T,) or binary.shape != (T,):
        raise ValueError(
            f"{name}: weights {tuple(weights.shape)}, bias {tuple(bias.shape)}"
            f", binary {tuple(binary.shape)} do not match tower {(B, T, H)}")
    if under_vmap(tower, weights, bias, binary):
        return _MultiheadScore.apply(tower, weights, bias, binary)
    if not _on_cuda(name, tower, weights, bias, binary):
        return multihead_score_plain(tower, weights, bias, binary)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (tower, weights, bias, binary)):
        return _MultiheadScore.apply(tower, weights, bias, binary)
    return _multihead_score_cuda(tower, weights, bias, binary)


def _multihead_score_cuda(tower, weights, bias, binary):
    B, T, H = tower.shape
    out = torch.empty((B, T), dtype=torch.float32, device=tower.device)
    if out.numel() == 0:
        return out
    vec = multihead_score_vector_body(B * T, H, tower.data_ptr(), weights.data_ptr())
    lib = _lib()
    _launch("multihead_score", lib.mmlrec_multihead_score, tower.data_ptr(),
            weights.data_ptr(), bias.data_ptr(), binary.data_ptr(), B, T, H,
            out.data_ptr(), int(vec), device=tower.device)
    return out


def multihead_score_backward(tower, weights, bias, binary, grad_out):
    """Plain backward of the score: (d_tower [B, T, H], d_weights [T, H],
    d_bias [T]) from the saved inputs and the output's cotangent [B, T];
    ``binary`` is a constant mask."""
    z = torch.einsum("bth,th->bt", tower, weights) + bias[None]
    s = torch.sigmoid(z)
    d_z = grad_out * (binary * (s * (1.0 - s)) + (1.0 - binary))
    d_tower = d_z[..., None] * weights[None]
    d_weights = torch.einsum("bt,bth->th", d_z, tower)
    return d_tower, d_weights, d_z.sum(dim=0)


class _MultiheadScore(torch.autograd.Function):
    """The score kernel forward (its plain version on the CPU, where only a
    stacked call comes here), ``multihead_score_backward`` backward."""

    @staticmethod
    def forward(tower, weights, bias, binary):
        if tower.device.type == "cuda":
            return _multihead_score_cuda(tower, weights, bias, binary)
        return multihead_score_plain(tower, weights, bias, binary)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    @staticmethod
    def backward(ctx, grad_out):
        backward_counts["multihead_score"] += 1
        return (*multihead_score_backward(*ctx.saved_tensors, grad_out), None)

    @staticmethod
    def vmap(info, in_dims, tower, weights, bias, binary):
        """S stacked calls as ONE: the stack folded into the heads, a
        ``[B, S*T, H]`` tower (one copy, member-major heads) against
        ``[S*T, H]`` weights, ``[S*T]`` bias and binary; the result is
        ``[B, S, T]`` with the stack on axis 1."""
        S = info.batch_size
        tower, weights, bias, binary = (
            stack_front(t, d, S) for t, d in zip((tower, weights, bias, binary), in_dims))
        B, T, H = tower.shape[1:]
        tower = tower.movedim(0, 1).reshape(B, S * T, H)
        weights, bias, binary = (t.reshape(S * T, *t.shape[2:]) for t in (weights, bias, binary))
        if not under_vmap(tower, weights, bias, binary):
            tower, weights, bias, binary = (
                t.contiguous() for t in (tower, weights, bias, binary))
            _on_cuda("multihead_score", tower, weights, bias, binary)
        out = _MultiheadScore.apply(tower, weights, bias, binary)
        return out.view(B, S, T), 1
