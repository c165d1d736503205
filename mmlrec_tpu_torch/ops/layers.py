"""Core NN primitives (the port of ``mmlrec_tpu/ops/layers.py``).

Every "list of K parallel layers" of the reference is one stacked parameter
``[K, in, out]`` contracted with one einsum, as in the JAX package; the
kernels keep that layout so that weights copy across unchanged.  Submodules
are named as the flax ones are (``dense_0``, ``kernel``, ``bias``), so a
state-dict key is the flax path with ``.`` for ``/``.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn

from ..parallel.mesh import all_gather
from .initializers import (
    constant_init,
    eye_init,
    lecun_normal_init,
    normal_init,
    torch_linear_bias_init,
    torch_linear_kernel_init,
    uniform_range_init,
    xavier_normal_init,
    zeros_init,
)
from .kernels import multihead_score, take_fill


def activation_fn(name: Optional[str]) -> Callable[[torch.Tensor], torch.Tensor]:
    """Stateless activations (reference model/utils.py:10-37).  ``prelu``
    and ``dice`` carry parameters: ``MLP`` and ``StackedMLP`` build them,
    and anywhere else they raise, as in the JAX package."""
    if name is None or name == "" or name.lower() == "linear":
        return lambda x: x
    name = name.lower()
    if name == "relu":
        return torch.relu
    if name == "sigmoid":
        return torch.sigmoid
    raise NotImplementedError(f"activation {name!r}")


class MemberGenerators(list):
    """One generator per member of a stacked model (``train/multi_seed.py``):
    set as a model's draw generator, it makes every draw inside
    ``torch.func.vmap`` take member s's values from generator s, the draw a
    solo model with that generator makes (``uniform``)."""


class _MemberUniform(torch.autograd.Function):
    """U[0, 1) of ``shape`` from each member's generator, stacked, under
    vmap (``like`` carries the stack); not differentiable."""

    @staticmethod
    def forward(like, shape, generators):
        raise RuntimeError("member draws run under torch.func.vmap over the members")

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mark_non_differentiable(output)

    @staticmethod
    def backward(ctx, grad):
        return None, None, None

    @staticmethod
    def vmap(info, in_dims, like, shape, generators):
        if info.batch_size != len(generators):
            raise ValueError(f"{info.batch_size} stacked members, {len(generators)} generators")
        return torch.stack([torch.rand(shape, generator=g, device=g.device)
                            for g in generators]), 0


def uniform(shape, generator, device, like: Optional[torch.Tensor] = None) -> torch.Tensor:
    """U[0, 1) of ``shape`` on ``device`` from ``generator``, or, from
    ``MemberGenerators`` under vmap over the members, member s's draw from
    its generator s (``like``: a tensor that carries the stack)."""
    if isinstance(generator, MemberGenerators):
        return _MemberUniform.apply(like, tuple(shape), generator)
    return torch.rand(tuple(shape), generator=generator, device=device)


# ---------------------------------------------------------------------------
# The batch shard of a data-parallel step (layers.py:33-100).  Under a mesh
# each rank's step sees only its rows of the global batch; the trainer sets
# this context around a step whose batch is split over the ``data`` group
# (a ``parallel.mesh.DataGroup``: group, rank, world), and what couples the
# rows of a batch reads it: BatchNorm and DomainBatchNorm reduce their
# statistics over the group (``all_reduce_sum``), dropout draws the mask of
# the global batch and keeps the rank's rows.  Unset (one process, or a
# batch every rank holds whole) they act on the batch they are given.
# ---------------------------------------------------------------------------

_BATCH_SHARD: contextvars.ContextVar = contextvars.ContextVar("batch_shard", default=None)


@contextlib.contextmanager
def batch_shard(dp):
    """Run the block with the step's batch split over ``dp`` (None: whole)."""
    token = _BATCH_SHARD.set(dp)
    try:
        yield
    finally:
        _BATCH_SHARD.reset(token)


def current_batch_shard():
    """The data group the running step's batch is split over, or None."""
    return _BATCH_SHARD.get()


class _AllReduceSum(torch.autograd.Function):
    """The sum over the group's ranks, forward and backward: the loss of a
    data-parallel step is the sum of the ranks' losses, each reading the
    summed statistic, so the cotangent of a rank's input is the sum of
    every rank's cotangent of the statistic."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(x: torch.Tensor, dp) -> torch.Tensor:
    """``x`` summed over the ranks of ``dp`` (a differentiable all-reduce)."""
    return _AllReduceSum.apply(x, dp.group)


class _AllGatherRows(torch.autograd.Function):
    """Every rank's rows in rank order; the cotangent of a rank's rows is
    its slice of the global cotangent (each rank computes the whole of a
    loss that reads the gathered rows)."""

    @staticmethod
    def forward(ctx, x, group, rank, world):
        ctx.rank, ctx.rows = rank, x.shape[0]
        out = torch.empty((world * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype,
                          device=x.device)
        all_gather(out, x.contiguous(), group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad[ctx.rank * ctx.rows:(ctx.rank + 1) * ctx.rows], None, None, None


def all_gather_rows(x: torch.Tensor, dp) -> torch.Tensor:
    """Every rank's ``x`` of ``dp`` concatenated along dim 0 in rank order:
    the global batch of a rank's rows (differentiable)."""
    return _AllGatherRows.apply(x, dp.group, dp.rank, dp.world)


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator) -> torch.Tensor:
    """``nn.Dropout`` semantics as the JAX package's ``ShardedDropout`` has
    them (layers.py:133-160): a Bernoulli keep mask drawn from ``generator``
    (on ``x``'s device; per member from ``MemberGenerators``), kept values
    scaled by ``1 / keep``.  In a batch shard (``batch_shard``) the mask is
    drawn for the global ``[world * B, ...]`` batch, and the rank keeps its
    rows: every rank's generator draws what the one process draws, so a
    rank applies the one process's mask to its examples, and the draws after
    it stay in step."""
    if rate == 0.0:
        return x
    if rate == 1.0:
        return torch.zeros_like(x)
    keep = 1.0 - rate
    dp = _BATCH_SHARD.get()
    if dp is None:
        mask = uniform(x.shape, generator, x.device, x) < keep
    else:
        b = x.shape[0]
        whole = uniform((dp.world * b,) + tuple(x.shape[1:]), generator, x.device, x)
        mask = whole[dp.rank * b:(dp.rank + 1) * b] < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` in plain tensor ops (mmlrec_tpu/ops/layers.py:
    244-251, 327-335): statistics over the ``batch_axes`` leading axes, one
    pair per entry of ``feature_shape`` (``[F]`` inside ``MLP``, ``[K, F]``
    inside ``StackedMLP``, matching K independent ``BatchNorm1d``s; ``[F]``
    over two batch axes inside a stacked ``Dice``, flax's default
    ``axis=-1``).

    In training mode the batch statistics normalise the input and move the
    running ones, ``running = momentum * running + (1 - momentum) * batch``.
    The variance is the biased one, computed as ``mean(x^2) - mean(x)^2``
    clipped at 0, and that is also what the running variance accumulates:
    ``nn.BatchNorm1d`` keeps the unbiased one and would part from flax after
    one step.  ``scale`` and ``bias`` are parameters (none with ``affine``
    off, as Dice's ``use_scale=False, use_bias=False``), ``mean`` and
    ``var`` buffers, named as the flax leaves.  In a batch shard
    (``batch_shard``) the statistics are the global batch's: the shards are
    equal, so the rank means of ``x`` and ``x^2`` are summed over the group
    (one ``all_reduce_sum``) and divided by its size (bn_cross_replica_axis,
    layers.py:33-65); with one rank the values are the unsharded ones."""

    def __init__(self, feature_shape: Sequence[int], *, momentum: float = 0.9,
                 eps: float = 1e-5, affine: bool = True, batch_axes: int = 1):
        super().__init__()
        shape = tuple(int(n) for n in feature_shape)
        self.feature_shape, self.batch_axes = shape, int(batch_axes)
        self.momentum, self.eps = float(momentum), float(eps)
        self.scale = nn.Parameter(torch.ones(shape)) if affine else None
        self.bias = nn.Parameter(torch.zeros(shape)) if affine else None
        self.register_buffer("mean", torch.zeros(shape))
        self.register_buffer("var", torch.ones(shape))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n = self.batch_axes
        if x.dim() != len(self.feature_shape) + n:
            axes = "one batch axis" if n == 1 else f"{n} batch axes"
            raise ValueError(f"BatchNorm over {self.feature_shape} features expects {axes} "
                             f"before them, got {tuple(x.shape)}")
        if self.training:
            dims = tuple(range(n))
            mean = x.mean(dim=dims)
            sq = (x * x).mean(dim=dims)
            dp = _BATCH_SHARD.get()
            if dp is not None:
                both = all_reduce_sum(torch.stack([mean, sq]), dp) / dp.world
                mean, sq = both[0], both[1]
            var = torch.clamp(sq - mean * mean, min=0.0)
            with torch.no_grad():
                self.mean.mul_(self.momentum).add_(mean, alpha=1.0 - self.momentum)
                self.var.mul_(self.momentum).add_(var, alpha=1.0 - self.momentum)
        else:
            mean, var = self.mean, self.var
        if self.scale is None:
            return (x - mean) * torch.rsqrt(var + self.eps)
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.scale) + self.bias


class PReLU(nn.Module):
    """torch ``nn.PReLU`` (mmlrec_tpu/ops/layers.py:178-192): ``alpha``
    starts at 0.25, of shape ``(1,)`` inside ``MLP`` and ``(K, 1)`` inside a
    stack of K (one alpha per expert or task, as the reference's one
    ``nn.PReLU`` per module)."""

    def __init__(self, param_shape: Sequence[int] = (1,)):
        super().__init__()
        self.alpha = nn.Parameter(torch.full(tuple(param_shape), 0.25))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.where(x >= 0, x, self.alpha * x)


class Dice(nn.Module):
    """DIN's data-adaptive activation (mmlrec_tpu/ops/layers.py:195-214):
    ``p = sigmoid(batchnorm(x)); out = p * x + (1 - p) * alpha * x``.
    ``alpha`` [F] starts at zero; the BatchNorm (``BatchNorm_0``, as flax
    names it) has eps 1e-8, no scale and no bias, and reduces over every
    axis but the last: over B inside ``MLP``, over B and K inside a stack."""

    def __init__(self, features: int, *, batch_axes: int = 1):
        super().__init__()
        self.alpha = nn.Parameter(torch.zeros(features))
        self.BatchNorm_0 = BatchNorm((features,), eps=1e-8, affine=False, batch_axes=batch_axes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p = torch.sigmoid(self.BatchNorm_0(x))
        return p * x + (1.0 - p) * self.alpha * x


class _DNN(nn.Module):
    """What ``MLP`` and ``StackedMLP`` share: per layer ``dense_i``, BatchNorm
    ``bn_i`` before the activation when ``use_bn``, dropout after it in
    training mode (the identity at eval) with masks from the
    ``dropout_generator`` the trainer sets and reseeds every step.  A
    subclass builds the layers (``_dense``) and names the shape of one
    layer's BatchNorm statistics (``_bn_shape``).  ``prelu`` and ``dice``
    are modules of their own per layer, ``prelu_i`` and ``dice_i`` (alpha's
    shape from ``_prelu_shape``, Dice's batch axes from ``_batch_axes``)."""

    def __init__(self, in_dim: int, hidden_units: Sequence[int], *, generator: torch.Generator,
                 activation: Optional[str], dropout_rate: float, use_bn: bool, init_std: float):
        super().__init__()
        if len(hidden_units) == 0:
            raise ValueError("hidden_units is empty!!")
        kind = (activation or "").lower()
        self.act_kind = kind if kind in ("prelu", "dice") else None
        self.act = None if self.act_kind else activation_fn(activation)
        self.dropout_rate = float(dropout_rate)
        self.dropout_generator: Optional[torch.Generator] = None
        self.depth, self.use_bn = len(hidden_units), bool(use_bn)
        fan_in = in_dim
        for i, units in enumerate(hidden_units):
            self.add_module(f"dense_{i}", self._dense(
                fan_in, units, generator=generator, kernel_init=normal_init(init_std),
                bias_init=torch_linear_bias_init(fan_in)))
            if use_bn:
                self.add_module(f"bn_{i}", BatchNorm(self._bn_shape(units)))
            if self.act_kind == "prelu":
                self.add_module(f"prelu_{i}", PReLU(self._prelu_shape()))
            elif self.act_kind == "dice":
                self.add_module(f"dice_{i}", Dice(units, batch_axes=self._batch_axes))
            fan_in = units

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        drop = self.training and self.dropout_rate > 0
        if drop and self.dropout_generator is None:
            raise RuntimeError(
                "dropout in training mode needs a generator: set "
                "RecModel.set_dropout_generator (the Trainer does)")
        for i in range(self.depth):
            x = getattr(self, f"dense_{i}")(x)
            if self.use_bn:
                x = getattr(self, f"bn_{i}")(x)
            x = getattr(self, f"{self.act_kind}_{i}")(x) if self.act_kind else self.act(x)
            if drop:
                x = dropout(x, self.dropout_rate, self.dropout_generator)
        return x


class Dense(nn.Module):
    """flax ``nn.Dense``: kernel ``[in, out]`` and bias ``[out]``; by default
    flax's own init (LeCun-normal kernel, zero bias)."""

    def __init__(self, in_dim: int, features: int, *, generator: torch.Generator,
                 use_bias: bool = True, kernel_init: Optional[Callable] = None,
                 bias_init: Optional[Callable] = None):
        super().__init__()
        self.kernel = nn.Parameter((kernel_init or lecun_normal_init())(generator, (in_dim, features)))
        self.bias = None
        if use_bias:
            self.bias = nn.Parameter((bias_init or zeros_init())(generator, (features,)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x @ self.kernel
        return y if self.bias is None else y + self.bias


class MLP(_DNN):
    """Multi-layer perceptron (reference ``DNN``, model/utils.py:92-161;
    mmlrec_tpu/ops/layers.py:217-261): ``Dense`` layers with a normal(0,
    init_std) kernel and torch's default bias; BatchNorm statistics per
    feature."""

    def __init__(self, in_dim: int, hidden_units: Sequence[int], *, generator: torch.Generator,
                 activation: Optional[str] = "relu", dropout_rate: float = 0.0,
                 use_bn: bool = False, init_std: float = 1e-4):
        super().__init__(in_dim, hidden_units, generator=generator, activation=activation,
                         dropout_rate=dropout_rate, use_bn=use_bn, init_std=init_std)

    def _dense(self, fan_in, units, **init):
        return Dense(fan_in, units, **init)

    def _bn_shape(self, units):
        return (units,)

    _batch_axes = 1

    def _prelu_shape(self):
        return (1,)


class StackedDense(nn.Module):
    """K parallel Dense layers as one einsum (mmlrec_tpu/ops/layers.py:
    264-296).  Input [B, in] (broadcast to every stack member) or
    [B, K, in]; output [B, K, out]."""

    def __init__(
        self,
        stack: int,
        in_dim: int,
        features: int,
        *,
        generator: torch.Generator,
        use_bias: bool = True,
        kernel_init: Optional[Callable] = None,
        bias_init: Optional[Callable] = None,
    ):
        super().__init__()
        kinit = kernel_init or torch_linear_kernel_init()
        self.kernel = nn.Parameter(kinit(generator, (stack, in_dim, features)))
        self.bias = None
        if use_bias:
            binit = bias_init or torch_linear_bias_init(in_dim)
            self.bias = nn.Parameter(binit(generator, (stack, features)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() == 2:
            y = torch.einsum("bi,kio->bko", x, self.kernel)
        elif x.dim() == 3:
            y = torch.einsum("bki,kio->bko", x, self.kernel)
        else:
            raise ValueError(f"StackedDense expects rank 2/3 input, got {tuple(x.shape)}")
        if self.bias is not None:
            y = y + self.bias[None]
        return y


class StackedMLP(_DNN):
    """K parallel MLPs as stacked einsums (mmlrec_tpu/ops/layers.py:
    299-347): ``StackedDense`` layers; BatchNorm statistics per (stack,
    feature) pair."""

    def __init__(self, stack: int, in_dim: int, hidden_units: Sequence[int], *,
                 generator: torch.Generator, activation: Optional[str] = "relu",
                 dropout_rate: float = 0.0, use_bn: bool = False, init_std: float = 1e-4):
        self.stack = stack
        super().__init__(in_dim, hidden_units, generator=generator, activation=activation,
                         dropout_rate=dropout_rate, use_bn=use_bn, init_std=init_std)

    def _dense(self, fan_in, units, **init):
        return StackedDense(self.stack, fan_in, units, **init)

    def _bn_shape(self, units):
        return (self.stack, units)

    _batch_axes = 2

    def _prelu_shape(self):
        return (self.stack, 1)


class PredictionHeads(nn.Module):
    """Per-task output layer (reference ``PredictionLayer``, model/utils.py:
    225-248; mmlrec_tpu/ops/layers.py:350-369): a learned scalar bias per
    task (init zero), then sigmoid for binary heads.

    The port fuses the tower's final ``[T, H] -> 1`` projection into the
    head: ``forward(tower, weights)`` is one multihead-score kernel computing
    ``is_binary * sigmoid(tower . w + b) + (1 - is_binary) * (tower . w + b)``.
    ``from_logits`` is the JAX package's plain form, for logits that are no
    such product (the MLP family's one shared logit).
    """

    def __init__(self, task_types: Tuple[str, ...]):
        super().__init__()
        self.bias = nn.Parameter(torch.zeros(len(task_types)))
        binary = [1.0 if t == "binary" else 0.0 for t in task_types]
        self.register_buffer(
            "is_binary", torch.tensor(binary, dtype=torch.float32), persistent=False
        )

    def forward(self, tower: torch.Tensor, weights: torch.Tensor,
                bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        """tower [B, T, H], weights [T, H] -> [B, T].  ``bias`` [T] is the
        final layer's own bias, if it has one: added to the heads' bias
        before the kernel, where the JAX package adds it to the logit."""
        b = self.bias if bias is None else self.bias + bias
        return multihead_score(tower, weights, b, self.is_binary)

    def from_logits(self, logits: torch.Tensor) -> torch.Tensor:
        """logits [B, T] (or [B, 1], broadcast to the T heads) -> [B, T],
        in plain tensor ops as in the JAX package (layers.py:361-369)."""
        out = logits + self.bias[None]
        return self.is_binary * torch.sigmoid(out) + (1.0 - self.is_binary) * out


class WideLinear(nn.Module):
    """LR-style wide logit (reference ``Linear``, basemodel.py:14-66;
    mmlrec_tpu/ops/layers.py:372-433), the opt-in ``use_wide_linear`` term
    added to every head before its sigmoid: per-table 1-dim embeddings of
    the sparse slots summed, plus the dense values through one ``[Dd, 1]``
    kernel -> [B, 1].

    One fused ``[sum(vocab), 1]`` table of normal(init_std) draws.  Slot
    ``i`` reads column ``slot_cols[i]`` of the packed ids and table
    ``slot_tables[i]`` (features sharing an ``embedding_name`` share a
    table); the gather has ``jnp.take``'s fill mode."""

    def __init__(self, vocab_sizes: Sequence[int], n_dense: int, *, generator: torch.Generator,
                 slot_tables: Sequence[int], slot_cols: Sequence[int], init_std: float = 1e-4):
        super().__init__()
        vocab_sizes = [int(v) for v in vocab_sizes]
        self.table = self.kernel = None
        if vocab_sizes:
            offsets = [sum(vocab_sizes[:t]) for t in slot_tables]
            # index tensors on the model's device: a CUDA graph captures no
            # host-to-device copy
            self.register_buffer("slot_cols", torch.tensor(list(slot_cols), dtype=torch.long),
                                 persistent=False)
            self.register_buffer("slot_offsets", torch.tensor(offsets, dtype=torch.int32),
                                 persistent=False)
            self.table = nn.Parameter(normal_init(init_std)(generator, (sum(vocab_sizes), 1)))
        self.n_dense = int(n_dense)
        if self.n_dense:
            self.kernel = nn.Parameter(normal_init(init_std)(generator, (self.n_dense, 1)))

    def forward(self, ids: torch.Tensor, dense: torch.Tensor) -> torch.Tensor:
        logit = dense.new_zeros((ids.shape[0], 1))
        if self.table is not None:
            flat = ids.index_select(1, self.slot_cols) + self.slot_offsets[None, :]
            logit = logit + take_fill(self.table, flat)[..., 0].sum(dim=1, keepdim=True)
        if self.kernel is not None:
            logit = logit + dense[:, : self.n_dense] @ self.kernel
        return logit


class CrossStitchLayer(nn.Module):
    """Learned ``(T*F) x (T*F)`` mixing matrix, identity at init (reference
    model/cross_stitch.py:7-27; mmlrec_tpu/ops/layers.py:436-445).
    Input and output [B, T, F]."""

    def __init__(self, tasks: int, features: int, *, generator: torch.Generator):
        super().__init__()
        n = tasks * features
        self.cross_stitch_weight = nn.Parameter(eye_init()(generator, (n, n)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, f = x.shape
        return (x.reshape(b, t * f) @ self.cross_stitch_weight).reshape(b, t, f)


class AITMAttention(nn.Module):
    """AITM's two-token single-head attention transfer (reference
    model/aitm.py:44-49, 85-94; mmlrec_tpu/ops/layers.py:690-712): ``p`` is
    the information transferred from the previous task, ``q`` the task's own
    feature, both [B, F]; the output is their attention-weighted mix [B, dim]."""

    def __init__(self, in_dim: int, dim: int, *, generator: torch.Generator):
        super().__init__()
        self.dim = dim
        for name in ("h1", "h2", "h3"):
            self.add_module(name, Dense(
                in_dim, dim, generator=generator, kernel_init=torch_linear_kernel_init(),
                bias_init=torch_linear_bias_init(dim)))

    def forward(self, p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
        x = torch.stack([p, q], dim=1)  # [B, 2, F]
        V, K, Q = self.h1(x), self.h2(x), self.h3(x)
        att = torch.softmax(
            torch.sum(K * Q, dim=2, keepdim=True) / float(self.dim) ** 0.5, dim=1)
        return torch.sum(att * V, dim=1)


def sequence_pooling(seq_emb: torch.Tensor, mask: torch.Tensor, mode: str = "mean",
                     eps: float = 1e-8) -> torch.Tensor:
    """Masked pooling over a behaviour sequence (mmlrec_tpu/ops/layers.py:
    715-731): ``seq_emb`` [B, T, E], ``mask`` [B, T] (1 = valid) -> [B, E];
    "sum", "mean" (the sum over ``length + eps``) or "max" (the masked
    positions pushed down by 1e9)."""
    mask = mask.to(seq_emb.dtype)
    if mode == "max":
        return torch.amax(seq_emb - (1.0 - mask[..., None]) * 1e9, dim=1)
    summed = torch.sum(seq_emb * mask[..., None], dim=1)
    if mode == "sum":
        return summed
    if mode == "mean":
        return summed / (torch.sum(mask, dim=1, keepdim=True) + eps)
    raise ValueError(f"pooling mode {mode!r} must be sum/mean/max")


class SharedSpecificDense(nn.Module):
    """STAR's shared x specific layer (reference ``SharedSpecificLinear``,
    model/utils.py:163-223; mmlrec_tpu/ops/layers.py:448-503): domain d's
    weight is ``specific_kernel[d] * shared_kernel`` and its bias
    ``specific_bias[d] + shared_bias``; all D domains at once, [B, in] or
    [B, D, in] -> [B, D, out].  ``freeze_ref_faithful`` replays the
    reference's unregistered parameters: domains 0..D-2 of the specific
    tensors are detached (no gradient), domain D-1 trains."""

    def __init__(self, num_domains: int, in_dim: int, features: int, *,
                 generator: torch.Generator, use_shared: bool = True, use_bias: bool = True,
                 freeze_ref_faithful: bool = False):
        super().__init__()
        D = int(num_domains)
        kinit, binit = torch_linear_kernel_init(), torch_linear_bias_init(in_dim)
        self.freeze_ref_faithful = bool(freeze_ref_faithful)
        self.specific_kernel = nn.Parameter(kinit(generator, (D, in_dim, features)))
        self.specific_bias = (nn.Parameter(binit(generator, (D, features))) if use_bias
                              else None)
        self.shared_kernel = (nn.Parameter(kinit(generator, (in_dim, features))) if use_shared
                              else None)
        self.shared_bias = (nn.Parameter(binit(generator, (features,)))
                            if use_shared and use_bias else None)

    def weight_and_bias(self):
        """(weight [D, in, out], bias [D, out] or None) of every domain."""
        w, b = self.specific_kernel, self.specific_bias
        D = w.shape[0]
        if self.freeze_ref_faithful and D > 1:
            w = torch.cat([w[: D - 1].detach(), w[D - 1:]], dim=0)
            if b is not None:
                b = torch.cat([b[: D - 1].detach(), b[D - 1:]], dim=0)
        if self.shared_kernel is not None:
            w = w * self.shared_kernel[None]
        if b is not None and self.shared_bias is not None:
            b = b + self.shared_bias[None]
        return w, b

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w, b = self.weight_and_bias()
        y = torch.einsum("bi,dio->bdo" if x.dim() == 2 else "bdi,dio->bdo", x, w)
        return y if b is None else y + b[None]


class GateNN(nn.Module):
    """PEPNet's gate (reference model/pepnet.py:8-32; mmlrec_tpu/ops/
    layers.py:506-540): Dense -> (BatchNorm) -> activation -> (dropout) ->
    Dense -> 2 * sigmoid, both Dense layers with torch's default init."""

    def __init__(self, in_dim: int, output_dim: int, hidden_dim: Optional[int] = None, *,
                 generator: torch.Generator, hidden_activation: str = "relu",
                 dropout_rate: float = 0.0, batch_norm: bool = False):
        super().__init__()
        hidden = hidden_dim or output_dim
        self.dense_0 = Dense(in_dim, hidden, generator=generator,
                             kernel_init=torch_linear_kernel_init(),
                             bias_init=torch_linear_bias_init(in_dim))
        self.BatchNorm_0 = BatchNorm((hidden,)) if batch_norm else None
        self.act = activation_fn(hidden_activation)
        self.dropout_rate = float(dropout_rate)
        self.dropout_generator: Optional[torch.Generator] = None
        self.dense_1 = Dense(hidden, output_dim, generator=generator,
                             kernel_init=torch_linear_kernel_init(),
                             bias_init=torch_linear_bias_init(hidden))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.dense_0(x)
        if self.BatchNorm_0 is not None:
            x = self.BatchNorm_0(x)
        x = self.act(x)
        if self.training and self.dropout_rate > 0:
            x = dropout(x, self.dropout_rate, self.dropout_generator)
        return 2.0 * torch.sigmoid(self.dense_1(x))


class SNRGate(nn.Module):
    """SNR / MSSM routing layer (reference model/snr_trans.py:9-50,
    model/mssm.py:9-59; mmlrec_tpu/ops/layers.py:543-687): each (output j,
    input i) connection is a learned ``units x units`` transform scaled by a
    hard-concrete gate

        z = clip(sigmoid(log u - log(1 - u) + log(alpha) / beta)
                 * (epsilon - gamma) + gamma, 0, 1)

    with beta 0.9, gamma -0.1, epsilon 1.1.  ``elementwise`` off (SNR): one
    z per connection, u ``[out, in]``; on (MSSM): one z per output feature,
    u ``[out, in, units]``.  [B, in, units] -> [B, out, units] as one
    einsum.

    ``alpha`` is ``(1,)`` (the reference's ``torch.rand(1)``) or, with
    ``per_connection_alpha``, shaped as u; U(0, 1) at init, or the constant
    ``open_init_alpha`` (>= ~8.7 opens every midpoint gate fully).  It is
    clamped at 1e-8, u is clipped to [1e-8, 1 - 2^-20] (``1 - 1e-8`` is 1.0
    in f32) and ``log(1 - u)`` is ``log1p(-u)``, as in the JAX package.

    ``stochastic``: u is no parameter but drawn in training mode from
    U(1e-8, 1 - 2^-20) with ``dropout_generator`` (the trainer's, reseeded
    every step), and is the midpoint 0.5 in eval mode and while
    ``noise_off`` is set (the trainer's gate-noise warmup epochs).  The
    freezes replay the reference's unregistered parameters: ``trans``
    (SNR and MSSM) and ``u`` (MSSM, deterministic gates) are detached."""

    def __init__(self, input_dim: int, output_dim: int, units: int, *,
                 generator: torch.Generator, elementwise: bool = False, beta: float = 0.9,
                 gamma: float = -0.1, epsilon: float = 1.1, e: float = 1e-8,
                 freeze_trans_ref_faithful: bool = False, freeze_u_ref_faithful: bool = False,
                 stochastic: bool = False, per_connection_alpha: bool = False,
                 open_init_alpha: Optional[float] = None):
        super().__init__()
        self.input_dim, self.output_dim, self.units = input_dim, output_dim, units
        self.elementwise, self.stochastic = bool(elementwise), bool(stochastic)
        self.beta, self.gamma, self.epsilon, self.e = beta, gamma, epsilon, e
        self.per_connection_alpha = bool(per_connection_alpha)
        self.freeze_trans = bool(freeze_trans_ref_faithful)
        self.freeze_u = bool(freeze_u_ref_faithful) and not self.stochastic
        self.u_shape = ((output_dim, input_dim, units) if self.elementwise
                        else (output_dim, input_dim))
        alpha_shape = self.u_shape if self.per_connection_alpha else (1,)
        alpha_init = (constant_init(open_init_alpha) if open_init_alpha is not None
                      else uniform_range_init(0.0, 1.0))
        self.alpha = nn.Parameter(alpha_init(generator, alpha_shape))
        self.u = (None if self.stochastic
                  else nn.Parameter(uniform_range_init(e, 1.0 - e)(generator, self.u_shape)))
        self.trans = nn.Parameter(
            xavier_normal_init()(generator, (output_dim, input_dim, units, units)))
        #: the gate-noise warmup switch: the midpoint gate in training too
        self.noise_off = False
        self.dropout_generator: Optional[torch.Generator] = None

    def gate_u(self, device, like: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The u of this call: the parameter, or (stochastic) a draw or the
        midpoint."""
        if not self.stochastic:
            return self.u.detach() if self.freeze_u else self.u
        if self.training and not self.noise_off:
            if self.dropout_generator is None:
                raise RuntimeError(
                    "stochastic gates in training mode need a generator: set "
                    "RecModel.set_dropout_generator (the Trainer does)")
            lo, hi = self.e, 1.0 - 2.0 ** -20
            draw = uniform(self.u_shape, self.dropout_generator, device, like)
            return lo + (hi - lo) * draw
        return torch.full(self.u_shape, 0.5, device=device)

    def gates(self, u: torch.Tensor) -> torch.Tensor:
        """z [out, in] or [out, in, units] from u."""
        alpha = self.alpha if self.per_connection_alpha else self.alpha[0]
        alpha_safe = torch.clamp(alpha, min=1e-8)
        u_safe = torch.clamp(u, self.e, 1.0 - 2.0 ** -20)
        s = torch.sigmoid(torch.log(u_safe) - torch.log1p(-u_safe)
                          + torch.log(alpha_safe) / self.beta)
        return torch.clamp(s * (self.epsilon - self.gamma) + self.gamma, 0.0, 1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() != 3 or tuple(x.shape[1:]) != (self.input_dim, self.units):
            raise ValueError(f"SNRGate expects [B, {self.input_dim}, {self.units}], "
                             f"got {tuple(x.shape)}")
        z = self.gates(self.gate_u(x.device, x))
        trans = self.trans.detach() if self.freeze_trans else self.trans
        tz = trans * (z[:, :, None, :] if self.elementwise else z[:, :, None, None])
        return torch.einsum("bju,ijuv->biv", x, tz)
