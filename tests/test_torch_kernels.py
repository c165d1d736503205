"""The port's kernel wrappers on the CPU, held against the JAX package's
Pallas kernels (interpret mode) on the same numpy-made inputs.

On the CPU a wrapper runs its kernel's plain version, so these tests pin
the plain versions that the CUDA kernels are compared with on the card
(chip_smoke.py).  Tolerances: the embed-concat is pure data movement and
must match bitwise; the mix and the score sum in another order than XLA,
so they are held to f32 rounding (rtol 1e-5, atol 1e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmlrec_tpu.ops.embedding import take_rows_matmul_grad
from mmlrec_tpu.ops.pallas_kernels import (
    embed_concat,
    fused_embed_concat,
    gated_expert_mix,
    multihead_score,
)
from mmlrec_tpu_torch.ops import kernels as K


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


@pytest.mark.parametrize("V,D,B,F,Nd,block_b", [
    (64, 8, 40, 5, 3, 16),
    (32, 4, 37, 3, 2, 16),  # ragged last tile
    (128, 8, 16, 4, 1, 8),  # a one-column dense tail
])
def test_embed_concat_plain_matches_pallas_bitwise(V, D, B, F, Nd, block_b):
    rng = np.random.default_rng(V + B)
    table = rng.normal(0, 0.3, (V, D)).astype(np.float32)
    ids = rng.integers(0, V, (B, F)).astype(np.int32)
    dense = rng.normal(0, 1, (B, Nd)).astype(np.float32)
    want = fused_embed_concat(jnp.asarray(table), jnp.asarray(ids),
                              jnp.asarray(dense), block_b=block_b, interpret=True)
    got = K.embed_concat(torch.from_numpy(table), torch.from_numpy(ids),
                         torch.from_numpy(dense))
    assert got.shape == (B, F * D + Nd)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


def test_embed_concat_out_of_range_ids_follow_jnp_take():
    """The JAX forward gathers with jnp.take's fill mode: an id in [-V, 0)
    wraps once, any other out-of-range id gives a NaN row."""
    V, D, Nd = 16, 4, 2
    rng = np.random.default_rng(5)
    table = rng.normal(0, 0.3, (V, D)).astype(np.float32)
    ids = np.array([[0, -1, V - 1], [-V, -V - 1, V], [3, V + 7, -2**31]], np.int32)
    dense = rng.normal(0, 1, (3, Nd)).astype(np.float32)
    want = np.asarray(jnp.concatenate(
        [jnp.take(jnp.asarray(table), jnp.asarray(ids), axis=0).reshape(3, -1),
         jnp.asarray(dense)], axis=1))
    got = K.embed_concat(torch.from_numpy(table), torch.from_numpy(ids),
                         torch.from_numpy(dense)).numpy()
    nan = np.isnan(want)
    assert nan.any() and not nan.all()
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_array_equal(_bits(got[~nan]), _bits(want[~nan]))


def _embed_grad_case(seed=2):
    rng = np.random.default_rng(seed)
    vocab_sizes = (20, 7, 30)  # 57 rows, padded to V = 64
    V, D, B, Nd = 64, 4, 48, 3
    offsets = np.array([0, 20, 27], np.int32)
    table = rng.normal(0, 0.3, (V, D)).astype(np.float32)
    local = np.stack([rng.integers(0, v, B) for v in vocab_sizes], 1).astype(np.int32)
    local[:8, 0] = 3  # a row hit many times
    dense = rng.normal(0, 1, (B, Nd)).astype(np.float32)
    cot = rng.normal(0, 1, (B, len(vocab_sizes) * D + Nd)).astype(np.float32)
    return vocab_sizes, offsets, table, local, dense, cot


def _port_embed_grads(table, ids, dense, cot, matmul_grad=None):
    t = torch.from_numpy(table).requires_grad_(True)
    d = torch.from_numpy(dense).requires_grad_(True)
    K.reset_launch_counts()
    out = K.embed_concat(t, torch.from_numpy(ids), d, matmul_grad=matmul_grad)
    g_t, g_d = torch.autograd.grad(out, (t, d), torch.from_numpy(cot))
    assert K.backward_counts["embed_concat"] == 1 and K.launch_counts["embed_concat"] == 0
    return out.detach().numpy(), g_t.numpy(), g_d.numpy()


def test_embed_concat_gradient_matches_jax_scatter_add():
    """Against ``jax.grad`` of the JAX ``embed_concat`` (its custom_vjp's
    ``jnp`` scatter-add, pallas_kernels.py:82-88).  d_dense is a slice:
    bitwise.  d_table sums up to 8 f32 cotangents per row, in position order
    on both sides on the CPU: atol 1e-6 covers any order."""
    _, offsets, table, local, dense, cot = _embed_grad_case()
    ids = local + offsets[None]
    want_out, vjp = jax.vjp(lambda t, d: embed_concat(t, jnp.asarray(ids), d, interpret=True),
                            jnp.asarray(table), jnp.asarray(dense))
    want_t, want_d = vjp(jnp.asarray(cot))
    out, g_t, g_d = _port_embed_grads(table, ids, dense, cot)
    np.testing.assert_array_equal(_bits(out), _bits(want_out))
    np.testing.assert_array_equal(_bits(g_d), _bits(want_d))
    np.testing.assert_allclose(g_t, np.asarray(want_t), rtol=0, atol=1e-6)
    assert not g_t[57:].any()  # the pad rows


def test_embed_concat_gradient_matches_jax_onehot_matmul():
    """Against ``jax.grad`` of ``take_rows_matmul_grad`` (embedding.py:
    113-156), the route the JAX model takes for the flagship: a one-hot
    product per feature, equal to the scatter-add to f32 rounding (~4e-6 at
    flagship scale per its docstring; atol 2e-6 at 48 rows)."""
    vocab_sizes, offsets, table, local, dense, cot = _embed_grad_case()
    D = table.shape[1]
    g_rows = cot[:, : len(vocab_sizes) * D].reshape(len(local), len(vocab_sizes), D)
    _, vjp = jax.vjp(lambda t: take_rows_matmul_grad(t, jnp.asarray(local), vocab_sizes,
                                                    max(vocab_sizes)), jnp.asarray(table))
    (want_t,) = vjp(jnp.asarray(g_rows))
    ids = local + offsets[None]
    _, g_mm, g_d = _port_embed_grads(table, ids, dense, cot,
                                     matmul_grad=(vocab_sizes, torch.from_numpy(offsets)))
    np.testing.assert_allclose(g_mm, np.asarray(want_t), rtol=0, atol=2e-6)
    _, g_sc, g_d2 = _port_embed_grads(table, ids, dense, cot)
    np.testing.assert_allclose(g_mm, g_sc, rtol=0, atol=2e-6)
    np.testing.assert_array_equal(g_d, g_d2)
    np.testing.assert_array_equal(_bits(g_d), _bits(cot[:, len(vocab_sizes) * D:]))


def test_embed_concat_gradient_ignores_out_of_range_ids():
    """The forward's NaN rows (ids outside the table) add nothing to
    d_table; an id in [-V, 0) wraps once, as in the forward; two runs of the
    scatter-add give equal bits."""
    V, D = 16, 4
    table = np.zeros((V, D), np.float32)
    ids = np.array([[0, -1], [V, 3], [-V - 1, 3], [-2**31, -V]], np.int32)
    cot = np.ones((4, 2 * D), np.float32)
    out, g_t, _ = _port_embed_grads(table, ids, np.zeros((4, 0), np.float32), cot)
    want = np.zeros((V, D), np.float32)
    want[0], want[V - 1], want[3] = 2.0, 1.0, 2.0  # rows 0 (id 0, id -V), 15 (id -1), 3 (twice)
    np.testing.assert_array_equal(g_t, want)
    assert np.isnan(out).sum() == 3 * D
    _, again, _ = _port_embed_grads(table, ids, np.zeros((4, 0), np.float32), cot)
    np.testing.assert_array_equal(_bits(g_t), _bits(again))
    # the one-hot route: an id outside its feature's vocabulary adds nothing
    got = K.onehot_matmul_rows(torch.ones(2, 2, D), torch.tensor([[0, 5], [9, -1]]), (4, 6), V)
    want = np.zeros((V, D), np.float32)
    want[0], want[4 + 5] = 1.0, 1.0
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("B,T,E,D", [
    (24, 3, 4, 16), (33, 2, 4, 128),
    (32 * 2, 1, 3 + 2, 128),  # PLE's per-task gates: batch B * T, one task, spec + shared experts
    (32, 1, 2 * 3 + 2, 128),  # PLE's shared gate: one task over T * spec + shared experts
])
def test_gated_expert_mix_plain_matches_pallas(B, T, E, D):
    rng = np.random.default_rng(B)
    logits = rng.normal(0, 2, (B, T, E)).astype(np.float32)
    experts = rng.normal(0, 1, (B, E, D)).astype(np.float32)
    want = gated_expert_mix(jnp.asarray(logits), jnp.asarray(experts),
                            block_b=8, interpret=True)
    got = K.gated_expert_mix(torch.from_numpy(logits), torch.from_numpy(experts))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("B,T,H", [
    (32, 4, 8), (37, 2, 64),
    (40, 2, 128),  # a family without a tower MLP: the expert width
    (24, 1, 16), (19, 6, 64), (3, 2, 64), (21, 2, 62),  # T = 1, T = 6, batch 3, H % 4 != 0
])
def test_multihead_score_plain_matches_pallas(B, T, H):
    rng = np.random.default_rng(H)
    tower = rng.normal(0, 1, (B, T, H)).astype(np.float32)
    w = rng.normal(0, 0.3, (T, H)).astype(np.float32)
    b = rng.normal(0, 0.5, (T,)).astype(np.float32)
    want = multihead_score(jnp.asarray(tower), jnp.asarray(w), jnp.asarray(b),
                           block_b=16, interpret=True)
    got = K.multihead_score(torch.from_numpy(tower), torch.from_numpy(w),
                            torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_multihead_score_mask_is_prediction_heads():
    """With a binary/regression mask the score is the JAX PredictionHeads
    epilogue (mmlrec_tpu/ops/layers.py:366-369) after the tower's final
    StackedDense."""
    from mmlrec_tpu.ops.layers import PredictionHeads

    B, T, H = 20, 3, 8
    rng = np.random.default_rng(0)
    tower = rng.normal(0, 1, (B, T, H)).astype(np.float32)
    w = rng.normal(0, 0.3, (T, H)).astype(np.float32)
    b = rng.normal(0, 0.5, (T,)).astype(np.float32)
    types = ("binary", "regression", "binary")
    logits = jnp.einsum("bki,kio->bko", jnp.asarray(tower), jnp.asarray(w)[..., None])[..., 0]
    want = PredictionHeads(task_types=types).apply({"params": {"bias": jnp.asarray(b)}}, logits)
    binary = torch.tensor([1.0, 0.0, 1.0])
    got = K.multihead_score(torch.from_numpy(tower), torch.from_numpy(w),
                            torch.from_numpy(b), binary)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_wrappers_reject_bad_inputs():
    t = torch.zeros(8, 4)
    with pytest.raises(TypeError):
        K.embed_concat(t, torch.zeros(2, 3, dtype=torch.int64), torch.zeros(2, 1))
    with pytest.raises(ValueError):
        K.embed_concat(t, torch.zeros(2, 3, dtype=torch.int32), torch.zeros(3, 1))
    with pytest.raises(ValueError):
        K.gated_expert_mix(torch.zeros(2, 2, 4), torch.zeros(2, 3, 8))
    with pytest.raises(ValueError):
        K.multihead_score(torch.zeros(2, 2, 4), torch.zeros(2, 5), torch.zeros(2))
    # a device that is neither the CPU nor CUDA never reaches a kernel
    meta = torch.empty(2, 2, 4, device="meta")
    with pytest.raises(ValueError, match="CPU or on one CUDA device"):
        K.gated_expert_mix(meta, torch.empty(2, 4, 8, device="meta"))


# ----------------------------------------------------------------------
# embed_concat: the choice between the CUDA kernel's two bodies
# ----------------------------------------------------------------------
_ADDR = 0x7F0000000000  # a made-up device address, 16-byte aligned


@pytest.mark.parametrize("what,kwargs,vector_rows", [
    ("flagship batch", {}, 4096),
    ("the last request of the serving round", dict(batch=1000), 1000),
    ("B % 4 != 0: the last tile of 2 rows is scalar", dict(batch=4090), 4088),
    ("B % 8 == 4: a last tile of 4 rows is still vector", dict(batch=4092), 4092),
    ("fewer rows than 4", dict(batch=3), 0),
    ("D % 4 != 0", dict(dim=6, width=16 * 6 + 61), 0),
    ("D = 4", dict(dim=4, width=16 * 4 + 61), 4096),
    ("table view off by 4 bytes", dict(table_addr=_ADDR + 4), 0),
    ("table view off by 8 bytes", dict(table_addr=_ADDR + 8), 0),
    ("dense view off by 4 bytes", dict(dense_addr=_ADDR + 0x10004), 0),
    ("output off by 8 bytes", dict(out_addr=_ADDR + 0x20008), 0),
    ("no dense block (address 0)", dict(width=128, dense_addr=0), 4096),
    ("a tile image beyond the static shared memory", dict(width=2000), 0),
])
def test_embed_concat_vector_rows_on_made_up_addresses(what, kwargs, vector_rows):
    """Which batch rows the kernel's 16-byte body takes is a pure function of
    shapes and addresses: D % 4 == 0, aligned table, dense block and output,
    a tile image within 48 KB, and every tile but a last one whose row count
    is no multiple of 4."""
    assert K._EMBED_ROWS_PER_BLOCK == 8  # the cases above are written for 8-row tiles
    args = dict(batch=4096, dim=8, width=16 * 8 + 61, table_addr=_ADDR,
                dense_addr=_ADDR + 0x10000, out_addr=_ADDR + 0x20000)
    args.update(kwargs)
    assert K.embed_concat_vector_rows(**args) == vector_rows, what


def test_embed_tile_rows_match_the_cuda_source():
    import re

    source = K.LIBRARY.source.read_text()
    (default,) = re.findall(r"#define MMLREC_EMBED_TILE_ROWS (\d+)", source)
    assert int(default) == K._EMBED_ROWS_PER_BLOCK and K._EMBED_ROWS_PER_BLOCK % 4 == 0
    assert "kEmbedRowsPerBlock = MMLREC_EMBED_TILE_ROWS" in source
    # the wrapper hands the choice to the kernel: one int before the stream
    assert K.LIBRARY.signatures["mmlrec_embed_concat"][-2:] == [K._i, K._p]


# ----------------------------------------------------------------------
# multihead_score: the choice between the CUDA kernel's two bodies
# ----------------------------------------------------------------------
@pytest.mark.parametrize("what,kwargs,vector", [
    ("flagship [4096, 2, 64]", {}, True),
    ("H = 128", dict(hidden=128), True),
    ("H = 16", dict(hidden=16), True),
    ("H = 4: one lane a row", dict(hidden=4), True),
    ("H = 200: more float4 than a warp has lanes", dict(hidden=200), True),
    ("H % 4 != 0", dict(hidden=62), False),
    ("H = 1", dict(hidden=1), False),
    ("tower view off by 4 bytes", dict(tower_addr=_ADDR + 4), False),
    ("tower view off by 8 bytes", dict(tower_addr=_ADDR + 8), False),
    ("weights view off by 4 bytes", dict(weights_addr=_ADDR + 0x10004), False),
    ("more rows than the body's 32-bit thread arithmetic holds", dict(rows=2**26), False),
    ("the most rows it holds", dict(rows=2**26 - 1), True),
])
def test_multihead_score_vector_body_on_made_up_addresses(what, kwargs, vector):
    """Which body the kernel takes is a pure function of the shape and the
    addresses: H % 4 == 0, tower and weights on 16-byte boundaries."""
    args = dict(rows=4096 * 2, hidden=64, tower_addr=_ADDR, weights_addr=_ADDR + 0x10000)
    args.update(kwargs)
    assert K.multihead_score_vector_body(**args) is vector, what


@pytest.mark.parametrize("hidden,lanes,rows,grid", [
    (64, 16, 1, (512, 256)),  # a warp carries two rows
    (128, 32, 2, (512, 256)),  # a row takes a warp: a group takes two rows of one head
    (256, 32, 2, (512, 256)),  # more than a warp of float4: a lane loops
    (16, 4, 1, (128, 256)),
    (4, 1, 1, (32, 256)),
    (8, 2, 1, (64, 256)),
    (36, 16, 1, (512, 256)),  # 9 float4: the next power of two
])
def test_multihead_score_lanes_rows_and_grid(hidden, lanes, rows, grid):
    assert K.multihead_score_lanes(hidden) == lanes
    assert K.multihead_score_rows_per_group(hidden) == rows
    assert K.multihead_score_grid(4096, 2, hidden, True) == grid
    assert K.multihead_score_grid(4096, 2, hidden, False) == (1024, 256)  # a warp per row
    # a ragged last group still gets its lanes
    assert K.multihead_score_grid(3, 2, hidden, True) == (1, 256)


def test_multihead_score_constants_match_the_cuda_source():
    import re

    source = K.LIBRARY.source.read_text()
    for macro, mirror in (("MMLREC_SCORE_THREADS", K._SCORE_THREADS),
                          ("MMLREC_SCORE_ROWS_PER_GROUP", K._SCORE_ROWS_PER_GROUP),
                          ("MMLREC_SCORE_MIN_LANES", K._SCORE_MIN_LANES)):
        (default,) = re.findall(r"#define " + macro + r" (\d+)", source)
        assert int(default) == mirror, macro
    assert "kScoreThreads = MMLREC_SCORE_THREADS" in source
    # the rule of the rows a group takes, as the Python mirror has it
    assert "kScoreRowsPerGroup > 0 ? kScoreRowsPerGroup : (kLanes == 32 ? 2 : 1)" in source
    # the lanes of a group, as multihead_score_lanes computes them
    assert "while (lanes < 32 && lanes * 4 < hidden) lanes *= 2;" in source
    for lanes in (1, 2, 4, 8, 16, 32):  # one instance per group width
        assert f"launch_score_lanes<{lanes}>(" in source
    # one __global__ per body, one launch site each
    for kernel in ("multihead_score_vector_kernel", "multihead_score_scalar_kernel"):
        assert len(re.findall(r"\n" + kernel + r"\(", source)) == 1
        assert len(re.findall(kernel + r"(<[^>]*>)?\s*<<<", source)) == 1
    # the wrapper hands the choice to the kernel: one int before the stream
    assert K.LIBRARY.signatures["mmlrec_multihead_score"][-2:] == [K._i, K._p]


def test_multihead_score_on_views_and_odd_widths_takes_the_plain_version_on_the_cpu():
    """What the scalar body serves on the card (H = 62, a view off by 4
    bytes, a regression head) is the same plain function on the CPU."""
    rng = np.random.default_rng(1)
    for H in (62, 64):
        flat = torch.from_numpy(rng.normal(0, 1, 10 * 2 * H + 1).astype(np.float32))
        tower = flat[1:].view(10, 2, H)  # off by 4 bytes
        w = torch.from_numpy(rng.normal(0, 0.3, (2, H)).astype(np.float32))
        b = torch.from_numpy(rng.normal(0, 0.5, (2,)).astype(np.float32))
        binary = torch.tensor([0.0, 1.0])
        got = K.multihead_score(tower, w, b, binary)
        z = np.einsum("bth,th->bt", tower.numpy(), w.numpy()) + b.numpy()
        want = np.stack([z[:, 0], 1 / (1 + np.exp(-z[:, 1]))], 1)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
        assert not K.multihead_score_vector_body(20, H, tower.data_ptr(), w.data_ptr())
