"""Plain versions of the row kernels (B1-B4 of the two-phase step and the
library functions B8-B10), held against the JAX package's Pallas kernels on
the CPU: the fast reference path (``interpret=True``) at a step-like size,
and the genuine Pallas interpreter (``interpret="pallas"``) at a tiny one.

Tolerance: none.  The gathers and writes are pure data movement, so every
slot in the window, every row a write leaves alone, the poison of a skipped
gather slot and every duplicate id must match bitwise.  The read-modify-
write (B8) does one f32 add per element, which has no order to differ in,
and rounds to bfloat16 in integer arithmetic as XLA does: bitwise too, NaN,
infinities, denormals and ties included.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmlrec_tpu.ops.pallas_gather import (
    pallas_row_gather,
    pallas_rows_gather_dual,
    pallas_rows_gather_hbm,
)
from mmlrec_tpu.ops.pallas_scatter import (
    pallas_rows_add,
    pallas_rows_update,
    pallas_rows_write,
    pallas_rows_write_dual,
    pallas_rows_write_pipelined,
)
from mmlrec_tpu_torch.ops import cuda_build
from mmlrec_tpu_torch.ops import row_gather as G
from mmlrec_tpu_torch.ops import row_scatter as S


def _bits(a):
    a = np.asarray(a)
    if a.dtype.itemsize == 2:  # bfloat16 (ml_dtypes) or its int16 view
        return a.view(np.uint16)
    return a.view(np.uint32) if a.dtype.itemsize == 4 else a


def _bf16_bits(t):
    """The 16 bits of each element of a torch bfloat16 tensor."""
    return t.contiguous().view(torch.int16).numpy().view(np.uint16)


def _jnp_bf16(bits):
    """uint16 bits -> a jnp bfloat16 array with those bits."""
    return jnp.asarray(bits.astype(np.uint16)).view(jnp.bfloat16)


def _torch_bf16(bits):
    return torch.from_numpy(bits.astype(np.uint16).view(np.int16).copy()).view(torch.bfloat16)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _windows(K, n_real):
    """(JAX kwargs, port kwargs) for no window, n_real and bounds."""
    nr = np.asarray([n_real], np.int32)
    b = np.asarray([3, n_real], np.int32)
    return [
        ({}, {}),
        ({"n_real": jnp.asarray(nr)}, {"n_real": _t(nr)}),
        ({"bounds": jnp.asarray(b)}, {"bounds": _t(b)}),
    ]


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_rows_gather_dual_plain_matches_jax(dtype):
    rng = np.random.default_rng(0)
    V, W, K = 300, 128, 256
    if dtype == np.float32:
        stacked = rng.normal(size=(2, V, W)).astype(np.float32)
    else:
        stacked = rng.integers(-2**31, 2**31, (2, V, W), dtype=np.int64).astype(np.int32)
    ids = rng.integers(0, 40, K).astype(np.int32)  # heavy duplication
    ids[:3] = [-1, -V, V + 7]  # wraps once; outside the table
    for jkw, tkw in _windows(K, 200):
        want = pallas_rows_gather_dual(jnp.asarray(stacked), jnp.asarray(ids),
                                       interpret=True, **jkw)
        got = G.rows_gather_dual(_t(stacked), _t(ids), **tkw)
        assert got.dtype == torch.from_numpy(stacked).dtype
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


def test_rows_gather_dual_plain_matches_pallas_interpreter():
    rng = np.random.RandomState(3)
    V, W, K = 64, 128, 16
    ids = rng.choice(V, size=K, replace=True).astype(np.int32)
    stacked = rng.rand(2, V, W).astype(np.float32)
    n_real = np.asarray([11], np.int32)
    interp = pallas_rows_gather_dual(jnp.asarray(stacked), jnp.asarray(ids),
                                     n_real=jnp.asarray(n_real), chunk=4,
                                     interpret="pallas")
    got = G.rows_gather_dual(_t(stacked), _t(ids), n_real=_t(n_real)).numpy()
    np.testing.assert_array_equal(got[:, :11], np.asarray(interp)[:, :11])
    assert np.isnan(got[:, 11:]).all()  # skipped slots: the poison
    full = pallas_rows_gather_dual(jnp.asarray(stacked), jnp.asarray(ids), chunk=4,
                                   interpret="pallas")
    np.testing.assert_array_equal(G.rows_gather_dual(_t(stacked), _t(ids)).numpy(),
                                  np.asarray(full))


def test_rows_gather_hbm_plain_matches_jax():
    rng = np.random.default_rng(1)
    V, W, K = 200, 128, 256
    table = rng.normal(size=(V, W)).astype(np.float32)
    ids = rng.integers(0, V, K).astype(np.int32)
    ids[:4] = [5, 5, -3, V]  # duplicates, a wrapped id, an id past the end
    want = pallas_rows_gather_hbm(jnp.asarray(table), jnp.asarray(ids), interpret=True)
    got = G.rows_gather_hbm(_t(table), _t(ids))
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    # tiny: the genuine interpreter (in-range ids, duplicates)
    small_ids = rng.integers(0, 64, 16).astype(np.int32)
    small = table[:64]
    interp = pallas_rows_gather_hbm(jnp.asarray(small), jnp.asarray(small_ids), chunk=8,
                                    interpret="pallas")
    np.testing.assert_array_equal(
        G.rows_gather_hbm(_t(small), _t(small_ids)).numpy(), np.asarray(interp))


def _unique_ids(rng, V, K, n_real, pad):
    real = np.sort(rng.choice(V, size=n_real, replace=False))
    return np.concatenate([real, np.full(K - n_real, pad)]).astype(np.int32)


@pytest.mark.parametrize("pad", ["n_phys_rows", "distinct"])
def test_rows_write_dual_plain_matches_jax(pad):
    rng = np.random.default_rng(2)
    V, W, K, n = 300, 128, 256, 180
    if pad == "n_phys_rows":  # device metadata: pads one past the last row
        ids = _unique_ids(rng, V, K, n, V)
    else:  # host metadata: distinct untouched rows
        ids = rng.permutation(V)[:K].astype(np.int32)
    stacked = rng.normal(size=(2, V, W)).astype(np.float32)
    values = rng.normal(size=(2, K, W)).astype(np.float32)
    for jkw, tkw in _windows(K, n):
        if pad == "n_phys_rows" and not jkw:
            continue  # every slot in the window: the pads would be stored
        want = pallas_rows_write_dual(jnp.asarray(stacked), jnp.asarray(ids),
                                      jnp.asarray(values), interpret=True, **jkw)
        arr = _t(stacked.copy())
        got = S.rows_write_dual(arr, _t(ids), _t(values), **tkw)
        assert got is arr  # in place
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


def test_rows_write_plain_matches_jax_mixed_widths_and_dtypes():
    rng = np.random.default_rng(4)
    V, K, n = 300, 256, 150
    ids = _unique_ids(rng, V, K, n, V)
    table = rng.normal(size=(V, 128)).astype(np.float32)
    monu = rng.integers(-2**31, 2**31, (V, 8), dtype=np.int64).astype(np.int32)
    v_t = rng.normal(size=(K, 128)).astype(np.float32)
    v_m = rng.integers(-2**31, 2**31, (K, 8), dtype=np.int64).astype(np.int32)
    for jkw, tkw in _windows(K, n)[1:]:
        want = pallas_rows_write((jnp.asarray(table), jnp.asarray(monu)), jnp.asarray(ids),
                                 (jnp.asarray(v_t), jnp.asarray(v_m)), interpret=True, **jkw)
        arrays = (_t(table.copy()), _t(monu.copy()))
        got = S.rows_write(arrays, _t(ids), (_t(v_t), _t(v_m)), **tkw)
        assert got[0] is arrays[0] and got[1] is arrays[1]
        for g, w in zip(got, want):
            np.testing.assert_array_equal(_bits(g.numpy()), _bits(w))


def test_row_writes_plain_match_pallas_interpreter():
    rng = np.random.RandomState(11)
    V, D, K = 64, 128, 16
    real = rng.choice(V, size=10, replace=False).astype(np.int32)
    pads = np.setdiff1d(np.arange(V), real)[: K - 10].astype(np.int32)
    ids = np.concatenate([np.sort(real), pads])
    table = rng.rand(V, D).astype(np.float32)
    monu = rng.rand(V, D).astype(np.float32)
    vals = rng.randn(2, K, D).astype(np.float32)
    for jkw, tkw in _windows(K, 10)[1:]:
        a = pallas_rows_write((jnp.asarray(table), jnp.asarray(monu)), jnp.asarray(ids),
                              (jnp.asarray(vals[0]), jnp.asarray(vals[1])), chunk=4,
                              interpret="pallas", **jkw)
        b = S.rows_write((_t(table.copy()), _t(monu.copy())), _t(ids),
                         (_t(vals[0]), _t(vals[1])), **tkw)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(np.asarray(x), y.numpy())
        stacked = np.stack([table, monu])
        c = pallas_rows_write_dual(jnp.asarray(stacked), jnp.asarray(ids), jnp.asarray(vals),
                                   chunk=4, interpret="pallas", **jkw)
        d = S.rows_write_dual(_t(stacked.copy()), _t(ids), _t(vals), **tkw)
        np.testing.assert_array_equal(np.asarray(c), d.numpy())


def test_row_kernels_route_cpu_tensors_to_the_plain_versions(monkeypatch):
    def no_kernel(*a, **k):
        raise AssertionError("a CPU tensor reached the CUDA path")

    monkeypatch.setattr(G.LIBRARY, "load", no_kernel)
    monkeypatch.setattr(cuda_build, "launch", no_kernel)
    cuda_build.reset_launch_counts()
    stacked = torch.randn(2, 32, 8)
    ids = torch.tensor([1, 1, 31, 0], dtype=torch.int32)
    n_real = torch.tensor([3], dtype=torch.int32)
    assert G.rows_gather_dual(stacked, ids, n_real=n_real).shape == (2, 4, 8)
    assert G.rows_gather_hbm(stacked[0], ids).shape == (4, 8)
    S.rows_write((stacked[0].clone(),), torch.tensor([4, 2, 32, 32], dtype=torch.int32),
                 (torch.randn(4, 8),), n_real=torch.tensor([2], dtype=torch.int32))
    S.rows_write_dual(stacked, torch.tensor([4, 2, 32, 32], dtype=torch.int32),
                      torch.randn(2, 4, 8), n_real=torch.tensor([2], dtype=torch.int32))
    assert all(v == 0 for v in cuda_build.launch_counts.values())


def test_row_kernels_check_their_inputs():
    stacked = torch.randn(2, 8, 4)
    with pytest.raises(TypeError, match="int32"):
        G.rows_gather_dual(stacked, torch.arange(3))
    with pytest.raises(TypeError, match="must be one of"):
        G.rows_gather_hbm(stacked[0].double(), torch.arange(3, dtype=torch.int32))
    with pytest.raises(ValueError, match=r"\[2, V, W\]"):
        S.rows_write_dual(stacked[0], torch.arange(3, dtype=torch.int32), torch.zeros(3, 4))
    with pytest.raises(TypeError, match="do not match"):
        S.rows_write((stacked[0],), torch.arange(3, dtype=torch.int32),
                     (torch.zeros(3, 4, dtype=torch.float64),))
    with pytest.raises(ValueError, match="one CUDA device"):
        G.rows_gather_hbm(torch.empty(8, 4, device="meta"), torch.arange(3, dtype=torch.int32))
    assert set(S.launch_counts) >= {"rows_gather_dual", "rows_gather_hbm", "rows_write",
                                    "rows_write_dual", "row_gather", "rows_write_pipelined",
                                    "rows_update"}


# ----------------------------------------------------------------------
# B9: row_gather
# ----------------------------------------------------------------------
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_row_gather_plain_matches_jax(dtype):
    rng = np.random.default_rng(9)
    V, D, K = 200, 128, 256
    if dtype == np.float32:
        table = rng.normal(size=(V, D)).astype(np.float32)
    else:
        table = rng.integers(-2**31, 2**31, (V, D), dtype=np.int64).astype(np.int32)
    ids = rng.integers(0, V, K).astype(np.int32)
    ids[:5] = [7, 7, -3, V, -V - 1]  # duplicates, a wrapped id, ids outside the table
    want = jnp.take(jnp.asarray(table), jnp.asarray(ids), axis=0)  # the kernel's stated math
    got = G.row_gather(_t(table), _t(ids), chunk=64)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    np.testing.assert_array_equal(_bits(got.numpy()),
                                  _bits(G.rows_gather_hbm(_t(table), _t(ids)).numpy()))
    # the genuine interpreter (in-range ids: its row copies have no fill mode)
    small_ids = rng.integers(0, 64, 16).astype(np.int32)
    interp = pallas_row_gather(jnp.asarray(table[:64]), jnp.asarray(small_ids), chunk=8,
                               interpret=True)
    np.testing.assert_array_equal(
        _bits(G.row_gather(_t(table[:64]), _t(small_ids), chunk=8).numpy()), _bits(interp))
    with pytest.raises(ValueError, match="multiple of chunk"):
        G.row_gather(_t(table), _t(ids[:100]), chunk=64)


# ----------------------------------------------------------------------
# B10: rows_write_pipelined
# ----------------------------------------------------------------------
def test_rows_write_pipelined_plain_matches_jax_and_rows_write():
    rng = np.random.default_rng(10)
    V, K, n = 300, 256, 150
    ids = _unique_ids(rng, V, K, n, V)
    table = rng.normal(size=(V, 128)).astype(np.float32)
    monu = rng.integers(-2**31, 2**31, (V, 8), dtype=np.int64).astype(np.int32)
    v_t = rng.normal(size=(K, 128)).astype(np.float32)
    v_m = rng.integers(-2**31, 2**31, (K, 8), dtype=np.int64).astype(np.int32)
    for jkw, tkw in _windows(K, n)[1:]:
        want = pallas_rows_write_pipelined(
            (jnp.asarray(table), jnp.asarray(monu)), jnp.asarray(ids),
            (jnp.asarray(v_t), jnp.asarray(v_m)), interpret=True, **jkw)
        arrays = (_t(table.copy()), _t(monu.copy()))
        got = S.rows_write_pipelined(arrays, _t(ids), (_t(v_t), _t(v_m)), **tkw)
        assert got[0] is arrays[0] and got[1] is arrays[1]  # in place
        unpiped = S.rows_write((_t(table.copy()), _t(monu.copy())), _t(ids),
                               (_t(v_t), _t(v_m)), **tkw)
        for g, w, u in zip(got, want, unpiped):
            np.testing.assert_array_equal(_bits(g.numpy()), _bits(w))
            np.testing.assert_array_equal(_bits(g.numpy()), _bits(u.numpy()))
    with pytest.raises(ValueError, match="multiple of chunk"):
        S.rows_write_pipelined((_t(table.copy()),), _t(ids[:100]), (_t(v_t[:100]),), chunk=64)


def test_rows_write_pipelined_plain_matches_pallas_interpreter():
    """The shapes of tests/test_pallas_kernels.py:158-188: n_real and the
    [lo, hi) bounds mode, boundary chunks, distinct pad rows at the tail."""
    rng = np.random.RandomState(7)
    V, D, K = 64, 128, 16
    real = rng.choice(V, size=10, replace=False).astype(np.int32)
    pads = np.setdiff1d(np.arange(V), real)[: K - 10].astype(np.int32)
    ids = np.concatenate([np.sort(real), pads])
    table, monu = rng.rand(V, D).astype(np.float32), rng.rand(V, D).astype(np.float32)
    vals = rng.randn(2, K, D).astype(np.float32)
    for jkw, tkw in _windows(K, 10)[1:]:
        a = pallas_rows_write_pipelined(
            (jnp.asarray(table), jnp.asarray(monu)), jnp.asarray(ids),
            (jnp.asarray(vals[0]), jnp.asarray(vals[1])), chunk=4, interpret="pallas", **jkw)
        b = S.rows_write_pipelined((_t(table.copy()), _t(monu.copy())), _t(ids),
                                   (_t(vals[0]), _t(vals[1])), chunk=4, **tkw)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(_bits(x), _bits(y.numpy()))


# ----------------------------------------------------------------------
# B8: rows_update / rows_add
# ----------------------------------------------------------------------
_SPECIAL_F32 = np.array(
    [0x00000000, 0x80000000, 0x7F800000, 0xFF800000, 0x7FC00000, 0xFFC00001, 0x7F800001,
     0x00800000, 0x3F808000, 0x3F818000, 0x3F807FFF, 0x3F808001, 0x7F7FFFFF, 0xFF7FFFFF,
     0x7F7F8000, 0x33800000, 0xB3800000],
    np.uint32).view(np.float32)  # zeros, infs, NaNs, bf16 ties, the smallest normal, the largest
# f32 denormals are held against numpy, not JAX: XLA's CPU backend treats a
# denormal operand of an add as zero, which is no part of the contract
_DENORMAL_F32 = np.array([0x00000001, 0x80000001, 0x007FFFFF, 0x807FFFFF, 0x00010000,
                          0x00018000], np.uint32).view(np.float32)


def test_rows_update_plain_matches_jax_add_and_set():
    """(table "add", monu "set") with an n_real window: the reference path
    at a step-like size; the mask holds -0.0 (a zero) and a NaN (not one),
    and the payload of the "set" array is opaque bits (NaN patterns kept)."""
    rng = np.random.default_rng(8)
    V, W, K, n = 300, 128, 256, 180
    ids = _unique_ids(rng, V, K, n, V)  # pads one past the last row: clipped, then skipped
    ids[0] = -5  # below the table: clipped to row 0 (row 0 is no other slot's)
    ids[1:n] = np.sort(rng.choice(np.arange(1, V), size=n - 1, replace=False))
    table = rng.normal(size=(V, W)).astype(np.float32)
    table[ids[1], : len(_SPECIAL_F32)] = _SPECIAL_F32
    monu = rng.integers(0, 2**32, (V, W), dtype=np.int64).astype(np.uint32).view(np.float32)
    d_t = rng.normal(size=(K, W)).astype(np.float32)
    d_t[2, : len(_SPECIAL_F32)] = _SPECIAL_F32
    d_m = rng.integers(0, 2**32, (K, W), dtype=np.int64).astype(np.uint32).view(np.float32)
    mask = (rng.random((K, W)) > 0.5).astype(np.float32)
    mask[3, :4] = [-0.0, np.nan, 0.0, -1.0]
    nr = np.asarray([n], np.int32)
    for n_real_j, n_real_t in ((jnp.asarray(nr), _t(nr)), (None, None)):
        if n_real_j is None:
            ids_run = np.sort(rng.choice(V, size=K, replace=False)).astype(np.int32)
        else:
            ids_run = ids
        want = pallas_rows_update(
            (jnp.asarray(table), jnp.asarray(monu)), jnp.asarray(ids_run),
            (jnp.asarray(d_t), jnp.asarray(d_m)), modes=("add", "set"),
            masks=(None, jnp.asarray(mask)), n_real=n_real_j, interpret=True)
        arrays = (_t(table.copy()), _t(monu.copy()))
        got = S.rows_update(arrays, _t(ids_run), (_t(d_t), _t(d_m)), modes=("add", "set"),
                            masks=(None, _t(mask)), n_real=n_real_t)
        assert got[0] is arrays[0] and got[1] is arrays[1]  # in place
        for g, w in zip(got, want):
            np.testing.assert_array_equal(_bits(g.numpy()), _bits(w))


def test_rows_update_set_on_int32_lanes_matches_jax():
    rng = np.random.default_rng(18)
    V, W, K = 64, 8, 16
    ids = rng.permutation(V)[:K].astype(np.int32)
    arr = rng.integers(-2**31, 2**31, (V, W), dtype=np.int64).astype(np.int32)
    d = rng.integers(-2**31, 2**31, (K, W), dtype=np.int64).astype(np.int32)
    mask = rng.integers(-1, 2, (K, W)).astype(np.int32)
    (want,) = pallas_rows_update((jnp.asarray(arr),), jnp.asarray(ids), (jnp.asarray(d),),
                                 modes=("set",), masks=(jnp.asarray(mask),), chunk=8,
                                 interpret=True)
    (got,) = S.rows_update((_t(arr.copy()),), _t(ids), (_t(d),), modes=("set",),
                           masks=(_t(mask),), chunk=8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("delta", ["float32", "bfloat16"])
def test_rows_add_bf16_storage_matches_jax_bitwise(delta):
    """f32 (or bf16) deltas into a bf16 array (tests/test_pallas_kernels.py:
    105-125): the f32 sum is rounded to bf16 as XLA rounds it.  The special
    values ride as old rows against zero deltas and as deltas against zero
    rows, so that every sum is one of them."""
    rng = np.random.default_rng(5)
    V, D, K = 32, 128, 8
    ids = rng.permutation(V)[:K].astype(np.int32)
    nu = rng.random((V, D)).astype(np.float32)
    d_n = rng.normal(size=(K, D)).astype(np.float32)
    ns = len(_SPECIAL_F32)
    nu[ids[0], :ns], d_n[0, :ns] = _SPECIAL_F32, 0.0
    nu[ids[1], :ns], d_n[1, :ns] = 0.0, _SPECIAL_F32
    nu_bits = np.asarray(jnp.asarray(nu).astype(jnp.bfloat16).view(jnp.uint16))
    if delta == "bfloat16":
        d_bits = np.asarray(jnp.asarray(d_n).astype(jnp.bfloat16).view(jnp.uint16))
        d_j, d_t = _jnp_bf16(d_bits), _torch_bf16(d_bits)
    else:
        d_j, d_t = jnp.asarray(d_n), _t(d_n)
    (want,) = pallas_rows_add((_jnp_bf16(nu_bits),), jnp.asarray(ids), (d_j,), chunk=8,
                              interpret=True)
    (got,) = S.rows_add((_torch_bf16(nu_bits),), _t(ids), (d_t,), chunk=8)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bf16_bits(got), np.asarray(want.view(jnp.uint16)))


def test_rows_add_keeps_denormals():
    """Denormal rows and deltas pass through the f32 add and the bf16 round
    unflushed: 0 + x == x, and a bf16 denormal keeps its bits."""
    n = len(_DENORMAL_F32)
    ids = torch.arange(2, dtype=torch.int32)
    arr32 = torch.zeros(2, n)
    arr32[0] = _t(_DENORMAL_F32)
    d = torch.zeros(2, n)
    d[1] = _t(_DENORMAL_F32)
    (got,) = S.rows_add((arr32.clone(),), ids, (d,), chunk=2)
    np.testing.assert_array_equal(_bits(got.numpy()), np.stack([_bits(_DENORMAL_F32)] * 2))
    # into bf16: round-to-nearest-even of the denormal's bits, in integers
    b = _bits(_DENORMAL_F32).astype(np.uint64)
    want = (((b + 0x7FFF + ((b >> 16) & 1)) >> 16) & 0xFFFF).astype(np.uint16)
    (got16,) = S.rows_add((torch.zeros(2, n, dtype=torch.bfloat16),), ids, (arr32 + d,), chunk=2)
    np.testing.assert_array_equal(_bf16_bits(got16), np.stack([want] * 2))
    assert want[4] == 0x0001 and want[5] == 0x0002  # a bf16 denormal, and a tie to even


def test_rows_update_plain_matches_pallas_interpreter():
    """The shapes of tests/test_pallas_kernels.py:82-125 and :221-236."""
    rng = np.random.RandomState(11)
    V, D, K = 64, 128, 16
    real = rng.choice(V, size=10, replace=False).astype(np.int32)
    pads = np.setdiff1d(np.arange(V), real)[: K - 10].astype(np.int32)
    ids = np.concatenate([np.sort(real), pads])
    table, monu = rng.rand(V, D).astype(np.float32), rng.rand(V, D).astype(np.float32)
    d_t = rng.randn(K, D).astype(np.float32)
    d_t[10:] = 0.0  # the Pallas body runs the boundary chunk in full
    mask = (rng.rand(K, D) > 0.5).astype(np.float32)
    d_m = rng.randn(K, D).astype(np.float32) * mask
    mask[10:] = 0.0
    nr = np.asarray([10], np.int32)
    a = pallas_rows_update((jnp.asarray(table), jnp.asarray(monu)), jnp.asarray(ids),
                           (jnp.asarray(d_t), jnp.asarray(d_m)), modes=("add", "set"),
                           masks=(None, jnp.asarray(mask)), n_real=jnp.asarray(nr), chunk=4,
                           interpret="pallas")
    b = S.rows_update((_t(table.copy()), _t(monu.copy())), _t(ids), (_t(d_t), _t(d_m)),
                      modes=("add", "set"), masks=(None, _t(mask)), n_real=_t(nr), chunk=4)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(_bits(x), _bits(y.numpy()))
    # all-"add" over two arrays, every slot real
    uniq = rng.choice(V, size=K, replace=False).astype(np.int32)
    a = pallas_rows_add((jnp.asarray(table), jnp.asarray(monu)), jnp.asarray(uniq),
                        (jnp.asarray(d_t), jnp.asarray(d_m)), chunk=8, interpret="pallas")
    b = S.rows_add((_t(table.copy()), _t(monu.copy())), _t(uniq), (_t(d_t), _t(d_m)), chunk=8)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(_bits(x), _bits(y.numpy()))


def test_rows_update_checks_its_inputs_and_routes_cpu_tensors(monkeypatch):
    def no_kernel(*a, **k):
        raise AssertionError("a CPU tensor reached the CUDA path")

    monkeypatch.setattr(G.LIBRARY, "load", no_kernel)
    monkeypatch.setattr(cuda_build, "launch", no_kernel)
    cuda_build.reset_launch_counts()
    arr, ids = torch.zeros(8, 4), torch.arange(4, dtype=torch.int32)
    d = torch.ones(4, 4)
    S.rows_add((arr,), ids, (d,), chunk=4)
    assert arr[:4].eq(1).all() and not arr[4:].any()
    G.row_gather(arr, ids, chunk=2)
    S.rows_write_pipelined((arr,), ids, (d,), chunk=2)
    assert all(v == 0 for v in cuda_build.launch_counts.values())
    with pytest.raises(ValueError, match="mask"):
        S.rows_update((arr,), ids, (d,), modes=("set",), chunk=4)
    with pytest.raises(TypeError, match="'add' array"):
        S.rows_add((arr.int(),), ids, (d,), chunk=4)
    with pytest.raises(TypeError, match="dtype"):
        S.rows_update((arr,), ids, (d,), modes=("set",), masks=(d.int(),), chunk=4)
    with pytest.raises(ValueError, match="multiple of chunk"):
        S.rows_add((arr,), ids, (d,), chunk=3)
    with pytest.raises(ValueError, match="'add' or 'set'"):
        S.rows_update((arr,), ids, (d,), modes=("mul",), chunk=4)
    with pytest.raises(ValueError, match="one CUDA device"):
        S.rows_add((torch.empty(8, 4, device="meta"),), ids, (d,), chunk=4)


# ----------------------------------------------------------------------
# B8: the wide path of the CUDA kernel (what the card's check relies on)
# ----------------------------------------------------------------------
_BASE = 0x7F0000000000  # a made-up device address, 16-byte aligned


@pytest.mark.parametrize("what,es,des,kwargs,run", [
    # 128-wide rows at aligned addresses: every pair takes the wide path
    ("f32 += f32", 4, 4, {}, 4),
    ("bf16 += f32", 2, 4, {}, 8),
    ("bf16 += bf16", 2, 2, {}, 8),
    ("f32 += bf16", 4, 2, {}, 8),
    ("bf16 set", 2, 2, dict(mask_addr=_BASE + 0x4000, mask_row_bytes=256), 8),
    ("f32 set", 4, 4, dict(mask_addr=_BASE + 0x4000, mask_row_bytes=512), 4),
    # a width that is no multiple of the lane's run
    ("odd width, f32 += f32", 4, 4, dict(width=127), 1),
    ("odd width, bf16 += f32", 2, 4, dict(width=127), 1),
    ("width 126, bf16 += bf16", 2, 2, dict(width=126), 1),
    ("width 132: whole runs of 4", 4, 4, dict(width=132, delta_row_bytes=132 * 4), 4),
    ("width 132: no whole runs of 8", 2, 4, dict(width=132, delta_row_bytes=132 * 4), 1),
    ("width 136", 2, 4, dict(width=136, delta_row_bytes=136 * 4), 8),
    # an address off its access: 8 bf16 are 16 bytes, 8 f32 two accesses of 16
    ("bf16 array off by 2 bytes", 2, 4, dict(array_addr=_BASE + 2), 1),
    ("bf16 array off by 4 bytes", 2, 4, dict(array_addr=_BASE + 4), 1),
    ("bf16 array off by 8 bytes", 2, 4, dict(array_addr=_BASE + 8), 1),
    ("f32 array off by 4 bytes", 4, 4, dict(array_addr=_BASE + 4), 1),
    ("f32 array off by 8 bytes", 4, 2, dict(array_addr=_BASE + 8), 1),
    ("f32 delta off by 4 bytes", 2, 4, dict(delta_addr=_BASE + 0x2000 + 4), 1),
    ("f32 delta off by 8 bytes", 2, 4, dict(delta_addr=_BASE + 0x2000 + 8), 1),
    ("bf16 delta off by 2 bytes", 4, 2, dict(delta_addr=_BASE + 0x2000 + 2), 1),
    ("bf16 delta off by 8 bytes", 4, 2, dict(delta_addr=_BASE + 0x2000 + 8), 1),
    # a strided delta: rows further apart than their width
    ("strided f32 delta", 2, 4, dict(delta_row_bytes=128 * 4 + 4), 1),
    ("strided f32 delta, a 16-byte multiple", 2, 4, dict(delta_row_bytes=128 * 4 + 16), 8),
    ("strided bf16 delta", 2, 2, dict(delta_row_bytes=128 * 2 + 2), 1),
    ("strided bf16 delta, 8 bytes", 2, 2, dict(delta_row_bytes=128 * 2 + 8), 1),
    ("bf16 mask off by 2 bytes", 2, 2, dict(mask_addr=_BASE + 0x4002, mask_row_bytes=256), 1),
    ("bf16 mask rows 258 bytes apart", 2, 2,
     dict(mask_addr=_BASE + 0x4000, mask_row_bytes=258), 1),
])
def test_update_lane_run_on_made_up_addresses(what, es, des, kwargs, run):
    """The choice of the kernel's path is a pure function of width, element
    sizes, addresses and strides: a lane's run is 4 elements of a 4-byte
    pair and ``_LANE_ELEMS`` where a bf16 operand takes part, each operand's
    rows must be aligned to min(16, run x element size) bytes, and anything
    else takes one element a lane."""
    assert S._LANE_ELEMS == 8  # the cases above are written for a run of 8
    args = dict(width=128, array_addr=_BASE, delta_addr=_BASE + 0x2000,
                delta_row_bytes=128 * des)
    args.update(kwargs)
    assert S.update_lane_run(elem_size=es, delta_elem_size=des, **args) == run, what


@pytest.mark.parametrize("widths,runs,lanes", [
    ((128,), (4,), 32),  # a 128-wide f32 row: a warp per slot
    ((128,), (8,), 16),  # a 128-wide bf16 row: two slots a warp
    ((128, 128), (8, 4), 32),  # the widest row decides
    ((32,), (8,), 4),
    ((8,), (4,), 2),
    ((4,), (4,), 1),
    ((126,), (1,), 32),  # one element a lane
    ((20,), (1,), 32),
    ((16,), (1,), 16),
    ((1024,), (4,), 32),  # more than one pass of a warp
])
def test_update_lanes_per_slot(widths, runs, lanes):
    assert S.update_lanes_per_slot(widths, runs) == lanes


def test_update_lane_run_matches_the_cuda_source():
    import re

    source = G.LIBRARY.source.read_text()
    (default,) = re.findall(r"#define MMLREC_UPDATE_LANE_ELEMS (\d+)", source)
    assert int(default) == S._LANE_ELEMS
    assert "kLaneElems = MMLREC_UPDATE_LANE_ELEMS" in source


def test_rows_add_bf16_deltas_into_f32_matches_jax_bitwise():
    """bf16 deltas into an f32 array: the delta widened exactly (bits << 16),
    one f32 add, no rounding."""
    rng = np.random.default_rng(15)
    V, D, K = 32, 128, 8
    ids = rng.permutation(V)[:K].astype(np.int32)
    table = rng.normal(size=(V, D)).astype(np.float32)
    d = rng.normal(size=(K, D)).astype(np.float32)
    ns = len(_SPECIAL_F32)
    table[ids[0], :ns], d[0, :ns] = _SPECIAL_F32, 0.0
    table[ids[1], :ns], d[1, :ns] = 0.0, _SPECIAL_F32
    d_bits = np.asarray(jnp.asarray(d).astype(jnp.bfloat16).view(jnp.uint16))
    nr = np.asarray([6], np.int32)
    for n_real_j, n_real_t in ((None, None), (jnp.asarray(nr), _t(nr))):
        (want,) = pallas_rows_add((jnp.asarray(table),), jnp.asarray(ids), (_jnp_bf16(d_bits),),
                                  n_real=n_real_j, chunk=8, interpret=True)
        (got,) = S.rows_add((_t(table.copy()),), _t(ids), (_torch_bf16(d_bits),),
                            n_real=n_real_t, chunk=8)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


def test_rows_update_set_on_bf16_lanes_matches_jax_bitwise():
    """"set" on a bf16 array: the payload is opaque 16-bit lanes (NaN
    patterns and denormals kept), the mask is compared as a value (-0.0 is a
    zero, a NaN is not)."""
    rng = np.random.default_rng(16)
    V, D, K, n = 64, 128, 16, 12
    ids = _unique_ids(rng, V, K, n, V)
    def payload(shape):
        # any bits, but every NaN the quiet NaN of its sign: XLA's CPU backend
        # widens a bf16 select to f32 and back, which turns every other NaN
        # into that one (no part of the contract; the second half of this
        # test holds NaN payloads against numpy)
        bits = rng.integers(0, 2**16, shape).astype(np.uint16)
        nan = ((bits & 0x7F80) == 0x7F80) & ((bits & 0x007F) != 0)
        return np.where(nan, (bits & 0x8000) | 0x7FC0, bits).astype(np.uint16)

    arr, vals = payload((V, D)), payload((K, D))
    mask = np.where(rng.random((K, D)) > 0.5, 0x3F80, 0).astype(np.uint16)  # 1.0 or 0.0
    mask[0, :4] = [0x8000, 0x7FC0, 0x0000, 0xBF80]  # -0.0, NaN, 0.0, -1.0
    nr = np.asarray([n], np.int32)
    (want,) = pallas_rows_update((_jnp_bf16(arr),), jnp.asarray(ids), (_jnp_bf16(vals),),
                                 modes=("set",), masks=(_jnp_bf16(mask),),
                                 n_real=jnp.asarray(nr), chunk=8, interpret=True)
    (got,) = S.rows_update((_torch_bf16(arr),), _t(ids), (_torch_bf16(vals),), modes=("set",),
                           masks=(_torch_bf16(mask),), n_real=_t(nr), chunk=8)
    np.testing.assert_array_equal(_bf16_bits(got), np.asarray(want.view(jnp.uint16)))
    row = ids[0]  # the mask's first four lanes: keep, take, keep, take
    np.testing.assert_array_equal(_bf16_bits(got)[row, :4],
                                  [arr[row, 0], vals[0, 1], arr[row, 2], vals[0, 3]])
    # NaN payloads, denormals and an infinity, against a select in numpy
    arr[:, :8] = vals[:, :8] = [0x7F81, 0xFF81, 0x7FBF, 0x0001, 0x8001, 0x7F80, 0x7FC1, 0xFFFF]
    vals[:, :8] ^= 0x0002
    (got,) = S.rows_update((_torch_bf16(arr),), _t(ids), (_torch_bf16(vals),), modes=("set",),
                           masks=(_torch_bf16(mask),), n_real=_t(nr), chunk=8)
    take = (mask[:n] & 0x7FFF) != 0
    want = arr.copy()
    want[ids[:n]] = np.where(take, vals[:n], arr[ids[:n]])
    np.testing.assert_array_equal(_bf16_bits(got), want)


@pytest.mark.parametrize("run", [4, 8])
def test_lane_of_rounded_sums_packs_little_endian(run):
    """A numpy model of the kernel's wide store: a lane rounds its ``run``
    f32 sums to bf16 in integer arithmetic and packs them two to a 32-bit
    word, element 2i in the low half and element 2i + 1 in the high half, so
    that the words' bytes in memory are the ``run`` bf16 values in element
    order.  The rounding and the order of the halves are those of
    ``pack_monu_rounded`` (mu low, nu high), held here on its 22 special
    values."""
    from mmlrec_tpu_torch.train import sparse_embedding as T
    from tests.test_torch_sparse_embedding import SPECIAL

    values = np.resize(SPECIAL, -(-len(SPECIAL) // run) * run).reshape(-1, run)  # lanes of `run` sums
    rounded = S.bf16_bits_rne(_t(values)).numpy().astype(np.uint32)  # [lanes, run], 16 bits each
    words = rounded[:, 0::2] | (rounded[:, 1::2] << 16)  # [lanes, run / 2]
    # in memory (little-endian) the words read back as the bf16 values in order
    np.testing.assert_array_equal(words.astype("<u4").view("<u2"), rounded.astype(np.uint16))
    # word i is pack_monu_rounded(mu = element 2i, nu = element 2i + 1)
    packed = T.pack_monu_rounded(_t(values[:, 0::2].copy()), _t(values[:, 1::2].copy()))
    np.testing.assert_array_equal(_bits(packed.numpy()), words)
    # and the 16 bits are XLA's convert: the JAX package's own rounding
    want = np.asarray(jnp.asarray(values).astype(jnp.bfloat16).view(jnp.uint16))
    np.testing.assert_array_equal(rounded.astype(np.uint16), want)
