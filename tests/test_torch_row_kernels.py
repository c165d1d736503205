"""Plain versions of the row kernels B1-B4 of the two-phase step, held
against the JAX package's Pallas kernels on the CPU: the fast reference
path (``interpret=True``) at a step-like size, and the genuine Pallas
interpreter (``interpret="pallas"``) at a tiny one.

Tolerance: none.  The kernels are pure data movement, so every slot in the
window, every row a write leaves alone, the poison of a skipped gather slot
and every duplicate id must match bitwise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmlrec_tpu.ops.pallas_gather import pallas_rows_gather_dual, pallas_rows_gather_hbm
from mmlrec_tpu.ops.pallas_scatter import pallas_rows_write, pallas_rows_write_dual
from mmlrec_tpu_torch.ops import cuda_build
from mmlrec_tpu_torch.ops import row_gather as G
from mmlrec_tpu_torch.ops import row_scatter as S


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype.itemsize == 4 else a


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
                                    "rows_write_dual"}
