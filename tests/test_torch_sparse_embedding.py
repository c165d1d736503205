"""The port's SparseAdam pieces of the two-phase step, held against the JAX
package on the CPU (mmlrec_tpu/train/sparse_embedding.py).

Tolerance: none.  Packing, unpacking, layout folds and the dedup metadata
are pure bit manipulation; the table update runs the same f32 op chain as
the JAX function, elementwise and in the same order, and its fold into
whole rows is integer arithmetic, so the new table and moments must match
bitwise too.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmlrec_tpu.ops.pallas_gather import pallas_rows_gather_dual
from mmlrec_tpu.train import sparse_embedding as J
from mmlrec_tpu_torch.ops.row_gather import rows_gather_dual
from mmlrec_tpu_torch.train import sparse_embedding as T

SPECIAL = np.array([
    0x7FC00000, 0xFFC00000, 0x7F800001, 0xFF812345, 0x7FA00001,  # NaNs
    0x00000000, 0x80000000, 0x7F800000, 0xFF800000,  # +-0, +-inf
    0x00000001, 0x80000001, 0x00400000, 0x007FFFFF, 0x807FFFFF,  # denormals
    0x3F808000, 0x3F818000, 0x3F808001, 0x3F7FFFFF, 0x7F7FFFFF,  # ties, round-ups
    0xFF7FFFFF, 0x3F800000, 0xBF80FFFF,
], np.uint32).view(np.float32)


def _bits(a):
    return np.asarray(a).view(np.uint32 if np.asarray(a).dtype.itemsize == 4 else np.uint16)


def _values(rng, n):
    """Special values followed by random normals of many magnitudes."""
    rand = (rng.normal(size=n) * 10.0 ** rng.integers(-40, 30, n)).astype(np.float32)
    return np.concatenate([SPECIAL, rand])


def test_pack_monu_rounded_matches_jax_bitwise():
    rng = np.random.default_rng(0)
    mu, nu = _values(rng, 1000), _values(rng, 1000)[::-1].copy()
    want = J.pack_monu_rounded(jnp.asarray(mu), jnp.asarray(nu))
    got = T.pack_monu_rounded(torch.from_numpy(mu), torch.from_numpy(nu))
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    # f32 inputs to pack_monu round the same way
    got2 = T.pack_monu(torch.from_numpy(mu), torch.from_numpy(nu))
    np.testing.assert_array_equal(_bits(got2.numpy()), _bits(want))


def test_unpack_and_repack_match_jax_bitwise():
    rng = np.random.default_rng(1)
    raw = np.concatenate([SPECIAL.view(np.uint32),
                          rng.integers(0, 2**32, 4000, dtype=np.uint64).astype(np.uint32)])
    container = raw.view(np.float32).reshape(-1, 2)
    jmu, jnu = J.unpack_monu(jnp.asarray(container))
    tmu, tnu = T.unpack_monu(torch.from_numpy(container.copy()))
    np.testing.assert_array_equal(_bits(tmu.view(torch.int16).numpy()), _bits(np.asarray(jmu)))
    np.testing.assert_array_equal(_bits(tnu.view(torch.int16).numpy()), _bits(np.asarray(jnu)))
    jf = J.unpack_monu_f32(jnp.asarray(container))
    tf = T.unpack_monu_f32(torch.from_numpy(container.copy()))
    for a, b in zip(tf, jf):
        np.testing.assert_array_equal(_bits(a.numpy()), _bits(b))
    # bf16 pairs re-pack to the container's exact bits (mu low, nu high)
    back = T.pack_monu(tmu, tnu)
    np.testing.assert_array_equal(_bits(back.numpy()), raw.reshape(-1, 2))
    np.testing.assert_array_equal(_bits(back.numpy()), _bits(J.pack_monu(jmu, jnu)))


def test_monu_bit_layout_mu_low_nu_high():
    mu = torch.tensor([1.0], dtype=torch.bfloat16)  # 0x3F80
    nu = torch.tensor([-2.0], dtype=torch.bfloat16)  # 0xC000
    assert int(T.pack_monu(mu, nu).view(torch.int32)) & 0xFFFFFFFF == 0xC0003F80


@pytest.mark.parametrize("pack_factor,dups", [(1, True), (4, True), (4, False)])
def test_device_step_metadata_matches_jax_bitwise(pack_factor, dups):
    rng = np.random.RandomState(0)
    K, V = 96, 400
    n_phys = V // pack_factor
    flat = rng.randint(0, 40 if dups else V, K).astype(np.int32)
    Kp = 112
    want = J.device_step_metadata(jnp.asarray(flat), pack_factor, Kp, n_phys)
    got = T.device_step_metadata(torch.from_numpy(flat), pack_factor, Kp, n_phys)
    names = ("inv", "rep", "pids", "pinv", "nuniq", "prep")
    for name, g, w in zip(names, got, want):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_array_equal(_bits(g.numpy()), _bits(w), err_msg=name)
    n = int(got[4][0])
    assert (got[2][n:] == n_phys).all()  # pads one past the last row


def test_stacked_plane_folds_match_jax():
    rng = np.random.default_rng(2)
    table = rng.normal(size=(64, 8)).astype(np.float32)
    monu = rng.normal(size=(64, 8)).astype(np.float32)
    fat = T.fold_stacked_planes(torch.from_numpy(table), torch.from_numpy(monu))
    np.testing.assert_array_equal(fat.numpy(), np.asarray(J.fold_stacked_planes(table, monu)))
    top, bottom = T.split_stacked_planes(fat)
    jtop, jbottom = J.split_stacked_planes(jnp.asarray(fat.numpy()))
    np.testing.assert_array_equal(top.numpy(), np.asarray(jtop))
    np.testing.assert_array_equal(bottom.numpy(), np.asarray(jbottom))
    ids = torch.arange(5, dtype=torch.int32)
    assert T.stacked_table_rows(ids, 64) is ids
    # two shards: the shard-major layout, as JAX's
    fat2 = T.fold_stacked_planes(torch.from_numpy(table), torch.from_numpy(monu), n_shards=2)
    np.testing.assert_array_equal(fat2.numpy(), np.asarray(J.fold_stacked_planes(table, monu, 2)))
    top2, bottom2 = T.split_stacked_planes(fat2, n_shards=2)
    np.testing.assert_array_equal(top2.numpy(), table)
    np.testing.assert_array_equal(bottom2.numpy(), monu)


def _update_case(P, container, monu_gather="xla", seed=3):
    """Inputs of one table update, warm moments included, for both sides."""
    rng = np.random.default_rng(seed)
    D = 8
    Vp, K = 64, 96
    W = P * D
    table = rng.normal(0, 0.3, (Vp, W)).astype(np.float32)
    mu = rng.normal(0, 1e-2, (Vp, W)).astype(np.float32)
    nu = np.abs(rng.normal(0, 1e-3, (Vp, W))).astype(np.float32)
    monu = np.asarray(J.pack_monu_rounded(jnp.asarray(mu), jnp.asarray(nu)))
    flat = rng.integers(0, Vp * P // 2, K).astype(np.int32)  # duplicates
    g_rows = rng.normal(0, 0.1, (K, D)).astype(np.float32)
    Kp = 128
    meta = J.device_step_metadata(jnp.asarray(flat), P, Kp, Vp)
    inv, rep, pids, pinv, nuniq, prep = meta
    phys = flat // P
    kw = dict(lr=0.05, pack_factor=P, use_pallas=True, n_real=nuniq, prep=prep)
    if container == "stacked":
        fat = np.concatenate([table, monu])
        pair = pallas_rows_gather_dual(jnp.asarray(fat).reshape(2, Vp, W),
                                       jnp.asarray(phys), chunk=K, interpret=True)
        j_new, j_state = J.two_phase_sparse_adam_unique(
            jnp.asarray(fat), jnp.asarray(g_rows), jnp.asarray(flat), inv, rep, pids, pinv,
            J.SparseAdamFoldedState(count=jnp.asarray(4, jnp.int32)), interpret=True,
            sup=pair[0], sup_c=pair[1], **kw)
        j_table, j_monu = np.asarray(j_new)[:Vp], np.asarray(j_new)[Vp:]
    else:
        j_new, j_state = J.two_phase_sparse_adam_unique(
            jnp.asarray(table), jnp.asarray(g_rows), jnp.asarray(flat), inv, rep, pids, pinv,
            J.SparseAdamPackedState(monu=jnp.asarray(monu), count=jnp.asarray(4, jnp.int32)),
            interpret=True, sup=jnp.take(jnp.asarray(table), jnp.asarray(phys), axis=0),
            monu_gather=monu_gather, **kw)
        j_table, j_monu = np.asarray(j_new), np.asarray(j_state.monu)

    t_meta = T.device_step_metadata(torch.from_numpy(flat), P, Kp, Vp)
    tinv, trep, tpids, tpinv, tnuniq, tprep = t_meta
    tflat = torch.from_numpy(flat)
    tkw = dict(lr=0.05, pack_factor=P, use_pallas=True, n_real=tnuniq, prep=tprep)
    count = torch.tensor(4, dtype=torch.int32)
    if container == "stacked":
        fat_t = torch.from_numpy(np.concatenate([table, monu]))
        pair = rows_gather_dual(fat_t.view(2, Vp, W), torch.from_numpy(phys))
        out, st = T.two_phase_sparse_adam_unique(
            fat_t, torch.from_numpy(g_rows), tflat, tinv, trep, tpids, tpinv,
            T.SparseAdamFoldedState(count=count), sup=pair[0], sup_c=pair[1], **tkw)
        assert out is fat_t  # written in place
        t_table, t_monu = out[:Vp].numpy(), out[Vp:].numpy()
    else:
        table_t, monu_t = torch.from_numpy(table.copy()), torch.from_numpy(monu.copy())
        out, st = T.two_phase_sparse_adam_unique(
            table_t, torch.from_numpy(g_rows), tflat, tinv, trep, tpids, tpinv,
            T.SparseAdamPackedState(monu=monu_t, count=count),
            sup=table_t.index_select(0, torch.from_numpy(phys).long()),
            monu_gather=monu_gather, **tkw)
        assert out is table_t and st.monu is monu_t
        t_table, t_monu = out.numpy(), st.monu.numpy()
    assert int(st.count) == int(j_state.count) == 5
    return (table, monu), (t_table, t_monu), (j_table, j_monu)


@pytest.mark.parametrize("container,P,monu_gather", [
    ("stacked", 1, "xla"), ("stacked", 16, "xla"),
    ("split", 1, "xla"), ("split", 16, "pallas"),
])
def test_two_phase_sparse_adam_unique_matches_jax(container, P, monu_gather):
    (table0, monu0), (t_table, t_monu), (j_table, j_monu) = _update_case(
        P, container, monu_gather)
    changed = (_bits(j_table) != _bits(table0)) | (_bits(j_monu) != _bits(monu0))
    assert changed.any() and not changed.all()
    np.testing.assert_array_equal(_bits(t_table), _bits(j_table))
    np.testing.assert_array_equal(_bits(t_monu), _bits(j_monu))


def test_two_phase_sparse_adam_unique_refuses_unported_paths():
    """An unknown state is a TypeError; the unique update (use_pallas=False)
    of packed and split moments and split bf16 moments, once ROADMAP A4,
    run (tests/test_torch_split_moments.py holds them bitwise against
    JAX)."""
    table = torch.zeros(8, 4)
    args = [table, torch.zeros(2, 4), torch.zeros(2, dtype=torch.int32)] + [None] * 4
    with pytest.raises(TypeError, match="state"):
        T.two_phase_sparse_adam_unique(*args, object(), lr=0.1)
    ids, g = torch.tensor([1, 1], dtype=torch.int32), torch.ones(2, 4)
    rep, pids = torch.tensor([1.0, 0.0]), torch.tensor([1, 0, 2, 3], dtype=torch.int32)
    pinv, nuniq = torch.zeros(2, dtype=torch.int32), torch.ones(1, dtype=torch.int32)
    for st in (T.init_sparse_adam(table, packed=True), T.init_sparse_adam(table),
               T.init_sparse_adam(table, dtype=torch.bfloat16)):
        for use_pallas in (False, True):
            t = table.clone()
            out, new = T.two_phase_sparse_adam_unique(
                t, g, ids, torch.zeros(2, dtype=torch.int32), rep, pids, pinv,
                type(st)(*(a.clone() for a in st)), lr=0.1, use_pallas=use_pallas,
                n_real=nuniq, prep=rep)
            assert out is t and int(new.count) == 1
            # row 1 took one Adam step of lr against the summed gradient; the rest stay
            torch.testing.assert_close(t[1], torch.full((4,), -0.1), rtol=1e-5, atol=0)
            assert not t[[0, 2, 3]].any()
    assert T.init_sparse_adam(table).mu.dtype == torch.float32
    bf16 = T.init_sparse_adam(table, dtype=torch.bfloat16)
    t, new = T.two_phase_sparse_adam(table.clone(), g, ids, torch.zeros(2, dtype=torch.int32),
                                     rep, bf16, lr=0.1)
    assert new.mu.dtype == torch.bfloat16 and new.mu[1].float().gt(0).all()
    torch.testing.assert_close(t[1], torch.full((4,), -0.1), rtol=1e-5, atol=0)