"""The row-sharded table's shard-local math (``parallel/shard_embedding.py``)
in one process, every shard in turn, against JAX's ``shard_map`` functions
(``mmlrec_tpu/parallel/shard_embedding.py``) on 2 and 4 of the conftest's
virtual CPU devices (the Pallas kernels in interpret mode, as the JAX
package's tests run them), against a one-process dense take and add, and
against the port's one-shard updates.

Tolerances: the layouts and the primitives move data: bitwise against JAX
and against the dense forms, at pack_factor 1 and 4.  The updates: the
assembled shards bitwise the port's one-shard update (the same op chain on
the same inputs, the window written by B2 / B3 with ``bounds``), which is
JAX's pin for its sharded against its one-chip update (tests/
test_mesh_stacked.py:72-180: untouched rows bitwise, touched rows within
2 ulp).  Against JAX's jitted ``shard_map`` update, whose compiled program
fuses the Adam chain (a few f32 ulp), JAX's own tolerances for the same
comparison: the table and f32 moments rtol 1e-5 (atol 1e-12 for the table,
1e-7 for the moments; tests/test_explicit_collectives.py:84-127,
tests/test_mesh_stacked.py:166-171), bf16 moments, packed or split,
within one bf16 step (rtol 2^-7), and the rows no slot touches, pads
included, bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from mmlrec_tpu.parallel import shard_embedding as JS
from mmlrec_tpu.train import sparse_embedding as JE
from mmlrec_tpu_torch.parallel import shard_embedding as TS
from mmlrec_tpu_torch.train import sparse_embedding as TE

DIM, VP, K = 8, 64, 48
ROUTE = ("accperm", "resid_pos", "resid_slot", "gdup_pos", "gdup_tgt")


def _mesh(n):
    return jax.sharding.Mesh(np.asarray(jax.devices()[:n]), ("model",))


def _rows(n, x):
    return jax.device_put(jnp.asarray(x), NamedSharding(_mesh(n), P("model", None)))


def _jax_map(n, body, n_sharded, n_args, n_out_sharded, n_out):
    rs = P("model", None)
    out = (rs,) * n_out_sharded + (P(),) * (n_out - n_out_sharded)
    return jax.jit(jax.shard_map(
        body, mesh=_mesh(n), in_specs=(rs,) * n_sharded + (P(),) * (n_args - n_sharded),
        out_specs=out[0] if n_out == 1 else out, check_vma=False))


def _shards(a: torch.Tensor, n: int):
    r = a.shape[0] // n
    return [a[i * r:(i + 1) * r].clone() for i in range(n)]


def _case(P_, seed=3):
    """(table [VP, DIM P], flat ids [K] with duplicates, the host metadata
    with the gather route, row cotangents)."""
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(VP, DIM * P_)).astype(np.float32) * 0.1
    flat = rng.integers(0, VP * P_, (1, K))
    meta = TE.batch_step_metadata(flat, P_, VP, chunk=8, want_route=True)
    m = dict(zip(("inv", "rep", "pids", "pinv", "nuniq", "prep") + ROUTE,
                 (a[0] for a in meta)))
    g = rng.normal(size=(K, DIM)).astype(np.float32)
    return table, flat[0].astype(np.int32), m, g


def _t(a):
    """A tensor of its own (the updates write in place)."""
    return torch.from_numpy(np.array(a))


def _near_jax(got, want, what, packed=False, bf16=False):
    """The tolerances of the module docstring: ``packed`` compares the
    container's two bf16 moments, ``bf16`` split bf16 moments."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    if packed:
        for a, b in zip(TE.unpack_monu_f32(_t(got)), TE.unpack_monu_f32(_t(want))):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2 ** -7, atol=1e-30,
                                       err_msg=what)
    elif bf16:
        np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=1e-30, err_msg=what)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-12 if what == "table" else 1e-7,
                                   err_msg=what)


@pytest.mark.parametrize("n_shards", [1, 2, 4, 8])
def test_fold_split_roundtrip_and_row_map(n_shards):
    """tests/test_mesh_stacked.py::test_fold_split_roundtrip_and_row_map,
    the port against JAX bitwise."""
    rng = np.random.RandomState(0)
    table, monu = (rng.rand(VP, 16).astype(np.float32) for _ in range(2))
    fat = TE.fold_stacked_planes(_t(table), _t(monu), n_shards)
    np.testing.assert_array_equal(fat.numpy(), np.asarray(
        JE.fold_stacked_planes(jnp.asarray(table), jnp.asarray(monu), n_shards)))
    t2, m2 = TE.split_stacked_planes(fat, n_shards)
    np.testing.assert_array_equal(t2.numpy(), table)
    np.testing.assert_array_equal(m2.numpy(), monu)
    p = torch.arange(VP)
    rows = TE.stacked_table_rows(p, VP, n_shards)
    np.testing.assert_array_equal(rows.numpy(), np.asarray(
        JE.stacked_table_rows(jnp.arange(VP), VP, n_shards)))
    np.testing.assert_array_equal(fat[rows].numpy(), table)
    r = VP // n_shards
    for d in range(n_shards):
        blk = fat[d * 2 * r:(d + 1) * 2 * r].numpy()
        np.testing.assert_array_equal(blk[:r], table[d * r:(d + 1) * r])
        np.testing.assert_array_equal(blk[r:], monu[d * r:(d + 1) * r])


@pytest.mark.parametrize("n_shards", [2, 4])
def test_convert_moves_the_shard_major_container_to_the_ranks(n_shards):
    """JAX's shard-major ``[2Vp, W]`` container, as numpy, becomes each
    rank's ``[table_m; monu_m]`` (the shard a port rank holds), and back,
    bitwise; a mesh with ``stacked_shards = n`` folds to it."""
    from mmlrec_tpu_torch.convert import ranks_to_table, table_to_ranks

    rng = np.random.RandomState(1)
    table, monu = (rng.rand(VP, 16).astype(np.float32) for _ in range(2))
    fat = np.asarray(JE.fold_stacked_planes(jnp.asarray(table), jnp.asarray(monu), n_shards))
    parts = table_to_ranks(fat, n_shards)
    r = VP // n_shards
    for m, part in enumerate(parts):
        np.testing.assert_array_equal(part[:r], table[m * r:(m + 1) * r])
        np.testing.assert_array_equal(part[r:], monu[m * r:(m + 1) * r])
    np.testing.assert_array_equal(ranks_to_table(parts), fat)
    with pytest.raises(ValueError, match="divide"):
        table_to_ranks(fat[:-2], 4)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("pack_factor", [1, 4])
def test_owned_gather_and_scatter_add(pack_factor, n):
    """The shards' partial gathers summed are JAX's psum'd owned_gather and
    the dense take; each shard's owner-local add, the shards together, is
    JAX's owned_scatter_add and the dense add (unique ids; the ids of the
    other shards drop, negative local ids included)."""
    table, _, _, _ = _case(pack_factor)
    rng = np.random.default_rng(1)
    ids = rng.permutation(VP * pack_factor)[:37].astype(np.int32)
    delta = rng.normal(size=(37, DIM)).astype(np.float32)
    tt, ti, td = _t(table), _t(ids), _t(delta)
    got = sum(TS.owned_gather_partial(s, ti, DIM, pack_factor, i)
              for i, s in enumerate(_shards(tt, n)))
    want = _jax_map(n, lambda t, i: JS.owned_gather(t, i, DIM, pack_factor), 1, 2, 0, 1)(
        _rows(n, table), jnp.asarray(ids))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), TE.gather_rows(tt, ti, DIM, pack_factor).numpy())
    added = torch.cat([TS.owned_scatter_add(s, ti, td, pack_factor, i)
                       for i, s in enumerate(_shards(tt, n))])
    want = _jax_map(n, lambda t, i, d: JS.owned_scatter_add(t, i, d, pack_factor), 1, 3, 1, 1)(
        _rows(n, table), jnp.asarray(ids), jnp.asarray(delta))
    np.testing.assert_array_equal(added.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        added.numpy(), TE._scatter_add_rows(tt.clone(), ti, td, pack_factor).numpy())


@pytest.mark.parametrize("n", [2, 4])
def test_owned_bounds_match_jax(n):
    """Each shard's window of the sorted unique rows, from device values."""
    _, _, m, _ = _case(1)
    r = VP // n
    for i in range(n):
        got = TS.owned_bounds(_t(m["pids"]), _t(m["nuniq"]), i, r)
        want = JS._owned_bounds(jnp.asarray(m["pids"]), jnp.asarray(m["nuniq"]),
                                jnp.int32(i * r), r)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("pack_factor", [1, 4])
def test_sharded_scatter_update(pack_factor):
    """``sharded_two_phase_sparse_adam`` on 4 shards: the one-shard scatter
    update bitwise, JAX's sharded update at its tolerances (from moments a
    step has moved)."""
    n = 4
    table, flat, m, g = _case(pack_factor)
    rng = np.random.default_rng(5)
    mu = rng.normal(size=table.shape).astype(np.float32) * 1e-2
    nu = rng.random(table.shape).astype(np.float32) * 1e-3
    one_t = _t(table)
    one = TE.SparseAdamState(_t(mu), _t(nu), torch.tensor(1, dtype=torch.int32))
    TE.two_phase_sparse_adam(one_t, _t(g), _t(flat), _t(m["inv"]), _t(m["rep"]), one, 1e-2,
                             pack_factor=pack_factor)
    parts = []
    for i, (t, a, b) in enumerate(zip(*(_shards(_t(x), n) for x in (table, mu, nu)))):
        st = TE.SparseAdamState(a, b, torch.tensor(1, dtype=torch.int32))
        TS.sharded_two_phase_sparse_adam(t, _t(g), _t(flat), _t(m["inv"]), _t(m["rep"]), st,
                                         1e-2, i, pack_factor=pack_factor)
        parts.append((t, st.mu, st.nu))
    got = [torch.cat(x).numpy() for x in zip(*parts)]
    for a, b in zip(got, (one_t, one.mu, one.nu)):
        np.testing.assert_array_equal(a, b.numpy())

    def body(t, a, b, cnt, gg, f, iv, rp):
        nt, ns = JS.sharded_two_phase_sparse_adam(
            t, gg, f, iv, rp, JE.SparseAdamState(mu=a, nu=b, count=cnt), lr=1e-2,
            pack_factor=pack_factor)
        return nt, ns.mu, ns.nu, ns.count

    want = _jax_map(n, body, 3, 8, 3, 4)(
        _rows(n, table), _rows(n, mu), _rows(n, nu), jnp.int32(1), jnp.asarray(g),
        jnp.asarray(flat), jnp.asarray(m["inv"]), jnp.asarray(m["rep"]))
    for a, b, what in zip(got, want[:3], ("table", "mu", "nu")):
        _near_jax(a, b, what)


@pytest.mark.parametrize("pack_factor", [1, 4])
@pytest.mark.parametrize("moments,route", [("packed", "scatter"), ("packed", "gather"),
                                           ("float32", "scatter"), ("bfloat16", "scatter")])
def test_sharded_pallas_update(moments, route, pack_factor):
    """``sharded_two_phase_sparse_adam_pallas`` on 4 shards, each writing
    its window through B3 with ``bounds``: packed bf16 moments by the
    scatter and the gather dedup route, split f32 and bf16 moments; the
    one-shard write-kernel update bitwise, JAX's at its tolerances."""
    n = 4
    table, flat, m, g = _case(pack_factor)
    rng = np.random.default_rng(6)
    mu = rng.normal(size=table.shape).astype(np.float32) * 1e-2
    nu = rng.random(table.shape).astype(np.float32) * 1e-3
    packed = moments == "packed"
    if packed:
        arrays = (TE.pack_monu(_t(mu), _t(nu)).numpy(),)
        make_t = lambda a, c: TE.SparseAdamPackedState(a[0], c)  # noqa: E731
        make_j = lambda a, c: JE.SparseAdamPackedState(monu=a[0], count=c)  # noqa: E731
    else:
        mdt = getattr(torch, moments)
        arrays = (_t(mu).to(mdt), _t(nu).to(mdt))
        make_t = lambda a, c: TE.SparseAdamState(a[0], a[1], c)  # noqa: E731
        make_j = lambda a, c: JE.SparseAdamState(mu=a[0], nu=a[1], count=c)  # noqa: E731
    arrays = tuple(a if isinstance(a, torch.Tensor) else _t(a) for a in arrays)
    meta = [_t(m[k]) for k in ("inv", "rep", "pids", "pinv", "nuniq", "prep")]
    route_kw = {k: _t(m[k]) for k in ROUTE} if route == "gather" else {}
    one_t, one_a = _t(table), tuple(a.clone() for a in arrays)
    c0 = torch.tensor(1, dtype=torch.int32)
    one = make_t(one_a, c0.clone())
    inv, rep, pids, pinv, nuniq, prep = meta
    TE.two_phase_sparse_adam_unique(one_t, _t(g), _t(flat), inv, rep, pids, pinv, one, 1e-2,
                                    pack_factor=pack_factor, n_real=nuniq, prep=prep,
                                    **route_kw)
    parts = []
    for i, (t, *a) in enumerate(zip(_shards(_t(table), n), *(_shards(x, n) for x in arrays))):
        st = make_t(a, c0.clone())
        TS.sharded_two_phase_sparse_adam_pallas(t, _t(g), _t(flat), *meta, st, 1e-2, i,
                                                pack_factor=pack_factor, **route_kw)
        parts.append((t, *a))
    got = [torch.cat(x) for x in zip(*parts)]
    for a, b in zip(got, (one_t,) + one_a):
        assert torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16 else a,
                           b.view(torch.int16) if b.dtype == torch.bfloat16 else b)

    def jx(a):
        return jnp.asarray(a.float().numpy()).astype(jnp.bfloat16) if a.dtype == torch.bfloat16 \
            else jnp.asarray(a.numpy())

    na = len(arrays)

    def body(t, *rest):
        a, (cnt, gg, f, *mm) = rest[:na], rest[na:]
        kw = dict(zip(ROUTE, mm[6:]))
        nt, ns = JS.sharded_two_phase_sparse_adam_pallas(
            t, gg, f, *mm[:6], make_j(a, cnt), lr=1e-2, pack_factor=pack_factor,
            interpret=True, **kw)
        return (nt,) + tuple(ns[:na])

    jroute = [jnp.asarray(m[k]) for k in ROUTE] if route == "gather" else []
    args = ([_rows(n, table)] + [_rows(n, jx(a)) for a in arrays]
            + [jnp.int32(1), jnp.asarray(g), jnp.asarray(flat)]
            + [jnp.asarray(x.numpy()) for x in meta] + jroute)
    want = _jax_map(n, body, 1 + na, len(args), 1 + na, 1 + na)(*args)
    for i, (a, b) in enumerate(zip(got, want)):
        a = a.float().numpy() if a.dtype == torch.bfloat16 else a.numpy()
        _near_jax(a, b, "table" if i == 0 else moments, packed=packed and i > 0,
                  bf16=moments == "bfloat16" and i > 0)


@pytest.mark.parametrize("pack_factor", [1, 4])
@pytest.mark.parametrize("update_space", ["position", "slot"])
def test_sharded_folded_update(update_space, pack_factor):
    """``sharded_two_phase_sparse_adam_folded`` on the shard-major container
    over 4 shards (B1 pair gather, of the clipped local ids in position
    space or of the window with ``bounds`` in slot space; B2 write of the
    window): the pin of tests/test_mesh_stacked.py:72-180 against the
    port's one-shard stacked update (untouched rows, pads included,
    bitwise; touched rows within 2 ulp: the port is in fact bitwise) and
    JAX's sharded update at JAX's tolerances (module docstring)."""
    n = 4
    table, flat, m, g = _case(pack_factor)
    rng = np.random.RandomState(3)
    W = table.shape[1]
    monu = TE.pack_monu(torch.from_numpy(rng.randn(VP, W).astype(np.float32) * 0.01),
                        torch.from_numpy((rng.rand(VP, W) * 1e-3).astype(np.float32)))
    meta = [_t(m[k]) for k in ("inv", "rep", "pids", "pinv", "nuniq", "prep")]
    route = {k: _t(m[k]) for k in ROUTE}
    inv, rep, pids, pinv, nuniq, prep = meta
    c0 = torch.tensor(2, dtype=torch.int32)
    fat1 = TE.fold_stacked_planes(_t(table), monu)
    if update_space == "slot":
        from mmlrec_tpu_torch.ops.row_gather import rows_gather_dual

        pair = rows_gather_dual(fat1.view(2, VP, W), pids, n_real=nuniq)
        TE.two_phase_sparse_adam_slot(fat1, _t(g), _t(flat), rep, pids, nuniq, pair[0], pair[1],
                                      TE.SparseAdamFoldedState(c0.clone()), 1e-2,
                                      *route.values(), pack_factor=pack_factor)
    else:
        TE.two_phase_sparse_adam_unique(fat1, _t(g), _t(flat), inv, rep, pids, pinv,
                                        TE.SparseAdamFoldedState(c0.clone()), 1e-2,
                                        pack_factor=pack_factor, n_real=nuniq, prep=prep,
                                        **route)
    want_t, want_m = TE.split_stacked_planes(fat1, 1)
    fatn = TE.fold_stacked_planes(_t(table), monu, n)
    r2 = 2 * (VP // n)
    for i in range(n):
        TS.sharded_two_phase_sparse_adam_folded(
            fatn[i * r2:(i + 1) * r2], _t(g), _t(flat), *meta,
            TE.SparseAdamFoldedState(c0.clone()), 1e-2, i, pack_factor=pack_factor,
            update_space=update_space, **route)
    got_t, got_m = TE.split_stacked_planes(fatn, n)
    touched = np.zeros(VP, bool)
    touched[m["pids"][:int(m["nuniq"][0])]] = True
    np.testing.assert_array_equal(got_t.numpy()[~touched], table[~touched])
    np.testing.assert_array_equal(got_m.numpy()[~touched], monu.numpy()[~touched])
    np.testing.assert_array_max_ulp(got_t.numpy(), want_t.numpy(), maxulp=2)
    np.testing.assert_array_equal(got_t.numpy(), want_t.numpy())  # in fact bitwise
    np.testing.assert_array_equal(got_m.numpy(), want_m.numpy())

    def body(fs, cnt, gg, f, *mm):
        nf, ns = JS.sharded_two_phase_sparse_adam_folded(
            fs, gg, f, *mm[:6], JE.SparseAdamFoldedState(count=cnt), lr=1e-2,
            pack_factor=pack_factor, interpret=True, update_space=update_space, chunk=8,
            **dict(zip(ROUTE, mm[6:])))
        return nf, ns.count

    args = ([_rows(n, TE.fold_stacked_planes(_t(table), monu, n).numpy()), jnp.int32(2),
             jnp.asarray(g), jnp.asarray(flat)] + [jnp.asarray(x.numpy()) for x in meta]
            + [jnp.asarray(m[k]) for k in ROUTE])
    jfat, jcnt = _jax_map(n, body, 1, len(args), 1, 2)(*args)
    jt, jm = JE.split_stacked_planes(jnp.asarray(jax.device_get(jfat)), n)
    _near_jax(got_t.numpy(), jt, "table")
    _near_jax(got_m.numpy(), jm, "monu", packed=True)
    np.testing.assert_array_equal(np.asarray(jt)[~touched], table[~touched])
    np.testing.assert_array_equal(got_m.numpy()[~touched], np.asarray(jm)[~touched])
    assert int(jcnt) == 3


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_sharded_sparse_adam_row_update(moments, n):
    """``sharded_sparse_adam_row_update`` on n shards, two steps: the
    batch's rows hold duplicates, each shard sees rows it does not own, and
    the last shard owns none of them; the assembled shards equal the
    one-chip ``sparse_adam_row_update`` bitwise (the count moving on every
    shard), and JAX's at its tolerances."""
    rng = np.random.default_rng(7)
    mdt = TE.MOMENT_DTYPES[moments]
    table = rng.normal(size=(VP, DIM)).astype(np.float32) * 0.1
    mu = rng.normal(size=table.shape).astype(np.float32) * 1e-2
    nu = rng.random(table.shape).astype(np.float32) * 1e-3
    r = VP // n
    steps = [(rng.integers(0, (n - 1) * r, K), rng.normal(size=table.shape).astype(np.float32))
             for _ in range(2)]
    for rows, _ in steps:
        rows[:6] = rows[6]  # a run of duplicates
    one_t = _t(table)
    one = TE.SparseAdamState(_t(mu).to(mdt), _t(nu).to(mdt), torch.tensor(0, dtype=torch.int32))
    shards = [(t, TE.SparseAdamState(a.to(mdt), b.to(mdt), torch.tensor(0, dtype=torch.int32)))
              for t, a, b in zip(*(_shards(_t(x), n) for x in (table, mu, nu)))]
    jt = jnp.asarray(table)
    js = JE.SparseAdamState(mu=jnp.asarray(mu).astype(moments), nu=jnp.asarray(nu).astype(moments),
                            count=jnp.int32(0))
    for rows, g in steps:
        TE.sparse_adam_row_update(one_t, _t(g), _t(rows), one, 1e-2)
        for i, (t, st) in enumerate(shards):
            TS.sharded_sparse_adam_row_update(t, _t(g)[i * r:(i + 1) * r], _t(rows), st, 1e-2, i)
        jt, js = JE.sparse_adam_row_update(jt, jnp.asarray(g), jnp.asarray(rows), js, lr=1e-2)
    got = {"table": torch.cat([t for t, _ in shards]),
           "mu": torch.cat([st.mu for _, st in shards]), "nu": torch.cat([st.nu for _, st in shards])}
    for name, want in (("table", one_t), ("mu", one.mu), ("nu", one.nu)):
        np.testing.assert_array_equal(got[name].view(torch.int16 if moments == "bfloat16"
                                                     and name != "table" else torch.int32),
                                      want.view(torch.int16 if moments == "bfloat16"
                                                and name != "table" else torch.int32),
                                      err_msg=name)
    assert [int(st.count) for _, st in shards] == [2] * n and int(one.count) == 2
    np.testing.assert_array_equal(got["table"][(n - 1) * r:].numpy(), table[(n - 1) * r:])
    for name, want in (("table", jt), ("mu", js.mu), ("nu", js.nu)):
        _near_jax(got[name].float().numpy(), np.asarray(want.astype(jnp.float32)), name,
                  bf16=moments == "bfloat16" and name != "table")


@pytest.mark.parametrize("pack_factor", [1, 16])
def test_shard_major_container_forward_reads_the_table_plane(pack_factor):
    """A stacked container built shard-major (``stacked_shards = 4``) and held
    whole maps each physical row to its shard's block (embedding.py:280-301):
    its forward equals the plane-major container's on the same table plane,
    bitwise, lane-packed too; its initial table plane is the plane-major
    one's draw."""
    from mmlrec_tpu_torch.models import get_model
    from mmlrec_tpu_torch.synthetic import make_config, make_data
    from mmlrec_tpu_torch.utils.seeding import make_generator

    vocab = 100 if pack_factor == 1 else 1 << 16
    kw = dict(task_name="mtl", model_name="mmoe", n_sparse=4, n_dense=2, hidden=(16, 8),
              tower=(8,), gate=(8,), two_phase_embedding=True, table_update="pallas",
              table_opt_dtype="bfloat16", table_container="stacked")
    cfg1, cfg4 = make_config(**kw), make_config(**kw, stacked_shards=4)
    layout, x, _, _ = make_data(cfg1, n=64, vocab=vocab)
    one = get_model("mmoe", layout, cfg1, generator=make_generator(0, "cpu"), device="cpu")
    four = get_model("mmoe", layout, cfg4, generator=make_generator(0, "cpu"), device="cpu")
    f1, f4 = one.embeddings.fused, four.embeddings.fused
    assert f1.pack_factor == pack_factor and f4.dual_shards == 4
    plane = TE.split_stacked_planes(f1.table.detach(), 1)[0]
    np.testing.assert_array_equal(TE.split_stacked_planes(f4.table.detach(), 4)[0].numpy(),
                                  plane.numpy())
    with torch.no_grad():
        f1.table.normal_()
        f4.table.copy_(TE.fold_stacked_planes(*TE.split_stacked_planes(f1.table, 1), 4))
        four.load_state_dict({k: v for k, v in one.state_dict().items()
                              if k != "embeddings.fused.table"}, strict=False)
    ids = torch.from_numpy(np.stack([x[f"s{i}"] for i in range(4)], 1).astype(np.int32))
    np.testing.assert_array_equal(f4(ids).detach().numpy(), f1(ids).detach().numpy())
