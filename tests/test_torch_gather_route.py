"""The gather dedup route of the port's two-phase step (``dedup_route=
"gather"``, what the JAX trainer's auto picks for the write kernel with
packed bf16 moments and host metadata), held against the JAX package on the
CPU.

* The route metadata (``batch_step_metadata(want_route=True)``: accperm,
  the pruned residuals, the logical duplicates, the quantised monotone
  caps) bitwise against JAX's, numpy and native, at P = 1, 4 and 16, on
  uniform and Zipf ids and on one batch of exactly 65,536 ids (the uint16
  boundary of the upload codec).
* The update (``two_phase_sparse_adam_unique`` with the route lists) bitwise
  against the JAX function on the same inputs (its Pallas write in
  interpret mode), stacked and split; inside the port, route == scatter
  bitwise as the JAX package pins it (function and fit), and the codec's
  compaction changes no bit.
* A fit against the JAX trainer from one carried state at
  ``test_torch_two_phase_fit.py``'s tolerances (``test_torch_route_common``),
  and the JAX trainer's own ValueErrors.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_route_common as C
from mmlrec_tpu import synthetic as jsyn
from mmlrec_tpu.models import get_model as jax_get_model
from mmlrec_tpu.train import Trainer as JaxTrainer
from mmlrec_tpu.train import sparse_embedding as J
from mmlrec_tpu.train import staging as jstaging
from mmlrec_tpu_torch import native
from mmlrec_tpu_torch import synthetic as tsyn
from mmlrec_tpu_torch.models import get_model
from mmlrec_tpu_torch.train import Trainer, staging
from mmlrec_tpu_torch.train import sparse_embedding as T

V = 16384  # logical ids of the metadata cases
ROUTE = ("accperm", "resid_pos", "resid_slot", "gdup_pos", "gdup_tgt")


def _ids(kind, steps=2, K=512, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "uniform":
        return rng.integers(0, V, (steps, K)).astype(np.int64)
    return ((rng.zipf(1.1, (steps, K)) - 1) % V).astype(np.int64)


def _assert_same(a, b, what):
    assert len(a) == len(b), what
    for i, (x, y) in enumerate(zip(a, b)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=f"{what} [{i}]")
        assert np.asarray(x).dtype == np.asarray(y).dtype, f"{what} [{i}]"


def _native_or_skip():
    try:
        native.get_meta_lib()
    except native.NativeUnavailable:
        pytest.skip("no C++ compiler for native/step_metadata.cpp")


@pytest.mark.parametrize("kind", ["uniform", "zipf"])
@pytest.mark.parametrize("P", [1, 4, 16])
def test_route_metadata_matches_jax(kind, P):
    ids = _ids(kind)
    got = T.batch_step_metadata(ids, P, V // P, want_route=True, use_native=False)
    assert len(got) == 11
    _assert_same(got, J.batch_step_metadata(ids, P, V // P, want_route=True,
                                            use_native=False), f"{kind} P={P}")
    _native_or_skip()
    T.reset_metadata_calls()
    _assert_same(T.batch_step_metadata(ids, P, V // P, want_route=True, use_native=True), got,
                 f"native {kind} P={P}")
    assert T.metadata_calls == {"native": 1, "numpy": 0}


def test_route_metadata_at_65536_ids_and_its_codec():
    """One batch of exactly 65,536 ids: K = Kp = 65,536, so resid_slot's drop
    value Kp and gdup_tgt's K ride the codec as 65,535 (slot16); the port's
    kinds are JAX's and every live array decodes to its bits."""
    ids = (np.random.default_rng(5).zipf(1.1, (1, 65536)) - 1) % (1 << 20)
    meta = T.batch_step_metadata(ids, 4, 1 << 18, want_route=True, use_native=False)
    _assert_same(meta, J.batch_step_metadata(ids, 4, 1 << 18, want_route=True,
                                             use_native=False), "K=65536")
    assert meta[2].shape == (1, 65536) and (meta[8] == 65536).any() and (meta[10] == 65536).any()
    for space in ("position", "slot"):
        tr = C.jax_codec_view(update_space=space)
        codec, jcodec = staging.meta_codec(tr, meta), jstaging.meta_codec(tr, meta)
        assert codec.kinds == jcodec.kinds
        dead = [k for k, (kind, _) in enumerate(codec.kinds) if kind == "dead"]
        assert dead == ([0] if space == "slot" else [0, 3])
        decoded = codec.decode(tuple(torch.from_numpy(staging.upload_form(a)[0])
                                     for a in codec.encode(meta)))
        jdecoded = jcodec.decode(tuple(jnp.asarray(a[0]) for a in jcodec.encode(meta)))
        for k, (d, jd, a) in enumerate(zip(decoded, jdecoded, meta)):
            if k not in dead:
                np.testing.assert_array_equal(d.numpy(), a[0], err_msg=f"{space} [{k}]")
                np.testing.assert_array_equal(d.numpy(), np.asarray(jd), err_msg=f"[{k}]")
    _native_or_skip()
    _assert_same(T.batch_step_metadata(ids, 4, 1 << 18, want_route=True, use_native=True),
                 meta, "native K=65536")


def test_route_r_cap_quantized_and_monotone():
    """The route lists' width is 256 * 2^k and honours the caller's floor;
    the trainer keeps the largest it has made (tests/test_sparse_embedding.py
    of the JAX package pins the same)."""
    rng = np.random.default_rng(0)
    K, P, Vp = 512, 2, 4096

    def r_cap(ids, r_cap_min=0):
        meta = T.batch_step_metadata(ids, P, Vp, want_route=True, r_cap_min=r_cap_min,
                                     use_native=False)
        assert meta[7].shape == meta[8].shape
        return meta[7].shape[1]

    ids = rng.permutation(4000)[:K][None, :].astype(np.int64)
    assert r_cap(ids) == 256
    ids_dup = rng.integers(0, 90, (1, K)).astype(np.int64)
    n_resid = len(np.unique(ids_dup)) - len(np.unique(ids_dup // P))
    cap = r_cap(ids_dup)
    assert cap >= n_resid and cap in (256, 512, 1024) and cap & (cap - 1) == 0
    assert r_cap(ids, r_cap_min=1024) == 1024  # the floor wins
    assert T._quantized_cap(257) == 512 and T._quantized_cap(0) == 256

    cfg = tsyn.make_config(vocab=400, **{**C.KW, "table_update": "pallas",
                                         "table_opt_dtype": "bfloat16"})
    layout, x, *_ = tsyn.make_data(cfg, n=256, seed=0, vocab=400)
    tr = Trainer(get_model("mmoe", layout, cfg, device="cpu"), device="cpu").compile()
    assert tr.dedup_route == "gather" and tr._route_r_cap == 0
    flat = staging.flat_ids(tr, tr.pack_inputs(x)[0][:64], 1)
    assert staging.step_metadata(tr, flat)[7].shape[1] == 256 and tr._route_r_cap == 256
    tr._route_r_cap = 512
    meta = staging.step_metadata(tr, flat)
    assert meta[7].shape[1] == meta[9].shape[1] == 512 and tr._route_r_cap == 512


def test_native_step_metadata_matches_numpy():
    """The native pass (sm_counts + sm_fill with the route arrays) equals the
    numpy formulation on every duplicate structure, caps and floors
    included, and the JAX package's native pass where its library loads."""
    _native_or_skip()
    rng = np.random.default_rng(0)
    K, P, Vp = 512, 4, 4096
    cases = {
        "uniform": rng.integers(0, Vp, (3, K)),
        "heavy": rng.integers(0, 60, (2, K)),
        "zipfish": (rng.zipf(1.2, (2, K)) - 1) % Vp,
        "all_same": np.full((1, K), 7),
        "all_unique": rng.permutation(Vp)[:K][None, :],
    }
    try:
        from mmlrec_tpu.native import get_meta_lib

        get_meta_lib()
        jax_native = True
    except Exception:
        jax_native = False
    for name, ids in cases.items():
        ids = ids.astype(np.int64)
        for want_route in (False, True):
            for floor in (0, 512):
                a = T.batch_step_metadata(ids, P, Vp, want_route=want_route, r_cap_min=floor,
                                          use_native=False)
                b = T.batch_step_metadata(ids, P, Vp, want_route=want_route, r_cap_min=floor,
                                          use_native=True)
                _assert_same(a, b, f"{name} route={want_route} floor={floor}")
                if jax_native:
                    _assert_same(b, J.batch_step_metadata(
                        ids, P, Vp, want_route=want_route, r_cap_min=floor, use_native=True),
                        f"JAX native {name}")


def _update_case(P, folded, seed=7):
    """(port args, JAX args, metadata) of one route update: a stacked
    [2Vp, W] container or a split table with a packed container, heavy
    duplicates of one logical id and of its physical row."""
    D, K, Vp = 8, 512, 1024
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(2 * Vp if folded else Vp, P * D)).astype(np.float32)
    monu = T.pack_monu_rounded(torch.from_numpy(rng.normal(0, 1e-2, (Vp, P * D)).astype(
        np.float32)), torch.from_numpy(np.abs(rng.normal(0, 1e-3, (Vp, P * D))).astype(
            np.float32))).numpy()
    if folded:
        table[Vp:] = monu
    flat = rng.integers(0, Vp * P, K).astype(np.int64)
    flat[:50] = flat[0]
    flat[50:60] = flat[0] + 1 if P > 1 else flat[0]
    g = rng.normal(size=(K, D)).astype(np.float32)
    meta = T.batch_step_metadata(flat[None], P, Vp, want_route=True, use_native=False)
    return table, monu, flat.astype(np.int32), g, meta


def _port_update(table, monu, flat, g, meta, P, folded, route=True):
    t = torch.from_numpy(table.copy())
    count = torch.tensor(2, dtype=torch.int32)
    st = (T.SparseAdamFoldedState(count=count) if folded
          else T.SparseAdamPackedState(monu=torch.from_numpy(monu.copy()), count=count))
    m = [torch.from_numpy(a[0]) for a in meta]
    kw = dict(zip(ROUTE, m[6:])) if route else {}
    t, st = T.two_phase_sparse_adam_unique(
        t, torch.from_numpy(g), torch.from_numpy(flat), m[0], m[1], m[2], m[3], st, lr=0.05,
        pack_factor=P, n_real=m[4], prep=m[5], **kw)
    return t, (None if folded else st.monu)


@pytest.mark.parametrize("folded", [True, False])
@pytest.mark.parametrize("P", [1, 16])
def test_gather_route_update_matches_jax(P, folded):
    table, monu, flat, g, meta = _update_case(P, folded)
    t, m = _port_update(table, monu, flat, g, meta, P, folded)
    count = jnp.asarray(2, jnp.int32)
    st = (J.SparseAdamFoldedState(count=count) if folded
          else J.SparseAdamPackedState(monu=jnp.asarray(monu), count=count))
    jm = [jnp.asarray(a[0]) for a in meta]
    jt, jst = J.two_phase_sparse_adam_unique(
        jnp.asarray(table), jnp.asarray(g), jnp.asarray(flat), jm[0], jm[1], jm[2], jm[3], st,
        lr=0.05, pack_factor=P, use_pallas=True, interpret=True, n_real=jm[4], prep=jm[5],
        **dict(zip(ROUTE, jm[6:])))
    np.testing.assert_array_equal(C.bits(t), C.bits(jt))
    if not folded:
        np.testing.assert_array_equal(C.bits(m), C.bits(jst.monu))
    assert not np.array_equal(C.bits(t), C.bits(table))  # rows moved


def test_route_bitwise_at_pack_factor_16():
    """Route == scatter accumulation bitwise at P = 16 with heavy duplicates
    of one logical id and of its physical row, and the two gradient-sum
    forms agree at every first occurrence."""
    for folded in (True, False):
        table, monu, flat, g, meta = _update_case(16, folded, seed=11)
        a = _port_update(table, monu, flat, g, meta, 16, folded, route=True)
        b = _port_update(table, monu, flat, g, meta, 16, folded, route=False)
        for x, y in zip(a, b):
            if x is not None:
                np.testing.assert_array_equal(C.bits(x), C.bits(y))
    gt = torch.from_numpy(g)
    m = [torch.from_numpy(a[0]) for a in meta]
    scatter = T._segment_sum(gt, m[0])
    routed = T._gdup_sum(gt, m[9], m[10])
    first = m[1] > 0
    np.testing.assert_array_equal(C.bits(scatter[first]), C.bits(routed[first]))


@pytest.mark.parametrize("container", ["split", "stacked"])
def test_dedup_route_gather_matches_scatter(container):
    """The fit with the gather route equals the scatter route's bitwise
    (table, moments, dense parameters, losses), heavy duplicates included
    (vocab 80), full shuffle; the codec compacts the gather route's stacks."""
    fits = {}
    for route in ("scatter", "gather"):
        cfg = tsyn.make_config(vocab=80, **{**C.KW, "table_update": "pallas",
                                            "table_opt_dtype": "bfloat16",
                                            "table_container": container,
                                            "dedup_route": route, "update_space": "position"})
        layout, x, y, _ = tsyn.make_data(cfg, n=320, seed=0, vocab=80)
        tr = Trainer(get_model("mmoe", layout, cfg, device="cpu"), device="cpu").compile()
        assert tr.dedup_route == route
        tr.fit(x, y, batch_size=64, epochs=2, verbose=0)
        assert isinstance(tr._meta_codec, staging.MetaCodec)
        assert [k for k, _ in tr._meta_codec.kinds].count("dead") == (2 if route == "gather"
                                                                     else 0)
        fits[route] = tr
    a, b = fits["scatter"], fits["gather"]
    for x_, y_ in zip(C.table_and_moments(a), C.table_and_moments(b)):
        np.testing.assert_array_equal(C.bits(x_), C.bits(y_))
    for (k, p), q in zip(a.rest_params().items(), b.rest_params().values()):
        np.testing.assert_array_equal(C.bits(p), C.bits(q), err_msg=k)
    assert [h["loss"] for h in a.history] == [h["loss"] for h in b.history]


@pytest.mark.parametrize("shuffle", [True, "block"])
def test_fit_meta_compact_bitwise_stacked_route(shuffle):
    """The stacked gather-route fit with the upload codec (uint16 lists, the
    dead inv and pinv, uint8 masks) equals the uncompacted fit bitwise."""
    fits = {}
    for compact in (True, False):
        cfg = tsyn.make_config(vocab=80, **{**C.KW, "table_update": "pallas",
                                            "table_opt_dtype": "bfloat16",
                                            "table_container": "stacked",
                                            "update_space": "position",
                                            "meta_compact": compact})
        layout, x, y, _ = tsyn.make_data(cfg, n=320, seed=0, vocab=80)
        tr = Trainer(get_model("mmoe", layout, cfg, device="cpu"), device="cpu").compile()
        tr.fit(x, y, batch_size=64, epochs=2, verbose=0, shuffle=shuffle)
        fits[compact] = tr
    assert isinstance(fits[True]._meta_codec, staging.MetaCodec) and fits[False]._meta_codec is None
    np.testing.assert_array_equal(C.bits(fits[True].table), C.bits(fits[False].table))
    assert [h["loss"] for h in fits[True].history] == [h["loss"] for h in fits[False].history]


@pytest.mark.parametrize("container,vocab", [("stacked", 1 << 16), ("split", 400)])
def test_gather_route_fit_matches_jax(container, vocab):
    """Host metadata with packed bf16 moments: both trainers resolve the
    gather route in position space (no 25% duplication at these vocabs),
    then fit the same three steps from one carried state."""
    extra = dict(table_update="pallas", table_opt_dtype="bfloat16", table_container=container)
    jtr, x, y = C.jax_side(vocab, **extra)
    tr = C.port_trainer(vocab, C.state_of(jtr), **extra)
    assert tr.dedup_route == jtr.dedup_route == "gather"
    C.fit_both_and_compare(jtr, tr, x, y)
    assert tr.update_space == jtr.update_space == "position"


@pytest.mark.parametrize("extra,match", [
    (dict(dedup_route="gather", table_update="scatter"), "packed bf16"),
    (dict(dedup_route="gather", table_update="pallas"), "packed bf16"),  # f32 moments
    (dict(dedup_route="gather", table_update="pallas", table_opt_dtype="bfloat16",
          device_metadata=True), "no gather-route lists"),
    (dict(table_update="unique", device_metadata=True), "unique"),
    (dict(dedup_route="bogus"), "scatter|gather"),
])
def test_gather_route_validation_matches_jax(extra, match):
    for side in ("port", "jax"):
        if side == "port":
            cfg = tsyn.make_config(vocab=400, **{**C.KW, **extra})
            layout, *_ = tsyn.make_data(cfg, n=8, vocab=400)
            make = lambda: Trainer(get_model("mmoe", layout, cfg, device="cpu"), device="cpu")
        else:
            cfg = jsyn.make_config(vocab=400, **{**C.KW, **extra})
            layout, *_ = jsyn.make_data(cfg, n=8, vocab=400)
            make = lambda: JaxTrainer(jax_get_model("mmoe", layout, cfg))
        with pytest.raises(ValueError, match=match):
            make()


def test_baseline_recipe_runs_through_the_cli(tmp_path, monkeypatch):
    """BASELINE.md's recipe for tables of 10M rows and more through the
    port's CLI on the CPU: ``table_update: "pallas"`` (explicit: the CPU's
    auto is the scatter update), ``table_opt_dtype: "bfloat16"``, the
    stacked container, ``shuffle_mode: "block"``, host metadata (no
    ``device_metadata``); the route and the space resolve themselves."""
    import json

    from _torch_cli_common import ROWS, cut_config
    from mmlrec_tpu_torch.main import parse_args, run

    monkeypatch.chdir(tmp_path)
    path = cut_config("configs/msl/config_AE.json", tmp_path)
    with open(path) as f:
        raw = json.load(f)
    raw["model_config"].update(table_update="pallas", table_opt_dtype="bfloat16",
                               table_container="stacked")
    raw["training_config"]["shuffle_mode"] = "block"
    with open(path, "w") as f:
        json.dump(raw, f)
    T.reset_metadata_calls()
    (row, tr), = run(parse_args(["--config", path, "--seed", "0", "--synthetic",
                                 "--synthetic_rows", str(ROWS), "--synthetic_vocab", "65536",
                                 "--device", "cpu"]))
    assert (tr.table_update, tr.table_container, tr.dedup_route) == ("pallas", "stacked",
                                                                     "gather")
    assert tr.update_space in ("position", "slot") and not tr.device_metadata
    assert isinstance(tr.table_opt, T.SparseAdamFoldedState) and int(tr.table_opt.count) > 0
    assert T.metadata_calls["native"] + T.metadata_calls["numpy"] >= 1
    assert all(np.isfinite(float(v)) for k, v in row.items() if k != "type")
