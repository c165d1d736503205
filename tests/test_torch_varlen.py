"""Behaviour-sequence (varlen) features of the port, held against the JAX
package on the CPU: ``sequence_pooling``, the varlen tables of
``EmbeddingCollection``, ``embed_inputs`` (sparse ++ pooled varlen ++
dense, the embed-concat's dense operand being ``cat(pooled, dense)``),
``Trainer.pack_inputs``, fits, the serving bundle, and the refusals.

Layouts: ``shared`` (a sequence that shares the embedding name ``s0`` of a
sparse feature: a table ``table_s0`` of its own beside the fused one,
mean-pooled, the mask from ``id != 0``), ``own_len`` (a sequence of its own
name and dim 6 beside sparse dim 4, sum-pooled, the mask from its length
column while the ids past the length are not 0), ``only`` (two sequences,
max- and mean-pooled, no sparse feature: no fused table).

Tolerances: pack_inputs and the bundle's round trip are data movement:
bitwise.  Pooling, forwards and fits run f32 sums in another order than
XLA: rtol 1e-5, atol 1e-6 (pooling, probabilities, every parameter after
the fits; losses rtol 1e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmlrec_tpu import synthetic as jsyn
from mmlrec_tpu.features import DenseFeat as JDense
from mmlrec_tpu.features import FeatureLayout as JLayout
from mmlrec_tpu.features import SparseFeat as JSparse
from mmlrec_tpu.features import VarLenSparseFeat as JVarLen
from mmlrec_tpu.models import get_model as jax_get_model
from mmlrec_tpu.ops.layers import sequence_pooling as jax_sequence_pooling
from mmlrec_tpu.serving import _packing_schema as jax_packing_schema
from mmlrec_tpu.train import Trainer as JaxTrainer
from mmlrec_tpu_torch import synthetic as tsyn
from mmlrec_tpu_torch.convert import load_jax_variables
from mmlrec_tpu_torch.features import DenseFeat, FeatureLayout, SparseFeat, VarLenSparseFeat
from mmlrec_tpu_torch.models import get_model
from mmlrec_tpu_torch.ops import kernels as K
from mmlrec_tpu_torch.ops.embedding import fused_table_geometry, segment_sum_rows
from mmlrec_tpu_torch.ops.layers import sequence_pooling
from mmlrec_tpu_torch.serving import ServingBundle, save_serving_bundle
from mmlrec_tpu_torch.train import Trainer
from mmlrec_tpu_torch.train.trainer import stacked_auto_conditions
from tests.test_torch_models import numpy_variables

TOL = dict(rtol=1e-5, atol=1e-6)
KW = dict(emb=4, n_sparse=2, n_dense=2, hidden=(16, 8), tower=(8,), gate=(8,), batch_size=64,
          lr=1e-3)
N, BATCH = 230, 64


def _columns(kind, mod):
    """The feature columns of a layout, from the JAX package's or the
    port's ``features`` module (``mod``: (SparseFeat, VarLenSparseFeat,
    DenseFeat))."""
    S, V, D = mod
    dense = [D("d0", 1), D("d1", 1)]
    if kind == "shared":
        return [S("s0", 50, 4), S("s1", 40, 4),
                V(S("hist", 50, 4, embedding_name="s0"), maxlen=5, combiner="mean")] + dense
    if kind == "own_len":
        return [S("s0", 50, 4), S("s1", 40, 4),
                V(S("hist", 60, 6), maxlen=5, combiner="sum", length_name="hist_len")] + dense
    return [V(S("hist", 60, 4), maxlen=5, combiner="max"),
            V(S("tags", 30, 4), maxlen=3, combiner="mean")] + dense


def _layouts(kind):
    return (JLayout(_columns(kind, (JSparse, JVarLen, JDense))),
            FeatureLayout(_columns(kind, (SparseFeat, VarLenSparseFeat, DenseFeat))))


def _data(layout, task, n=N, seed=0):
    """Columns of ``layout``: sparse ids (``s0`` in [0, 2) under msl, the
    domain), sequences with id 0 past a length drawn in 1..maxlen (with a
    length column: nonzero ids past it, which its mask must leave out),
    dense values; labels from the first sequence's ids."""
    rng = np.random.default_rng(seed)
    x = {}
    for slot in layout.sparse_slots:
        f = slot.feature
        x[f.name] = rng.integers(0, 2 if (task == "msl" and f.name == "s0") else
                                 f.vocabulary_size, n)
    if task == "msl" and "s0" not in x:
        x["s0"] = rng.integers(0, 2, n)
    for slot in layout.varlen_slots:
        f = slot.feature
        vocab = layout.embedding_specs[f.embedding_name][0]
        lens = rng.integers(1, f.maxlen + 1, n)
        ids = rng.integers(1, vocab, (n, f.maxlen))
        if f.length_name is None:
            ids = np.where(np.arange(f.maxlen)[None] < lens[:, None], ids, 0)
        else:
            x[f.length_name] = lens
        x[f.name] = ids
    for slot in layout.dense_slots:
        x[slot.feature.name] = rng.random(n).astype(np.float32)
    first = x[layout.varlen_slots[0].feature.name]
    signal = (first[:, 0] % 5) / 5.0 + x["d0"]
    y = np.stack([(signal + rng.random(n)) > 1.0 for _ in range(2)], axis=1).astype(np.float32)
    if not layout.sparse_slots:
        x = _tuple_form(layout, x)
    return x, y


def _tuple_form(layout, x):
    """The packed ``(ids, dense)`` form, in which both packages take a
    layout without sparse features: their ``pack_inputs`` of a dict
    reshapes its first sequence to (-1, -1) there and raises
    (mmlrec_tpu/train/trainer.py:597)."""
    ids = np.concatenate([x[s.feature.name] for s in layout.varlen_slots], axis=1)
    dense = np.stack([x[s.feature.name] for s in layout.dense_slots], axis=1)
    return ids.astype(np.int32), dense.astype(np.float32)


def _pair(name, kind, task="mtl", optimizer="adam", **extra):
    """(JAX trainer, port trainer, x, y) from one numpy state, cold."""
    jl, tl = _layouts(kind)
    args = dict(KW, task_name=task, model_name=name, **extra)
    jcfg, tcfg = jsyn.make_config(**args), tsyn.make_config(**args)
    x, y = _data(tl, task)
    jtr = JaxTrainer(jax_get_model(name, jl, jcfg), seed=0).compile(
        optimizer=optimizer, metrics=["auc"])
    ids, dense = jtr.pack_inputs(x)
    dm = jnp.ones((2, 2), jnp.float32) if task != "mtl" else None
    shapes = jax.eval_shape(
        lambda i, d: jtr.model.init(jax.random.PRNGKey(0), i, d, dm, train=False),
        jnp.asarray(ids[:2]), jnp.asarray(dense[:2]))
    variables = numpy_variables(shapes, seed=1)
    jtr.variables = jax.tree_util.tree_map(jnp.asarray, variables)
    tr = Trainer(get_model(name, tl, tcfg, device="cpu"), seed=0, device="cpu").compile(
        optimizer=optimizer, metrics=["auc"])
    load_jax_variables(tr.model, variables)
    return jtr, tr, x, y


def _flat(tree):
    return {".".join(str(p.key) for p in path): np.asarray(a)
            for path, a in jax.tree_util.tree_flatten_with_path(tree)[0]}


# ----------------------------------------------------------------------
# pooling, tables, packing
# ----------------------------------------------------------------------
@pytest.mark.parametrize("mode", ["sum", "mean", "max"])
@pytest.mark.parametrize("from_lengths", [False, True])
def test_sequence_pooling_matches_jax(mode, from_lengths):
    rng = np.random.default_rng(3)
    B, T, E = 24, 6, 5
    emb = rng.normal(0, 1, (B, T, E)).astype(np.float32)
    ids = rng.integers(0, 4, (B, T))  # id 0 (padding) anywhere
    lens = rng.integers(0, T + 1, B)  # a row of length 0 too
    mask = (np.arange(T)[None] < lens[:, None]) if from_lengths else ids != 0
    want = jax_sequence_pooling(jnp.asarray(emb), jnp.asarray(mask), mode=mode)
    got = sequence_pooling(torch.from_numpy(emb), torch.from_numpy(mask), mode=mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    with pytest.raises(ValueError, match="sum/mean/max"):
        sequence_pooling(torch.from_numpy(emb), torch.from_numpy(mask), mode="median")


@pytest.mark.parametrize("kind,params", [
    ("shared", ["embeddings.fused.table", "embeddings.table_s0"]),
    ("own_len", ["embeddings.fused.table", "embeddings.table_hist"]),
    ("only", ["embeddings.table_hist", "embeddings.table_tags"]),
])
def test_varlen_tables_match_the_jax_collection(kind, params):
    jtr, tr, x, _ = _pair("mmoe", kind)
    want = {k: v.shape for k, v in _flat(jtr.variables["params"]).items()
            if k.startswith("embeddings")}
    got = {k: tuple(p.shape) for k, p in tr.model.named_parameters() if k.startswith("embeddings")}
    assert sorted(got) == params and got == want
    # a fresh port model draws its varlen tables from normal(init_std)
    fresh = get_model("mmoe", tr.layout, tr.cfg, device="cpu")
    for k in params:
        if "fused" not in k:
            std = float(getattr(fresh.embeddings, k.split(".")[-1]).detach().std())
            assert 0.5e-4 < std < 2e-4, k
    assert fused_table_geometry(tr.layout) is None


@pytest.mark.parametrize("kind", ["shared", "own_len", "only"])
def test_pack_inputs_matches_jax_bitwise(kind):
    jtr, tr, x, _ = _pair("mmoe", kind)
    if kind == "only":  # a dict fails in both packages alike; the tuple form packs
        rng = np.random.default_rng(0)
        cols = {"hist": rng.integers(0, 60, (N, 5)), "tags": rng.integers(0, 30, (N, 3)),
                "d0": rng.random(N), "d1": rng.random(N)}
        for t in (jtr, tr):
            with pytest.raises(ValueError, match="one unknown dimension"):
                t.pack_inputs(cols)
    for got, want in zip(tr.pack_inputs(x), jtr.pack_inputs(x)):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    width = {"shared": 2 + 5, "own_len": 2 + 5 + 1, "only": 5 + 3}[kind]
    assert tr.pack_inputs(x)[0].shape == (N, width)


def test_segment_sum_rows_is_the_scatter_add():
    """The card's varlen cotangent (``segment_sum_rows``), run here on the
    CPU, against the serial scatter-add: one index at half the positions,
    strays and negatives adding nothing; sums in a tree order, so within
    f32 rounding of the largest sum (rtol 1e-6 of it), and bitwise equal
    run to run."""
    g = torch.Generator().manual_seed(0)
    for k, n in ((1, 5), (7, 3), (4096, 50), (20000, 1000)):
        idx = torch.randint(-2, n + 2, (k,), generator=g)
        idx[: k // 2] = 0
        v = torch.randn(k, 8, generator=g)
        got, want = segment_sum_rows(v, idx, n), K.scatter_add_rows(v, idx, n)
        assert got.shape == (n, 8)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=1e-6 * float(want.abs().max()))
        assert torch.equal(got, segment_sum_rows(v, idx, n))


# ----------------------------------------------------------------------
# forwards and fits against JAX
# ----------------------------------------------------------------------
@pytest.mark.parametrize("name,kind,task", [
    ("mmoe", "shared", "mtl"), ("mlp", "only", "mtl"), ("sharedbottom", "own_len", "msl"),
    ("ple", "shared", "mtl"), ("star", "own_len", "msl"), ("apg", "shared", "msl"),
    ("pepnet", "own_len", "msl"), ("hmoe", "only", "mtl"), ("pcg", "own_len", "mtl"),
])
def test_varlen_forward_matches_jax(name, kind, task):
    jtr, tr, x, _ = _pair(name, kind, task)
    ids, dense = jtr.pack_inputs(x)
    dmask = jtr._domain_mask_from(x)
    probs, state = jtr.model.apply(
        jtr.variables, jnp.asarray(ids), jnp.asarray(dense),
        None if dmask is None else jnp.asarray(dmask), train=False, mutable=["intermediates"])
    K.reset_launch_counts()
    with torch.no_grad():
        got, inter = tr.model(torch.from_numpy(ids), torch.from_numpy(dense),
                              None if dmask is None else torch.from_numpy(dmask),
                              return_intermediates=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(probs), **TOL)
    want_in = state["intermediates"]["dnn_input"]
    want_in = want_in[0] if isinstance(want_in, tuple) else want_in
    assert inter["dnn_input"].shape[1] == tr.layout.input_dim
    np.testing.assert_allclose(inter["dnn_input"].numpy(), np.asarray(want_in), **TOL)
    assert sum(K.launch_counts.values()) == 0  # the CPU runs the plain versions


@pytest.mark.parametrize("name,kind,task,extra", [
    ("mmoe", "shared", "mtl", dict(l2_reg_embedding=1e-3)),  # L2 over the varlen table too
    ("sharedbottom", "own_len", "msl", dict(masked_loss=True)),
    ("mmoe", "only", "mtl", {}),
])
def test_varlen_fit_matches_jax(name, kind, task, extra):
    jtr, tr, x, y = _pair(name, kind, task, **extra)
    for t in (jtr, tr):
        t.fit(x, y, batch_size=BATCH, epochs=1, verbose=0)
    for got, want in zip(tr.history, jtr.history):
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
        np.testing.assert_allclose(got["auc"], want["auc"], atol=1e-5)
    want = _flat(jtr.variables["params"])
    got = {k: p.detach().numpy() for k, p in tr.model.named_parameters()}
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6, err_msg=k)
    tables = [k for k in got if k.startswith("embeddings.table_")]
    start = numpy_variables(jax.eval_shape(lambda: jtr.variables), seed=1)
    assert tables and all(not np.array_equal(got[k], _flat(start["params"])[k]) for k in tables)
    np.testing.assert_allclose(tr.predict(x, BATCH), jtr.predict(x, batch_size=BATCH), **TOL)


def test_varlen_bundle_round_trip(tmp_path):
    """Save, load and serve a varlen model: the bundle's packing is the JAX
    bundle's, its predictions the model's own bitwise and JAX's within
    1e-6, from [n, maxlen] request columns."""
    jtr, tr, x, _ = _pair("sharedbottom", "own_len", "msl", masked_loss=True)
    meta = save_serving_bundle(tr.model, str(tmp_path / "b"))
    assert meta["packing"] == jax_packing_schema(jtr.layout)
    assert [f["kind"] for f in meta["features"]] == ["sparse", "sparse", "varlen", "dense",
                                                   "dense"]
    bundle = ServingBundle.load(str(tmp_path / "b"), device="cpu")
    assert bundle.model.layout.feature_columns == tr.layout.feature_columns
    got = bundle.predict(x)
    ids, dense = tr.pack_inputs(x)
    dmask = torch.from_numpy(tr._domain_mask_from(x))
    with torch.inference_mode():
        own = tr.model(torch.from_numpy(ids), torch.from_numpy(dense), dmask).numpy()
    np.testing.assert_array_equal(got, own.astype(np.float64))
    np.testing.assert_array_equal(bundle.predict(x, batch_size=64), got)
    want = jtr.model.apply(jtr.variables, jnp.asarray(ids), jnp.asarray(dense),
                           jnp.asarray(dmask.numpy()), train=False)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


# ----------------------------------------------------------------------
# refusals
# ----------------------------------------------------------------------
def test_non_uniform_sparse_dims_raise_as_jax_fails():
    cols = lambda S, D: [S("s0", 50, 4), S("s1", 50, 6), D("d0", 1)]  # noqa: E731
    cfg = dict(KW, task_name="mtl", model_name="mmoe")
    jl = JLayout(cols(JSparse, JDense))
    jmodel = jax_get_model("mmoe", jl, jsyn.make_config(**cfg))
    with pytest.raises(ValueError, match="same shape"):
        jmodel.init(jax.random.PRNGKey(0), jnp.zeros((2, 2), jnp.int32), jnp.zeros((2, 1)),
                    None, train=False)
    tl = FeatureLayout(cols(SparseFeat, DenseFeat))
    for name in ("mmoe", "star", "sharedbottom", "mlp"):
        with pytest.raises(ValueError, match="same shape"):
            get_model(name, tl, tsyn.make_config(**cfg), device="cpu")


@pytest.mark.parametrize("extra", [
    dict(two_phase_embedding=True, table_update="scatter"),
    dict(sparse_embedding_update=True),
])
def test_sparse_updates_refuse_varlen_as_jax(extra):
    _, tl = _layouts("shared")
    cfg = tsyn.make_config(**dict(KW, task_name="mtl", model_name="mmoe", **extra))
    with pytest.raises(ValueError, match="no varlen features"):
        Trainer(get_model("mmoe", tl, cfg, device="cpu"), device="cpu")
    pallas = tsyn.make_config(**dict(KW, two_phase_embedding=True, table_update="pallas",
                                     table_opt_dtype="bfloat16"))
    assert not stacked_auto_conditions(pallas, tl, 64, device="cuda")
