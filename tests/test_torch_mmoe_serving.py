"""The port's host layer, MMoE forward and serving bundle, held against the
JAX package on the CPU.

Every input and every weight is made with numpy and fed to both sides.
Weights are transplanted with std 0.1-0.5: the default 1e-4 init leaves
every probability at ~0.5, which would hide a wrong expert mix or head.

Tolerances: the DNN input (gather + concat) is pure data movement and must
match bitwise.  Everything after it goes through f32 matrix products and
softmax/sigmoid whose sums run in another order in PyTorch than in XLA, so
activations are held to rtol 1e-5 / atol 1e-6 and probabilities to atol
1e-6.
"""

import dataclasses
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmlrec_tpu import synthetic as jsyn
from mmlrec_tpu.config import ExperimentConfig as JaxConfig
from mmlrec_tpu.models import get_model as jax_get_model
from mmlrec_tpu.serving import ServingBundle as JaxBundle
from mmlrec_tpu.serving import save_serving_bundle as jax_save_bundle
from mmlrec_tpu.train import Trainer
from mmlrec_tpu_torch import synthetic as tsyn
from mmlrec_tpu_torch.config import ExperimentConfig as TorchConfig
from mmlrec_tpu_torch.convert import load_jax_variables
from mmlrec_tpu_torch.models import get_model
from mmlrec_tpu_torch.ops import kernels as K
from mmlrec_tpu_torch.serving import ServingBundle, save_serving_bundle

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(emb=4, n_sparse=3, n_dense=2, hidden=(16, 8), tower=(8,),
             gate=(8,), batch_size=64)


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


def _pair(task_name="mtl", n=96, vocab=100, seed=0, **kw):
    """The same config and data on both sides, a JAX model with transplanted
    numpy weights, and the port model loaded with the same weights."""
    args = dict(SMALL, task_name=task_name, model_name="mmoe", vocab=vocab, **kw)
    jcfg, tcfg = jsyn.make_config(**args), tsyn.make_config(**args)
    jl, x, y, jmask = jsyn.make_data(jcfg, n=n, vocab=vocab, seed=seed)
    tl, tx, ty, tmask = tsyn.make_data(tcfg, n=n, vocab=vocab, seed=seed)
    jmodel = jax_get_model("mmoe", jl, jcfg)
    ids, dense = Trainer(jmodel, seed=0).pack_inputs(x)
    shapes = jax.eval_shape(
        lambda i, d: jmodel.init(jax.random.PRNGKey(0), i, d, None, train=False),
        jnp.asarray(ids[:2]), jnp.asarray(dense[:2]))
    rng = np.random.default_rng(seed + 1)
    std = {"table": 0.3, "bias": 0.1, "kernel": 0.5}
    params = jax.tree_util.tree_map_with_path(
        lambda path, a: rng.normal(0, std[path[-1].key], a.shape).astype(np.float32),
        shapes["params"])
    variables = {"params": params}
    tmodel = load_jax_variables(get_model("mmoe", tl, tcfg, device="cpu"), variables)
    data = dict(x=x, tx=tx, y=y, ty=ty, jmask=jmask, tmask=tmask, ids=ids, dense=dense)
    return jcfg, jmodel, variables, tmodel, data


def _jax_forward(jmodel, variables, ids, dense, mask=None):
    """(probs, intermediates) of the JAX model, as one jitted program."""
    fn = jax.jit(lambda v, i, d, m: jmodel.apply(
        v, i, d, m, train=False, mutable=["intermediates"]))
    probs, state = fn(variables, jnp.asarray(ids), jnp.asarray(dense),
                      None if mask is None else jnp.asarray(mask))
    return np.asarray(probs), {k: np.asarray(v) for k, v in state["intermediates"].items()}


def test_configs_and_synthetic_data_match_the_jax_package():
    for path in sorted(glob.glob(os.path.join(ROOT, "configs", "**", "*.json"), recursive=True)):
        a, b = JaxConfig.from_file(path), TorchConfig.from_file(path)
        assert dataclasses.asdict(a) == dataclasses.asdict(b), path
    *_, data = _pair("msl", n=64)
    assert data["x"].keys() == data["tx"].keys()
    for k in data["x"]:
        np.testing.assert_array_equal(data["x"][k], data["tx"][k])
    np.testing.assert_array_equal(data["y"], data["ty"])
    np.testing.assert_array_equal(data["jmask"], data["tmask"])


@pytest.mark.parametrize("task_name,with_mask", [
    ("mtl", False), ("msl", False), ("msl", True), ("mtmsl", True),
])
def test_mmoe_forward_matches_jax(task_name, with_mask):
    kw = {"num_tasks": 4} if task_name == "mtmsl" else {}  # 2 tasks x 2 domains
    jcfg, jmodel, variables, tmodel, d = _pair(task_name, **kw)
    mask = d["jmask"] if with_mask else None
    want, inter_want = _jax_forward(jmodel, variables, d["ids"], d["dense"], mask)
    with torch.inference_mode():
        got, inter = tmodel(
            torch.from_numpy(d["ids"]), torch.from_numpy(d["dense"]),
            None if mask is None else torch.from_numpy(mask),
            return_intermediates=True)
    np.testing.assert_array_equal(_bits(inter["dnn_input"]), _bits(inter_want["dnn_input"]))
    for k in ("expert_outputs", "mmoe_outputs", "tower_outputs"):
        np.testing.assert_allclose(inter[k].numpy(), np.asarray(inter_want[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    assert 0.02 < want.std(), "weights too small to test the heads"
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


@pytest.mark.parametrize("vocab", [100, 1 << 16])
def test_out_of_range_ids_follow_the_jax_forward(vocab):
    """An id past the fused table is a NaN row in the JAX forward (fill-mode
    take), a negative one wraps; the port's gather does the same, in the
    unpacked and the lane-packed layout."""
    kw = {"n_sparse": 4} if vocab > 1000 else {}
    _, jmodel, variables, tmodel, d = _pair("mtl", n=8, vocab=vocab, **kw)
    ids = d["ids"].copy()
    rows = tmodel.embeddings.fused.table.numel() // tmodel.embeddings.fused.dim
    ids[0, -1] = rows  # past the end (minus the last feature's offset: NaN)
    ids[1, 0] = -1  # wraps to the last (pad) row
    ids[2, 1] = -2**31 + 1  # out of range below
    want = _jax_forward(jmodel, variables, ids, d["dense"])[1]["dnn_input"]
    with torch.inference_mode():
        got, _ = tmodel.embed_inputs(torch.from_numpy(ids), torch.from_numpy(d["dense"]))
    nan = np.isnan(want)
    assert nan[0].any() and nan[2].any() and not nan[1].any()
    np.testing.assert_array_equal(np.isnan(got.numpy()), nan)
    np.testing.assert_array_equal(_bits(got.numpy()[~nan]), _bits(want[~nan]))


def test_packed_table_layout_matches_jax():
    """4 features x 65536 ids = 2^18 fused rows: the table is lane-packed
    [rows/P, 128] on both sides and the port's flat view gathers the same
    rows bitwise."""
    from mmlrec_tpu.ops.embedding import fused_table_geometry as jax_geometry
    from mmlrec_tpu_torch.ops.embedding import fused_table_geometry

    _, jmodel, variables, tmodel, d = _pair("mtl", n=64, vocab=1 << 16, n_sparse=4)
    assert fused_table_geometry(tmodel.layout) == jax_geometry(jmodel.layout) == (4, 32, 8192)
    assert tuple(tmodel.embeddings.fused.table.shape) == (8192, 128)
    assert variables["params"]["embeddings"]["fused"]["table"].shape == (8192, 128)
    want = _jax_forward(jmodel, variables, d["ids"], d["dense"])[1]["dnn_input"]
    ids = torch.from_numpy(d["ids"])
    with torch.inference_mode():
        got, sparse = tmodel.embed_inputs(ids, torch.from_numpy(d["dense"]))
        rows = tmodel.embeddings.sparse_embeddings(ids)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    assert rows.shape == sparse.shape == (64, 4, 4)
    np.testing.assert_array_equal(_bits(rows), _bits(want[:, :16].reshape(64, 4, 4)))
    np.testing.assert_array_equal(_bits(sparse), _bits(rows))


def test_port_init_statistics_match_jax():
    """The RNGs differ, so init is held by per-group mean and std only."""
    args = dict(SMALL, task_name="msl", model_name="mmoe", n_sparse=8, vocab=1000,
                hidden=(64, 32))
    jcfg, tcfg = jsyn.make_config(**args), tsyn.make_config(**args)
    jl, x, _, _ = jsyn.make_data(jcfg, n=8, vocab=1000)
    tl, *_ = tsyn.make_data(tcfg, n=8, vocab=1000)
    jmodel = jax_get_model("mmoe", jl, jcfg)
    ids, dense = Trainer(jmodel, seed=0).pack_inputs(x)
    init = jax.jit(lambda i, d: jmodel.init(jax.random.PRNGKey(0), i, d, None, train=False))
    jp = jax.device_get(init(jnp.asarray(ids[:2]), jnp.asarray(dense[:2]))["params"])
    flat = {"/".join(k.key for k in p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(jp)[0]}
    tp = {k.replace(".", "/"): v.detach().numpy()
          for k, v in get_model("mmoe", tl, tcfg, device="cpu").named_parameters()}
    assert sorted(flat) == sorted(tp)
    for k, a in flat.items():
        b = tp[k]
        assert a.shape == b.shape, k
        if k == "embeddings/fused/table":  # real rows normal(1e-4), pad rows exactly 0
            real = 8 * 1000
            assert not b.reshape(-1, 4)[real:].any()
            a, b = a.reshape(-1, 4)[:real], b.reshape(-1, 4)[:real]
        if not a.any():
            assert not b.any(), k
            continue
        # 6 standard errors of a sample of a.size draws
        se = 6 / np.sqrt(a.size)
        assert abs(b.mean() - a.mean()) < se * a.std() * np.sqrt(2), k
        assert abs(b.std() / a.std() - 1) < se, k


def _jax_bundle(tmp_path, jcfg, jmodel, variables):
    tr = Trainer(jmodel, seed=0).compile()
    tr.variables = variables
    jax_save_bundle(tr, str(tmp_path / "jax"), batch_size=64, platforms=["cpu"])
    return JaxBundle.load(str(tmp_path / "jax"))


@pytest.mark.parametrize("task_name,kw", [
    ("mtl", {}),
    ("msl", {"masked_loss": True}),
    ("mtl", {"vocab": 1 << 16, "n_sparse": 4}),  # lane-packed table
])
def test_serving_bundle_matches_jax_bundle(tmp_path, task_name, kw):
    n = 200  # not a multiple of the batch size: the fixed mode pads and trims
    jcfg, jmodel, variables, tmodel, d = _pair(task_name, n=n, **kw)
    jb = _jax_bundle(tmp_path, jcfg, jmodel, variables)
    meta = save_serving_bundle(tmodel, str(tmp_path / "torch"))
    assert meta["needs_mask"] == jb.meta["needs_mask"]
    assert meta["packing"] == jb.meta["packing"]
    assert set(jb.meta) - {"platforms"} <= set(meta)
    tb = ServingBundle.load(str(tmp_path / "torch"), device="cpu")
    want = jb.predict(d["x"])
    got = tb.predict(d["tx"])
    assert got.dtype == np.float64 and got.shape == want.shape == (n, jb.meta["num_heads"])
    np.testing.assert_allclose(got, want, atol=1e-6)
    np.testing.assert_allclose(tb.predict(d["tx"], batch_size=64), want, atol=1e-6)
    tb.meta["batch_mode"], tb.meta["batch_size"] = "fixed", 64
    np.testing.assert_allclose(tb.predict(d["tx"]), want, atol=1e-6)
    assert sum(K.launch_counts.values()) == 0  # the CPU never launches a kernel


def test_unported_options_are_refused():
    """What stays refused: a shard-major stacked container whose physical
    rows do not divide by its shards raises the JAX package's ValueError,
    sparse features of non-uniform dims raise the
    ValueError of the JAX package's failed stack.  A behaviour sequence, the
    parameterised activations and the wide logit build."""
    from mmlrec_tpu_torch.features import DenseFeat, FeatureLayout, SparseFeat, VarLenSparseFeat

    tl, *_ = tsyn.make_data(tsyn.make_config(**SMALL), n=8)
    cfg = tsyn.make_config(**SMALL, table_container="stacked", stacked_shards=1021)
    with pytest.raises(ValueError, match="to divide evenly"):
        get_model("mmoe", tl, cfg, device="cpu")
    varlen = [SparseFeat("s0", 50, 4), VarLenSparseFeat(SparseFeat("h", 50, 4), maxlen=3)]
    model = get_model("star", FeatureLayout(varlen), tsyn.make_config(**SMALL), device="cpu")
    assert tuple(model.embeddings.table_h.shape) == (50, 4)
    mixed = [SparseFeat("s0", 50, 4), SparseFeat("s1", 50, 6), DenseFeat("d0", 1)]
    with pytest.raises(ValueError, match="same shape"):
        get_model("star", FeatureLayout(mixed), tsyn.make_config(**SMALL), device="cpu")
    for kw in ({"dnn_activation": "prelu"}, {"dnn_activation": "dice"},
               {"use_wide_linear": True}):
        get_model("mmoe", tl, tsyn.make_config(**SMALL, **kw), device="cpu")
