"""The port's model families against the JAX ones on the CPU.

One case per registry name and regime: the JAX model is initialised, every
leaf of its variables (parameters and BatchNorm statistics) is replaced by a
numpy draw, the same tree is loaded into the port's model
(``convert.load_jax_variables``: no per-family table of names), and the
same numpy inputs go through both.

Tolerances: the DNN input (gather + concat) is data movement: bitwise.
Everything after it goes through f32 products, softmax and sigmoid whose
sums run in another order than XLA's: probabilities and activations atol
1e-6 / rtol 1e-5, the L2 penalty rtol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmlrec_tpu import synthetic as jsyn
from mmlrec_tpu.models import MODEL_REGISTRY as JAX_REGISTRY
from mmlrec_tpu.models import get_model as jax_get_model
from mmlrec_tpu.train import Trainer as JaxTrainer
from mmlrec_tpu.train.losses import l2_regularization as jax_l2
from mmlrec_tpu_torch import synthetic as tsyn
from mmlrec_tpu_torch.convert import load_jax_variables
from mmlrec_tpu_torch.models import MODEL_REGISTRY, UNPORTED, get_model
from mmlrec_tpu_torch.ops import kernels as K
from mmlrec_tpu_torch.train.losses import l2_regularization

SMALL = dict(emb=4, n_sparse=3, n_dense=2, hidden=(16, 8), tower=(8,), gate=(8,),
             batch_size=64)
TOL = dict(rtol=1e-5, atol=1e-6)
SLICE = ("mlp", "sharedbottom", "esmm", "escm", "escm_dr", "hmoe", "cross_stitch", "aitm",
         "ple", "pcg")
MSL = ("sharedbottom", "ple", "mlp", "hmoe", "cross_stitch")  # as tests/test_models.py
CASES = (
    [(name, "mtl", False, False) for name in SLICE]
    + [(name, "msl", mask, False) for name in MSL for mask in (False, True)]
    + [(name, "mtmsl", True, False) for name in ("sharedbottom", "ple", "hmoe")]
    + [(name, "mtl", False, True)
       for name in ("sharedbottom", "ple", "mlp", "esmm", "escm_dr", "hmoe", "cross_stitch",
                    "aitm")]
    + [("sharedbottom", "msl", True, True), ("ple", "mtmsl", True, True)]
)


def numpy_variables(variables, seed):
    """Every leaf of a flax variable tree replaced by a numpy draw: the
    table std 0.3, kernels and mixing matrices 1.5 / sqrt(fan_in) (so that
    activations stay of order 1 through every layer and the absolute
    tolerance means the same everywhere), biases 0.1, BatchNorm scales
    around 1 and running variances positive."""
    rng = np.random.default_rng(seed)

    def draw(path, a):
        leaf = path[-1].key
        if leaf == "var":
            return rng.uniform(0.5, 2.0, a.shape).astype(np.float32)
        if leaf == "scale":
            return rng.normal(1.0, 0.2, a.shape).astype(np.float32)
        std = 0.3 if leaf == "table" else 0.1
        if leaf in ("kernel", "cross_stitch_weight"):
            std = 1.5 / np.sqrt(a.shape[-2])
        return rng.normal(0.0, std, a.shape).astype(np.float32)

    tree = {k: v for k, v in dict(variables).items() if k in ("params", "batch_stats")}
    return jax.tree_util.tree_map_with_path(draw, jax.device_get(tree))


def family_pair(name, task_name="mtl", n=64, seed=0, **kw):
    """(JAX model, its numpy variables, the port's model with the same
    variables, data) for one family."""
    if task_name == "mtmsl":
        kw.setdefault("num_tasks", 4)  # 2 tasks x 2 domains
    args = dict(SMALL, task_name=task_name, model_name=name, vocab=100, **kw)
    jcfg, tcfg = jsyn.make_config(**args), tsyn.make_config(**args)
    jl, x, y, jmask = jsyn.make_data(jcfg, n=n, vocab=100, seed=seed)
    tl, *_ = tsyn.make_data(tcfg, n=n, vocab=100, seed=seed)
    jmodel = jax_get_model(name, jl, jcfg)
    ids, dense = JaxTrainer(jmodel, seed=0).pack_inputs(x)
    shapes = jax.eval_shape(
        lambda i, d: jmodel.init(jax.random.PRNGKey(0), i, d, None, train=False),
        jnp.asarray(ids[:2]), jnp.asarray(dense[:2]))
    variables = numpy_variables(shapes, seed + 1)
    tmodel = load_jax_variables(get_model(name, tl, tcfg, device="cpu"), variables)
    return jmodel, variables, tmodel, dict(x=x, y=y, mask=jmask, ids=ids, dense=dense,
                                           jcfg=jcfg, tcfg=tcfg)


def _jax_forward(jmodel, variables, ids, dense, mask, train=False):
    fn = jax.jit(lambda v, i, d, m: jmodel.apply(
        v, i, d, m, train=train, mutable=["intermediates", "batch_stats"]))
    probs, state = fn(variables, jnp.asarray(ids), jnp.asarray(dense),
                      None if mask is None else jnp.asarray(mask))
    return np.asarray(probs), jax.device_get(state)


def _flat(tree):
    return {".".join(str(p.key) for p in path): np.asarray(a)
            for path, a in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("name,task_name,with_mask,use_bn", CASES)
def test_family_forward_matches_jax(name, task_name, with_mask, use_bn):
    jmodel, variables, tmodel, d = family_pair(name, task_name, dnn_use_bn=use_bn,
                                               l2_reg_dnn=1e-3, l2_reg_embedding=1e-4)
    has_stats = bool(variables.get("batch_stats"))
    assert has_stats == (use_bn and name != "mlp")  # the MLP family's layers take no BatchNorm
    mask = d["mask"] if with_mask else None
    ids, dense = torch.from_numpy(d["ids"]), torch.from_numpy(d["dense"])
    tmask = None if mask is None else torch.from_numpy(mask)
    want, state = _jax_forward(jmodel, variables, d["ids"], d["dense"], mask)
    K.reset_launch_counts()
    with torch.inference_mode():
        got, inter = tmodel(ids, dense, tmask, return_intermediates=True)
        again = tmodel(ids, dense, tmask)
    assert sum(K.launch_counts.values()) == 0  # the CPU runs the plain versions
    assert got.shape == want.shape == (64, {"escm": 3, "escm_dr": 4}.get(name, want.shape[1]))
    assert 0.01 < want.std(), "weights too small to test the heads"
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_array_equal(again.numpy(), got.numpy())

    # the named intermediates are the ones the JAX model sows
    inter_want = state["intermediates"]
    assert set(inter) == set(inter_want), (sorted(inter), sorted(inter_want))
    np.testing.assert_array_equal(inter["dnn_input"].numpy().view(np.int32),
                                  np.asarray(inter_want["dnn_input"]).view(np.int32))
    for k, v in inter_want.items():
        np.testing.assert_allclose(inter[k].numpy(), np.asarray(v), err_msg=k, **TOL)

    # the family's own l2_reg_dnn inclusion set
    mc = d["jcfg"].model_config
    assert type(tmodel).REG_DNN_PREFIXES == type(jmodel).REG_DNN_PREFIXES
    reg = l2_regularization(dict(tmodel.named_parameters()), mc.l2_reg_embedding, mc.l2_reg_dnn,
                            dnn_prefixes=type(tmodel).REG_DNN_PREFIXES)
    reg_want = jax_l2(variables["params"], mc.l2_reg_embedding, mc.l2_reg_dnn,
                      dnn_prefixes=type(jmodel).REG_DNN_PREFIXES)
    np.testing.assert_allclose(float(reg.detach()), float(reg_want), rtol=1e-6)

    # injected rows (the two-phase step's) give what the table path gives
    with torch.inference_mode():
        rows = tmodel.embeddings.sparse_embeddings(ids)
        injected = tmodel(ids, dense, tmask, rows=rows)
    np.testing.assert_array_equal(injected.numpy(), got.numpy())

    if has_stats:  # a training-mode forward: batch statistics in, running ones moved
        want_tr, state = _jax_forward(jmodel, variables, d["ids"], d["dense"], mask, train=True)
        tmodel.train()
        with torch.no_grad():
            got_tr = tmodel(ids, dense, tmask)
        tmodel.eval()
        np.testing.assert_allclose(got_tr.numpy(), want_tr, **TOL)
        assert not np.allclose(got_tr.numpy(), got.numpy(), atol=1e-4)
        stats = _flat(state["batch_stats"])
        persistent = set(tmodel.state_dict())
        buffers = {k: b.numpy() for k, b in tmodel.named_buffers() if k in persistent}
        assert set(buffers) == set(stats)
        for k in stats:
            np.testing.assert_allclose(buffers[k], stats[k], rtol=0, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("name", SLICE)
def test_family_parameter_names_are_the_flax_paths_and_init_follows_jax(name):
    """A family whose parameter names differ from the flax paths is a
    fault.  The RNGs differ, so init is held per group: kernels of the DNNs
    std 1e-4, flax-default layers by their std, identities and zeros
    exactly."""
    args = dict(SMALL, task_name="mtl", model_name=name, vocab=100, hidden=(64, 32),
                dnn_use_bn=True)
    jcfg, tcfg = jsyn.make_config(**args), tsyn.make_config(**args)
    jl, x, _, _ = jsyn.make_data(jcfg, n=8, vocab=100)
    tl, *_ = tsyn.make_data(tcfg, n=8, vocab=100)
    jmodel = jax_get_model(name, jl, jcfg)
    ids, dense = JaxTrainer(jmodel, seed=0).pack_inputs(x)
    init = jax.jit(lambda i, d: jmodel.init(jax.random.PRNGKey(0), i, d, None, train=False))
    jv = jax.device_get(init(jnp.asarray(ids[:2]), jnp.asarray(dense[:2])))
    tmodel = get_model(name, tl, tcfg, device="cpu")
    assert type(tmodel).__name__ == type(jmodel).__name__
    params = {k: v.detach().numpy() for k, v in tmodel.named_parameters()}
    want = _flat(jv["params"])
    assert sorted(params) == sorted(want)
    stats = {k: v.numpy() for k, v in tmodel.state_dict().items() if k not in params}
    want_stats = _flat(jv.get("batch_stats", {}))
    assert sorted(stats) == sorted(want_stats)
    for k, a in {**want, **want_stats}.items():
        b = {**params, **stats}[k]
        assert a.shape == b.shape, k
        if a.std() == 0 or k.endswith("cross_stitch_weight"):  # zeros, ones, identities
            np.testing.assert_array_equal(b, a, err_msg=k)
        elif k != "embeddings.fused.table" and a.size >= 256:
            assert abs(b.std() / a.std() - 1) < 6 / np.sqrt(a.size) + 0.05, k


def test_aitm_needs_exactly_two_tasks_and_esmm_ignores_the_mask():
    cfg = tsyn.make_config(**SMALL, model_name="aitm", num_tasks=3)
    layout, *_ = tsyn.make_data(cfg, n=8)
    with pytest.raises(ValueError, match="equal to 2"):
        get_model("aitm", layout, cfg, device="cpu")
    *_, tmodel, d = family_pair("esmm")
    ids, dense = torch.from_numpy(d["ids"]), torch.from_numpy(d["dense"])
    with torch.inference_mode():
        masked = tmodel(ids, dense, torch.zeros(64, 2))
        plain = tmodel(ids, dense)
    np.testing.assert_array_equal(masked.numpy(), plain.numpy())
    assert (plain[:, 1] <= plain[:, 0]).all()  # pCTCVR = pCTR * pCVR


def test_registry_names_and_refusals():
    assert set(MODEL_REGISTRY) | set(UNPORTED) == set(JAX_REGISTRY)
    assert set(SLICE) | {"mmoe"} == set(MODEL_REGISTRY)
    assert MODEL_REGISTRY["pcg"] is MODEL_REGISTRY["mmoe"]
    cfg = tsyn.make_config(**SMALL)
    layout, *_ = tsyn.make_data(cfg, n=8)
    for name in UNPORTED:
        with pytest.raises(NotImplementedError, match="ROADMAP A5"):
            get_model(name, layout, cfg, device="cpu")
    with pytest.raises(KeyError, match="unknown model"):
        get_model("no_such_family", layout, cfg, device="cpu")
    for kw in ({"dnn_activation": "prelu"}, {"dnn_activation": "dice"},
               {"use_wide_linear": True}):
        with pytest.raises(NotImplementedError, match="ROADMAP A5"):
            get_model("sharedbottom", layout, tsyn.make_config(**SMALL, **kw), device="cpu")


@pytest.mark.parametrize("what,mutate", [
    ("a missing buffer", lambda v: v["batch_stats"]["bottom_dnn"].pop("bn_0")),
    ("an extra buffer", lambda v: v["batch_stats"]["bottom_dnn"].update(
        bn_9={"mean": np.zeros(3, np.float32)})),
    ("a mis-shaped buffer", lambda v: v["batch_stats"]["bottom_dnn"]["bn_0"].update(
        var=np.ones(3, np.float32))),
    ("a float64 buffer", lambda v: v["batch_stats"]["bottom_dnn"]["bn_0"].update(
        mean=np.zeros(16, np.float64))),
    ("no batch_stats at all", lambda v: v.pop("batch_stats")),
    ("a missing parameter", lambda v: v["params"]["bottom_dnn"]["bn_0"].pop("scale")),
    ("another collection", lambda v: v.update(cache={})),
])
def test_load_jax_variables_is_as_strict_with_buffers_as_with_parameters(what, mutate):
    _, variables, tmodel, _ = family_pair("sharedbottom", dnn_use_bn=True)
    variables = jax.tree_util.tree_map(np.array, variables)
    load_jax_variables(tmodel, variables)  # the whole tree loads
    np.testing.assert_array_equal(tmodel.bottom_dnn.bn_0.var.numpy(),
                                  variables["batch_stats"]["bottom_dnn"]["bn_0"]["var"])
    mutate(variables)
    with pytest.raises(ValueError):
        load_jax_variables(tmodel, variables)
