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
SCENE = ("snr_trans", "mssm", "star", "apg", "pepnet")
SLICE = ("mlp", "sharedbottom", "esmm", "escm", "escm_dr", "hmoe", "cross_stitch", "aitm",
         "ple", "pcg") + SCENE
MSL = ("sharedbottom", "ple", "mlp", "hmoe", "cross_stitch") + SCENE  # as tests/test_models.py
CASES = (
    [(name, "mtl", False, False) for name in SLICE]
    + [(name, "msl", mask, False) for name in MSL for mask in (False, True)]
    + [(name, "mtmsl", True, False) for name in ("sharedbottom", "ple", "hmoe", "star", "mssm")]
    + [(name, "mtl", False, True)
       for name in ("sharedbottom", "ple", "mlp", "esmm", "escm_dr", "hmoe", "cross_stitch",
                    "aitm", "snr_trans", "mssm", "star")]
    + [("sharedbottom", "msl", True, True), ("ple", "mtmsl", True, True),
       ("star", "msl", True, True), ("star", "msl", False, True), ("mssm", "msl", True, True)]
)
# options any family may take: (family, regime, mask, BatchNorm, model_config)
OPTION_CASES = [
    ("sharedbottom", "mtl", False, False, dict(dnn_activation="prelu")),
    ("ple", "msl", True, True, dict(dnn_activation="prelu")),
    ("mmoe", "mtl", False, False, dict(dnn_activation="dice")),
    ("sharedbottom", "msl", True, True, dict(dnn_activation="dice")),
    ("mssm", "mtl", False, False, dict(dnn_activation="dice")),
    ("snr_trans", "mtl", False, False, dict(dnn_activation="prelu")),
    ("star", "msl", True, True, dict(domain_bn_mode="intended")),
    ("star", "msl", True, False, dict(use_shared=False, ref_faithful_frozen_params=True)),
    ("snr_trans", "mtl", False, False, dict(snr_gate_alpha="per_connection")),
    ("mssm", "msl", True, False, dict(snr_gate_alpha="per_connection",
                                      snr_gate_open_init=9.0)),
    ("snr_trans", "mtl", False, False, dict(snr_stochastic_gates=True)),
    ("pepnet", "msl", True, False, dict(user_sf_item_sf=True)),
] + [(name, "mtl" if name in ("esmm", "escm", "escm_dr", "aitm") else "msl", True, False,
      dict(use_wide_linear=True, l2_reg_linear=1e-3))
     for name in ("mlp", "esmm", "escm_dr", "hmoe", "aitm", "mmoe", "ple", "sharedbottom",
                  "cross_stitch") + SCENE]


def numpy_variables(variables, seed):
    """Every leaf of a flax variable tree replaced by a numpy draw: the
    table std 0.3, kernels, mixing matrices and gate transforms 1.5 /
    sqrt(fan_in), STAR's two factors of a weight each the square root of
    that, gate locations and u inside their clip bounds (so that
    activations stay of order 1 through every layer and the absolute
    tolerance means the same everywhere), biases 0.1, BatchNorm scales
    around 1 and running variances positive."""
    rng = np.random.default_rng(seed)

    def draw(path, a):
        leaf = path[-1].key
        if leaf in ("var", "pop_var"):
            return rng.uniform(0.5, 2.0, a.shape).astype(np.float32)
        if leaf in ("scale", "gamma"):
            return rng.normal(1.0, 0.2, a.shape).astype(np.float32)
        if leaf == "alpha":  # activation slopes around PReLU's 0.25; gate locations in
            # (0.05, 2), a gate's one scalar location above 0.3 so that not all gates shut
            if str(path[-2].key).startswith(("prelu", "dice")):
                return rng.uniform(0.05, 0.5, a.shape).astype(np.float32)
            return rng.uniform(0.3 if a.shape == (1,) else 0.05, 2.0, a.shape).astype(np.float32)
        if leaf == "u":  # inside (0, 1), away from the clip bounds
            return rng.uniform(0.05, 0.95, a.shape).astype(np.float32)
        std = 0.3 if leaf == "table" else 0.1
        if leaf in ("kernel", "cross_stitch_weight", "trans") or leaf.startswith("w_"):
            std = 1.5 / np.sqrt(a.shape[-2])
        if leaf in ("specific_kernel", "shared_kernel"):  # STAR's weight is their product
            std = np.sqrt(1.5) / a.shape[-2] ** 0.25
        return rng.normal(0.0, std, a.shape).astype(np.float32)

    tree = {k: v for k, v in dict(variables).items() if k in ("params", "batch_stats")}
    return jax.tree_util.tree_map_with_path(draw, jax.device_get(tree))


def family_pair(name, task_name="mtl", n=64, seed=0, **kw):
    """(JAX model, its numpy variables, the port's model with the same
    variables, data) for one family."""
    if task_name == "mtmsl":
        kw.setdefault("num_tasks", 4)  # 2 tasks x 2 domains
    side = kw.pop("user_sf_item_sf", False)  # PEPNet's user and item side features
    args = dict(SMALL, task_name=task_name, model_name=name, vocab=100, **kw)
    jcfg, tcfg = jsyn.make_config(**args), tsyn.make_config(**args)
    if side:
        for cfg in (jcfg, tcfg):
            cfg.data_config.user_sf, cfg.data_config.item_sf = "s1", "s2"
    jl, x, y, jmask = jsyn.make_data(jcfg, n=n, vocab=100, seed=seed)
    tl, *_ = tsyn.make_data(tcfg, n=n, vocab=100, seed=seed)
    jmodel = jax_get_model(name, jl, jcfg)
    ids, dense = JaxTrainer(jmodel, seed=0).pack_inputs(x)
    # the JAX trainer's init: a mask of ones in the msl and mtmsl regimes
    # (it creates STAR's DomainBatchNorm where the mask's width is T)
    dm = None if task_name == "mtl" else jnp.ones((2, jcfg.data_config.num_domains))
    shapes = jax.eval_shape(
        lambda i, d: jmodel.init(jax.random.PRNGKey(0), i, d, dm, train=False),
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


def _expects_stats(name, task_name, use_bn, extra):
    """Whether the family keeps BatchNorm statistics: Dice always; with
    BatchNorm every family whose layers take it (not MLP, APG or PEPNet),
    STAR only where its DomainBatchNorm exists (msl: D == T)."""
    if extra.get("dnn_activation") == "dice":
        return True
    if name == "star":
        return use_bn and task_name == "msl"
    return use_bn and name not in ("mlp", "apg", "pepnet")


@pytest.mark.parametrize("name,task_name,with_mask,use_bn", CASES)
def test_family_forward_matches_jax(name, task_name, with_mask, use_bn):
    _check_family_forward(name, task_name, with_mask, use_bn)


@pytest.mark.parametrize("name,task_name,with_mask,use_bn,extra", OPTION_CASES)
def test_family_forward_with_options_matches_jax(name, task_name, with_mask, use_bn, extra):
    _check_family_forward(name, task_name, with_mask, use_bn, **extra)


def _check_family_forward(name, task_name, with_mask, use_bn, **extra):
    jmodel, variables, tmodel, d = family_pair(name, task_name, dnn_use_bn=use_bn,
                                               l2_reg_dnn=1e-3, l2_reg_embedding=1e-4, **extra)
    has_stats = bool(variables.get("batch_stats"))
    assert has_stats == _expects_stats(name, task_name, use_bn, extra)
    assert ("wide_linear" in variables["params"]) == bool(extra.get("use_wide_linear"))
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
                            dnn_prefixes=type(tmodel).REG_DNN_PREFIXES,
                            l2_linear=mc.l2_reg_linear)
    reg_want = jax_l2(variables["params"], mc.l2_reg_embedding, mc.l2_reg_dnn,
                      dnn_prefixes=type(jmodel).REG_DNN_PREFIXES, l2_linear=mc.l2_reg_linear)
    np.testing.assert_allclose(float(reg.detach()), float(reg_want), rtol=1e-6)

    # injected rows (the two-phase step's) give what the table path gives
    with torch.inference_mode():
        rows = tmodel.embeddings.sparse_embeddings(ids)
        injected = tmodel(ids, dense, tmask, rows=rows)
    np.testing.assert_array_equal(injected.numpy(), got.numpy())

    # a training-mode forward: batch statistics in, running ones moved (STAR's
    # DomainBatchNorm only where a mask reaches it; stochastic gates draw
    # from another generator than JAX's: tests/test_torch_scene_families.py)
    if (has_stats and not extra.get("snr_stochastic_gates")
            and (name != "star" or mask is not None)):
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
        if a.size == 1 and a.item() != 0:  # one draw (a gate's U(0, 1) location, a bias)
            assert abs(a.item()) < 1 and abs(b.item()) < 1, k
        elif a.std() == 0 or k.endswith("cross_stitch_weight"):  # zeros, ones, identities
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
    """Every name of the JAX registry builds, on a layout with a behaviour
    sequence too; sparse features of non-uniform dims raise the ValueError
    of the JAX package's failed stack (tests/test_torch_varlen.py holds both
    against JAX); a shard-major stacked container whose physical rows do
    not divide by its shards raises the JAX package's ValueError."""
    from mmlrec_tpu_torch.features import DenseFeat, FeatureLayout, SparseFeat, VarLenSparseFeat

    assert set(MODEL_REGISTRY) == set(JAX_REGISTRY) and UNPORTED == ()
    assert set(SLICE) | {"mmoe"} == set(MODEL_REGISTRY)
    assert MODEL_REGISTRY["pcg"] is MODEL_REGISTRY["mmoe"]
    cfg = tsyn.make_config(**SMALL)
    layout, *_ = tsyn.make_data(cfg, n=8)
    with pytest.raises(KeyError, match="unknown model"):
        get_model("no_such_family", layout, cfg, device="cpu")
    varlen = FeatureLayout([SparseFeat("s0", 100, 4), DenseFeat("d0", 1), VarLenSparseFeat(
        SparseFeat("hist", 100, 4), maxlen=5, combiner="mean")])
    mixed = FeatureLayout([SparseFeat("s0", 100, 4), SparseFeat("s1", 100, 8), DenseFeat("d0", 1)])
    model = get_model("sharedbottom", varlen, cfg, device="cpu")
    assert sorted(k for k, _ in model.named_parameters() if k.startswith("embeddings")) == [
        "embeddings.fused.table", "embeddings.table_hist"]
    with pytest.raises(ValueError, match="same shape"):
        get_model("sharedbottom", mixed, cfg, device="cpu")
    with pytest.raises(ValueError, match="to divide evenly"):
        get_model("sharedbottom", layout, tsyn.make_config(
            **SMALL, table_container="stacked", stacked_shards=1021), device="cpu")
    for kw in ({"dnn_activation": "prelu"}, {"dnn_activation": "dice"},
               {"use_wide_linear": True}):
        get_model("sharedbottom", layout, tsyn.make_config(**SMALL, **kw), device="cpu")
    with pytest.raises(NotImplementedError, match="activation 'prelu'"):  # as in the JAX STAR
        get_model("star", layout, tsyn.make_config(**SMALL, dnn_activation="prelu"),
                  device="cpu")


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
