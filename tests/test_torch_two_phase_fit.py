"""The port's two-phase SparseAdam fit of MMoE, held against the JAX Trainer
on the CPU, plus the port's own pins.

Both sides start from one state: the JAX trainer fits three steps from
transplanted numpy weights (so its moments and Adam state are warm), and
that whole state is carried into the port (``convert.load_jax_train_state``).
Then both fit the same three batches (the last one partial and shuffled),
one ``fit`` call per step, for the stacked and the split container at pack
factors 1 and 16 (batch 64 x 4 features: K = 256, so the JAX step takes
its dual gather).

Tolerances: per-step losses within rtol 1e-5 and dense parameters within
atol 1e-6 (f32 products and sums run in another order in PyTorch than in
XLA); the table within atol 1e-6, and the unpacked moments within 2^-7
relative: one bf16 rounding flip of a lane per step, which an ulp-level
gradient difference can cause.  The port's own stacked and split
containers must train to equal bits, as the JAX package pins
(tests/test_sparse_embedding.py:598-632).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from mmlrec_tpu import synthetic as jsyn
from mmlrec_tpu.models import get_model as jax_get_model
from mmlrec_tpu.train import Trainer as JaxTrainer
from mmlrec_tpu_torch import synthetic as tsyn
from mmlrec_tpu_torch.convert import load_jax_train_state
from mmlrec_tpu_torch.models import get_model
from mmlrec_tpu_torch.ops import kernels as K
from mmlrec_tpu_torch.serving import ServingBundle, save_serving_bundle
from mmlrec_tpu_torch.train import Trainer
from mmlrec_tpu_torch.train.sparse_embedding import (
    SparseAdamPackedState,
    SparseAdamState,
    fold_stacked_planes,
    pack_monu_rounded,
    split_stacked_planes,
    unpack_monu_f32,
)

KW = dict(task_name="mtl", model_name="mmoe", n_sparse=4, n_dense=2, hidden=(16, 8),
          tower=(8,), gate=(8,), batch_size=64, lr=3e-3, two_phase_embedding=True,
          table_update="pallas", table_opt_dtype="bfloat16", device_metadata=True)
VOCAB = {1: 400, 16: 1 << 16}  # 1664 rows unpacked; 2^18 rows, lane-packed P = 16
SLICES = ((160, 224, False), (224, 288, False), (288, 328, True))


def _rows(x, a, b):
    return {k: v[a:b] for k, v in x.items()}


def _pack(layout, x):
    ids = np.stack([x[s.feature.name] for s in layout.sparse_slots], 1).astype(np.int32)
    dense = np.stack([x[s.feature.name] for s in layout.dense_slots], 1).astype(np.float32)
    return torch.from_numpy(ids), torch.from_numpy(dense)


def _numpy_params(shapes, seed, fat):
    """Weights of every leaf from numpy; the stacked container's moment half
    starts at zero."""
    rng = np.random.default_rng(seed)
    std = {"table": 0.3, "bias": 0.1, "kernel": 0.3}

    def draw(path, a):
        x = rng.normal(0, std[path[-1].key], a.shape).astype(np.float32)
        if fat and path[-1].key == "table":
            x[a.shape[0] // 2:] = 0.0
        return x

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _flat(tree):
    return {"/".join(str(p.key) for p in path): np.asarray(a)
            for path, a in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _jax_side(container, P):
    vocab = VOCAB[P]
    cfg = jsyn.make_config(vocab=vocab, table_container=container, **KW)
    layout, x, y, _ = jsyn.make_data(cfg, n=328, seed=0, vocab=vocab)
    jtr = JaxTrainer(jax_get_model("mmoe", layout, cfg), seed=0).compile()
    ids, dense = jtr.pack_inputs(x)
    shapes = jax.eval_shape(
        lambda i, d: jtr.model.init(jax.random.PRNGKey(0), i, d, None, train=False),
        jnp.asarray(ids[:2]), jnp.asarray(dense[:2]))["params"]
    params = _numpy_params(shapes, seed=1, fat=container == "stacked")
    jtr.variables = {"params": jax.tree_util.tree_map(jnp.asarray, params)}
    jtr.fit(_rows(x, 0, 160), y[:160], batch_size=64, epochs=1, verbose=0)  # warm state
    assert jtr._emb_pack_factor == P and jtr.pair_gather == (
        "dual" if container == "stacked" else "split")
    return jtr, x, y


def _state_of(jtr):
    params = jax.tree_util.tree_map(np.asarray, jtr.variables["params"])
    st = jtr._train_state
    adam = st["opt_state"][0]  # optax.flatten(adam): flat mu / nu vectors
    _, unravel = ravel_pytree(JaxTrainer._without_table(params)[0])
    opt_state = {"count": np.asarray(adam.count), "mu": unravel(adam.mu),
                 "nu": unravel(adam.nu)}
    table_opt = {"count": np.asarray(st["table_opt"].count)}
    if hasattr(st["table_opt"], "monu"):
        table_opt["monu"] = np.asarray(st["table_opt"].monu)
    return params, table_opt, opt_state


def _port_trainer(container, P, state):
    cfg = tsyn.make_config(vocab=VOCAB[P], table_container=container, **KW)
    layout, *_ = tsyn.make_data(cfg, n=8, seed=0, vocab=VOCAB[P])
    tr = Trainer(get_model("mmoe", layout, cfg, device="cpu"), seed=0, device="cpu").compile()
    return load_jax_train_state(tr, *state)


def _table_and_monu(tr):
    if tr.table_container == "stacked":
        return tuple(a.numpy() for a in split_stacked_planes(tr.table.detach()))
    return tr.table.detach().numpy(), tr.table_opt.monu.numpy()


@pytest.mark.parametrize("container,P", [("stacked", 1), ("split", 1),
                                         ("stacked", 16), ("split", 16)])
def test_two_phase_fit_matches_jax(container, P):
    jtr, x, y = _jax_side(container, P)
    tr = _port_trainer(container, P, _state_of(jtr))
    K.reset_launch_counts()
    for a, b, shuffle in SLICES:
        jtr.fit(_rows(x, a, b), y[a:b], batch_size=64, epochs=1, verbose=0, shuffle=shuffle)
        tr.fit(_rows(x, a, b), y[a:b], batch_size=64, epochs=1, verbose=0, shuffle=shuffle)
        np.testing.assert_allclose(tr.history[-1]["loss"], jtr.history[-1]["loss"], rtol=1e-5)
    assert sum(K.launch_counts.values()) == 0  # the CPU runs the plain versions

    want = _flat(jtr.variables["params"])
    got = {k.replace(".", "/"): p.detach().numpy() for k, p in tr.model.named_parameters()}
    assert set(got) == set(want)
    for k in want:
        if k != "embeddings/fused/table":
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6, err_msg=k)
    table, monu = _table_and_monu(tr)
    _, j_to, _ = _state_of(jtr)
    j_table = want["embeddings/fused/table"]
    Vp = table.shape[0]
    j_monu = j_to["monu"] if container == "split" else j_table[Vp:]
    np.testing.assert_allclose(table, j_table[:Vp], rtol=0, atol=1e-6)
    for a, b in zip(unpack_monu_f32(torch.from_numpy(monu)),
                    unpack_monu_f32(torch.from_numpy(np.array(j_monu)))):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2.0 ** -7, atol=0)
    assert int(tr.table_opt.count) == int(j_to["count"]) == 6
    np.testing.assert_allclose(tr.predict(_rows(x, 0, 100), 64),
                               jtr.predict(_rows(x, 0, 100), 64), rtol=0, atol=1e-6)


def _random_state(P, seed=7):
    """A warm state without JAX: numpy weights, random packed moments."""
    rng = np.random.default_rng(seed)
    cfg = tsyn.make_config(vocab=VOCAB[P], table_container="split", **KW)
    layout, x, y, _ = tsyn.make_data(cfg, n=160, seed=0, vocab=VOCAB[P])
    model = get_model("mmoe", layout, cfg, device="cpu")
    params, mu, nu = {}, {}, {}
    for k, p in model.named_parameters():
        node = params
        for part in k.split(".")[:-1]:
            node = node.setdefault(part, {})
        node[k.split(".")[-1]] = rng.normal(0, 0.3, tuple(p.shape)).astype(np.float32)
        if k != "embeddings.fused.table":
            mu[k.replace(".", "/")] = rng.normal(0, 1e-3, tuple(p.shape)).astype(np.float32)
            nu[k.replace(".", "/")] = np.abs(rng.normal(0, 1e-4, tuple(p.shape))).astype(np.float32)
    table = params["embeddings"]["fused"]["table"]
    monu = pack_monu_rounded(
        torch.from_numpy(rng.normal(0, 1e-2, table.shape).astype(np.float32)),
        torch.from_numpy(np.abs(rng.normal(0, 1e-3, table.shape)).astype(np.float32))).numpy()

    def nest(flat):
        out = {}
        for k, v in flat.items():
            node = out
            for part in k.split("/")[:-1]:
                node = node.setdefault(part, {})
            node[k.split("/")[-1]] = v
        return out

    opt_state = {"count": np.int32(2), "mu": nest(mu), "nu": nest(nu)}
    return params, monu, opt_state, x, y


@pytest.mark.parametrize("P", [1, 16])
def test_stacked_container_trains_bitwise_equal_to_split(P):
    params, monu, opt_state, x, y = _random_state(P)
    fat_params = jax.tree_util.tree_map(lambda a: a, params)
    fat_params["embeddings"]["fused"]["table"] = fold_stacked_planes(
        torch.from_numpy(params["embeddings"]["fused"]["table"]), torch.from_numpy(monu)).numpy()
    split = _port_trainer("split", P, (params, {"count": 3, "monu": monu}, opt_state))
    stacked = _port_trainer("stacked", P, (fat_params, {"count": 3}, opt_state))
    for tr in (split, stacked):
        tr.fit(x, y, batch_size=64, epochs=2, verbose=0)
    assert [h["loss"] for h in split.history] == [h["loss"] for h in stacked.history]
    for a, b in zip(_table_and_monu(split), _table_and_monu(stacked)):
        np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))
    for (k, p), (k2, q) in zip(split.rest_params().items(), stacked.rest_params().items()):
        assert k == k2
        np.testing.assert_array_equal(p.detach().numpy(), q.detach().numpy(), err_msg=k)
    np.testing.assert_array_equal(split.predict(x, 64), stacked.predict(x, 64))


def test_stacked_container_init_and_serving_view(tmp_path):
    """The stacked param's top half is drawn exactly as the split table and
    the bottom half is zero; the serving forward's flat view of the fat
    param reads plane 0."""
    cfg = tsyn.make_config(vocab=VOCAB[16], **KW)
    layout, x, *_ = tsyn.make_data(cfg, n=64, seed=0, vocab=VOCAB[16])
    split = get_model("mmoe", layout, cfg, device="cpu")
    cfg_s = tsyn.make_config(vocab=VOCAB[16], table_container="stacked", **KW)
    stacked = get_model("mmoe", layout, cfg_s, device="cpu")
    fat, table = stacked.embeddings.fused.table, split.embeddings.fused.table
    assert fat.shape == (2 * table.shape[0], 128) and stacked.embeddings.fused.phys_rows == table.shape[0]
    assert torch.equal(fat[: table.shape[0]], table) and not fat[table.shape[0]:].any()
    with torch.no_grad():  # the serving forward must not read the moment half
        fat[table.shape[0]:] = float("nan")
    ids, dense = _pack(layout, x)
    with torch.inference_mode():
        a = split(ids, dense)
        b = stacked(ids, dense)
    assert torch.equal(a, b)
    # injected rows give the table's forward exactly
    rows = table.view(-1, 8)[ids.long() + split.embeddings.fused.offsets.long()]
    with torch.inference_mode():
        c = split(ids, dense, rows=rows)
    assert torch.equal(a, c)
    # the bundle of a stacked model is the split model: the moment half stays behind
    save_serving_bundle(stacked, str(tmp_path))
    bundle = ServingBundle.load(str(tmp_path), device="cpu")
    assert bundle.meta["config"]["model_config"]["table_container"] == "split"
    assert torch.equal(bundle.model.embeddings.fused.table, table)
    np.testing.assert_array_equal(bundle.predict(x), a.numpy().astype(np.float64))


def test_injected_rows_are_differentiable():
    cfg = tsyn.make_config(vocab=50, n_sparse=3, n_dense=2, hidden=(8,), tower=(4,), gate=(4,))
    layout, x, *_ = tsyn.make_data(cfg, n=16, seed=0, vocab=50)
    model = get_model("mmoe", layout, cfg, device="cpu")
    ids, dense = _pack(layout, x)
    rows = torch.randn(16, 3, 8, requires_grad=True)
    dnn_input, emb = model.embed_inputs(ids, dense, rows)
    assert emb is rows and dnn_input.shape == (16, 3 * 8 + 2)
    (g,) = torch.autograd.grad(dnn_input.square().sum(), rows)
    torch.testing.assert_close(g, 2 * rows.detach())


def test_gated_expert_mix_backward_matches_autograd():
    g = torch.Generator().manual_seed(0)
    logits = (2 * torch.randn(64, 2, 4, generator=g)).requires_grad_(True)
    experts = torch.randn(64, 4, 16, generator=g).requires_grad_(True)
    grad_out = torch.randn(64, 2, 16, generator=g)
    want = torch.autograd.grad(K.gated_expert_mix_plain(logits, experts), (logits, experts),
                               grad_out)
    got = K.gated_expert_mix_backward(logits.detach(), experts.detach(), grad_out)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-5)


def test_multihead_score_backward_matches_autograd():
    g = torch.Generator().manual_seed(1)
    tower = torch.randn(64, 3, 8, generator=g).requires_grad_(True)
    w = (0.3 * torch.randn(3, 8, generator=g)).requires_grad_(True)
    b = torch.randn(3, generator=g).requires_grad_(True)
    binary = torch.tensor([1.0, 0.0, 1.0])  # a regression head in the middle
    grad_out = torch.randn(64, 3, generator=g)
    want = torch.autograd.grad(K.multihead_score_plain(tower, w, b, binary), (tower, w, b),
                               grad_out)
    got = K.multihead_score_backward(tower.detach(), w.detach(), b.detach(), binary, grad_out)
    for a, c in zip(got, want):
        torch.testing.assert_close(a, c, atol=1e-6, rtol=1e-5)


# scan_steps, batch_metric_curves and ROADMAP A4's routes are ported: their
# cases (item None) fit with the knob (tests/test_torch_staged_fit.py holds
# the host-loop knobs bitwise; test_torch_gather_route.py,
# test_torch_slot_space.py and test_torch_split_moments.py the routes
# against JAX); a combination the JAX trainer refuses raises its ValueError
# (the item is then the message), an unported knob NotImplementedError
# naming its ROADMAP item
@pytest.mark.parametrize("override,item", [
    (dict(two_phase_embedding=False, scan_steps=16), None),  # the dense fit takes it too
    (dict(table_update="scatter"), None),  # split bf16 moments
    (dict(table_update="unique"), ValueError("incompatible with table_update='unique'")),
    (dict(table_update="auto"), None),  # the CPU resolves auto to scatter: split bf16
    (dict(table_opt_dtype="float16"), None),  # the write kernel on split f16 (the CPU only)
    (dict(device_metadata=False), None),  # host metadata: the gather route
    (dict(dedup_route="gather"), ValueError("no gather-route lists")),
    (dict(update_space="slot"), ValueError("update_space='slot' requires")),
    (dict(scan_steps=16), None),
    (dict(batch_metric_curves=True), None),
    (dict(use_gradnorm=True), ValueError("per-task gradient methods")),
])
def test_unported_knobs_raise_naming_their_roadmap_item(override, item):
    cfg = tsyn.make_config(**{**KW, "vocab": 400, **override})
    layout, x, y, _ = tsyn.make_data(cfg, n=150, seed=0, vocab=400)
    model = get_model("mmoe", layout, cfg, device="cpu")
    if item is not None:
        err, match = ((type(item), str(item)) if isinstance(item, Exception)
                      else (NotImplementedError, item))
        with pytest.raises(err, match=match):
            Trainer(model, device="cpu")
        return
    tr = Trainer(model, device="cpu").compile(metrics=["auc"])
    tr.fit(x, y, batch_size=64, epochs=2, verbose=0)
    assert tr._scan_steps == 16 and np.isfinite([h["loss"] for h in tr.history]).all()
    curves = "batch_metric_curves" in override
    assert [len(c) for c in tr.batch_history] == ([3, 3] if curves else [])
    assert ("batch_mean_auc" in tr.history[-1]) == curves
    if override.get("two_phase_embedding", True):
        mdt = override.get("table_opt_dtype", "bfloat16")
        split = tr.table_update == "scatter" or mdt == "float16"
        assert isinstance(tr.table_opt, SparseAdamState if split else SparseAdamPackedState)
        if split:
            assert tr.table_opt.mu.dtype == getattr(torch, mdt)
        assert tr.dedup_route == ("gather" if override.get("device_metadata") is False
                                  else "scatter")


def test_trainer_refuses_meshes_and_defaults_to_the_card(monkeypatch, tmp_path):
    cfg = tsyn.make_config(vocab=400, **KW)
    layout, x, y, _ = tsyn.make_data(cfg, n=64, seed=0, vocab=400)
    model = get_model("mmoe", layout, cfg, device="cpu")
    from mmlrec_tpu_torch.parallel import create_mesh

    mesh = create_mesh(device="cpu")  # a process group of one
    try:  # the write-kernel update on a mesh needs the explicit exchange (JAX's ValueError)
        with pytest.raises(ValueError, match="requires the explicit_collective_embedding path"):
            Trainer(model, mesh=mesh, device="cpu")
    finally:
        torch.distributed.destroy_process_group()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(model)
    tr = Trainer(model, device="cpu").compile()
    tr.fit(x, y, batch_size=64, shuffle="block", verbose=0)  # block mode is ported
    assert len(tr.history) == 1 and np.isfinite(tr.history[0]["loss"])
    with pytest.raises(ValueError, match="shuffle"):
        tr.fit(x, y, batch_size=64, shuffle="rows", verbose=0)
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        tr.fit(x, y, batch_size=64, resume_from=str(tmp_path / "ckpt"), verbose=0)
    with pytest.raises(ValueError, match="Kp"):
        tr.fit(x, y, batch_size=512, verbose=0)
