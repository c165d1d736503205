"""The port's layers (``mmlrec_tpu_torch/ops/layers.py``) against the flax
ones on the CPU: the same numpy-made weights and inputs through both.

Tolerances: f32 products and sums in another order than XLA's, so outputs
are held to atol 1e-6 / rtol 1e-5.  BatchNorm's running statistics after
three consecutive training calls are held to atol 1e-6: flax computes the
batch variance as ``mean(x^2) - mean(x)^2`` and so does the port, so what is
left is the order of the sums over the batch.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmlrec_tpu.ops import layers as JL
from mmlrec_tpu_torch.convert import load_jax_variables
from mmlrec_tpu_torch.ops import initializers as TI
from mmlrec_tpu_torch.ops import layers as TL
from mmlrec_tpu_torch.utils.seeding import make_generator

TOL = dict(rtol=1e-5, atol=1e-6)


def _numpy_variables(variables, seed):
    """The flax tree with every leaf replaced by a numpy draw: weights of
    order 0.3, BatchNorm scales around 1, running variances positive."""
    rng = np.random.default_rng(seed)

    def draw(path, a):
        leaf = path[-1].key
        if leaf == "var":
            return rng.uniform(0.5, 2.0, a.shape).astype(np.float32)
        if leaf == "scale":
            return rng.normal(1.0, 0.2, a.shape).astype(np.float32)
        return rng.normal(0.0, 0.3, a.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, jax.device_get(dict(variables)))


def _flat(tree):
    return {".".join(str(p.key) for p in path): np.asarray(a)
            for path, a in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _pair(jmodule, tmodule, x, seed, **apply_kw):
    variables = jmodule.init(jax.random.PRNGKey(0), *[jnp.asarray(a) for a in x], **apply_kw)
    variables = _numpy_variables(variables, seed)
    load_jax_variables(tmodule, variables)
    return variables


@pytest.mark.parametrize("stacked,rank", [(False, 2), (True, 2), (True, 3)])
def test_mlp_batchnorm_training_and_eval_match_flax(stacked, rank):
    rng = np.random.default_rng(7)
    B, K, d_in, hidden = 48, 3, 6, (8, 5)
    gen = make_generator(0)
    if stacked:
        jm = JL.StackedMLP(stack=K, hidden_units=hidden, use_bn=True)
        tm = TL.StackedMLP(K, d_in, hidden, generator=gen, use_bn=True)
    else:
        jm = JL.MLP(hidden_units=hidden, use_bn=True)
        tm = TL.MLP(d_in, hidden, generator=gen, use_bn=True)
    shape = (B, K, d_in) if rank == 3 else (B, d_in)
    batches = [rng.normal(0.3, 1.5, shape).astype(np.float32) for _ in range(4)]
    variables = _pair(jm, tm, (batches[0],), seed=11, train=False)
    assert set(variables) == {"params", "batch_stats"}
    stat_shape = (K, hidden[0]) if stacked else (hidden[0],)
    assert variables["batch_stats"]["bn_0"]["mean"].shape == stat_shape
    assert tuple(tm.bn_0.mean.shape) == tuple(tm.bn_0.scale.shape) == stat_shape

    # three consecutive training calls: outputs and running statistics
    tm.train()
    for x in batches[:3]:
        want, mutated = jm.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
        variables = {**variables, "batch_stats": mutated["batch_stats"]}
        got = tm(torch.from_numpy(x))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    stats = _flat(variables["batch_stats"])
    buffers = {k: b.numpy() for k, b in tm.named_buffers()}
    assert set(buffers) == set(stats) == {"bn_0.mean", "bn_0.var", "bn_1.mean", "bn_1.var"}
    for k in stats:
        np.testing.assert_allclose(buffers[k], stats[k], rtol=0, atol=1e-6, err_msg=k)

    # eval reads the running statistics and leaves them alone
    tm.eval()
    want = jm.apply(variables, jnp.asarray(batches[3]), train=False)
    got = tm(torch.from_numpy(batches[3]))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    for k in stats:
        np.testing.assert_allclose(dict(tm.named_buffers())[k].numpy(), stats[k], rtol=0, atol=1e-6)


def test_batchnorm_keeps_the_biased_variance_and_differentiates_through_the_statistics():
    """One training call on a known batch: the running variance moves by a
    tenth of the *biased* batch variance (torch's BatchNorm1d would add the
    unbiased one), and the gradient flows through mean and variance as in
    flax."""
    rng = np.random.default_rng(3)
    x = rng.normal(1.0, 2.0, (16, 4)).astype(np.float32)
    bn = TL.BatchNorm((4,)).train()
    xt = torch.from_numpy(x).requires_grad_(True)
    out = bn(xt)
    np.testing.assert_allclose(bn.mean.numpy(), 0.1 * x.mean(0), rtol=1e-6)
    np.testing.assert_allclose(bn.var.numpy(), 0.9 + 0.1 * x.var(0), rtol=1e-5)
    assert not np.allclose(bn.var.numpy(), 0.9 + 0.1 * x.var(0, ddof=1), rtol=1e-3)
    cot = rng.normal(0, 1, x.shape).astype(np.float32)
    (g,) = torch.autograd.grad(out, xt, torch.from_numpy(cot))
    jbn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    variables = jbn.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = jax.grad(lambda a: jnp.sum(jbn.apply(variables, a, mutable=["batch_stats"])[0]
                                      * jnp.asarray(cot)))(jnp.asarray(x))
    np.testing.assert_allclose(g.numpy(), np.asarray(want), rtol=1e-4, atol=1e-6)
    with pytest.raises(ValueError, match="one batch axis"):
        bn(torch.zeros(2, 3, 4))


def test_mlp_without_batchnorm_and_dense_match_flax():
    rng = np.random.default_rng(5)
    x = rng.normal(0, 1, (20, 6)).astype(np.float32)
    jm, tm = JL.MLP(hidden_units=(8, 4), activation="sigmoid"), TL.MLP(
        6, (8, 4), generator=make_generator(0), activation="sigmoid")
    variables = _pair(jm, tm, (x,), seed=1, train=False)
    assert set(variables) == {"params"} and not list(tm.buffers())
    assert sorted(k for k, _ in tm.named_parameters()) == sorted(_flat(variables["params"]))
    np.testing.assert_allclose(tm(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(jm.apply(variables, jnp.asarray(x))), **TOL)
    jd, td = fnn.Dense(3, use_bias=False), TL.Dense(6, 3, generator=make_generator(0),
                                                    use_bias=False)
    variables = _pair(jd, td, (x,), seed=2)
    np.testing.assert_allclose(td(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(jd.apply(variables, jnp.asarray(x))), **TOL)
    with pytest.raises(ValueError, match="hidden_units"):
        TL.MLP(6, (), generator=make_generator(0))


def test_cross_stitch_layer_matches_flax_and_starts_as_the_identity():
    rng = np.random.default_rng(9)
    x = rng.normal(0, 1, (12, 3, 5)).astype(np.float32)
    jm, tm = JL.CrossStitchLayer(), TL.CrossStitchLayer(3, 5, generator=make_generator(0))
    w0 = tm.cross_stitch_weight.detach().numpy()
    np.testing.assert_array_equal(w0, np.eye(15, dtype=np.float32))
    np.testing.assert_array_equal(
        w0, np.asarray(jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
                       ["cross_stitch_weight"]))
    np.testing.assert_array_equal(tm(torch.from_numpy(x)).detach().numpy(), x)
    variables = _pair(jm, tm, (x,), seed=4)
    np.testing.assert_allclose(tm(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(jm.apply(variables, jnp.asarray(x))), **TOL)


def test_aitm_attention_matches_flax():
    rng = np.random.default_rng(13)
    p, q = (rng.normal(0, 1, (18, 8)).astype(np.float32) for _ in range(2))
    jm, tm = JL.AITMAttention(dim=8), TL.AITMAttention(8, 8, generator=make_generator(0))
    variables = _pair(jm, tm, (p, q), seed=6)
    assert sorted(k for k, _ in tm.named_parameters()) == sorted(_flat(variables["params"]))
    got = tm(torch.from_numpy(p), torch.from_numpy(q))
    np.testing.assert_allclose(got.detach().numpy(),
                               np.asarray(jm.apply(variables, jnp.asarray(p), jnp.asarray(q))), **TOL)


def test_prediction_heads_from_logits_match_flax():
    rng = np.random.default_rng(17)
    types = ("binary", "regression", "binary")
    jm, tm = JL.PredictionHeads(task_types=types), TL.PredictionHeads(types)
    logits = rng.normal(0, 2, (10, 3)).astype(np.float32)
    variables = _pair(jm, tm, (logits,), seed=8)
    np.testing.assert_allclose(tm.from_logits(torch.from_numpy(logits)).detach().numpy(),
                               np.asarray(jm.apply(variables, jnp.asarray(logits))), **TOL)
    shared = logits[:, :1]  # one logit for every head, as the MLP family feeds it
    want = jm.apply(variables, jnp.broadcast_to(jnp.asarray(shared), (10, 3)))
    np.testing.assert_allclose(tm.from_logits(torch.from_numpy(shared)).detach().numpy(),
                               np.asarray(want), **TOL)


def test_initializers_follow_the_flax_defaults():
    """The RNGs differ, so a draw is held by its statistics: LeCun-normal
    has variance 1 / fan_in and no value beyond two of its untruncated
    standard deviations."""
    gen = make_generator(0)
    w = TI.lecun_normal_init()(gen, (400, 300)).numpy()
    ref = np.asarray(jax.nn.initializers.lecun_normal()(jax.random.PRNGKey(0), (400, 300)))
    assert abs(w.std() / ref.std() - 1) < 0.02 and abs(w.mean()) < 3 * ref.std() / np.sqrt(w.size)
    assert np.abs(w).max() <= np.abs(ref).max() * 1.01 <= 2.0 / 0.8796 / np.sqrt(400) * 1.02
    assert not TI.zeros_init()(gen, (3, 2)).any()
    eye = TI.eye_init()(gen, (2, 4, 4)).numpy()
    np.testing.assert_array_equal(eye, np.broadcast_to(np.eye(4, dtype=np.float32), (2, 4, 4)))
    with pytest.raises(ValueError, match="square"):
        TI.eye_init()(gen, (3, 4))
