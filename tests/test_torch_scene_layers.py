"""The layers of the scene families (SNR-Trans, MSSM, STAR, APG, PEPNet),
the parameterised activations and the wide logit, against the flax modules
on the CPU: the same numpy-made weights and inputs through both, and the
gradients of one cotangent.

Tolerances: f32 products and sums in another order than XLA's, so outputs
and gradients are held to atol 1e-6 / rtol 1e-5, BatchNorm statistics to
atol 1e-6.  Where the JAX module stops a gradient the port's parameter gets
none (``.grad`` is None) or a zero one.  Draws stay off the clip bounds of
the gates (``alpha`` in (0.05, 2), ``u`` in (0.05, 0.95)): at a bound
``torch.clamp`` passes the whole gradient and ``jnp.clip`` none or half.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmlrec_tpu.models.apg import APGLayer as JAPGLayer
from mmlrec_tpu.ops import initializers as JI
from mmlrec_tpu.ops import layers as JL
from mmlrec_tpu.ops.domain_norm import DomainBatchNorm as JDomainBatchNorm
from mmlrec_tpu_torch.convert import load_jax_variables
from mmlrec_tpu_torch.models.apg import APGLayer
from mmlrec_tpu_torch.ops import initializers as TI
from mmlrec_tpu_torch.ops import layers as TL
from mmlrec_tpu_torch.ops.domain_norm import DomainBatchNorm
from mmlrec_tpu_torch.utils.seeding import make_generator

TOL = dict(rtol=1e-5, atol=1e-6)


def _numpy_variables(variables, seed, std=0.3):
    rng = np.random.default_rng(seed)

    def draw(path, a):
        leaf = path[-1].key
        if leaf in ("var", "pop_var"):
            return rng.uniform(0.5, 2.0, a.shape).astype(np.float32)
        if leaf in ("scale", "gamma"):
            return rng.normal(1.0, 0.2, a.shape).astype(np.float32)
        if leaf == "alpha":
            return rng.uniform(0.05, 2.0, a.shape).astype(np.float32)
        if leaf == "u":
            return rng.uniform(0.05, 0.95, a.shape).astype(np.float32)
        if leaf in ("trans",) or leaf.startswith("w_"):
            return rng.normal(0.0, 1.0 / np.sqrt(a.shape[-2]), a.shape).astype(np.float32)
        return rng.normal(0.0, std, a.shape).astype(np.float32)

    tree = {k: v for k, v in jax.device_get(dict(variables)).items()
            if k in ("params", "batch_stats")}
    return jax.tree_util.tree_map_with_path(draw, tree)


def _flat(tree):
    return {".".join(str(p.key) for p in path): np.asarray(a)
            for path, a in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _pair(jmodule, tmodule, inputs, seed, edit=None, **apply_kw):
    variables = jmodule.init(jax.random.PRNGKey(0), *[jnp.asarray(a) for a in inputs],
                             **apply_kw)
    variables = _numpy_variables(variables, seed)
    if edit is not None:
        edit(variables)
    load_jax_variables(tmodule, variables)
    return variables


def _grads_match(jmodule, tmodule, variables, inputs, cot, frozen=(), **apply_kw):
    """Output and the gradients of sum(out * cot) w.r.t. every parameter and
    the first input, port against flax; ``frozen`` parameters take none."""
    def loss(params, x0):
        out = jmodule.apply({**variables, "params": params}, x0,
                            *[jnp.asarray(a) for a in inputs[1:]], **apply_kw)
        return jnp.sum(out * jnp.asarray(cot)), out

    (_, want), (gp, gx) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        variables["params"], jnp.asarray(inputs[0]))
    x0 = torch.from_numpy(inputs[0]).requires_grad_(True)
    tmodule.zero_grad(set_to_none=True)
    out = tmodule(x0, *[torch.from_numpy(a) for a in inputs[1:]])
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), **TOL)
    (out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(x0.grad.numpy(), np.asarray(gx), **TOL)
    params = dict(tmodule.named_parameters())
    for k, g in _flat(gp).items():
        got = params[k].grad
        if k in frozen:
            assert not np.any(g), k  # JAX stops the gradient
            assert got is None or not got.any(), k
        else:
            np.testing.assert_allclose(got.numpy(), g, err_msg=k, **TOL)
    return out.detach().numpy()


# ----------------------------------------------------------------------
# initializers
# ----------------------------------------------------------------------
def test_xavier_and_range_initializers_follow_the_jax_package():
    """Fans are shape[-2] and shape[-1] alone; the draws are held by their
    statistics against the JAX package's (the RNGs differ)."""
    gen, key = make_generator(0), jax.random.PRNGKey(0)
    shape = (3, 4, 64, 96)  # fans 64 and 96, not flax's receptive field
    for t_init, j_init in ((TI.xavier_normal_init(), JI.xavier_normal_init()),
                           (TI.xavier_uniform_init(), JI.xavier_uniform_init())):
        a, b = t_init(gen, shape).numpy(), np.asarray(j_init(key, shape))
        assert abs(a.std() / b.std() - 1) < 0.02 and abs(a.mean()) < 4 * a.std() / np.sqrt(a.size)
        assert abs(a.std() - np.sqrt(2.0 / 160)) < 0.02 * np.sqrt(2.0 / 160)
    u = TI.xavier_uniform_init()(gen, (64, 96)).numpy()
    assert np.abs(u).max() <= np.sqrt(6.0 / 160)
    r = TI.uniform_range_init(0.25, 0.75)(gen, (20000,)).numpy()
    assert r.min() >= 0.25 and r.max() < 0.75 and abs(r.mean() - 0.5) < 0.005
    np.testing.assert_array_equal(TI.constant_init(9.0)(gen, (2, 3)).numpy(), np.full((2, 3), 9.0))


# ----------------------------------------------------------------------
# SNRGate
# ----------------------------------------------------------------------
GATE_CASES = [  # elementwise, per_connection_alpha, freeze_trans, freeze_u
    (False, False, False, False), (True, False, False, False), (False, True, False, False),
    (True, True, False, False), (False, False, True, False), (True, False, True, True),
]


@pytest.mark.parametrize("elementwise,per_conn,freeze_trans,freeze_u", GATE_CASES)
def test_snr_gate_matches_flax_with_gradients(elementwise, per_conn, freeze_trans, freeze_u):
    rng = np.random.default_rng(1)
    B, E, T, U = 12, 3, 2, 5
    kw = dict(elementwise=elementwise, freeze_trans_ref_faithful=freeze_trans,
              freeze_u_ref_faithful=freeze_u)
    jm = JL.SNRGate(input_dim=E, output_dim=T, units=U, per_connection_alpha=per_conn, **kw)
    tm = TL.SNRGate(E, T, U, generator=make_generator(0), per_connection_alpha=per_conn, **kw)
    x = rng.normal(0, 1, (B, E, U)).astype(np.float32)
    variables = _pair(jm, tm, (x,), seed=2)
    assert sorted(k for k, _ in tm.named_parameters()) == ["alpha", "trans", "u"]
    u_shape = (T, E, U) if elementwise else (T, E)
    assert tm.u.shape == u_shape and tm.alpha.shape == (u_shape if per_conn else (1,))
    cot = rng.normal(0, 1, (B, T, U)).astype(np.float32)
    frozen = {k for k, on in (("trans", freeze_trans), ("u", freeze_u)) if on}
    out = _grads_match(jm, tm, variables, (x,), cot, frozen=frozen)
    z = tm.gates(tm.u).detach().numpy()
    assert 0 < z.mean() < 1 and out.std() > 0.1  # neither all open nor all shut
    for k in frozen:
        assert dict(tm.named_parameters())[k].grad is None


@pytest.mark.parametrize("elementwise", [False, True])
def test_snr_gate_fully_open_and_shut(elementwise):
    """``alpha >= 8.7`` opens every gate at the midpoint u = 0.5 (z = 1: the
    transforms alone, no gradient into alpha or u); a tiny alpha shuts
    every gate of u in (0.05, 0.95) (z = 0: zeros).  Both sides agree on
    output and gradients."""
    rng = np.random.default_rng(3)
    B, E, T, U = 8, 2, 3, 4
    x = rng.normal(0, 1, (B, E, U)).astype(np.float32)
    cot = rng.normal(0, 1, (B, T, U)).astype(np.float32)
    for alpha, want_z in ((9.0, 1.0), (1e-3, 0.0)):
        jm = JL.SNRGate(input_dim=E, output_dim=T, units=U, elementwise=elementwise,
                        open_init_alpha=alpha)
        tm = TL.SNRGate(E, T, U, generator=make_generator(0), elementwise=elementwise,
                        open_init_alpha=alpha)
        init = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
        np.testing.assert_array_equal(tm.alpha.detach().numpy(), init["params"]["alpha"])
        def edit(v, alpha=alpha):
            v["params"]["alpha"] = np.full((1,), alpha, np.float32)
            if alpha > 1:
                v["params"]["u"] = np.full(v["params"]["u"].shape, 0.5, np.float32)

        variables = _pair(jm, tm, (x,), seed=4, edit=edit)
        out = _grads_match(jm, tm, variables, (x,), cot)
        np.testing.assert_array_equal(tm.gates(tm.u).detach().numpy(), want_z)
        assert not tm.alpha.grad.any()
        if want_z == 0.0:
            assert not out.any()
        else:
            trans = tm.trans.detach().numpy()
            np.testing.assert_allclose(out, np.einsum("bju,ijuv->biv", x, trans), **TOL)


def test_snr_gate_stochastic_u_and_its_warmup():
    """``stochastic``: eval and warmup use the midpoint u = 0.5 (equal to
    the JAX gate); training draws u from U(1e-8, 1 - 2^-20) with the
    trainer's generator, a new draw each call, held by range and mean (the
    RNGs differ); without a generator training raises."""
    rng = np.random.default_rng(5)
    B, E, T, U = 6, 4, 4, 3
    x = rng.normal(0, 1, (B, E, U)).astype(np.float32)
    jm = JL.SNRGate(input_dim=E, output_dim=T, units=U, elementwise=True, stochastic=True,
                    per_connection_alpha=True)
    tm = TL.SNRGate(E, T, U, generator=make_generator(0), elementwise=True, stochastic=True,
                    per_connection_alpha=True)
    variables = _pair(jm, tm, (x,), seed=6)
    assert sorted(k for k, _ in tm.named_parameters()) == ["alpha", "trans"]
    want = jm.apply(variables, jnp.asarray(x), train=False)
    np.testing.assert_allclose(tm.eval()(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(want), **TOL)
    with JL.gate_noise_off(True):
        want_warm = jm.apply(variables, jnp.asarray(x), train=True, rngs={"dropout": jax.random.PRNGKey(1)})
    tm.train()
    tm.noise_off = True
    np.testing.assert_allclose(tm(torch.from_numpy(x)).detach().numpy(), np.asarray(want_warm), **TOL)
    tm.noise_off = False
    with pytest.raises(RuntimeError, match="generator"):
        tm(torch.from_numpy(x))
    tm.dropout_generator = torch.Generator().manual_seed(0)
    draws = torch.stack([tm.gate_u("cpu") for _ in range(200)]).numpy()
    assert draws.shape == (200, T, E, U)
    assert draws.min() >= 1e-8 and draws.max() <= 1 - 2.0 ** -20
    assert abs(draws.mean() - 0.5) < 0.01 and abs(draws.std() - np.sqrt(1 / 12)) < 0.01
    a, b = tm(torch.from_numpy(x)), tm(torch.from_numpy(x))
    assert not torch.equal(a, b) and torch.isfinite(a).all()


def test_snr_gate_gradients_stay_finite_when_u_leaves_the_unit_interval():
    """As tests/test_layers.py holds the JAX gate: a trained u past 1 or
    below 0 sits on a clip bound, where only finiteness is held."""
    rng = np.random.default_rng(7)
    tm = TL.SNRGate(2, 2, 4, generator=make_generator(0), elementwise=True)
    with torch.no_grad():
        tm.u.view(-1)[0], tm.u.view(-1)[1] = 1.0001, -0.0001
    x = torch.from_numpy(rng.normal(size=(3, 2, 4)).astype(np.float32))
    loss = (tm(x) ** 2).sum()
    loss.backward()
    assert torch.isfinite(loss)
    for p in tm.parameters():
        assert torch.isfinite(p.grad).all()


# ----------------------------------------------------------------------
# SharedSpecificDense, DomainBatchNorm
# ----------------------------------------------------------------------
@pytest.mark.parametrize("rank,use_shared,use_bias,freeze", [
    (2, True, True, False), (3, True, True, False), (3, False, True, False),
    (2, True, False, False), (3, True, True, True),
])
def test_shared_specific_dense_matches_flax(rank, use_shared, use_bias, freeze):
    rng = np.random.default_rng(8)
    B, D, d_in, out = 10, 3, 6, 4
    kw = dict(use_shared=use_shared, use_bias=use_bias, freeze_ref_faithful=freeze)
    jm = JL.SharedSpecificDense(num_domains=D, features=out, **kw)
    tm = TL.SharedSpecificDense(D, d_in, out, generator=make_generator(0), **kw)
    x = rng.normal(0, 1, (B, d_in) if rank == 2 else (B, D, d_in)).astype(np.float32)
    variables = _pair(jm, tm, (x,), seed=9)
    assert sorted(k for k, _ in tm.named_parameters()) == sorted(_flat(variables["params"]))
    cot = rng.normal(0, 1, (B, D, out)).astype(np.float32)
    _grads_match(jm, tm, variables, (x,), cot)
    if freeze:  # domains 0..D-2 of the specific tensors take no gradient
        assert not tm.specific_kernel.grad[: D - 1].any() and tm.specific_kernel.grad[D - 1].any()
        assert not tm.specific_bias.grad[: D - 1].any()


def _domain_batches(rng, B, D, F, calls, absent=None):
    out = []
    for _ in range(calls):
        dom = rng.integers(0, D, B)
        if absent is not None:
            dom[dom == absent] = (absent + 1) % D
        out.append((rng.normal(0.5, 1.5, (B, F)).astype(np.float32),
                    np.eye(D, dtype=np.float32)[dom]))
    return out


@pytest.mark.parametrize("mode", ["reference", "intended"])
def test_domain_batch_norm_train_and_eval_match_flax(mode):
    """Four training calls in a row, the second with domain 1 absent (its
    statistics stay), then eval on the population statistics; the gradient
    of the training forward through the batch statistics."""
    rng = np.random.default_rng(10)
    B, D, F = 24, 3, 5
    batches = _domain_batches(rng, B, D, F, 4)
    batches[1] = _domain_batches(rng, B, D, F, 1, absent=1)[0]
    jm = JDomainBatchNorm(num_features=F, num_domains=D, mode=mode)
    tm = DomainBatchNorm(F, D, mode=mode)
    variables = _pair(jm, tm, batches[0], seed=11, train=False)
    assert set(_flat(variables["batch_stats"])) == {"pop_mean", "pop_var"}
    tm.train()
    for i, (x, mask) in enumerate(batches):
        before = tm.pop_mean.clone()
        want, mutated = jm.apply(variables, jnp.asarray(x), jnp.asarray(mask), train=True,
                                 mutable=["batch_stats"])
        variables = {**variables, "batch_stats": mutated["batch_stats"]}
        got = tm(torch.from_numpy(x), torch.from_numpy(mask))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
        for k, v in _flat(variables["batch_stats"]).items():
            np.testing.assert_allclose(getattr(tm, k).numpy(), v, rtol=0, atol=1e-6, err_msg=k)
        if i == 1:
            np.testing.assert_array_equal(tm.pop_mean[1].numpy(), before[1].numpy())
    x, mask = batches[-1]
    cot = rng.normal(0, 1, (B, F)).astype(np.float32)
    # eval: the population statistics, left alone
    tm.eval()
    want = jm.apply(variables, jnp.asarray(x), jnp.asarray(mask), train=False)
    np.testing.assert_allclose(tm(torch.from_numpy(x), torch.from_numpy(mask)).detach().numpy(),
                               np.asarray(want), **TOL)
    # the training forward's gradient, through the batch statistics
    tm.train()
    stats = {k: v.clone() for k, v in tm.named_buffers()}

    def loss(params, x0):
        out, _ = jm.apply({**variables, "params": params}, x0, jnp.asarray(mask), train=True,
                          mutable=["batch_stats"])
        return jnp.sum(out * jnp.asarray(cot))

    gp, gx = jax.grad(loss, argnums=(0, 1))(variables["params"], jnp.asarray(x))
    x0 = torch.from_numpy(x).requires_grad_(True)
    (tm(x0, torch.from_numpy(mask)) * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(x0.grad.numpy(), np.asarray(gx), rtol=1e-4, atol=1e-6)
    for k, g in _flat(gp).items():
        np.testing.assert_allclose(getattr(tm, k).grad.numpy(), g, err_msg=k, **TOL)
    assert not torch.equal(stats["pop_mean"], tm.pop_mean)  # a training call moves them


def test_domain_batch_norm_without_a_mask_is_a_plain_batch_norm():
    rng = np.random.default_rng(12)
    x = rng.normal(1.0, 2.0, (16, 4)).astype(np.float32)
    jm, tm = JDomainBatchNorm(num_features=4, num_domains=2), DomainBatchNorm(4, 2)
    mask = np.eye(2, dtype=np.float32)[np.arange(16) % 2]
    variables = _pair(jm, tm, (x, mask), seed=13, train=False)
    want = jm.apply(variables, jnp.asarray(x), None, train=True, mutable=["batch_stats"])[0]
    np.testing.assert_allclose(tm.train()(torch.from_numpy(x), None).detach().numpy(),
                               np.asarray(want), **TOL)
    with pytest.raises(ValueError, match="reference|intended"):
        DomainBatchNorm(4, 2, mode="other")


# ----------------------------------------------------------------------
# GateNN, APGLayer
# ----------------------------------------------------------------------
@pytest.mark.parametrize("batch_norm", [False, True])
def test_gate_nn_matches_flax(batch_norm):
    rng = np.random.default_rng(14)
    x = rng.normal(0, 1, (20, 7)).astype(np.float32)
    jm = JL.GateNN(output_dim=5, hidden_dim=9, batch_norm=batch_norm)
    tm = TL.GateNN(7, 5, 9, generator=make_generator(0), batch_norm=batch_norm)
    variables = _pair(jm, tm, (x,), seed=15, train=False)
    assert sorted(k for k, _ in tm.named_parameters()) == sorted(_flat(variables["params"]))
    tm.eval()
    cot = rng.normal(0, 1, (20, 5)).astype(np.float32)
    out = _grads_match(jm, tm, variables, (x,), cot, train=False)
    assert out.min() > 0 and out.max() < 2
    if batch_norm:  # training mode: batch statistics, running ones moved
        want, mutated = jm.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
        got = tm.train()(torch.from_numpy(x))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
        for k, v in _flat(mutated["batch_stats"]).items():
            np.testing.assert_allclose(dict(tm.named_buffers())[k].numpy(), v, atol=1e-6, rtol=0)
    gate = TL.GateNN(7, 5, generator=make_generator(0))  # hidden defaults to the output width
    assert tuple(gate.dense_0.kernel.shape) == (7, 5)


@pytest.mark.parametrize("uv_shared,mf_p", [(True, False), (True, True), (False, False)])
def test_apg_layer_matches_flax(uv_shared, mf_p):
    rng = np.random.default_rng(16)
    B, n, m, emb = 10, 12, 9, 4
    kw = dict(use_uv_shared=uv_shared, use_mf_p=mf_p, mf_k=4, mf_p=2)
    jm = JAPGLayer(input_dim=n, output_dim=m, scene_emb_dim=emb, **kw)
    tm = APGLayer(n, m, emb, generator=make_generator(0), **kw)
    x = rng.normal(0, 1, (B, n)).astype(np.float32)
    scene = rng.normal(0, 1, (B, emb)).astype(np.float32)
    variables = _pair(jm, tm, (x, scene), seed=17)
    assert sorted(k for k, _ in tm.named_parameters()) == sorted(_flat(variables["params"]))
    cot = rng.normal(0, 1, (B, m)).astype(np.float32)
    out = _grads_match(jm, tm, variables, (x, scene), cot)
    assert (out >= 0).all() and out.std() > 0.05  # relu, not all dead


def test_apg_layer_init_follows_the_jax_package():
    """The generators' kernels normal(init_std), the shared matrices
    Xavier-uniform, their biases zero: held by statistics."""
    tm = APGLayer(256, 128, 8, generator=make_generator(0), use_uv_shared=True, use_mf_p=False,
                  mf_k=4)
    jv = JAPGLayer(input_dim=256, output_dim=128, scene_emb_dim=8, use_mf_p=False, mf_k=4).init(
        jax.random.PRNGKey(0), jnp.zeros((2, 256)), jnp.zeros((2, 8)))["params"]
    for k, a in _flat(jv).items():
        b = dict(tm.named_parameters())[k].detach().numpy()
        assert a.shape == b.shape, k
        if a.std() == 0:
            np.testing.assert_array_equal(a, b, err_msg=k)
        elif a.size >= 256:
            assert abs(b.std() / a.std() - 1) < 6 / np.sqrt(a.size) + 0.05, k


# ----------------------------------------------------------------------
# PReLU, Dice, WideLinear
# ----------------------------------------------------------------------
@pytest.mark.parametrize("activation", ["prelu", "dice"])
@pytest.mark.parametrize("stacked", [False, True])
def test_parameterised_activations_in_the_dnns_match_flax(activation, stacked):
    """PReLU (alpha (1,) in an MLP, (K, 1) in a stack) and Dice (its
    BatchNorm over B inside an MLP, over B and K inside a stack), with
    BatchNorm before them, two training calls and one eval call."""
    rng = np.random.default_rng(18)
    B, K, d_in, hidden = 24, 3, 6, (8, 5)
    kw = dict(activation=activation, use_bn=True)
    if stacked:
        jm, tm = (JL.StackedMLP(stack=K, hidden_units=hidden, **kw),
                  TL.StackedMLP(K, d_in, hidden, generator=make_generator(0), **kw))
    else:
        jm, tm = JL.MLP(hidden_units=hidden, **kw), TL.MLP(d_in, hidden,
                                                           generator=make_generator(0), **kw)
    batches = [rng.normal(0.2, 1.3, (B, d_in)).astype(np.float32) for _ in range(3)]
    variables = _pair(jm, tm, (batches[0],), seed=19, train=False)
    names = sorted(k for k, _ in tm.named_parameters())
    assert names == sorted(_flat(variables["params"]))
    if activation == "prelu":
        assert tuple(tm.prelu_0.alpha.shape) == ((K, 1) if stacked else (1,))
        assert TL.MLP(d_in, hidden, generator=make_generator(0), **kw).prelu_1.alpha.item() == 0.25
    else:
        assert {"dice_0.BatchNorm_0.mean", "dice_1.BatchNorm_0.var"} <= set(
            _flat(variables["batch_stats"]))
        assert not TL.MLP(d_in, hidden, generator=make_generator(0), **kw).dice_0.alpha.any()
    tm.train()
    for x in batches[:2]:
        want, mutated = jm.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
        variables = {**variables, "batch_stats": mutated["batch_stats"]}
        np.testing.assert_allclose(tm(torch.from_numpy(x)).detach().numpy(), np.asarray(want), **TOL)
    buffers = dict(tm.named_buffers())
    for k, v in _flat(variables["batch_stats"]).items():
        np.testing.assert_allclose(buffers[k].numpy(), v, rtol=0, atol=1e-6, err_msg=k)
    tm.eval()
    cot = rng.normal(0, 1, (B, K, hidden[-1]) if stacked else (B, hidden[-1])).astype(np.float32)
    _grads_match(jm, tm, variables, (batches[2],), cot, train=False)


@pytest.mark.parametrize("shape", [(20, 6), (20, 3, 6)])
def test_dice_alone_matches_flax(shape):
    rng = np.random.default_rng(20)
    x = rng.normal(0.3, 1.2, shape).astype(np.float32)
    jm, tm = JL.Dice(), TL.Dice(shape[-1], batch_axes=len(shape) - 1)
    variables = _pair(jm, tm, (x,), seed=21, train=False)
    assert set(_flat(variables["batch_stats"])) == {"BatchNorm_0.mean", "BatchNorm_0.var"}
    assert tm.BatchNorm_0.mean.shape == (shape[-1],) and tm.BatchNorm_0.scale is None
    want, mutated = jm.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    np.testing.assert_allclose(tm.train()(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(want), **TOL)
    for k, v in _flat(mutated["batch_stats"]).items():
        np.testing.assert_allclose(dict(tm.named_buffers())[k].numpy(), v, rtol=0, atol=1e-6)
    cot = rng.normal(0, 1, shape).astype(np.float32)
    _grads_match(jm, tm.eval(), {**variables, "batch_stats": mutated["batch_stats"]}, (x,), cot,
                 train=False)


def test_prelu_alone_matches_flax():
    rng = np.random.default_rng(22)
    x = rng.normal(0, 1, (12, 4, 5)).astype(np.float32)
    jm, tm = JL._PReLU(param_shape=(4, 1)), TL.PReLU((4, 1))
    variables = _pair(jm, tm, (x,), seed=23)
    _grads_match(jm, tm, variables, (x,), rng.normal(0, 1, x.shape).astype(np.float32))


def test_wide_linear_with_shared_tables_matches_flax():
    """Three slots, the first and the third sharing a table, read from
    columns 0, 2 and 3 of the packed ids; the dense block's first columns."""
    from mmlrec_tpu_torch.features import DenseFeat, FeatureLayout, SparseFeat
    from mmlrec_tpu_torch.models.base import RecModel
    from mmlrec_tpu_torch.synthetic import make_config

    rng = np.random.default_rng(24)
    vocabs, B = (7, 5), 16
    ids = np.stack([rng.integers(0, 7, B), rng.integers(0, 9, B), rng.integers(0, 5, B),
                    rng.integers(0, 7, B)], axis=1).astype(np.int32)
    dense = rng.normal(0, 1, (B, 4)).astype(np.float32)
    kw = dict(vocab_sizes=vocabs, n_dense=3, slot_tables=(0, 1, 0), slot_cols=(0, 2, 3))
    jm = JL.WideLinear(**kw)
    tm = TL.WideLinear(vocabs, 3, generator=make_generator(0), slot_tables=(0, 1, 0),
                       slot_cols=(0, 2, 3))
    variables = _pair(jm, tm, (ids, dense), seed=25)
    assert tuple(tm.table.shape) == (12, 1) and tuple(tm.kernel.shape) == (3, 1)
    cot = rng.normal(0, 1, (B, 1)).astype(np.float32)

    want = jm.apply(variables, jnp.asarray(ids), jnp.asarray(dense))
    got = tm(torch.from_numpy(ids), torch.from_numpy(dense))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    gp = jax.grad(lambda p: jnp.sum(jm.apply({"params": p}, jnp.asarray(ids), jnp.asarray(dense))
                                    * jnp.asarray(cot)))(variables["params"])
    (got * torch.from_numpy(cot)).sum().backward()
    for k, g in _flat(gp).items():
        np.testing.assert_allclose(getattr(tm, k).grad.numpy(), g, err_msg=k, **TOL)
    # the model's wide term dedupes by embedding_name, as mmlrec_tpu/models/base.py does
    layout = FeatureLayout([SparseFeat("a", 7, 4), SparseFeat("b", 5, 4),
                            SparseFeat("c", 7, 4, embedding_name="a"), DenseFeat("d", 2)])
    model = RecModel(layout, make_config(use_wide_linear=True), generator=make_generator(0))
    assert tuple(model.wide_linear.table.shape) == (12, 1)
    assert model.wide_linear.slot_offsets.tolist() == [0, 7, 0]
    assert model.wide_linear.slot_cols.tolist() == [0, 1, 2]
