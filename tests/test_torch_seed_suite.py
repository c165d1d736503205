"""The port's seed suite (``mmlrec_tpu_torch.train.multi_seed``) on the CPU:
every case of tests/test_multi_seed.py against the port's own solo
``Trainer``, the stacked suite against the JAX ``SeedSuiteTrainer``, the
sequential-shared mode bitwise against solo fits, and the folded ``vmap``
rules of the forward kernels against separate calls.

Sizes are the JAX tests' (emb 4, 4 sparse, 2 dense, hidden (16, 8), 320
rows, batch 64, 128 validation rows), dropout 0 where JAX is compared.

Initial weights.  The stacked step's products and reductions run batched
(``bmm`` for ``mm``), and its kernel backwards are the hand-written plain
ones where the solo CPU step differentiates the plain forward: a member
agrees with its solo run to f32 rounding, not bitwise.  From the
reference-faithful init (std 1e-4) the predictions are nearly constant:
Adam turns the sign of near-zero gradients into lr-sized steps and near-tie
rows reorder the AUC, so rounding alone moved seed 2's predictions by
3.3e-3 after 3 epochs.  The stacked cases therefore start every member and
its solo twin from numpy weights of std 0.3, as tests/test_torch_dense_fit.py
does; the sequential-shared cases keep the model's own init (bitwise).
Against JAX: predictions atol 1e-6, losses rtol 1e-5, and val AUC within
one pair, 1 / (n_pos * n_neg): predictions that agree to 1e-7 can still
split a tie of two opposite-label rows, which moves a 128-row AUC by
0.5 / (n_pos * n_neg) ~ 6e-5.
"""

import jax
import numpy as np
import pytest
import torch
from torch.func import vmap

from _torch_suite_common import SIZES, STD, numpy_init
from mmlrec_tpu import synthetic as jsyn
from mmlrec_tpu.models import get_model as jax_get_model
from mmlrec_tpu.train.multi_seed import SeedSuiteTrainer as JaxSuite
from mmlrec_tpu_torch.convert import load_jax_variables
from mmlrec_tpu_torch.models import get_model
from mmlrec_tpu_torch.ops import kernels as K
from mmlrec_tpu_torch.ops.embedding import _TakeRows
from mmlrec_tpu_torch.synthetic import make_config, make_data
from mmlrec_tpu_torch.train import Trainer
from mmlrec_tpu_torch.train.multi_seed import SeedSuiteTrainer
from mmlrec_tpu_torch.utils.seeding import make_generator



def _setup(model_name="mmoe", task_name="mtl", optimizer="adam", **kw):
    cfg = make_config(task_name=task_name, model_name=model_name, **SIZES, **kw)
    cfg.optim_config.optimizer = optimizer
    layout, x, y, _ = make_data(cfg, n=320, seed=0)
    _, xv, yv, _ = make_data(cfg, n=128, seed=9)
    return cfg, layout, x, y, xv, yv


def _suite(cfg, layout, seeds, init=True):
    suite = SeedSuiteTrainer(get_model(cfg.model_config.model_name, layout, cfg, device="cpu"),
                             seeds=seeds, device="cpu").compile(metrics=["auc"])
    if init and not suite.sequential:
        for s, m in zip(seeds, suite.members):
            numpy_init(m, s)
    return suite


def _solo(cfg, layout, seed, init=True, **fit_kw):
    model = get_model(cfg.model_config.model_name, layout, cfg,
                      generator=make_generator(seed, "cpu"), device="cpu")
    if init:
        numpy_init(model, seed)
    return Trainer(model, seed=seed, device="cpu").compile(metrics=["auc"])


def _same_histories(a, b, auc_abs=1e-9):
    assert len(a) == len(b)
    for ha, hb in zip(a, b):
        assert ha["loss"] == pytest.approx(hb["loss"], rel=1e-5)
        if "val_auc" in hb:
            assert ha["val_auc"] == pytest.approx(hb["val_auc"], abs=auc_abs)


# ----------------------------------------------------------------------
# tests/test_multi_seed.py, against the port's solo Trainer
# ----------------------------------------------------------------------
@pytest.mark.parametrize("model_name,task,seeds,epochs,kw", [
    ("mmoe", "mtl", [0, 2], 3, {}),  # test_suite_matches_solo_trainers_exactly
    ("sharedbottom", "msl", [0, 4], 2, {}),  # test_suite_msl_regime
    ("mmoe", "mtl", [0, 2], 2, {"dnn_dropout": 0.2}),  # each member's own masks
    # stacked BatchNorm statistics, under SGD: a bias that feeds a BatchNorm
    # has a zero gradient in exact arithmetic, which Adam would scale up
    ("sharedbottom", "mtl", [1, 3], 2, {"dnn_use_bn": True, "optimizer": "sgd"}),
    ("ple", "msl", [0, 2], 2, {}),  # B5 twice a level
    ("snr_trans", "msl", [0, 2], 2, {"snr_stochastic_gates": True,
                                     "snr_gate_noise_warmup_epochs": 1}),
    ("escm", "mtl", [0, 2], 2, {}),  # [pCTR, pCTCVR] columns
])
def test_stacked_suite_matches_solo_trainers(model_name, task, seeds, epochs, kw):
    cfg, layout, x, y, xv, yv = _setup(model_name, task, **kw)
    if model_name == "escm":
        y = np.stack([y[:, 0], y[:, 0] * y[:, 1]], 1)
        yv = np.stack([yv[:, 0], yv[:, 0] * yv[:, 1]], 1)
    suite = _suite(cfg, layout, seeds)
    assert not suite.sequential
    suite.fit(x, y, batch_size=64, epochs=epochs, validation_data=(xv, yv), verbose=0)
    preds = suite.predict(xv, batch_size=64)
    assert preds.shape == (len(seeds), 128, 2) and np.isfinite(preds).all()
    for si, seed in enumerate(seeds):
        solo = _solo(cfg, layout, seed)
        solo.fit(x, y, batch_size=64, epochs=epochs, validation_data=(xv, yv), verbose=0)
        np.testing.assert_allclose(preds[si], solo.predict(xv, 64), rtol=0, atol=1e-6,
                                   err_msg=f"seed {seed} diverges from solo run")
        _same_histories(suite.histories[si], solo.history)
        if kw.get("dnn_use_bn"):
            for k, v in solo.model.state_dict().items():
                if k.endswith((".mean", ".var")):
                    np.testing.assert_allclose(suite.variables[k][si].numpy(), v.numpy(),
                                               atol=1e-6, err_msg=k)


def test_suite_early_stopping_per_seed():
    cfg, layout, x, y, xv, yv = _setup()
    cfg.optim_config.early_stop = 1
    suite = _suite(cfg, layout, [0, 2])
    suite.fit(x, y, batch_size=64, epochs=8, validation_data=(xv, yv), verbose=0)
    lengths = []
    for si, seed in enumerate([0, 2]):
        solo = _solo(cfg, layout, seed)
        solo.fit(x, y, batch_size=64, epochs=8, validation_data=(xv, yv), verbose=0)
        assert len(suite.histories[si]) == len(solo.history), seed
        lengths.append(len(solo.history))
        # the member's best snapshot is its own best epoch's
        np.testing.assert_allclose(suite.predict(xv, 64)[si], solo.predict(xv, 64), atol=1e-6)
    assert min(lengths) < 8  # a member stopped early


@pytest.mark.parametrize("extra", [
    {},  # test_suite_two_phase_sequential_matches_solo (split container, scatter update)
    {"table_update": "pallas", "table_opt_dtype": "bfloat16", "device_metadata": True,
     "table_container": "stacked", "vocab": 400},  # the stacked container
])
def test_suite_two_phase_sequential_matches_solo_bitwise(extra):
    """Two-phase configs run sequential-shared: each member is bitwise a
    solo fit of its seed from the model ``get_model`` draws for it."""
    seeds = [0, 2]
    cfg, layout, x, y, xv, yv = _setup(two_phase_embedding=True, **extra)
    suite = _suite(cfg, layout, seeds)
    assert suite.sequential and suite.members == []
    suite.fit(x, y, batch_size=64, epochs=3, validation_data=(xv, yv), verbose=0)
    preds = suite.predict(xv, batch_size=64)
    rows = suite.masked_test_metrics_device(xv, yv, None, 64)
    assert preds.shape == (2, 128, 2) and len(suite.capture_s) == 2
    for si, seed in enumerate(seeds):
        solo = _solo(cfg, layout, seed, init=False)
        solo.fit(x, y, batch_size=64, epochs=3, validation_data=(xv, yv), verbose=0)
        assert np.array_equal(preds[si], solo.predict(xv, 64)), seed
        assert [h["loss"] for h in suite.histories[si]] == [h["loss"] for h in solo.history]
        assert rows[si] == solo.masked_test_metrics_device(xv, yv, None, 64)


def test_suite_two_phase_pallas_sequential():
    """test_multi_seed.py's pallas case: the write-kernel update with packed
    bf16 moments stays finite and per-seed shaped."""
    cfg, layout, x, y, xv, yv = _setup(two_phase_embedding=True, table_update="pallas",
                                       table_opt_dtype="bfloat16")
    suite = _suite(cfg, layout, [0, 4])
    suite.fit(x, y, batch_size=64, epochs=1, validation_data=(xv, yv), verbose=0)
    preds = suite.predict(xv, batch_size=64)
    assert preds.shape == (2, 128, 2) and np.isfinite(preds).all()


def test_reset_for_seed_draws_the_cli_model():
    """``reset_for_seed(s)`` loads the weights ``get_model`` draws from the
    generator the CLI makes for seed s on the trainer's device."""
    cfg, layout, *_ = _setup()
    tr = Trainer(get_model("mmoe", layout, cfg, device="cpu"), device="cpu")
    tr.reset_for_seed(7)
    want = get_model("mmoe", layout, cfg, generator=make_generator(7, "cpu"), device="cpu")
    for k, v in want.state_dict().items():
        assert torch.equal(tr.model.state_dict()[k], v), k


@pytest.mark.parametrize("model_name,task,kw", [
    ("pcg", "msl", {}), ("mmoe", "msl", {"use_gradnorm": True}),
    ("mmoe", "msl", {"use_cagrad": True}), ("mmoe", "msl", {"use_cka_loss": True}),
])
def test_stacked_per_task_methods_match_solo(model_name, task, kw):
    """PCGrad, GradNorm (its [S, T] state), CAGrad and the CKA term under
    the stack, each member against its solo fit."""
    cfg, layout, x, y, xv, yv = _setup(model_name, task, **kw)
    suite = _suite(cfg, layout, [0, 2])
    suite.fit(x, y, batch_size=64, epochs=2, validation_data=(xv, yv), verbose=0)
    preds = suite.predict(xv, 64)
    for si, seed in enumerate([0, 2]):
        solo = _solo(cfg, layout, seed)
        solo.fit(x, y, batch_size=64, epochs=2, validation_data=(xv, yv), verbose=0)
        np.testing.assert_allclose(preds[si], solo.predict(xv, 64), atol=1e-6)
        _same_histories(suite.histories[si], solo.history)
        if kw.get("use_gradnorm"):
            for k, v in solo.gn_state.items():
                np.testing.assert_allclose(suite.gn_state[k][si].numpy(), v.numpy(), atol=1e-6)


# ----------------------------------------------------------------------
# the stacked suite against the JAX suite
# ----------------------------------------------------------------------
def test_stacked_suite_matches_jax_suite():
    """Each member's init is the JAX trainer's ``_init_variables`` tree of
    its seed, its leaves redrawn from numpy (module docstring), carried over
    by ``convert.load_jax_variables``."""
    seeds = [0, 2]
    kw = dict(task_name="msl", model_name="mmoe", **SIZES)
    jcfg = jsyn.make_config(**kw)
    layout, x, y, _ = jsyn.make_data(jcfg, n=320, seed=0)
    _, xv, yv, _ = jsyn.make_data(jcfg, n=128, seed=9)
    jsuite = JaxSuite(jax_get_model("mmoe", layout, jcfg), seeds=seeds).compile(metrics=["auc"])
    ids, dense = jsuite.tr.pack_inputs(x)
    inits = []
    for seed, jtr in zip(seeds, jsuite.trainers):
        rng = np.random.default_rng(seed + 100)
        tree = jax.tree_util.tree_map(
            lambda a: rng.normal(0, STD, a.shape).astype(np.float32),
            jax.tree_util.tree_map(np.asarray, jtr._init_variables(ids[:2], dense[:2])))
        inits.append(tree)
        jtr._init_variables = lambda i, d, t=tree: jax.tree_util.tree_map(jax.numpy.asarray, t)
    jsuite.fit(x, y, batch_size=64, epochs=3, validation_data=(xv, yv), verbose=0)
    jpreds = jsuite.predict(xv, batch_size=64)

    cfg = make_config(**kw)
    suite = _suite(cfg, make_data(cfg, n=8, seed=0)[0], seeds, init=False)
    for m, tree in zip(suite.members, inits):
        load_jax_variables(m, tree)
    suite.fit(x, y, batch_size=64, epochs=3, validation_data=(xv, yv), verbose=0)
    preds = suite.predict(xv, batch_size=64)
    np.testing.assert_allclose(preds, jpreds, rtol=0, atol=1e-6)
    pos = np.asarray(yv).reshape(len(yv), -1)[:, 0].sum()
    one_pair = 1.0 / (pos * (len(yv) - pos))
    for si in range(2):
        _same_histories(suite.histories[si], jsuite.histories[si], auc_abs=one_pair)


# ----------------------------------------------------------------------
# the kernels' folded vmap rules against S separate calls
# ----------------------------------------------------------------------
def _count(monkeypatch, name):
    calls = []
    fn = getattr(K, name)
    monkeypatch.setattr(K, name, lambda *a: calls.append(1) or fn(*a))
    return calls


def _grads_of(fn, inputs, cot):
    out = fn(*inputs)
    return out, torch.autograd.grad((out * cot).sum(), [t for t in inputs if t.requires_grad])


@pytest.mark.parametrize("packed,matmul", [(False, False), (False, True), (True, False)])
def test_embed_concat_fold_bitwise(packed, matmul, monkeypatch):
    S, B, F, D, Nd = 3, 10, 4, 4, 5
    g = torch.Generator().manual_seed(0)
    V = 32 * F if packed else 7 * F
    table = torch.randn(S, V * D // 128, 128, generator=g) if packed else torch.randn(S, V, D,
                                                                                       generator=g)
    table.requires_grad_(True)
    dense = torch.randn(S, B, Nd, generator=g, requires_grad=True)
    ids = torch.randint(-3, V + 3, (S, B, F), generator=g, dtype=torch.int32)
    vocab = (V // F,) * F
    offsets = torch.arange(F, dtype=torch.int32) * (V // F)
    mg = (vocab, offsets) if matmul else None
    if matmul:
        ids = (torch.randint(0, V // F, (S, B, F), generator=g, dtype=torch.int32) + offsets)

    def call(t, i, d):
        return K.embed_concat(t.view(-1, D), i, d, matmul_grad=mg)

    cot = torch.randn(S, B, F * D + Nd, generator=g)
    calls = _count(monkeypatch, "embed_concat_plain")
    out, grads = _grads_of(vmap(call), (table, ids, dense), cot)
    assert len(calls) == 1  # one call for the stack
    for s in range(S):
        t_s = table[s].detach().requires_grad_(True)
        d_s = dense[s].detach().requires_grad_(True)
        ref, ref_grads = _grads_of(call, (t_s, ids[s], d_s), cot[s])
        torch.testing.assert_close(out[s], ref, rtol=0, atol=0, equal_nan=True)
        for got, want in zip(grads, ref_grads):
            assert torch.equal(got[s], want)


def test_gated_expert_mix_fold(monkeypatch):
    S, B, T, E, H = 3, 6, 2, 4, 8
    g = torch.Generator().manual_seed(1)
    logits = torch.randn(S, B, T, E, generator=g, requires_grad=True)
    experts = torch.randn(S, B, E, H, generator=g, requires_grad=True)
    cot = torch.randn(S, B, T, H, generator=g)
    calls = _count(monkeypatch, "gated_expert_mix_plain")
    out, grads = _grads_of(vmap(K.gated_expert_mix), (logits, experts), cot)
    assert len(calls) == 1
    for s in range(S):
        ref, ref_grads = _grads_of(K.gated_expert_mix_plain,
                                   (logits[s].detach().requires_grad_(True),
                                    experts[s].detach().requires_grad_(True)), cot[s])
        torch.testing.assert_close(out[s], ref, rtol=0, atol=1e-6)
        for got, want in zip(grads, ref_grads):
            torch.testing.assert_close(got[s], want, rtol=0, atol=1e-6)


def test_multihead_score_fold(monkeypatch):
    S, B, T, H = 3, 6, 3, 8
    g = torch.Generator().manual_seed(2)
    tower = torch.randn(S, B, T, H, generator=g, requires_grad=True)
    weights = torch.randn(S, T, H, generator=g, requires_grad=True)
    bias = torch.randn(S, T, generator=g, requires_grad=True)
    binary = torch.tensor([1.0, 0.0, 1.0])  # shared by the stack: a regression head
    cot = torch.randn(S, B, T, generator=g)
    calls = _count(monkeypatch, "multihead_score_plain")
    out, grads = _grads_of(vmap(K.multihead_score, in_dims=(0, 0, 0, None)),
                           (tower, weights, bias, binary), cot)
    assert len(calls) == 1
    for s in range(S):
        ref, ref_grads = _grads_of(
            K.multihead_score_plain, tuple(t[s].detach().requires_grad_(True)
                                           for t in (tower, weights, bias)) + (binary,), cot[s])
        torch.testing.assert_close(out[s], ref, rtol=0, atol=1e-6)
        for got, want in zip(grads, ref_grads):
            torch.testing.assert_close(got[s], want, rtol=0, atol=1e-6)


def test_take_rows_fold_bitwise():
    """The varlen gather: out-of-range ids give NaN rows and no cotangent,
    [-V, 0) wraps, as in separate calls."""
    S, V, D, B, L = 3, 9, 4, 5, 6
    g = torch.Generator().manual_seed(3)
    table = torch.randn(S, V, D, generator=g, requires_grad=True)
    ids = torch.randint(-V - 2, V + 2, (S, B, L), generator=g, dtype=torch.int32)
    ids[:, :, 0] = 0  # a padding id repeated
    cot = torch.randn(S, B, L, D, generator=g)
    out, (grad,) = _grads_of(vmap(_TakeRows.apply), (table, ids), cot)
    for s in range(S):
        ref, (ref_grad,) = _grads_of(_TakeRows.apply,
                                     (table[s].detach().requires_grad_(True), ids[s]), cot[s])
        torch.testing.assert_close(out[s], ref, rtol=0, atol=0, equal_nan=True)
        assert torch.equal(grad[s], ref_grad)
