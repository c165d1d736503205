"""Checkpoints of the port's Trainer (mmlrec_tpu_torch/train/checkpointing.py)
on the CPU: bitwise round trips of the model checkpoint and of the training
state, a resumed fit equal to the uninterrupted one, the split layout on
disk between the stacked and the split containers, and a JAX trainer's
orbax state carried over through ``convert.load_jax_train_state``.

Tolerance: none within the port (every conversion is a slice or a bit
shift, and a resumed fit replays the same operations); the JAX comparison
at the two-phase fit's tolerance (tests/test_torch_f32_two_phase.py).
"""

import os

import jax
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
from mmlrec_tpu_torch.train import Trainer, checkpointing
from mmlrec_tpu_torch.train.sparse_embedding import SparseAdamState, split_stacked_planes, \
    unpack_monu

BASE = dict(task_name="msl", model_name="mmoe", n_sparse=4, n_dense=2, hidden=(16, 8),
            tower=(8,), gate=(8,), batch_size=64, lr=3e-3, dnn_dropout=0.2)
KINDS = {
    "dense": dict(vocab=400),
    "scatter_f32": dict(vocab=400, two_phase_embedding=True),  # host metadata
    "pallas_f32": dict(vocab=1 << 16, two_phase_embedding=True, table_update="pallas"),
    "stacked_bf16": dict(vocab=1 << 16, two_phase_embedding=True, table_update="pallas",
                         table_opt_dtype="bfloat16", device_metadata=True,
                         table_container="stacked"),
    "split_bf16": dict(vocab=1 << 16, two_phase_embedding=True, table_update="pallas",
                       table_opt_dtype="bfloat16", device_metadata=True),
}


def _trainer(kind, seed=0):
    kw = dict(KINDS[kind])
    vocab = kw.pop("vocab")
    cfg = tsyn.make_config(vocab=vocab, **BASE, **kw)
    layout, x, y, _ = tsyn.make_data(cfg, n=320, seed=0, vocab=vocab)
    _, xv, yv, _ = tsyn.make_data(cfg, n=100, seed=5, vocab=vocab)
    tr = Trainer(get_model("mmoe", layout, cfg, device="cpu"), seed=seed, device="cpu").compile()
    return tr, x, y, (xv, yv)


def _bits(t):
    return t.detach().contiguous().view(torch.int32) if t.dtype == torch.float32 else t.detach()


def _state(tr):
    """Every tensor of the training state, by name."""
    out = {f"model/{k}": v for k, v in tr.model.state_dict().items()}
    for field, value in tr.opt_state._asdict().items():
        if isinstance(value, dict):
            out.update({f"opt/{field}/{k}": v for k, v in value.items()})
        else:
            out[f"opt/{field}"] = value
    if tr.table_opt is not None:
        out.update({f"table_opt/{f}": v for f, v in tr.table_opt._asdict().items()})
    return out


def _assert_state_equal(a, b):
    sa, sb = _state(a), _state(b)
    assert set(sa) == set(sb)
    for k in sa:
        assert torch.equal(_bits(sa[k]), _bits(sb[k])), k


@pytest.mark.parametrize("kind", ["dense", "scatter_f32", "pallas_f32", "stacked_bf16"])
def test_resume_equals_the_uninterrupted_fit(kind, tmp_path):
    full, x, y, val = _trainer(kind)
    full.fit(x, y, batch_size=64, epochs=3, validation_data=val, shuffle=False, verbose=0)
    first, *_ = _trainer(kind)
    first.fit(x, y, batch_size=64, epochs=1, validation_data=val, shuffle=False, verbose=0)
    path = first.save_training_state(str(tmp_path))
    assert path == checkpointing.state_ckpt_dir(first, str(tmp_path))
    assert os.path.basename(path) == "mmoe_msl_seed0_state"
    resumed, *_ = _trainer(kind)
    resumed.fit(x, y, batch_size=64, epochs=3, validation_data=val, shuffle=False, verbose=0,
                resume_from=path)
    assert len(resumed.history) == 2  # epochs 2 and 3
    for h_full, h_res in zip(full.history[1:], resumed.history):
        assert h_full["loss"] == h_res["loss"] and h_full["val_auc"] == h_res["val_auc"]
    _assert_state_equal(full, resumed)
    assert (full.best_variables is None) == (resumed.best_variables is None)
    np.testing.assert_array_equal(resumed.predict(x, 64), full.predict(x, 64))


def test_stacked_to_split_to_stacked_is_bitwise(tmp_path):
    stacked, x, y, _ = _trainer("stacked_bf16")
    stacked.fit(x, y, batch_size=64, epochs=1, verbose=0)
    path = stacked.save_training_state(str(tmp_path / "a"))
    table, monu = split_stacked_planes(stacked.table.detach())
    # on disk: the table plane and the moments as split bf16
    payload = torch.load(os.path.join(path, checkpointing.STATE_FILE), weights_only=True)
    assert torch.equal(payload["params/embeddings.fused.table"], table)
    mu, nu = unpack_monu(monu)
    assert payload["table_opt/mu"].dtype == torch.bfloat16
    assert torch.equal(payload["table_opt/mu"].view(torch.int16), mu.view(torch.int16))
    assert torch.equal(payload["table_opt/nu"].view(torch.int16), nu.view(torch.int16))

    split, *_ = _trainer("split_bf16")
    split.fit(x, y, batch_size=64, epochs=1, verbose=0, resume_from=path)  # epoch 1: no step
    assert torch.equal(_bits(split.table), _bits(table))
    assert torch.equal(_bits(split.table_opt.monu), _bits(monu))
    path2 = split.save_training_state(str(tmp_path / "b"))
    again, *_ = _trainer("stacked_bf16")
    again.fit(x, y, batch_size=64, epochs=1, verbose=0, resume_from=path2)
    _assert_state_equal(stacked, again)
    # f32 moments restore the same state widened exactly
    f32, *_ = _trainer("pallas_f32")
    f32.fit(x, y, batch_size=64, epochs=1, verbose=0, resume_from=path)
    assert isinstance(f32.table_opt, SparseAdamState) and f32.table_opt.mu.dtype == torch.float32
    assert torch.equal(f32.table_opt.mu, mu.float()) and torch.equal(f32.table_opt.nu, nu.float())


@pytest.mark.parametrize("kind", ["scatter_f32", "stacked_bf16"])
def test_checkpoint_save_restore_predicts_bitwise(kind, tmp_path):
    tr, x, y, val = _trainer(kind)
    tr.cfg.save_config.save, tr.cfg.save_config.save_path = True, str(tmp_path)
    tr.fit(x, y, batch_size=64, epochs=2, validation_data=val, verbose=0)
    want = tr.predict(x, 64)
    path = checkpointing.model_ckpt_dir(tr, str(tmp_path))
    assert os.path.basename(path) == "mmoe_msl_seed0"
    saved = torch.load(os.path.join(path, checkpointing.VARIABLES_FILE), weights_only=True)
    assert saved["embeddings.fused.table"].shape[0] == tr.model.embeddings.fused.phys_rows
    fresh, *_ = _trainer(kind, seed=3)
    assert not np.array_equal(fresh.predict(x, 64), want)
    fresh.restore_checkpoint(path)
    np.testing.assert_array_equal(fresh.predict(x, 64), want)


def test_a_failed_save_prints_and_does_not_raise(tmp_path, monkeypatch, capsys):
    tr, x, y, _ = _trainer("scatter_f32")
    tr.cfg.save_config.save, tr.cfg.save_config.save_path = True, str(tmp_path)

    def fail(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(checkpointing, "_save", fail)
    tr.fit(x, y, batch_size=64, epochs=1, verbose=0)
    assert "checkpoint save failed: disk full" in capsys.readouterr().out
    assert len(tr.history) == 1 and not any(tmp_path.iterdir())


def test_checkpoint_loads_on_the_card_by_default(tmp_path, monkeypatch):
    tr, x, y, _ = _trainer("dense")
    path = tr.save_checkpoint(str(tmp_path))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        checkpointing.load_tensors(path, checkpointing.VARIABLES_FILE)
    assert checkpointing.load_tensors(path, checkpointing.VARIABLES_FILE, "cpu")
    with pytest.raises(FileNotFoundError):
        checkpointing.load_tensors(str(tmp_path / "none"), checkpointing.VARIABLES_FILE, "cpu")


def test_history_dump(tmp_path):
    import json

    tr, x, y, val = _trainer("scatter_f32")
    tr.fit(x, y, batch_size=64, epochs=2, validation_data=val, verbose=0)
    out = tmp_path / "logs" / "history.jsonl"
    tr.dump_history(str(out))
    lines = [json.loads(line) for line in out.read_text().splitlines()]
    assert [r["epoch"] for r in lines] == [0, 1] and lines[1]["loss"] == tr.history[1]["loss"]


def _numpy_params(shapes, seed):
    rng = np.random.default_rng(seed)
    std = {"table": 0.3, "bias": 0.1, "kernel": 0.3}
    return jax.tree_util.tree_map_with_path(
        lambda path, a: rng.normal(0, std[path[-1].key], a.shape).astype(np.float32), shapes)


def test_jax_orbax_state_carries_over(tmp_path):
    """A JAX trainer's training state (scatter update, f32 moments), saved
    with orbax and restored on the JAX side, goes into the port through
    convert.load_jax_train_state: the port predicts as the JAX trainer."""
    import jax.numpy as jnp

    kw = dict(BASE, dnn_dropout=0.0, two_phase_embedding=True)
    cfg = jsyn.make_config(vocab=400, **kw)
    layout, x, y, _ = jsyn.make_data(cfg, n=320, seed=0, vocab=400)

    def jax_trainer():
        jtr = JaxTrainer(jax_get_model("mmoe", layout, cfg), seed=0).compile()
        ids, dense = jtr.pack_inputs(x)
        shapes = jax.eval_shape(
            lambda i, d: jtr.model.init(jax.random.PRNGKey(0), i, d, None, train=False),
            jnp.asarray(ids[:2]), jnp.asarray(dense[:2]))["params"]
        jtr.variables = {"params": jax.tree_util.tree_map(jnp.asarray, _numpy_params(shapes, 1))}
        return jtr

    jtr = jax_trainer()
    jtr.fit(x, y, batch_size=64, epochs=1, verbose=0)
    path = jtr.save_training_state(str(tmp_path))
    back = jax_trainer()
    back.fit(x, y, batch_size=64, epochs=1, verbose=0, resume_from=path)  # restore, no step
    st = back._train_state
    assert isinstance(st["table_opt"].mu, jax.Array) and not hasattr(st["table_opt"], "monu")
    params = jax.tree_util.tree_map(np.asarray, st["params"])
    adam = st["opt_state"][0]
    _, unravel = ravel_pytree(JaxTrainer._without_table(params)[0])
    tcfg = tsyn.make_config(vocab=400, **kw)
    tlayout, *_ = tsyn.make_data(tcfg, n=8, seed=0, vocab=400)
    tr = Trainer(get_model("mmoe", tlayout, tcfg, device="cpu"), device="cpu").compile()
    topt = st["table_opt"]
    load_jax_train_state(
        tr, params, {"count": np.asarray(topt.count), "mu": np.asarray(topt.mu),
                     "nu": np.asarray(topt.nu)},
        {"count": np.asarray(adam.count), "mu": unravel(adam.mu), "nu": unravel(adam.nu)})
    assert isinstance(tr.table_opt, SparseAdamState) and int(tr.table_opt.count) == 5
    np.testing.assert_array_equal(tr.table_opt.mu.numpy(), np.asarray(jtr._train_state[
        "table_opt"].mu))
    back.variables = back.best_variables = {"params": st["params"]}
    np.testing.assert_allclose(tr.predict(x, 64), back.predict(x, 64), rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="monu"):  # packed moments would be asked for
        load_jax_train_state(tr, params, {"count": 1, "monu": np.zeros(1)}, {})
