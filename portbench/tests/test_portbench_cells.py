"""Each cell run end to end on the CPU at a small size, with the port's
plain kernels: the reference agrees with the program; with the program
broken underneath, ``correct`` comes out false; the module check; the
trace's reduction; and a cell added as new files alone."""

import json
import os
import shutil
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import run, trace
from portbench.tests.tiny import SCALES, SECONDS

ROOT = Path(__file__).resolve().parents[2]


def run_tiny(workload, seed=2**31 + 5):
    return run.run_cell(workload, seed, SECONDS, False, device="cpu", scale=SCALES[workload])


@pytest.mark.parametrize("workload", sorted(SCALES))
def test_the_reference_agrees_with_the_program(workload):
    r = run_tiny(workload)
    assert r["correct"], r["checks"]
    assert list(r) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert r["attempted"] > 0 and r["failed"] == 0 and "setup_s" in r["metrics"]


def _tensors(obj):
    """Every tensor a trainer's optimizer state holds."""
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, dict):
        return [t for v in obj.values() for t in _tensors(v)] + _tensors(getattr(obj, "flat", None))
    if isinstance(obj, tuple):
        return [t for v in obj for t in _tensors(v)]
    return []


def _state_unchanged(monkeypatch):
    """A step that computes its loss and leaves the state as it found it."""
    from mmlrec_tpu_torch.train.trainer import Trainer

    step = Trainer._step_on_batch

    def frozen(self, *args, **kwargs):
        held = [*self.model.state_dict().values(), *_tensors(self.opt_state),
                *_tensors(self.table_opt)]
        saved = [t.clone() for t in held]
        out = step(self, *args, **kwargs)
        with torch.no_grad():
            for t, s in zip(held, saved):
                t.copy_(s)
        return out

    monkeypatch.setattr(Trainer, "_step_on_batch", frozen)


def _half_batch(monkeypatch):
    """A step that leaves half of its batch out and takes the mean over the
    rest."""
    from mmlrec_tpu_torch.train.trainer import Trainer

    step = Trainer._step_on_batch

    def half(self, ids, dense, y, dmask, weight, meta=None):
        w = weight.clone()
        h = w.shape[0] // 2
        w[h:] = 0.0
        w[:h] *= 2.0
        return step(self, ids, dense, y, dmask, w, meta)

    monkeypatch.setattr(Trainer, "_step_on_batch", half)


def _answer_altered(monkeypatch):
    """Serving that alters one probability of every answer where it is
    produced."""
    from mmlrec_tpu_torch.serving import ServingBundle

    produce = ServingBundle._run

    def altered(self, *args):
        out = produce(self, *args)
        out[0, 0] = out[0, 0] * 0.999 + 0.0005
        return out

    monkeypatch.setattr(ServingBundle, "_run", altered)


@pytest.mark.parametrize("workload,fault", [
    ("recipe40m.zipf", _state_unchanged), ("recipe40m.zipf", _half_batch),
    ("ae.train", _state_unchanged), ("ae.train", _half_batch),
    ("ae.serve", _answer_altered)], ids=lambda v: getattr(v, "__name__", v))
def test_a_broken_program_is_not_correct(workload, fault, monkeypatch):
    fault(monkeypatch)
    r = run_tiny(workload)
    assert not r["correct"]
    over = [k for k, c in r["checks"].items() if c["value"] > c["limit"]]
    assert over, r["checks"]


def test_the_module_check_compares_whole_top_level_names(monkeypatch):
    base = set(run.forbidden_modules())
    monkeypatch.setitem(sys.modules, "mmlrec_tpu_torch_shadow", types.ModuleType("x"))
    assert set(run.forbidden_modules()) == base
    monkeypatch.setitem(sys.modules, "mmlrec_tpu.ops", types.ModuleType("mmlrec_tpu.ops"))
    assert "mmlrec_tpu" in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    assert {"jax", "mmlrec_tpu"} <= set(run.forbidden_modules())


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = ("import sys; from portbench.run import run_cell, forbidden_modules; "
            "from portbench.tests.tiny import SCALES; "
            "run_cell('ae.serve', 3, 0.5, False, device='cpu', scale=SCALES['ae.serve']); "
            "print(forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300, env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_the_trace_reduction():
    ns = 10**9
    device = (["k_a", "k_b", "Memcpy HtoD", "k_a"],
              np.array([0, 2, 3, 9]) * ns // 10, np.array([1, 4, 5, 12]) * ns // 10)
    host = (["aten::to", "aten::zeros"], np.array([1, 5]) * ns // 10, np.array([2, 9]) * ns // 10)
    tr = trace.Trace(device, host, (0, ns))
    assert tr.window_s == 1.0
    assert tr.busy_s() == pytest.approx(0.1 + 0.3 + 0.1)  # [0, .1), [.2, .5), [.9, 1)
    assert tr.kernel_launches() == 3
    assert tr.idle_gaps() == [(ns // 10, 2 * ns // 10), (5 * ns // 10, 9 * ns // 10)]
    gaps = tr.breakdown()["idle_gaps"]
    assert gaps[0] == ["aten::zeros", pytest.approx(0.4)] and gaps[1][0] == "aten::to"
    assert tr.seconds_matching({"k_a": "op"}) == {"op": pytest.approx(0.2)}


def test_a_cell_of_new_files_alone_runs(tmp_path):
    """A configuration, a mix, limits and a cell added as files and entries
    only, in a copy of the benchmark: MMoE at config_AE's widths under a
    smaller, block-shuffled AE mix."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec = json.loads((ROOT / "portbench/configs/ae_sharedbottom.json").read_text())
    spec["experiment"]["model_config"]["model_name"] = "mmoe"
    spec["experiment"]["training_config"]["shuffle_mode"] = "block"
    (tmp_path / "portbench/configs/ae_mmoe.json").write_text(json.dumps(spec))
    mix = json.loads((ROOT / "portbench/mixes/ae_train.json").read_text())
    mix["val_rows"] = 0
    (tmp_path / "portbench/mixes/ae_block.json").write_text(json.dumps(mix))
    limits = json.loads((ROOT / "portbench/limits/ae.train.json").read_text())
    (tmp_path / "portbench/limits/ae_mmoe.block.json").write_text(json.dumps(limits))
    bench["configs"].append(dict(bench["configs"][1], name="ae_mmoe",
                                 file="portbench/configs/ae_mmoe.json"))
    bench["workloads"].append({"name": "ae_mmoe.block", "config": "ae_mmoe",
                               "traffic": "ae_block", "chips": 1, "why": "a test's cell"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "ae.train" in m.get("workloads", []):
            m["workloads"].append("ae_mmoe.block")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = ("import json; from portbench.run import run_cell; "
            "s = {'vocab': 16384, 'batch': 256, 'train_batches': 4}; "
            "print(json.dumps(run_cell('ae_mmoe.block', 9, 0.5, False, device='cpu', scale=s)))")
    env = dict(os.environ, PYTHONPATH=f"{tmp_path}{os.pathsep}{ROOT}")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, timeout=300, env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and "host_bound.train_examples_per_s" in result["metrics"]


def test_without_a_card_the_run_prints_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present: this checks the refusal without one")
    code = run.main(["--workload", "ae.serve", "--seed", "1", "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert code == 3 and out.out == "" and "needs 1 CUDA card" in out.err
