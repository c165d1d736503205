"""A family the port registers, added to the benchmark as new files and
entries alone: ``mlp``, whose widths are the model config's
``dnn_hidden_units`` (a key outside ``Dims.widths``), under a
configuration that states a vocabulary per sparse slot.  Its family
modules are the fixture files under ``fixtures/``; the test adds them,
the configuration, a mix, limits, a CPU scale and the cell's entries to
a copy of the benchmark, changing no file the copy has."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np

from portbench import run
from portbench.drivers import common
from portbench.reference.dims import dims
from portbench.traffic import gen

ROOT = Path(__file__).resolve().parents[2]
HERE = Path(__file__).resolve().parent
CELL, CONFIG, MIX = "ae_mlp.uniform", "ae_mlp_slots", "ae_uniform"
#: each sparse slot's ids: two 2-id slots (the scene one of them), the
#: rest from 7 to 131,072 (16,384 at the CPU scale)
SLOTS = {"c1": 2, "c2": 4096, "c3": 7, "c4": 1000, "scene": 2}


def slot_spec():
    spec = json.loads((ROOT / "portbench/configs/ae_sharedbottom.json").read_text())
    spec["experiment"]["model_config"]["model_name"] = "mlp"
    cols, _ = gen.sparse_columns(spec["experiment"])
    spec["assumed"] = {"vocabulary_sizes": {c: SLOTS.get(c, 131072) for c in cols},
                       "why": "a test's per-slot vocabularies"}
    return spec


def test_each_slot_has_its_own_vocabulary():
    spec, mix = run.scaled(slot_spec(), json.loads(
        (ROOT / "portbench/mixes/ae_train.json").read_text()), {"vocab": 16384})
    d = dims(spec)
    sizes = [SLOTS.get(c, 16384) for c in d.sparse]
    assert d.vocabs == sizes and d.logical_rows == sum(sizes)
    assert d.offsets == [int(o) for o in np.concatenate([[0], np.cumsum(sizes)[:-1]])]
    assert d.model_config["dnn_hidden_units"] == [256, 128, 64]
    lay = common.layout(d).feature_columns
    assert [f.vocabulary_size for f in lay[:len(sizes)]] == sizes
    x, _ = gen.rows(spec["experiment"], d.vocabs, mix, 4096, 2**31 + 3, "train", "cpu")
    for col, v in zip(d.sparse, sizes):
        assert 0 <= x[col].min() and x[col].max() < v, col
    assert len(np.unique(x["c1"])) == 2 and x["c2"].max() >= 2048


def _add(path: Path, text: str) -> None:
    assert not path.exists(), f"{path} is a file the benchmark has"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(text)


def test_a_family_and_slot_vocabularies_of_new_files_alone_run(tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    copy = tmp_path / "portbench"
    for kind in ("reference", "arith"):
        fixture = HERE / "fixtures" / kind / "families" / "mlp.py"
        _add(copy / kind / "families" / "mlp.py", fixture.read_text())
    _add(copy / "configs" / f"{CONFIG}.json", json.dumps(slot_spec()))
    mix = json.loads((ROOT / "portbench/mixes/ae_train.json").read_text())
    mix["ids"] = {"kind": "uniform"}
    _add(copy / "mixes" / f"{MIX}.json", json.dumps(mix))
    limits = (ROOT / "portbench/limits/ae.train.json").read_text()
    _add(copy / "limits" / f"{CELL}.json", limits)
    _add(copy / "tests" / "scales" / f"{CELL}.json", json.dumps(
        {"vocab": 16384, "batch": 256, "train_batches": 4, "val_rows": 512}))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(bench["configs"][1], name=CONFIG,
                                 file=f"portbench/configs/{CONFIG}.json"))
    bench["workloads"].append({"name": CELL, "config": CONFIG, "traffic": MIX, "chips": 1,
                               "why": "a test's cell"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "ae.train" in m.get("workloads", []):
            m["workloads"].append(CELL)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    code = ("import json; from _pytest.monkeypatch import MonkeyPatch; "
            "from portbench.run import run_cell; from portbench.tests.tiny import SCALES; "
            "from portbench.tests.test_portbench_cells import _state_unchanged; "
            f"go = lambda: run_cell({CELL!r}, 2**31 + 9, 0.5, False, device='cpu', "
            f"scale=SCALES[{CELL!r}]); "
            "sound = go(); _state_unchanged(MonkeyPatch()); "
            "print(json.dumps([sound, go()]))")
    env = dict(os.environ, PYTHONPATH=f"{tmp_path}{os.pathsep}{ROOT}")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, timeout=300, env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    sound, frozen = json.loads(out.stdout.strip().splitlines()[-1])
    assert sound["correct"], sound["checks"]
    assert "host_bound.train_examples_per_s" in sound["metrics"]
    assert not frozen["correct"]
    assert frozen["checks"]["change_norm_gap"]["value"] > frozen["checks"]["change_norm_gap"]["limit"]
