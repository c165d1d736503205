"""``BENCHMARK.json`` against the rules its checker applies, and every
file a cell needs found by its name."""

import json
import re
from pathlib import Path

import pytest

from portbench import run

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")
METRIC_KEYS = {"name", "unit", "better", "source"}


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["command"]) <= 32
    for word in BENCH["command"]:
        assert LINE.match(word) and not word.startswith("/") and ".." not in word
    for path in BENCH["paths"]:
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", path) and (ROOT / path).is_dir()
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51


def test_every_name_and_unit_uses_the_allowed_characters():
    names = [c["name"] for c in BENCH["configs"]] + [w["name"] for w in BENCH["workloads"]]
    names += [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [w[k] for w in BENCH["workloads"] for k in ("config", "traffic")]
    names += [k for c in BENCH["configs"] for k in c["reduced"]]
    for name in names:
        assert NAME.match(name), name
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for text in ([c["why"] for c in BENCH["configs"]] + [w["why"] for w in BENCH["workloads"]]
                 + [m["layer"] for m in BENCH["per_layer"]]
                 + [c["source"] for c in BENCH["configs"]]):
        assert LINE.match(text), text
    every = [c["name"] for c in BENCH["configs"]]
    for group in (every, [w["name"] for w in BENCH["workloads"]],
                  [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]):
        assert len(group) == len(set(group))
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_entries_hold_just_their_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert len(c["reduced"]) <= 16
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"bound"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0 < m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"layer", "moves"}


def test_cells_report_setup_another_end_to_end_metric_and_a_per_layer_one():
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    for w in BENCH["workloads"]:
        e2e = [m["name"] for m in BENCH["end_to_end"] if run.applies(m, w["name"], [])]
        layer = [m for m in BENCH["per_layer"] if run.applies(m, w["name"], e2e)]
        assert "setup_s" in e2e and len(e2e) >= 2 and layer, w["name"]
        for m in layer:
            assert m["moves"] in e2e, (w["name"], m["name"])


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_a_cells_files_are_found_by_name(workload):
    cell, spec, mix, limits, entry = run.cell_files(BENCH, workload)
    assert spec["source"] == entry["source"] and spec["reduced"] == entry["reduced"]
    assert (ROOT / "portbench" / "drivers" / f"{mix['driver']}.py").is_file()
    assert limits["limits"] and all(v >= 0 for v in limits["limits"].values())
    family = spec["experiment"]["model_config"]["model_name"]
    for kind in ("reference", "arith"):
        assert (ROOT / "portbench" / kind / "families" / f"{family}.py").is_file()


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_a_metric_module_declares_what_the_benchmark_says(metric):
    module = run.metric_module(metric["name"])
    assert (module.UNIT, module.LAYER, module.MOVES, module.SOURCE) == (
        metric["unit"], metric["layer"], metric["moves"], metric["source"])
    assert module.read(object()) is None  # nothing to read: no value, never a 0


def test_each_configuration_is_used_and_its_file_lies_under_paths():
    used = {w["config"] for w in BENCH["workloads"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert used == {c["name"] for c in BENCH["configs"]} and len(set(files)) == len(files)
    for f in files:
        assert any(f.startswith(p + "/") for p in BENCH["paths"]) and (ROOT / f).is_file()
