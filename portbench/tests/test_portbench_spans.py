"""The per-layer metrics that read the program's own spans and epoch
counters: each cell traced at a small size reads every one of its metrics
of the kind as a finite value (on the CPU those that do not declare
``CARD_ONLY``, such as the share of graph replays: the CPU captures no
graph; on the card those too); a program that records no such span or key
(the port before them) gives no value, never a 0."""

import json
import math
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from portbench import run, trace
from portbench.tests.tiny import SCALES, SECONDS

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
PROGRAM = [m for m in BENCH["per_layer"] if m["source"] == "program_counter"]


def _program_metrics(workload, card=False):
    """The cell's metrics of the kind; off the card, those a CPU run reads."""
    return [m["name"] for m in PROGRAM if workload in m.get("workloads", [])
            and (card or not getattr(run.metric_module(m["name"]), "CARD_ONLY", False))]


@pytest.mark.parametrize("workload", sorted(SCALES))
def test_a_traced_cell_reads_the_programs_spans_and_counters(workload):
    r = run.run_cell(workload, 2**31 + 11, SECONDS, True, device="cpu", scale=SCALES[workload])
    assert r["correct"], r["checks"]
    names = _program_metrics(workload)
    assert names
    for name in names:
        value = r["metrics"][name]["value"]
        assert math.isfinite(value) and value >= 0, (name, value)
    if workload == "ae.train":
        # the CPU captures no CUDA graph: the count is read, and is 0
        assert r["metrics"]["fit.graph_captures"]["value"] == 0
        assert r["metrics"]["fit.worker_metadata_ms_per_step"]["value"] > 0
    if workload == "ae.serve":
        assert all(r["metrics"][n]["value"] > 0 for n in names)


def test_a_program_without_the_spans_and_keys_reads_nothing():
    ns = 10**9
    host = (["aten::to", "aten::zeros"], np.array([1, 5]) * ns // 10,
            np.array([2, 9]) * ns // 10)
    tr = trace.Trace(([], np.zeros(0, np.int64), np.zeros(0, np.int64)), host, (0, ns))
    old_epoch = {"prep_s": 0.1, "issue_s": 0.2, "sync_s": 0.3}
    ctx = SimpleNamespace(trace=tr, steps=10, requests=10, fit_timing=[old_epoch] * 2)
    for m in PROGRAM:
        if m["name"] == "fit.host_wait_ms_per_step":
            continue
        assert run.metric_module(m["name"]).read(ctx) is None, m["name"]


def test_a_span_is_read_inside_the_window_only():
    ns = 10**9
    host = (["mmlrec.serve.pack", "mmlrec.serve.pack", "mmlrec.serve.forward"],
            np.array([-2, 2, 4]) * ns // 10, np.array([1, 3, 5]) * ns // 10)
    tr = trace.Trace(([], np.zeros(0, np.int64), np.zeros(0, np.int64)), host, (0, ns))
    ctx = SimpleNamespace(trace=tr, requests=4)
    pack = run.metric_module("serve.pack_us_per_request").read(ctx)
    assert pack == pytest.approx(1e6 * 0.2 / 4)  # [0, .1) of the first, [.2, .3)


def test_on_the_card_the_fit_captures_its_graphs(card):
    r = run.run_cell("ae.train", 2**31 + 13, SECONDS, True, device="cuda",
                     scale=SCALES["ae.train"])
    assert r["correct"], r["checks"]
    assert r["metrics"]["fit.graph_captures"]["value"] >= 1


@pytest.mark.card
def test_on_the_card_serving_replays_its_graphs(card):
    r = run.run_cell("ae.serve", 2**31 + 17, SECONDS, True, device="cuda",
                     scale=SCALES["ae.serve"])
    assert r["correct"], r["checks"]
    names = _program_metrics("ae.serve", card=True)
    assert "serve.graph_replay_share" in names
    assert all(r["metrics"][n]["value"] > 0 for n in names), r["metrics"]
