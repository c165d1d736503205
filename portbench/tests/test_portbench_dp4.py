"""``ae.train.dp4``, which ``BENCHMARK.json`` does not list yet, rehearsed
on the CPU over four gloo processes at its fixture's scale, in a copy of
the benchmark with the cell added from ``fixtures/ae.train.dp4.json``:
the program passes, untraced and traced (the traced run reads the cell's
program counters); with one rank's gradient dropped from the all-reduce
the step takes three quarters of the batch, and ``correct`` comes out
false."""

import json
import math
from pathlib import Path

import pytest

from portbench import run
from portbench.drivers import train_dp
from portbench.tests.tiny import SECONDS

CELL = "ae.train.dp4"
FIXTURE = Path(__file__).parent / "fixtures" / f"{CELL}.json"
SCALE = json.loads(FIXTURE.read_text())["scale"]


@pytest.mark.parametrize("trace", [False, True])
def test_the_reference_agrees_with_the_program_over_four_ranks(trace):
    bench = train_dp.with_cell(FIXTURE)
    r = run.run_cell(CELL, 2**31 + 5, SECONDS, trace, device="cpu", scale=SCALE, bench=bench)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert r["checks"]["ranks_apart"]["value"] == 0
    assert ("setup_s" in r["metrics"]) != trace  # a traced run reports the per-layer metrics
    if trace:
        counters = [m["name"] for m in bench["per_layer"] if m["source"] == "program_counter"
                    and CELL in m.get("workloads", [])]
        assert counters
        for name in counters:
            value = r["metrics"][name]["value"]
            assert math.isfinite(value) and value >= 0, (name, value)


def test_a_dropped_rank_gradient_is_not_correct():
    bench = train_dp.with_cell(FIXTURE)
    ctx = train_dp.cell_ctx(bench, CELL, 2**31 + 21, SECONDS, "cpu", SCALE)
    out = train_dp.run(ctx, fault=True)
    limits = run.cell_files(bench, CELL)[3]["limits"]
    over = {k for k, v in out["numbers"].items() if v > limits[k]}
    assert "grad_norm_gap" in over, out["numbers"]
    assert out["numbers"]["ranks_apart"] == 0  # every rank takes the same reduced step

