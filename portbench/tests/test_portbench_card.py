"""On the card, at each cell's own size: the control (the reference in
TF32, the precision just below the configuration's float32, in the
program's place) fails at least one of the cell's numbers on every seed,
and a training cell's half-batch fault fails one too, while the program
passes all of them.  ``correct``'s limits were set from these readings
(``python3 -m portbench.calibrate``); PERF.md gives them.  A training
step replayed from its captured graph is compared too: a replay that
leaves the state as it was makes ``correct`` false."""

import json
from pathlib import Path

import pytest

from portbench import run
from portbench.calibrate import readings

ROOT = Path(__file__).resolve().parents[2]
BENCH = run.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
TRAINING = [c for c in CELLS if run.cell_files(BENCH, c)[2]["driver"] == "train"]


@pytest.mark.card
@pytest.mark.parametrize("workload", CELLS)
def test_the_control_fails_where_the_program_passes(workload, card):
    limits = json.loads((ROOT / "portbench" / "limits" / f"{workload}.json").read_text())
    limits = limits["limits"]
    rows = readings(workload, [2**31 + 101, 2**31 + 202, 2**31 + 303], controls=3)
    for row in rows:
        over = [k for k, v in row.items() if k in limits and v > limits[k]]
        if row["side"] == "program":
            assert not over, row
        else:
            assert over, row


@pytest.mark.card
@pytest.mark.parametrize("workload", TRAINING)
def test_a_replay_that_leaves_the_state_unchanged_is_not_correct(workload, card, monkeypatch):
    from mmlrec_tpu_torch.train.graphs import StepGraphs

    replay = StepGraphs.run

    def skipped(self, key, body):
        if key in self.graphs and key[0] != "eval":
            return  # a captured training step: nothing runs
        replay(self, key, body)

    monkeypatch.setattr(StepGraphs, "run", skipped)
    r = run.run_cell(workload, 2**31 + 404, 1.0, False)
    assert not r["correct"]
    assert r["checks"]["change_norm_gap"]["value"] > r["checks"]["change_norm_gap"]["limit"]
