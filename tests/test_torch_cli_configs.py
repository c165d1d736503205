"""The port's CLI on the CPU with the shipped msl and mtmsl configs and the
example config, as shipped, epochs and batches cut only
(tests/_torch_cli_common.py): each trains (two-phase where the config asks
for it, with host metadata and f32 moments), validates (on the device where
``device_eval`` is set), saves where ``save`` is set, dumps the layer
outputs where asked, and appends its row in the reference's schema."""

import os

import pytest

from _torch_cli_common import CONFIGS, check_shipped_run, cut_config, run_port

OTHERS = [c for c in CONFIGS if not c.startswith(os.path.join("configs", "mtl"))]


@pytest.mark.parametrize("rel", OTHERS)
def test_shipped_config_runs(rel, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    rows = run_port(cut_config(rel, tmp_path))
    assert len(rows) == 1
    check_shipped_run(rel, rows[0], tmp_path)
