"""The port's CLI with ``--data_parallel`` on the CPU: the command starts
its gloo ranks itself (main.py:95-113), rank 0 writes the one row, and the
row's metrics match the command without a mesh; the suite flags run the
plain seed loop under a mesh; what the JAX trainer refuses on a mesh
fails the ranks with its ValueError."""

import csv
import json
import os

import pytest
import torch

from mmlrec_tpu_torch.main import main
from tests._torch_cli_common import ROOT

CONFIG = "configs/example_synthetic_msl.json"


def _config(tmp_path, epochs=2):
    """The example config with its epochs cut and its batches kept (4096,
    which divides by the ranks)."""
    with open(os.path.join(ROOT, CONFIG)) as f:
        raw = json.load(f)
    raw["training_config"]["epochs"] = epochs
    path = tmp_path / "config.json"
    path.write_text(json.dumps(raw))
    return str(path), raw


def _rows(tmp_path, raw):
    with open(tmp_path / raw["data_config"]["test_result_path"]) as f:
        return list(csv.DictReader(f))


def _run(cfg, *flags):
    return main(["--config", cfg, "--synthetic", "--synthetic_rows", "2048", "--device",
                 "cpu", *flags])


def test_data_parallel_cli_matches_the_plain_command(tmp_path, monkeypatch):
    """``--data_parallel 2 --device cpu`` writes one row whose AUCs and
    log-losses match the command without a mesh within 1e-4."""
    monkeypatch.chdir(tmp_path)
    cfg, raw = _config(tmp_path)
    dp, = _run(cfg, "--seed", "0", "--data_parallel", "2")
    written = _rows(tmp_path, raw)
    assert len(written) == 1 and written[0]["type"] == dp["type"]
    plain, = _run(cfg, "--seed", "0")
    assert set(dp) == set(plain)
    keys = [k for k in plain if k.startswith(("auc", "log_loss", "total_auc"))]
    assert keys
    for k in keys:
        assert dp[k] == pytest.approx(plain[k], abs=1e-4), k


def test_model_parallel_cli_matches_the_plain_command(tmp_path, monkeypatch):
    """``--data_parallel 2 --model_parallel 2 --device cpu`` starts four
    ranks, the table row-sharded over two of them, on a two-phase config
    (config_AE.json's: the scatter update on a mesh, as JAX's GSPMD path);
    rank 0 writes one row whose AUCs and log-losses match the command
    without a mesh within 1e-4."""
    monkeypatch.chdir(tmp_path)
    with open(os.path.join(ROOT, "configs/msl/config_AE.json")) as f:
        raw = json.load(f)
    raw["training_config"].update(epochs=1, train_batch_size=512, test_batch_size=512)
    raw["save_config"]["save"] = False
    cfg = tmp_path / "ae.json"
    cfg.write_text(json.dumps(raw))
    mesh, = _run(str(cfg), "--seed", "0", "--data_parallel", "2", "--model_parallel", "2")
    assert len(_rows(tmp_path, raw)) == 1
    plain, = _run(str(cfg), "--seed", "0")
    keys = [k for k in plain if k.startswith(("auc", "log_loss", "total_auc"))]
    assert keys and set(mesh) == set(plain)
    for k in keys:
        assert mesh[k] == pytest.approx(plain[k], abs=1e-4), k


def test_data_parallel_suite_flags_run_the_plain_loop(tmp_path, monkeypatch):
    """With a mesh, ``--vmap_seeds --seeds 0,2`` trains the seeds one after
    the other (one row each, no suite wall time), as main.py:109-113 does;
    ``--data_parallel 1`` writes the row of the command without a mesh."""
    monkeypatch.chdir(tmp_path)
    cfg, raw = _config(tmp_path, epochs=1)
    rows = _run(cfg, "--seeds", "0,2", "--vmap_seeds", "--data_parallel", "2")
    assert [r["type"].rsplit("_", 1)[-1] for r in rows] == ["0", "2"]
    assert all("suite_wall_s" not in r and "examples_per_s" in r for r in rows)
    assert len(_rows(tmp_path, raw)) == 2
    one, = _run(cfg, "--seed", "0", "--data_parallel", "1")  # a group of one
    assert not torch.distributed.is_initialized()  # the command's group is gone
    plain, = _run(cfg, "--seed", "0")
    one.pop("examples_per_s"), plain.pop("examples_per_s")
    assert one == plain  # one rank: the same bits as no mesh


def test_data_parallel_refusals_name_their_part(tmp_path, monkeypatch):
    """What the JAX trainer refuses on a mesh fails the ranks with its
    ValueError: ``--model_parallel 2`` with the unique update (only the
    explicit exchange's pallas update runs on a mesh), and a per-task
    method on ESCM's entire-space loss; two ranks on one card over NCCL
    raise ValueError before any rank starts."""
    monkeypatch.chdir(tmp_path)
    cfg, raw = _config(tmp_path, epochs=1)
    unique = tmp_path / "unique.json"
    unique.write_text(json.dumps({**raw, "model_config": {
        **raw["model_config"], "two_phase_embedding": True, "table_update": "unique",
        "explicit_collective_embedding": True}}))
    with pytest.raises(RuntimeError, match="failed: ValueError: table_update unique/pallas with "
                                           "a mesh requires"):
        _run(str(unique), "--seed", "0", "--data_parallel", "1", "--model_parallel", "2")
    raw["model_config"].update(model_name="escm", use_cagrad=True)
    escm = tmp_path / "escm.json"
    escm.write_text(json.dumps(raw))
    with pytest.raises(RuntimeError, match="failed: ValueError: per-task gradient methods"):
        _run(str(escm), "--seed", "0", "--data_parallel", "2")
    assert not (tmp_path / raw["data_config"]["test_result_path"]).exists()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="needs 2 cards"):
        main(["--config", cfg, "--synthetic", "--seed", "0", "--data_parallel", "2"])
