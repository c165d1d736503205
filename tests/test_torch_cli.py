"""The port's CLI (``python -m mmlrec_tpu_torch.main``) on the CPU: the
shipped mtl configs as shipped, epochs and batches cut only
(tests/_torch_cli_common.py), the result row's schema against the JAX
package's main.py, and the flags that stay unported.  The msl and mtmsl
configs are in tests/test_torch_cli_configs.py."""

import json
import os

import pytest
import torch

from _torch_cli_common import CONFIGS, check_shipped_run, cut_config, read_csv, run_jax, \
    run_port
from mmlrec_tpu_torch.main import main

MTL = [c for c in CONFIGS if c.startswith(os.path.join("configs", "mtl"))]


def test_every_shipped_config_is_covered():
    from _torch_cli_common import ROOT

    assert len(CONFIGS) == 13 and len(MTL) == 5
    others = [c for c in CONFIGS if c not in MTL]
    with open(os.path.join(ROOT, "tests", "test_torch_cli_configs.py")) as f:
        src = f.read()
    assert "OTHERS" in src and len(others) == 8


@pytest.mark.parametrize("rel", MTL)
def test_shipped_mtl_config_runs(rel, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    rows = run_port(cut_config(rel, tmp_path))
    assert len(rows) == 1
    check_shipped_run(rel, rows[0], tmp_path)


@pytest.mark.parametrize("rel", ["configs/example_synthetic_msl.json",
                                 "configs/msl/config_AE.json",
                                 "configs/mtl/config_census.json"])
def test_row_schema_matches_jax_main(rel, tmp_path, monkeypatch):
    rows = {}
    for side, run in (("jax", run_jax), ("port", run_port)):
        work = tmp_path / side
        work.mkdir()
        monkeypatch.chdir(work)
        cfg = cut_config(rel, work)
        with open(cfg) as f:
            raw = json.load(f)
        raw["data_config"]["test_result_path"] = "results/rows.csv"
        with open(cfg, "w") as f:
            json.dump(raw, f)
        run(cfg)
        rows[side] = read_csv(str(work / "results" / "rows.csv"))
        ckpts = sorted(os.listdir(work / "checkpoint")) if (work / "checkpoint").exists() else []
        rows[side + "_ckpt"] = ckpts
    assert len(rows["jax"]) == len(rows["port"]) == 1
    assert list(rows["port"][0]) == list(rows["jax"][0])
    assert rows["port"][0]["type"] == rows["jax"][0]["type"]
    assert rows["port_ckpt"] == rows["jax_ckpt"]  # the same checkpoint directory names


def test_device_eval_flag_and_bundle_export(tmp_path, monkeypatch):
    """--device_eval takes the final metrics from the device; --export_bundle
    writes a serving bundle of the best variables."""
    monkeypatch.chdir(tmp_path)
    rel = "configs/mtl/config_ijcai.json"
    cfg = cut_config(rel, tmp_path)
    dev = run_port(cfg, "--device_eval", "--export_bundle", "bundles")[0]
    host = run_port(cfg)[0]
    assert list(dev) == list(host)
    for k in dev:
        if k.startswith(("auc", "log_loss")):
            assert dev[k] == pytest.approx(host[k], abs=2e-4), k
    from mmlrec_tpu_torch.serving import ServingBundle

    assert ServingBundle.load(str(tmp_path / "bundles" / dev["type"]), device="cpu")


@pytest.mark.parametrize("flags,err,item", [
    # a row-sharded table under the two-phase step's write-kernel update
    # without the explicit exchange: JAX's ValueError, raised by the ranks
    (["--data_parallel", "1", "--model_parallel", "2"], RuntimeError,
     "rank [01] failed: ValueError: table_update unique/pallas with a mesh requires the "
     "explicit_collective_embedding"),
    (["--device", "cuda"], RuntimeError, "no CUDA device"),
])
def test_unported_flags_raise(flags, err, item, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = cut_config("configs/example_synthetic_msl.json", tmp_path)
    if "--model_parallel" in flags:
        raw = json.loads(open(cfg).read())
        raw["model_config"].update(two_phase_embedding=True, table_update="pallas")
        with open(cfg, "w") as f:
            json.dump(raw, f)
    with pytest.raises(err, match=item):
        main(["--config", cfg, "--seed", "0", "--synthetic", "--device", "cpu", *flags])
    assert not (tmp_path / "results").exists()


def test_vmap_seeds_with_one_seed_runs_the_loop(tmp_path, monkeypatch):
    """``--vmap_seeds`` with one seed trains as the plain loop does
    (main.py:109-113): the same row as without the flag, the throughput
    (a wall-clock number) apart."""
    monkeypatch.chdir(tmp_path)
    cfg = cut_config("configs/example_synthetic_msl.json", tmp_path)
    with_flag, = run_port(cfg, "--vmap_seeds")
    without, = run_port(cfg)
    assert "suite_wall_s" not in with_flag
    with_flag.pop("examples_per_s"), without.pop("examples_per_s")
    assert with_flag == without


@pytest.mark.parametrize("seeds,flags", [("0,2", ["--vmap_seeds"]),
                                         ("", ["--sweep_lrs", "0.01,0.001"])])
def test_suite_flags_write_jax_rows(seeds, flags, tmp_path, monkeypatch):
    """The seed suite and the lr sweep run through the CLI on the CPU and
    write one row per member with the JAX package's labels and keys."""
    rows = {}
    for side, run in (("jax", run_jax), ("port", run_port)):
        work = tmp_path / side
        work.mkdir()
        monkeypatch.chdir(work)
        cfg = cut_config("configs/example_synthetic_msl.json", work)
        with open(cfg) as f:
            raw = json.load(f)
        raw["data_config"]["test_result_path"] = "results/rows.csv"
        with open(cfg, "w") as f:
            json.dump(raw, f)
        run(cfg, *flags, seeds=seeds)
        rows[side] = read_csv(str(work / "results" / "rows.csv"))
    assert len(rows["port"]) == 2
    assert [r["type"] for r in rows["port"]] == [r["type"] for r in rows["jax"]]
    assert [list(r) for r in rows["port"]] == [list(r) for r in rows["jax"]]
    assert rows["port"][0]["type"].endswith("_0" if seeds else "_0_lr0.01")


def test_csv_data_pipeline_is_not_ported(tmp_path, monkeypatch):
    """The CSV pipeline is ported now (tests/test_torch_data.py): without
    ``--synthetic`` the CLI reads the config's CSV files, and the example
    config, which names none, fails on the missing file as the JAX
    package's main.py does, not on a refusal."""
    monkeypatch.chdir(tmp_path)
    cfg = cut_config("configs/example_synthetic_msl.json", tmp_path)
    with pytest.raises(FileNotFoundError):
        main(["--config", cfg, "--seed", "0", "--device", "cpu"])
    assert not (tmp_path / "results").exists()
