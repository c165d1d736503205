"""Helpers of the port's CLI tests (tests/test_torch_cli*.py): a shipped
config cut to one epoch of 256-row batches, run through the port's
``main()`` on the CPU in a working directory of its own."""

import csv
import glob
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(os.path.relpath(p, ROOT) for p in glob.glob(os.path.join(ROOT, "configs", "**",
                                                                         "*.json"),
                                                              recursive=True))
ROWS, BATCH = 2048, 256
N_TEST = max(ROWS // 4, 1000)  # the CLI's synthetic test split


def cut_config(rel: str, out_dir, epochs: int = 1) -> str:
    """A copy of ``rel`` with its epochs and batches cut and everything else
    as shipped, paths included (relative: they land in the working dir)."""
    with open(os.path.join(ROOT, rel)) as f:
        raw = json.load(f)
    tc = raw["training_config"]
    tc["epochs"] = epochs
    for k in ("train_batch_size", "val_batch_size", "test_batch_size"):
        if k in tc:
            tc[k] = BATCH
    path = os.path.join(str(out_dir), "config.json")
    with open(path, "w") as f:
        json.dump(raw, f)
    return path


def run_port(cfg_path: str, *extra: str, seeds: str = ""):
    """The port's main() on the CPU, with ``--seed 0`` or ``--seeds seeds``."""
    from mmlrec_tpu_torch.main import main

    seed = ["--seeds", seeds] if seeds else ["--seed", "0"]
    return main(["--config", cfg_path, *seed, "--synthetic", "--synthetic_rows",
                 str(ROWS), "--device", "cpu", *extra])


def run_jax(cfg_path: str, *extra: str, seeds: str = "") -> None:
    """The JAX package's main.py, imported by path (another main.py may be on
    sys.path), with ``--seed 0`` or ``--seeds seeds``."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("mmlrec_main", os.path.join(ROOT, "main.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    old = sys.argv
    seed = ["--seeds", seeds] if seeds else ["--seed", "0"]
    sys.argv = ["main.py", "--config", cfg_path, *seed, "--synthetic",
                "--synthetic_rows", str(ROWS), *extra]
    try:
        mod.main()
    finally:
        sys.argv = old


def read_csv(path: str):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def check_shipped_run(rel: str, row: dict, workdir) -> None:
    """What a run of a shipped config must leave behind: its row in the
    reference's schema, in the CSV the config names; its checkpoint where
    ``save`` is set; the layer-output pickles where asked for."""
    with open(os.path.join(ROOT, rel)) as f:
        raw = json.load(f)
    dc, mc, sc = raw["data_config"], raw["model_config"], raw.get("save_config", {})
    n_heads = len(dc["label_columns"])
    want = ["type"] + [f"{m}_{i}" for i in range(n_heads) for m in ("log_loss", "auc")]
    if mc["task_name"] in ("msl", "mtmsl"):
        want.append("total_auc")
    want.append("examples_per_s")
    assert list(row) == want, rel
    assert row["type"] == f"{dc.get('data_name', '')}_{mc['task_name']}_{mc['model_name']}_0"
    for k in want[1:]:
        assert np.isfinite(row[k]), (rel, k)
        if k.startswith("auc") or k == "total_auc":
            assert 0.0 <= row[k] <= 1.0, (rel, k)
    path = dc.get("test_result_path", "")
    if path:
        rows = read_csv(os.path.join(str(workdir), path))
        assert len(rows) == 1 and list(rows[0]) == want
    ckpt = os.path.join(str(workdir), sc.get("save_path", "./checkpoint/"),
                        f"{mc['model_name']}_{mc['task_name']}_seed0")
    assert os.path.exists(os.path.join(ckpt, "variables.pt")) == bool(sc.get("save")), rel
    if sc.get("save_layer_output"):
        pkls = glob.glob(os.path.join(str(workdir), dc["layer_output_path"] + "*.pkl"))
        assert pkls, rel
        import pickle

        for p in pkls:
            with open(p, "rb") as f:
                a = pickle.load(f)
            assert isinstance(a, np.ndarray) and a.dtype == np.float64 and len(a) == N_TEST
