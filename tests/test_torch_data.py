"""The CSV data pipeline (``mmlrec_tpu_torch/data.py``, the loader's binding
in ``native.py``) against the JAX package's ``ctrdataset``, backend for
backend, on CSV files the tests write themselves.

The two JAX backends disagree with each other on data that is not clean
(an empty cell, ``NA`` / ``null``, numbers beside strings), so the port's
pandas-equivalent reader is held against JAX's ``_ctrdataset_pandas`` and
its native path against JAX's ``_ctrdataset_native``, each bitwise: codes,
vocabs, labels, mask and dense values.  The reader parses floats as
pandas' ``precise_xstrtod`` does, so a 17-digit dense column is bitwise
too, where Python's correctly rounded ``float()`` would differ from
pandas.  Then the ``auto`` rule, ``keep_frames``, the staged batch of
int32 (native) and int64 (pandas) codes, and the CLI on a CSV pair
against JAX's ``main.py``."""

import csv
import json
import os
import sys

import numpy as np
import pandas as pd
import pytest
import torch

from _torch_data_common import (assert_same_array, assert_same_dataset, configs, raw_config,
                                write_csv, write_pair)
from mmlrec_tpu import data as jax_data
from mmlrec_tpu_torch import data as port_data
from mmlrec_tpu_torch import native

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _native_csv_schema(tmp_path, rng):
    """tests/test_native_csv.py:22-58's schema, the floats written short."""
    n_tr, n = 300, 420
    df = pd.DataFrame({"cat_str": rng.choice(["alpha", "beta", "gamma", "zz"], n),
                       "cat_int": rng.integers(0, 9, n), "scene": rng.integers(0, 2, n),
                       "num_a": rng.normal(3, 2, n), "num_b": rng.random(n) * 100,
                       "label": rng.integers(0, 2, n)})
    df.loc[0, "cat_str"] = "with,comma"  # the RFC-4180 path
    tr, te = str(tmp_path / "tr.csv"), str(tmp_path / "te.csv")
    df[:n_tr].to_csv(tr, index=False, float_format="%.6g")
    df[n_tr:].to_csv(te, index=False, float_format="%.6g")
    return raw_config(tr, te, list(df.columns), ["cat_str", "cat_int", "scene"],
                      ["num_a", "num_b"])


def _kuairec(tmp_path, rng, degree_as_string):
    """The kuairec fixups (data_utils.py:27-33): the onehot columns cast to
    strings (a float one with empty cells: pandas 3 keeps them missing)
    and the rows of user_active_degree "0" dropped from train, which drops
    nothing when the column reads as integers."""
    def rows(n):
        degree = rng.choice(["0", "low", "high", "full"] if degree_as_string else
                            ["0", "1", "2", "3"], n)
        onehot0 = rng.choice(["1.0", "", "2.0", "10.0", "0.5"], n)
        return [[d, o0, o1, lab] for d, o0, o1, lab in
                zip(degree, onehot0, rng.integers(0, 3, n), rng.integers(0, 2, n))]
    header = ["user_active_degree", "onehot_feat0", "onehot_feat1", "label"]
    tr, te = write_pair(tmp_path, "kuairec_", header, rows(80), rows(40))
    return raw_config(tr, te, header, header[:3], task="mtl")


def _iaac(tmp_path, rng):
    header = ["predict_category_property", "item_brand_id", "label"]
    rows = [[p, b, lab] for p, b, lab in zip(rng.integers(100, 110, 100), rng.integers(0, 9, 100),
                                             rng.integers(0, 2, 100))]
    tr, te = write_pair(tmp_path, "iaac_", header, rows[:70], rows[70:])
    return raw_config(tr, te, header, header[:2], task="mtl")


def _amazon_new(tmp_path, rng):
    """Every column cast to strings: 10 sorts before 2."""
    header = ["vote", "style_new", "label"]
    rows = [[v, s, lab] for v, s, lab in zip(rng.choice([2, 10, 101, 3], 90),
                                             rng.integers(0, 4, 90), rng.integers(0, 2, 90))]
    tr, te = write_pair(tmp_path, "amazon_new_", header, rows[:60], rows[60:])
    return raw_config(tr, te, header, header[:2], task="mtl")


def _cells_case(tmp_path, rng, dense_cells, cat_cells, prefix="plain_"):
    """A pair of one dense and a few categorical columns drawn from the
    given cells, with a scene and a label column."""
    cats = list(cat_cells)
    header = ["n"] + [f"c{i}" for i in range(len(cats))] + ["scene", "label"]

    def rows(n):
        cols = [rng.choice(dense_cells, n)] + [rng.choice(c, n) for c in cats]
        return [[*r, s, lab] for r, s, lab in zip(zip(*cols), rng.integers(0, 2, n),
                                                  rng.integers(0, 2, n))]
    tr, te = write_pair(tmp_path, prefix, header, rows(40), rows(20))
    return raw_config(tr, te, header, header[1:-2], ["n"])


def _digits17(tmp_path, rng):
    """%.17g dense values, where pandas' parser and float() disagree."""
    header = ["c", "n6", "n17", "scene", "label"]
    rows = [[c, "%.6g" % a, "%.17g" % b, s, lab] for c, a, b, s, lab in zip(
        rng.integers(0, 50, 400), rng.normal(0, 1, 400), rng.normal(0, 1e4, 400),
        rng.integers(0, 2, 400), rng.integers(0, 2, 400))]
    tr, te = write_pair(tmp_path, "plain_", header, rows[:300], rows[300:])
    return raw_config(tr, te, header, ["c"], ["n6", "n17"])


def _low_memory_blocks(tmp_path, rng):
    """A 1024-column file: pandas' reader types each block of 512 rows on
    its own and joins the blocks (integers then a missing cell: float64;
    "True" then "1": objects that compare equal; a bool block then floats
    in a dense column: objects scaled through float())."""
    width, n = 1024, 700
    header = ["a", "b", "d", "scene", "label"] + [f"pad{i}" for i in range(width - 5)]
    pad = ["0"] * (width - 5)
    rows = [[str(rng.integers(0, 5)) if i < 512 else rng.choice(["", "3"]),
             "True" if i < 512 else rng.choice(["1", "2"]),
             rng.choice(["True", "False"]) if i < 512 else "%.6g" % rng.random(),
             rng.integers(0, 2), rng.integers(0, 2), *pad] for i in range(n)]
    tr, te = write_pair(tmp_path, "plain_", header, rows[:600], rows[600:])
    return raw_config(tr, te, header[:5], ["a", "b"], ["d"])


def _promotions(tmp_path, rng):
    """``pd.concat``'s promotions across the two files: bool then int64 gives
    int64, float64 then bool float64, bool then float64 objects."""
    header = ["bool_int", "float_bool", "bool_float", "scene", "label"]

    def rows(n, train):
        return [[rng.choice(["True", "False"]) if train else rng.integers(0, 3),
                 "%.6g" % rng.random() if train else rng.choice(["True", "False"]),
                 rng.choice(["True", "False"]) if train else rng.choice(["0.5", "1.5"]),
                 rng.integers(0, 2), rng.integers(0, 2)] for _ in range(n)]
    tr, te = write_pair(tmp_path, "plain_", header, rows(30, True), rows(12, False))
    return raw_config(tr, te, header, ["bool_int", "bool_float"], ["float_bool"])


CASES = {
    "native_csv_schema": _native_csv_schema,
    "kuairec_string_degree": lambda p, r: _kuairec(p, r, True),
    "kuairec_int_degree": lambda p, r: _kuairec(p, r, False),
    "iaac": _iaac,
    "amazon_new": _amazon_new,
    # where the two JAX backends disagree: empty cells, NA / null tokens
    "empty_cells": lambda p, r: _cells_case(p, r, ["0.5", "", "1.5"],
                                           [["1", "", "3"], ["x", "", "y"]]),
    "na_tokens": lambda p, r: _cells_case(p, r, ["0.5", "NA", "null", "2"],
                                         [["x", "NA", "null", "y"], ["1", "NA", "null"]]),
    "bool_columns": lambda p, r: _cells_case(p, r, ["1", "2"],
                                            [["True", "False"], ["TRUE", "false", ""]]),
    "one_beside_one_point_zero": lambda p, r: _cells_case(p, r, ["1", "1.0", "2"],
                                                         [["1", "1.0", "2"]]),
    "leading_spaces": lambda p, r: _cells_case(p, r, [" 0.5", "1.5 ", "2"],
                                              [[" 1", "1", "2 "], [" x", "x"]]),
    "digits17": _digits17,
    "low_memory_blocks": _low_memory_blocks,
    "promotions": _promotions,
}
# numbers in one file, strings in the other: sklearn's TypeError in JAX
MIXED = {
    "int_beside_string": (["1", "2"], ["x"]),
    "exponent_beside_hex": (["1e3", "2"], ["0x10"]),
}


def _case(name, tmp_path):
    return CASES[name](tmp_path, np.random.default_rng(sorted(CASES).index(name)))


def _mixed(name, tmp_path):
    train_cells, test_cells = MIXED[name]
    header = ["c", "scene", "label"]
    tr, te = write_pair(tmp_path, "plain_", header, [[c, 0, 1] for c in train_cells],
                        [[c, 1, 0] for c in test_cells])
    return raw_config(tr, te, header, ["c"])


@pytest.fixture(scope="module")
def native_libs():
    """Both packages' loaders of native/fast_csv.cpp, built as their own
    tests build them."""
    try:
        from mmlrec_tpu.native import get_lib

        get_lib()
        native.get_csv_lib()
    except Exception as e:  # noqa: BLE001
        pytest.skip(f"native toolchain unavailable: {e}")


@pytest.mark.parametrize("name", sorted(CASES))
def test_pandas_path_matches_jax_bitwise(name, tmp_path):
    port_cfg, jax_cfg = configs(_case(name, tmp_path))
    assert_same_dataset(port_data._ctrdataset_pandas(port_cfg),
                        jax_data._ctrdataset_pandas(jax_cfg))


def test_seventeen_digit_column_reads_as_pandas_reads_it(tmp_path):
    """The 17-digit column: pandas' parser is not correctly rounded there,
    and the reader follows it, not float()."""
    port_cfg, _ = configs(_digits17(tmp_path, np.random.default_rng(0)))
    with open(port_cfg.data_config.train_dataset_path, newline="") as f:
        cells = [r[2] for r in list(csv.reader(f))[1:]]
    pandas_values = pd.read_csv(port_cfg.data_config.train_dataset_path)["n17"].to_numpy()
    read = port_data._read_csv(port_cfg.data_config.train_dataset_path, ["n17"])["n17"]
    assert_same_array(read, pandas_values)
    assert (np.array([float(c) for c in cells]) != pandas_values).any()


@pytest.mark.parametrize("name", sorted(MIXED))
def test_mixed_types_raise_as_jax_does(name, tmp_path):
    port_cfg, jax_cfg = configs(_mixed(name, tmp_path))
    with pytest.raises(TypeError) as want:
        jax_data._ctrdataset_pandas(jax_cfg)
    with pytest.raises(TypeError) as got:
        port_data._ctrdataset_pandas(port_cfg)
    assert str(got.value) == str(want.value)


def test_unreproduced_pandas_behaviour_raises_by_name(tmp_path):
    """Integers beyond int64, which pandas reads as uint64: named, not
    read otherwise."""
    header = ["c", "scene", "label"]
    tr, te = write_pair(tmp_path, "plain_", header, [["9223372036854775808", 0, 1]],
                        [["1", 1, 0]])
    port_cfg, _ = configs(raw_config(tr, te, header, ["c"]))
    with pytest.raises(port_data.UnsupportedCSV, match="int64"):
        port_data._ctrdataset_pandas(port_cfg)


@pytest.mark.parametrize("name", sorted(CASES) + sorted(MIXED))
def test_native_path_matches_jax_bitwise(name, tmp_path, native_libs):
    raw = (_case if name in CASES else _mixed)(name, tmp_path)
    port_cfg, jax_cfg = configs(raw)
    got = port_data.ctrdataset(port_cfg, backend="native")
    assert_same_dataset(got, jax_data.ctrdataset(jax_cfg, backend="native"))
    assert all(v.dtype == np.int32 for k, v in got.train_input.items()
               if k in {s.feature.name for s in got.layout.sparse_slots})


def test_native_library_builds_outside_the_native_directory():
    path = native.library_path(native.CSV_SOURCE)
    assert path.parent == native.BUILD_DIR and path.name.startswith("libfastcsv_")
    assert native.CSV_SOURCE == native.NATIVE_DIR / "fast_csv.cpp"
    assert path != native.library_path() and path.parent != native.NATIVE_DIR


@pytest.mark.parametrize("prefix", ["plain_", "kuairec_", "iaac_", "amazon_new_"])
def test_auto_takes_the_backend_jax_takes(prefix, monkeypatch):
    taken = []
    for mod, tag in ((port_data, "port"), (jax_data, "jax")):
        monkeypatch.setattr(mod, "_ctrdataset_native", lambda cfg, t=tag: taken.append((t, "native")))
        monkeypatch.setattr(mod, "_ctrdataset_pandas",
                            lambda cfg, keep=False, t=tag: taken.append((t, "pandas")))
    port_cfg, jax_cfg = configs(raw_config(f"data/{prefix}train.csv", f"data/{prefix}test.csv",
                                           ["c", "scene", "label"], ["c"]))
    port_data.ctrdataset(port_cfg)
    jax_data.ctrdataset(jax_cfg)
    want = "native" if prefix == "plain_" else "pandas"
    assert taken == [("port", want), ("jax", want)]


def test_auto_falls_back_as_jax_does(tmp_path, monkeypatch, capsys):
    """A failing native loader: auto reads with pandas (JAX's rule),
    ``backend="native"`` raises."""
    from mmlrec_tpu import native as jax_native

    def unavailable(*a, **k):
        raise native.NativeUnavailable("no loader")

    port_cfg, jax_cfg = configs(_case("empty_cells", tmp_path))
    monkeypatch.setattr(native, "load_csv_columns", unavailable)
    monkeypatch.setattr(jax_native, "load_csv_columns", unavailable)
    assert_same_dataset(port_data.ctrdataset(port_cfg), jax_data.ctrdataset(jax_cfg))
    assert "using the pandas-equivalent reader" in capsys.readouterr().out
    with pytest.raises(native.NativeUnavailable):
        port_data.ctrdataset(port_cfg, backend="native")
    with pytest.raises(ValueError, match="backend"):
        port_data.ctrdataset(port_cfg, backend="arrow")


def test_keep_frames_holds_the_encoded_frames(tmp_path):
    port_cfg, jax_cfg = configs(_case("kuairec_string_degree", tmp_path))
    got = port_data.ctrdataset(port_cfg, keep_frames=True)
    want = jax_data.ctrdataset(jax_cfg, keep_frames=True)
    assert_same_dataset(got, want)
    for frames, df in ((got.train_frames, want.train_df), (got.test_frames, want.test_df)):
        assert list(frames) == list(df.columns)
        for c in frames:
            assert_same_array(frames[c], df[c].to_numpy(), c)
    assert got.train_frames["label"].dtype == np.int64  # labels stay raw
    port_cfg, _ = configs(_case("native_csv_schema", tmp_path))
    ds = port_data.ctrdataset(port_cfg, keep_frames=True, backend="native")
    assert ds.train_frames is None and ds.test_frames is None  # as JAX's native path


def test_int32_and_int64_codes_stage_the_same_batch(tmp_path, native_libs):
    """The native path's int32 codes and the pandas path's int64 codes go
    into the same packed and staged batch, bitwise."""
    from mmlrec_tpu_torch.models import get_model
    from mmlrec_tpu_torch.train import Trainer, staging

    port_cfg, _ = configs(_case("native_csv_schema", tmp_path))
    nat = port_data.ctrdataset(port_cfg, backend="native")
    pdx = port_data.ctrdataset(port_cfg, backend="pandas")
    assert nat.train_input["cat_int"].dtype == np.int32
    assert pdx.train_input["cat_int"].dtype == np.int64
    tr = Trainer(get_model("mmoe", nat.layout, port_cfg, device="cpu"), device="cpu").compile()
    staged = []
    for ds in (nat, pdx):
        ids, dense = tr.pack_inputs(ds.train_input)
        staged.append(staging.stage_dataset(tr, ids, dense, tr._prepare_y(ds.y_train),
                                            tr._domain_mask_from(ds.train_input)))
    for a, b in zip(*staged):
        assert a.dtype == b.dtype and torch.equal(a, b)
    idx = torch.arange(0, 256, 3)
    for a, b in zip(staging.fetch_staged_rows(tr, staged[0], idx),
                    staging.fetch_staged_rows(tr, staged[1], idx)):
        assert torch.equal(a, b)


def _cli_pair(tmp_path, task):
    """A CSV pair under ``data/`` with a learnable label and a config whose
    paths are relative to the working directory (tests/test_e2e.py's
    schema)."""
    rng = np.random.default_rng(0)
    n_tr, n_te = 600, 240
    n = n_tr + n_te
    cat_b = rng.integers(0, 7, n)
    label = ((cat_b > 3) ^ (rng.random(n) < 0.2)).astype(int)
    rows = [[a, b, s, "%.6g" % x, lab, lab2] for a, b, s, x, lab, lab2 in zip(
        rng.choice(["x", "y", "z"], n), cat_b, rng.integers(0, 2, n), rng.normal(0, 1, n), label,
        rng.integers(0, 2, n))]
    header = ["cat_a", "cat_b", "scene", "num_a", "label", "label2"]
    os.makedirs(tmp_path / "data")
    write_csv(tmp_path / "data" / "train.csv", header, rows[:n_tr])
    write_csv(tmp_path / "data" / "test.csv", header, rows[n_tr:])
    labels = ["label", "label2"] if task == "mtl" else ["label", "label"]
    raw = raw_config("data/train.csv", "data/test.csv", header, ["cat_a", "cat_b", "scene"],
                     ["num_a"], labels=labels, task=task,
                     extra_data={"test_result_path": "results/rows.csv"})
    raw["model_config"].update(model_name="sharedbottom", bottom_dnn_hidden_units=[16, 8],
                               tower_dnn_hidden_units=[8])
    raw["optim_config"] = {"lr": 0.01, "optimizer": "adam",
                           "loss": ["binary_crossentropy"] * 2, "metrics": ["auc"]}
    raw["training_config"] = {"train_batch_size": 256, "test_batch_size": 256, "epochs": 2}
    raw["save_config"] = {"save": False, "save_layer_output": False}
    with open(tmp_path / "config.json", "w") as f:
        json.dump(raw, f)
    return "config.json"


@pytest.mark.parametrize("task", ["msl", "mtl"])
def test_cli_trains_from_csv_files_as_jax_main(task, tmp_path, monkeypatch, native_libs):
    """``python -m mmlrec_tpu_torch.main --device cpu`` without
    ``--synthetic`` against JAX's main.py on the same files, from the same
    working directory layout: the same row schema and type
    (tests/test_torch_cli.py's rule: the two packages draw their initial
    weights from different generators) and metrics of the reference's
    range (tests/test_e2e.py's)."""
    from _torch_cli_common import read_csv
    from mmlrec_tpu_torch.main import main

    rows = {}
    for side in ("jax", "port"):
        work = tmp_path / side
        work.mkdir()
        cfg = _cli_pair(work, task)
        monkeypatch.chdir(work)
        if side == "port":
            main(["--config", cfg, "--seed", "0", "--device", "cpu"])
        else:
            import importlib.util

            spec = importlib.util.spec_from_file_location("mmlrec_main",
                                                          os.path.join(ROOT, "main.py"))
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            monkeypatch.setattr(sys, "argv", ["main.py", "--config", cfg, "--seed", "0"])
            mod.main()
        rows[side], = read_csv(str(work / "results" / "rows.csv"))
    assert list(rows["port"]) == list(rows["jax"])
    assert rows["port"]["type"] == rows["jax"]["type"] == f"csv_{task}_sharedbottom_0"
    for side, row in rows.items():
        for k, v in row.items():
            if k.startswith(("auc", "total_auc")):
                assert 0.0 <= float(v) <= 1.0, (side, k)
            elif k.startswith("log_loss"):
                assert 0.0 < float(v) < np.inf, (side, k)
