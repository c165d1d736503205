"""Helpers of the CSV data pipeline's tests (tests/test_torch_data.py,
test_torch_isolation.py, test_torch_cli.py): CSV pairs the test writes
itself, one raw config for both packages, and a bitwise comparison of two
datasets."""

import copy
import csv
import os

import numpy as np


def write_csv(path, header, rows) -> str:
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(header)
        w.writerows(rows)
    return str(path)


def write_pair(tmp_path, prefix, header, train_rows, test_rows):
    """``<prefix>train.csv`` and ``<prefix>test.csv`` in ``tmp_path``: the
    prefix decides which fixups the path rule applies."""
    return (write_csv(os.path.join(str(tmp_path), f"{prefix}train.csv"), header, train_rows),
            write_csv(os.path.join(str(tmp_path), f"{prefix}test.csv"), header, test_rows))


def raw_config(train_p, test_p, all_columns, features, dense=(), labels=("label", "label"),
               task="msl", scene="scene", ignore=(), emb=4, extra_data=None):
    """A config dict of the reference's schema over the CSV pair; msl takes
    ``scene`` as mask column and scene feature with two domains."""
    dc = {"data_name": "csv", "train_dataset_path": train_p, "test_dataset_path": test_p,
          "all_columns": list(all_columns), "feature_columns": list(features),
          "dense_columns": list(dense), "ignore_columns": list(ignore),
          "label_columns": list(labels)}
    if task in ("msl", "mtmsl"):
        dc.update(num_domains=2, mask_values=[0, 1], mask_column=scene, scene_feature=scene)
    dc.update(extra_data or {})
    n_heads = len(labels)
    return {"data_config": dc,
            "model_config": {"task_name": task, "model_name": "mmoe", "emb": emb,
                             "task_names": [f"t{i}" for i in range(n_heads)],
                             "task_types": ["binary"] * n_heads},
            "optim_config": {}, "training_config": {}, "save_config": {}}


def configs(raw):
    """(the port's ExperimentConfig, the JAX package's) of one raw dict."""
    from mmlrec_tpu.config import ExperimentConfig as JaxConfig
    from mmlrec_tpu_torch.config import ExperimentConfig

    return (ExperimentConfig.from_dict(copy.deepcopy(raw)),
            JaxConfig.from_dict(copy.deepcopy(raw)))


def _cells(a):
    """An array as comparable cells: its dtype and bytes, or for objects
    each value with its type (NaN as one token)."""
    a = np.asarray(a)
    if a.dtype == object:
        return [("nan",) if isinstance(v, float) and v != v else (type(v).__name__, v)
                for v in a.tolist()]
    return a.dtype.str, a.shape, a.tobytes()


def assert_same_array(got, want, what=""):
    """Bitwise: the same dtype and bytes (NaN payloads and -0.0 included);
    object arrays value by value with their types."""
    assert _cells(got) == _cells(want), what


def vocabs(ds):
    return {s.feature.name: s.feature.vocabulary_size for s in ds.layout.sparse_slots}


def assert_same_dataset(port, jax):
    """The port's dataset equals the JAX package's bitwise: every input
    column in the same order, the labels, the test mask, the vocabs."""
    assert vocabs(port) == vocabs(jax)
    assert port.layout.feature_names() == jax.layout.feature_names()
    for split in ("train_input", "test_input"):
        a, b = getattr(port, split), getattr(jax, split)
        assert list(a) == list(b), split
        for name in a:
            assert_same_array(a[name], b[name], f"{split} {name}")
    assert_same_array(port.y_train, jax.y_train, "y_train")
    assert_same_array(port.y_test, jax.y_test, "y_test")
    assert (port.test_mask is None) == (jax.test_mask is None)
    if jax.test_mask is not None:
        assert_same_array(port.test_mask, jax.test_mask, "test_mask")
