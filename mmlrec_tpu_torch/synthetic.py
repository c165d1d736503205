"""Synthetic dataset + config factory for tests and benchmarks.

The reference benchmark's datasets are external downloads (reference
README.md:31-43); tests and benches here synthesize data with the same
schema shapes.  ``aliexpress_like`` mirrors the AliExpress MSL config
(configs_msl/config_AE.json: 16 sparse + 61 dense features, 2 domains),
the flagship benchmark in BASELINE.json.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from .config import ExperimentConfig
from .features import DenseFeat, FeatureLayout, SparseFeat


def _merged_model_config(overrides, **base):
    base.update(overrides)
    return base


def make_config(
    task_name: str = "mtl",
    model_name: str = "mmoe",
    num_tasks: int = 2,
    num_domains: int = 2,
    emb: int = 8,
    n_sparse: int = 8,
    vocab: int = 100,
    n_dense: int = 4,
    hidden=(64, 32),
    tower=(16,),
    gate=(16,),
    lr: float = 1e-3,
    epochs: int = 2,
    batch_size: int = 256,
    **model_overrides,
) -> ExperimentConfig:
    sparse_names = [f"s{i}" for i in range(n_sparse)]
    dense_names = [f"d{i}" for i in range(n_dense)]
    if task_name == "mtl":
        label_columns = [f"label{i}" for i in range(num_tasks)]
        task_names = ["ctr"] * num_tasks
    elif task_name == "msl":
        label_columns = ["label"] * num_domains
        task_names = ["ctr"] * num_domains
    else:  # mtmsl: T base tasks x D domains, task-major
        base = num_tasks // num_domains
        label_columns = [
            f"label{t}" for t in range(base) for _ in range(num_domains)
        ]
        task_names = ["ctr"] * num_tasks
    n_heads = num_domains if task_name == "msl" else num_tasks
    raw = {
        "data_config": {
            "data_name": "synthetic",
            "all_columns": sparse_names + dense_names + sorted(set(label_columns)),
            "feature_columns": sparse_names,
            "dense_columns": dense_names,
            "label_columns": label_columns,
            "num_domains": num_domains,
            "mask_values": list(range(num_domains)) if task_name != "mtl" else [],
            "mask_column": "s0" if task_name != "mtl" else "",
            "scene_feature": "s0" if task_name != "mtl" else "s0",
        },
        "model_config": _merged_model_config(
            model_overrides,
            task_name=task_name,
            model_name=model_name,
            task="binary",
            task_names=task_names,
            task_types=["binary"] * n_heads,
            emb=emb,
            num_experts=4,
            shared_expert_num=2,
            specific_expert_num=3,
            num_levels=2,
            expert_dnn_hidden_units=list(hidden),
            dnn_hidden_units=list(hidden),
            bottom_dnn_hidden_units=list(hidden),
            gate_dnn_hidden_units=list(gate),
            tower_dnn_hidden_units=list(tower),
            task_weight_hidden_units=list(gate),
            l2_reg_linear=0.0,
            l2_reg_embedding=0.0,
            l2_reg_dnn=0.0,
            dnn_use_bn=False,
            dnn_dropout=0.0,
            dnn_activation="relu",
            use_cka_loss=False,
        ),
        "optim_config": {
            "lr": lr,
            "optimizer": "adam",
            "loss": ["binary_crossentropy"] * n_heads,
            "metrics": ["auc", "acc"],
            "early_stop": 3,
        },
        "training_config": {
            "train_batch_size": batch_size,
            "test_batch_size": batch_size,
            "epochs": epochs,
        },
        "save_config": {"save": False, "save_layer_output": False},
    }
    return ExperimentConfig.from_dict(raw)


def make_data(
    cfg: ExperimentConfig,
    n: int = 2048,
    vocab: int = 100,
    seed: int = 0,
) -> Tuple[FeatureLayout, Dict[str, np.ndarray], np.ndarray, Optional[np.ndarray]]:
    """Returns (layout, input_dict, y [N, num_label_cols], test_mask)."""
    rng = np.random.default_rng(seed)
    dc, mc = cfg.data_config, cfg.model_config
    feature_columns = list(dc.feature_columns)
    # reference appends scene_feature to the feature list (data_utils.py:49-50)
    if dc.scene_feature and dc.scene_feature not in feature_columns:
        feature_columns.append(dc.scene_feature)
    cols = [SparseFeat(f, vocab, mc.emb) for f in feature_columns] + [
        DenseFeat(f, 1) for f in dc.dense_columns
    ]
    layout = FeatureLayout(cols)
    x: Dict[str, np.ndarray] = {}
    for f in feature_columns:
        if f == dc.mask_column and mc.task_name != "mtl":
            x[f] = rng.integers(0, dc.num_domains, n)
        else:
            x[f] = rng.integers(0, vocab, n)
    if dc.mask_column and dc.mask_column not in x and mc.task_name != "mtl":
        x[dc.mask_column] = rng.integers(0, dc.num_domains, n)
    for f in dc.dense_columns:
        x[f] = rng.random(n).astype(np.float32)
    # labels correlated with features so AUC is learnable
    signal = (x[dc.feature_columns[0]] % 7) / 7.0 + sum(
        x[f] for f in dc.dense_columns[:2]
    ) * (0.5 if dc.dense_columns else 0.0)
    base_labels = {}
    for name in dict.fromkeys(dc.label_columns):
        noise = rng.random(n)
        base_labels[name] = (
            (signal + noise * 1.5) > np.median(signal + 0.75)
        ).astype(np.float32)
    y = np.stack([base_labels[c] for c in dc.label_columns], axis=1)
    test_mask = None
    if mc.task_name in ("msl", "mtmsl") and dc.mask_column:
        from .data import get_test_mask

        test_mask = get_test_mask(x[dc.mask_column], dc.mask_values, dc.num_domains)
    return layout, x, y, test_mask


def aliexpress_like_config(model_name: str = "mmoe", **kw) -> ExperimentConfig:
    """Flagship benchmark shape (configs_msl/config_AE.json): 16 sparse (emb 8)
    + 61 dense features, 2 domains, MSL."""
    defaults = dict(
        task_name="msl",
        num_domains=2,
        emb=8,
        n_sparse=16,
        n_dense=61,
        hidden=(256, 128),
        tower=(64,),
        gate=(64,),
        batch_size=4096,
    )
    defaults.update(kw)
    return make_config(model_name=model_name, **defaults)
