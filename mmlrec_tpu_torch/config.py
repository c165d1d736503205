"""Typed experiment configuration.

Parses the reference's JSON config files *unchanged* (the 12 files under
configs_mtl/, configs_msl/, configs_mtmsl/ are the compatibility contract;
see reference utils/data_utils.py:102-111 for the loader and main.py:90-104
for how sections are consumed).  Every key the reference reads is mapped to
a typed field; keys the reference silently ignores (loss_weights,
weight_decay, decay_step, gamma, max_steps, val_batch_size, save/save_path)
are retained and — unlike the reference — validated and, where sensible,
honored (checkpointing honors save/save_path).
"""

from __future__ import annotations

import dataclasses
import json
import os
import pickle
from typing import Any, Dict, List, Optional

import numpy as np


def unserialize(path: str):
    """Load json / npy / pickle by extension (reference utils/data_utils.py:102-111)."""
    suffix = os.path.basename(path).split(".")[-1]
    if suffix == "ny" or suffix == "npy":
        return np.load(path)
    if suffix == "json":
        with open(path, "r") as f:
            return json.load(f)
    with open(path, "rb") as f:
        return pickle.load(f)


@dataclasses.dataclass
class DataConfig:
    data_name: str = ""
    train_dataset_path: str = ""
    test_dataset_path: str = ""
    test_result_path: str = ""
    layer_output_path: str = ""
    all_columns: List[str] = dataclasses.field(default_factory=list)
    feature_columns: List[str] = dataclasses.field(default_factory=list)
    dense_columns: List[str] = dataclasses.field(default_factory=list)
    ignore_columns: List[str] = dataclasses.field(default_factory=list)
    label_columns: List[str] = dataclasses.field(default_factory=lambda: ["label"])
    sample: str = "random"
    num_domains: int = 1
    mask_values: List[Any] = dataclasses.field(default_factory=list)
    mask_column: str = ""
    scene_feature: str = ""
    user_sf: str = ""
    item_sf: str = ""
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class ModelConfig:
    task_name: str = "mtl"  # mtl | msl | mtmsl
    model_name: str = "sharedbottom"
    task: str = "binary"
    task_names: List[str] = dataclasses.field(default_factory=lambda: ["ctr", "ctcvr"])
    task_types: List[str] = dataclasses.field(default_factory=lambda: ["binary", "binary"])
    emb: int = 4
    num_experts: int = 4
    shared_expert_num: int = 1
    specific_expert_num: int = 3
    num_levels: int = 1
    expert_dnn_hidden_units: List[int] = dataclasses.field(default_factory=lambda: [256, 128])
    dnn_hidden_units: List[int] = dataclasses.field(default_factory=lambda: [256, 128])
    bottom_dnn_hidden_units: List[int] = dataclasses.field(default_factory=lambda: [256, 128])
    gate_dnn_hidden_units: List[int] = dataclasses.field(default_factory=lambda: [64])
    tower_dnn_hidden_units: List[int] = dataclasses.field(default_factory=lambda: [64])
    task_weight_hidden_units: List[int] = dataclasses.field(default_factory=lambda: [64])
    shared_hidden_unit: int = 256
    l2_reg_linear: float = 1e-5
    l2_reg_embedding: float = 1e-5
    l2_reg_dnn: float = 0.0
    dnn_use_bn: bool = False
    dnn_dropout: float = 0.0
    dnn_activation: str = "relu"
    use_cka_loss: bool = False
    use_shared: bool = True  # STAR
    loss_weights: Optional[List[float]] = None
    # --- TPU-framework additions (absent from reference configs; defaults
    # reproduce the reference's *effective* runtime behaviour) ---
    # The reference's always-true conditional bug nulls domain_mask before
    # every train step (basemodel.py:265-266), so MSL/MTMSL train unmasked.
    # Set True for the *intended* masked-loss semantics (basemodel.py:273-282).
    masked_loss: bool = False
    # DomainBatchNorm: 'reference' = whole-batch stats + per-domain affine in
    # training (the reference's effective F.batch_norm(training=True) path,
    # model/utils.py:581-606); 'intended' = per-domain masked batch stats.
    domain_bn_mode: str = "reference"
    # Reproduce the reference's unregistered-parameter bugs (frozen STAR
    # specific weights for domains < D-1, frozen SNR/MSSM routing params;
    # SURVEY §2.4.2) via stop_gradient when True.
    ref_faithful_frozen_params: bool = False
    compute_dtype: str = "float32"  # or "bfloat16" for the matmul path
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class OptimConfig:
    lr: float = 1e-3
    optimizer: str = "adagrad"
    loss: List[str] = dataclasses.field(
        default_factory=lambda: ["binary_crossentropy", "binary_crossentropy"]
    )
    metrics: List[str] = dataclasses.field(default_factory=lambda: ["auc", "acc"])
    weight_decay: float = 0.0
    decay_step: int = 0
    gamma: float = 1.0
    early_stop: int = 3
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class TrainingConfig:
    train_batch_size: int = 4096
    val_batch_size: int = 4096
    test_batch_size: int = 4096
    epochs: int = 10
    max_steps: int = 0
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class SaveConfig:
    save: bool = False
    save_path: str = "./checkpoint/"
    save_layer_output: bool = False
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)


_SECTION_TYPES = {
    "data_config": DataConfig,
    "model_config": ModelConfig,
    "optim_config": OptimConfig,
    "training_config": TrainingConfig,
    "save_config": SaveConfig,
}


def _build_section(cls, raw: Dict[str, Any]):
    field_names = {f.name for f in dataclasses.fields(cls)}
    known = {k: v for k, v in raw.items() if k in field_names and k != "extra"}
    extra = {k: v for k, v in raw.items() if k not in field_names}
    obj = cls(**known)
    obj.extra = extra
    return obj


@dataclasses.dataclass
class ExperimentConfig:
    data_config: DataConfig
    model_config: ModelConfig
    optim_config: OptimConfig
    training_config: TrainingConfig
    save_config: SaveConfig

    @classmethod
    def from_dict(cls, raw: Dict[str, Any]) -> "ExperimentConfig":
        sections = {}
        for key, typ in _SECTION_TYPES.items():
            sections[key] = _build_section(typ, raw.get(key, {}))
        cfg = cls(**sections)
        cfg.validate()
        return cfg

    @classmethod
    def from_file(cls, path: str) -> "ExperimentConfig":
        return cls.from_dict(unserialize(path))

    def validate(self) -> None:
        mc, dc = self.model_config, self.data_config
        if mc.task_name not in ("mtl", "msl", "mtmsl"):
            raise ValueError(f"task_name must be mtl/msl/mtmsl, got {mc.task_name!r}")
        if mc.task_name in ("msl", "mtmsl"):
            if dc.mask_column and len(dc.mask_values) != dc.num_domains:
                raise ValueError(
                    "len(mask_values) must equal num_domains "
                    f"({len(dc.mask_values)} != {dc.num_domains})"
                )
        for t in mc.task_types:
            if t not in ("binary", "regression"):
                raise ValueError(f"task type must be binary or regression, got {t!r}")

    # Mirror of reference basemodel.py:96-102.
    @property
    def num_tasks(self) -> int:
        mc, dc = self.model_config, self.data_config
        if mc.task_name == "msl":
            return dc.num_domains
        if mc.task_name == "mtmsl":
            return len(dc.label_columns)
        return len(mc.task_names)

    # Reference main.py:101: targets are the de-duplicated label columns.
    # NOTE: the reference uses list(set(...)) whose order is arbitrary for
    # >1 distinct label; we keep first-occurrence order (deterministic).
    @property
    def target_columns(self) -> List[str]:
        seen, out = set(), []
        for c in self.data_config.label_columns:
            if c not in seen:
                seen.add(c)
                out.append(c)
        return out

    def to_dict(self) -> Dict[str, Any]:
        def section(obj):
            d = {k: v for k, v in dataclasses.asdict(obj).items() if k != "extra"}
            d.update(obj.extra)
            return d

        return {k: section(getattr(self, k)) for k in _SECTION_TYPES}
