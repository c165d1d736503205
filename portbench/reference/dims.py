"""A configuration's shapes, read from its file by the benchmark itself.

The reference, the weights the benchmark draws and the FLOP and byte
counts all take their sizes from here, never from the program.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ..traffic.gen import sparse_columns

#: Adam's constants (optax.adam's defaults, which the reference MMLRec's
#: torch.optim.Adam shares)
B1, B2, EPS = 0.9, 0.999, 1e-8


@dataclass
class Dims:
    task_name: str
    model_name: str
    sparse: List[str]
    scene: Optional[str]
    dense: List[str]
    vocab: int
    emb: int
    heads: int
    lr: float
    moment_dtype: str
    widths: Dict[str, List[int]] = field(default_factory=dict)
    num_experts: int = 0

    @property
    def n_sparse(self) -> int:
        return len(self.sparse)

    @property
    def n_dense(self) -> int:
        return len(self.dense)

    @property
    def input_dim(self) -> int:
        return self.n_sparse * self.emb + self.n_dense

    @property
    def logical_rows(self) -> int:
        return self.n_sparse * self.vocab

    @property
    def offsets(self) -> List[int]:
        return [i * self.vocab for i in range(self.n_sparse)]

    @property
    def moment_bytes(self) -> int:
        return 2 if self.moment_dtype in ("bfloat16", "float16") else 4


def dims(spec: Dict) -> Dims:
    """The shapes of a configuration file's ``experiment``."""
    exp = spec["experiment"]
    mc, dc, oc = exp["model_config"], exp["data_config"], exp["optim_config"]
    sparse, scene = sparse_columns(exp)
    keys = ("bottom_dnn_hidden_units", "expert_dnn_hidden_units", "gate_dnn_hidden_units",
            "tower_dnn_hidden_units")
    return Dims(
        task_name=mc["task_name"], model_name=mc["model_name"], sparse=sparse, scene=scene,
        dense=list(dc["dense_columns"]), vocab=int(spec["assumed"]["vocabulary_size"]),
        emb=int(mc["emb"]), heads=len(dc["label_columns"]), lr=float(oc["lr"]),
        moment_dtype=str(mc.get("table_opt_dtype") or "float32"),
        widths={k: [int(u) for u in mc.get(k, [])] for k in keys},
        num_experts=int(mc.get("num_experts", 0)))
