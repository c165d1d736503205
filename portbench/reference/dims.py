"""A configuration's shapes, read from its file by the benchmark itself.

The reference, the weights the benchmark draws and the FLOP and byte
counts all take their sizes from here, never from the program.

A configuration file states its vocabularies under ``assumed``: either
``vocabulary_size``, the ids of every sparse slot, or
``vocabulary_sizes``, ``{column: ids}`` for every sparse slot, the scene
included.  The slots lie in the fused table one after another, in layout
order, as the program lays them out.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, field
from itertools import accumulate
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
    vocab: int  # the largest slot's ids (every slot's, with one vocabulary)
    emb: int
    heads: int
    lr: float
    moment_dtype: str
    widths: Dict[str, List[int]] = field(default_factory=dict)
    num_experts: int = 0
    #: each sparse slot's ids, in the order of ``sparse``
    vocabs: List[int] = field(default_factory=list)
    #: a copy of the configuration's ``experiment.model_config``: a family
    #: module reads any key of its own from here
    model_config: Dict = field(default_factory=dict)

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
        return sum(self.vocabs)

    @property
    def offsets(self) -> List[int]:
        """Each slot's first logical row: the cumulative sum of the
        vocabularies before it."""
        return list(accumulate(self.vocabs, initial=0))[:-1]

    @property
    def moment_bytes(self) -> int:
        return 2 if self.moment_dtype in ("bfloat16", "float16") else 4


def vocabularies(spec: Dict, sparse: List[str], scene: Optional[str]) -> List[int]:
    """Each sparse slot's ids, in the order of ``sparse``, from the file's
    ``assumed.vocabulary_sizes`` or its one ``assumed.vocabulary_size``."""
    assumed = spec["assumed"]
    if "vocabulary_sizes" not in assumed:
        return [int(assumed["vocabulary_size"])] * len(sparse)
    given = assumed["vocabulary_sizes"]
    if set(given) != set(sparse):
        raise ValueError(f"assumed.vocabulary_sizes names {sorted(given)}; the sparse slots "
                         f"are {sparse}")
    if scene:
        values = spec["experiment"]["data_config"].get("mask_values") or [0]
        if max(values) >= given[scene]:
            raise ValueError(f"the scene slot {scene!r} has {given[scene]} ids; its values "
                             f"reach {max(values)}")
    return [int(given[c]) for c in sparse]


def dims(spec: Dict) -> Dims:
    """The shapes of a configuration file's ``experiment``."""
    exp = spec["experiment"]
    mc, dc, oc = exp["model_config"], exp["data_config"], exp["optim_config"]
    sparse, scene = sparse_columns(exp)
    keys = ("bottom_dnn_hidden_units", "expert_dnn_hidden_units", "gate_dnn_hidden_units",
            "tower_dnn_hidden_units")
    vocabs = vocabularies(spec, sparse, scene)
    return Dims(
        task_name=mc["task_name"], model_name=mc["model_name"], sparse=sparse, scene=scene,
        dense=list(dc["dense_columns"]), vocab=max(vocabs),
        emb=int(mc["emb"]), heads=len(dc["label_columns"]), lr=float(oc["lr"]),
        moment_dtype=str(mc.get("table_opt_dtype") or "float32"),
        widths={k: [int(u) for u in mc.get(k, [])] for k in keys},
        num_experts=int(mc.get("num_experts", 0)), vocabs=vocabs,
        model_config=copy.deepcopy(mc))
