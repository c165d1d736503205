"""Feature-column schema and packed input layout.

TPU-native re-design of the reference's DeepCTR-style feature columns
(reference: model/utils.py:328-431).  Differences from the reference:

* The reference packs every feature into ONE dense float matrix and casts
  sparse columns back to ``long`` at lookup time (model/utils.py:407-431,
  basemodel.py:475-477).  Casting float->int loses precision for large
  vocabularies and forces a host-side concat.  Here the layout keeps two
  packed device arrays instead:

    - ``ids``   : int32   [B, n_sparse_slots]   (sparse + varlen slots)
    - ``dense`` : float32 [B, n_dense_dims]

* Sparse features additionally get a *fused-table offset* so that all
  embedding tables with a common dim can live in one ``[total_vocab, D]``
  array and be fetched with a single gather (see ops/embedding.py).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple, Union

DEFAULT_GROUP_NAME = "default_group"


@dataclasses.dataclass(frozen=True)
class SparseFeat:
    """Categorical feature. Mirrors reference model/utils.py:328-346."""

    name: str
    vocabulary_size: int
    embedding_dim: Union[int, str] = 4
    dtype: str = "int32"
    embedding_name: Optional[str] = None
    group_name: str = DEFAULT_GROUP_NAME

    def __post_init__(self):
        if self.embedding_name is None:
            object.__setattr__(self, "embedding_name", self.name)
        if self.embedding_dim == "auto":
            # reference model/utils.py:337-338
            object.__setattr__(
                self, "embedding_dim", 6 * int(math.pow(self.vocabulary_size, 0.25))
            )


@dataclasses.dataclass(frozen=True)
class DenseFeat:
    """Numeric feature. Mirrors reference model/utils.py:388-395."""

    name: str
    dimension: int = 1
    dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class VarLenSparseFeat:
    """Variable-length categorical feature (behaviour sequence).

    Mirrors reference model/utils.py:349-385.  ``combiner`` in
    {sum, mean, max}; ``length_name`` optionally points at a companion
    length column, otherwise 0-padding defines the mask.
    """

    sparsefeat: SparseFeat
    maxlen: int
    combiner: str = "mean"
    length_name: Optional[str] = None

    @property
    def name(self) -> str:
        return self.sparsefeat.name

    @property
    def vocabulary_size(self) -> int:
        return self.sparsefeat.vocabulary_size

    @property
    def embedding_dim(self) -> int:
        return self.sparsefeat.embedding_dim

    @property
    def embedding_name(self) -> str:
        return self.sparsefeat.embedding_name

    @property
    def group_name(self) -> str:
        return self.sparsefeat.group_name


FeatureColumn = Union[SparseFeat, DenseFeat, VarLenSparseFeat]


@dataclasses.dataclass(frozen=True)
class _SparseSlot:
    feature: SparseFeat
    start: int  # column span in the packed ids array
    end: int


@dataclasses.dataclass(frozen=True)
class _VarLenSlot:
    feature: VarLenSparseFeat
    start: int
    end: int
    length_slot: Optional[int]  # column in ids holding the length, if any


@dataclasses.dataclass(frozen=True)
class _DenseSlot:
    feature: DenseFeat
    start: int
    end: int


class FeatureLayout:
    """Packed layout of a list of feature columns.

    Equivalent role to the reference's ``build_input_features``
    (model/utils.py:407-431) but with separate int/float spaces, and with
    fused-embedding bookkeeping.

    Column order within each space follows first occurrence in
    ``feature_columns`` (duplicates by name are skipped, like the
    reference).
    """

    def __init__(self, feature_columns: Sequence[FeatureColumn]):
        self.feature_columns = list(feature_columns)
        self.sparse_slots: List[_SparseSlot] = []
        self.varlen_slots: List[_VarLenSlot] = []
        self.dense_slots: List[_DenseSlot] = []
        self._by_name: Dict[str, object] = {}

        # Sparse slots take the LEADING id columns (then varlen spans), in
        # first-occurrence order, regardless of how sparse/varlen interleave
        # in feature_columns: this is the order Trainer.pack_inputs packs and
        # the contract ``ids[:, :n_sparse]`` sites rely on (models/base.py).
        id_cursor = 0
        dense_cursor = 0
        seen = set()
        deferred_varlen: List[VarLenSparseFeat] = []
        for feat in self.feature_columns:
            if feat.name in seen:
                continue
            seen.add(feat.name)
            if isinstance(feat, SparseFeat):
                slot = _SparseSlot(feat, id_cursor, id_cursor + 1)
                id_cursor += 1
                self.sparse_slots.append(slot)
                self._by_name[feat.name] = slot
            elif isinstance(feat, DenseFeat):
                slot = _DenseSlot(feat, dense_cursor, dense_cursor + feat.dimension)
                dense_cursor += feat.dimension
                self.dense_slots.append(slot)
                self._by_name[feat.name] = slot
            elif isinstance(feat, VarLenSparseFeat):
                deferred_varlen.append(feat)
            else:
                raise TypeError(f"Invalid feature column type: {type(feat)}")
        for feat in deferred_varlen:
            length_slot = None
            start = id_cursor
            id_cursor += feat.maxlen
            if feat.length_name is not None and feat.length_name not in seen:
                seen.add(feat.length_name)
                length_slot = id_cursor
                id_cursor += 1
            slot = _VarLenSlot(feat, start, start + feat.maxlen, length_slot)
            self.varlen_slots.append(slot)
            self._by_name[feat.name] = slot

        self.num_id_slots = id_cursor
        self.num_dense_dims = dense_cursor

        # Fused-embedding bookkeeping: group sparse/varlen features that share
        # an embedding dim into one table with per-feature row offsets.
        self.embedding_specs: Dict[str, Tuple[int, int]] = {}  # name -> (vocab, dim)
        for slot in self.sparse_slots:
            f = slot.feature
            self.embedding_specs.setdefault(
                f.embedding_name, (f.vocabulary_size, int(f.embedding_dim))
            )
        for slot in self.varlen_slots:
            f = slot.feature
            self.embedding_specs.setdefault(
                f.embedding_name, (f.vocabulary_size, int(f.embedding_dim))
            )

    # ------------------------------------------------------------------
    @property
    def input_dim(self) -> int:
        """Flattened DNN input width (reference basemodel.py:489-507)."""
        sparse_dim = sum(int(s.feature.embedding_dim) for s in self.sparse_slots)
        varlen_dim = sum(int(s.feature.embedding_dim) for s in self.varlen_slots)
        return sparse_dim + varlen_dim + self.num_dense_dims

    def sparse_feature_index(self, name: str) -> int:
        """Position of a sparse feature among sparse slots (for scene embs)."""
        for i, slot in enumerate(self.sparse_slots):
            if slot.feature.name == name:
                return i
        raise KeyError(name)

    def feature_names(self) -> List[str]:
        names = [s.feature.name for s in self.sparse_slots]
        names += [s.feature.name for s in self.varlen_slots]
        names += [s.feature.name for s in self.dense_slots]
        return names

    def uniform_embedding_dim(self) -> Optional[int]:
        dims = {dim for _, dim in self.embedding_specs.values()}
        if len(dims) == 1:
            return dims.pop()
        return None


def get_feature_names(feature_columns: Sequence[FeatureColumn]) -> List[str]:
    return FeatureLayout(feature_columns).feature_names()
