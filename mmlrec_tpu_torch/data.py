"""CSV -> packed arrays: the port of ``mmlrec_tpu/data.py``.

``ctrdataset`` reproduces the JAX package's function backend for backend
(reference utils/data_utils.py:14-100): the joint train + test
label-encoding space, min-max scaling of the dense columns, vocab = max +
1, the scene feature appended to the feature columns, the kuairec / iaac /
amazon_new fixups and the domain test mask, with the labels as an
explicit [N, num_label_columns] array.

Two backends, as in JAX, and they do not agree with each other on data
that is not clean (an empty cell, ``NA`` / ``null``, numbers beside
strings in one column), so each is held against its own JAX counterpart:

- ``native``: the C++ loader ``native/fast_csv.cpp`` (``native.py``), JAX's
  ``_ctrdataset_native``: an empty or unparsable dense cell reads 0.0, a
  categorical column sorts numerically when every cell parses as a number
  (an empty cell does not), else by bytes; int32 codes.
- ``pandas``: JAX's ``_ctrdataset_pandas`` (``pd.read_csv`` +
  ``LabelEncoder`` + ``MinMaxScaler``) without pandas or scikit-learn,
  which the machine with the card does not have: ``_read_csv`` reproduces
  pandas 3's C reader for these files (the default NA tokens, the type of
  each column inferred per block of rows as pandas' low-memory reader
  does, int64 / float64 / bool / strings with NaN, its float parser
  ``precise_xstrtod`` digit for digit), ``_concat`` the promotion of
  ``pd.concat``, ``_label_encode`` and ``_minmax`` the two sklearn
  transformers (NaN sorts last; a mix of strings and numbers raises
  sklearn's TypeError); int64 codes.  Where a file needs a pandas behaviour
  that the reader does not reproduce, it raises ``UnsupportedCSV`` naming
  that behaviour instead of reading something else.

``backend="auto"`` takes the native loader unless the train path names one
of the fixup datasets, and falls back to the pandas-equivalent reader when
the native one fails (``mmlrec_tpu/data.py:44-65``).  Every code path here
is host-side numpy; the arrays go to the device with the trainer's batch.
"""

from __future__ import annotations

import csv
import dataclasses
import math
import re
import warnings
from typing import Dict, List, Optional, Sequence

import numpy as np

from .config import ExperimentConfig
from .features import DenseFeat, FeatureLayout, SparseFeat

BACKENDS = ("auto", "native", "pandas")
#: train paths whose datasets take the reference's string casts
#: (utils/data_utils.py:27-39, :55-56); ``auto`` reads them with pandas
FIXUP_DATASETS = ("kuairec", "iaac", "amazon_new")
#: pandas' default NA tokens (``pandas._libs.parsers.STR_NA_VALUES``)
NA_VALUES = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan", "1.#IND",
    "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a", "nan", "null"})
_INF_WORDS = {"inf": math.inf, "+inf": math.inf, "-inf": -math.inf, "infinity": math.inf,
              "+infinity": math.inf, "-infinity": -math.inf}
_SPACE = " \t\n\v\f\r"  # C's isspace in the ASCII range
_INT_CELLS = re.compile(r"(?:[ \t\n\v\f\r]*[+-]?[0-9]+[ \t\n\v\f\r]*\x00)*")
_PLAIN_DECIMALS = re.compile(
    r"(?:[ \t\n\v\f\r]*[+-]?(?:[0-9]+\.?[0-9]*|\.[0-9]+)[ \t\n\v\f\r]*\x00)*")
_POW10 = np.array([float(f"1e{i}") for i in range(309)])


class UnsupportedCSV(ValueError):
    """The file needs a pandas behaviour that the pandas-equivalent reader
    does not reproduce; the message names it."""


def get_test_mask(domain_values, mask_values, num_domains) -> np.ndarray:
    """(reference utils/data_utils.py:96-100)"""
    dv = np.asarray(domain_values).reshape(-1, 1)
    mv = np.asarray(mask_values).reshape(1, -1)
    return (dv == mv).astype(np.float32)


@dataclasses.dataclass
class CTRDataset:
    train_input: Dict[str, np.ndarray]
    test_input: Dict[str, np.ndarray]
    y_train: np.ndarray  # [N, num_label_columns] in label_columns order
    y_test: np.ndarray
    test_mask: Optional[np.ndarray]
    feature_columns: List  # SparseFeat / DenseFeat list
    layout: FeatureLayout
    #: ``keep_frames`` on the pandas path: JAX's ``train_df`` / ``test_df``
    #: as {column: encoded values} in the frames' column order
    train_frames: Optional[Dict[str, np.ndarray]] = None
    test_frames: Optional[Dict[str, np.ndarray]] = None


def ctrdataset(config: ExperimentConfig, keep_frames: bool = False,
               backend: str = "auto") -> CTRDataset:
    """The config's train and test CSV files (paths relative to the working
    directory) as a ``CTRDataset``.  ``backend``: ``"native"`` (the C++
    loader; its failure raises), ``"pandas"`` (the pandas-equivalent
    reader) or ``"auto"`` (native unless the train path names kuairec,
    iaac or amazon_new, whose string casts change the sort order; pandas
    when native fails, as in JAX).  ``keep_frames`` keeps the encoded
    columns on the pandas path only, as JAX keeps its frames."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: one of {BACKENDS}")
    needs_fixups = any(k in config.data_config.train_dataset_path for k in FIXUP_DATASETS)
    if backend == "native" or (backend == "auto" and not needs_fixups):
        try:
            return _ctrdataset_native(config)
        except Exception as e:  # noqa: BLE001 -- JAX's rule: any failure falls back
            if backend == "native":
                raise
            print(f"native csv loader unavailable ({e}); using the pandas-equivalent reader")
    return _ctrdataset_pandas(config, keep_frames)


def _scene_features(dc) -> List[str]:
    feature_columns = list(dc.feature_columns)
    if dc.scene_feature and dc.scene_feature not in feature_columns:
        feature_columns.append(dc.scene_feature)  # reference :49-50
    return feature_columns


def _ctrdataset_native(config: ExperimentConfig) -> CTRDataset:
    """``mmlrec_tpu/data.py:68-142`` on the port's binding of the loader."""
    from .native import load_csv_columns

    dc, mc = config.data_config, config.model_config
    feature_columns = _scene_features(dc)
    dense_columns = list(dc.dense_columns)
    label_columns = list(dc.label_columns)
    mask_column = dc.mask_column
    want_mask = mc.task_name in ("msl", "mtmsl") and mask_column != ""

    cols = feature_columns + dense_columns + list(dict.fromkeys(label_columns))
    kinds = [1] * len(feature_columns) + [0] * (len(cols) - len(feature_columns))
    if want_mask and mask_column not in cols:
        cols.append(mask_column)
        kinds.append(0)
    data, vocabs, train_rows, _ = load_csv_columns(
        dc.train_dataset_path, dc.test_dataset_path, cols, kinds)

    # min-max over the joint rows with sklearn's formula x*scale + (-min*scale)
    for c in dense_columns:
        v = data[c]
        lo, hi = v.min(), v.max()
        span = hi - lo
        if span > 0:
            scale = 1.0 / span
            data[c] = v * scale + (-lo * scale)
        else:
            data[c] = np.zeros_like(v)

    fixlen = [SparseFeat(c, vocabulary_size=vocabs[c], embedding_dim=mc.emb)
              for c in feature_columns] + [DenseFeat(c, 1) for c in dense_columns]
    layout = FeatureLayout(fixlen)
    names = layout.feature_names()
    train_input = {n: data[n][:train_rows] for n in names}
    test_input = {n: data[n][train_rows:] for n in names}
    test_mask = None
    if want_mask:
        train_input[mask_column] = data[mask_column][:train_rows]
        test_input[mask_column] = data[mask_column][train_rows:]
        test_mask = get_test_mask(data[mask_column][train_rows:], dc.mask_values,
                                  dc.num_domains)
    y_all = np.stack([data[c].astype(np.float32) for c in label_columns], axis=1)
    return CTRDataset(train_input=train_input, test_input=test_input,
                      y_train=y_all[:train_rows], y_test=y_all[train_rows:],
                      test_mask=test_mask, feature_columns=fixlen, layout=layout)


def _ctrdataset_pandas(config: ExperimentConfig, keep_frames: bool = False) -> CTRDataset:
    """``mmlrec_tpu/data.py:145-233`` on the pandas-equivalent reader: each
    column a numpy array of what the frame's column holds (int64, float64,
    bool, or objects: str, int, float, bool, NaN for a missing cell)."""
    dc, mc = config.data_config, config.model_config
    all_columns = list(dc.all_columns)
    dense_columns = list(dc.dense_columns)
    label_columns = list(dc.label_columns)
    skip = set(label_columns) | set(dc.ignore_columns)
    train_path, test_path = dc.train_dataset_path, dc.test_dataset_path

    train_df = _read_csv(train_path, all_columns)
    test_df = _read_csv(test_path, all_columns)

    # dataset-specific fixups (reference utils/data_utils.py:27-39)
    if "kuairec" in train_path:
        for col in all_columns:
            if "onehot" in col:
                train_df[col] = _astype_str(train_df[col])
                test_df[col] = _astype_str(test_df[col])
        if "user_active_degree" not in train_df:
            raise KeyError("user_active_degree")
        keep = _not_equal(train_df["user_active_degree"], "0")
        train_df = {c: v[keep] for c, v in train_df.items()}
    if "iaac" in train_path:
        col = "predict_category_property"
        train_df[col] = _astype_str(train_df[col])
        test_df[col] = _astype_str(test_df[col])
        test_df = {c: v[:-2] for c, v in test_df.items()}

    train_len = len(next(iter(train_df.values())))
    df = {c: _concat(v, test_df[c]) for c, v in train_df.items()}
    feature_columns = _scene_features(dc)

    for col in all_columns:
        if col not in skip:
            if "amazon_new" in train_path:
                df[col] = _astype_str(df[col])
            df[col] = _minmax(df[col]) if col in dense_columns else _label_encode(df[col])

    fixlen = [SparseFeat(feat, vocabulary_size=int(df[feat].max()) + 1, embedding_dim=mc.emb)
              for feat in feature_columns] + [DenseFeat(feat, 1) for feat in dense_columns]
    layout = FeatureLayout(fixlen)
    train = {c: v[:train_len] for c, v in df.items()}
    test = {c: v[train_len:] for c, v in df.items()}
    names = layout.feature_names()
    train_input = {name: train[name] for name in names}
    test_input = {name: test[name] for name in names}
    test_mask = None
    mask_column = dc.mask_column
    if mc.task_name in ("msl", "mtmsl") and mask_column != "":
        train_input[mask_column] = train[mask_column]
        test_input[mask_column] = test[mask_column]
        test_mask = get_test_mask(test[mask_column], dc.mask_values, dc.num_domains)
    # labels in label_columns order (duplicates allowed)
    y_train = np.stack([train[c].astype(np.float32) for c in label_columns], axis=1)
    y_test = np.stack([test[c].astype(np.float32) for c in label_columns], axis=1)
    return CTRDataset(train_input=train_input, test_input=test_input, y_train=y_train,
                      y_test=y_test, test_mask=test_mask, feature_columns=fixlen,
                      layout=layout, train_frames=train if keep_frames else None,
                      test_frames=test if keep_frames else None)


# ---------------------------------------------------------------------------
# pd.read_csv(path, usecols=columns) for the pandas-equivalent backend
# ---------------------------------------------------------------------------

def _read_csv(path: str, usecols: Sequence[str]) -> Dict[str, np.ndarray]:
    """The columns ``usecols`` of a CSV file in the file's column order, each
    typed as ``pd.read_csv`` (pandas 3, the C reader's defaults) types it:
    RFC-4180 quoting, blank and whitespace-only lines skipped, short rows
    padded with missing cells, the type of each block of rows inferred on
    its own and the blocks joined as pandas' low-memory reader joins them."""
    with open(path, newline="", encoding="utf-8-sig") as f:
        reader = csv.reader(f)
        header = next(reader, None)
        if header is None:
            raise ValueError(f"{path}: no columns to parse from file")
        rows = [r for r in reader
                if r and not (len(r) == 1 and r[0] and not r[0].strip(" \t"))]
    width = len(header)
    missing = [c for c in usecols if c not in header]
    if missing:
        raise ValueError(f"{path}: usecols do not match columns, columns expected but not "
                         f"found: {missing}")
    if len(set(header)) != width:
        raise UnsupportedCSV(f"{path}: repeated column names (pandas renames them)")
    if any(len(r) > width for r in rows):
        raise ValueError(f"{path}: a row has more fields than the header's {width}")
    if any(len(r) < width for r in rows):
        rows = [r + [""] * (width - len(r)) for r in rows]
    # pandas' low-memory reader infers each block of rows apart
    # (TextReader.buffer_lines: the largest power of two below 2^20 / width)
    block = 1
    while block * 2 < 2 ** 20 // width:
        block *= 2
    wanted = set(usecols)
    columns = list(zip(*rows)) if rows else [()] * width
    return {name: _join_blocks([_infer(cells[i:i + block])
                                for i in range(0, max(len(cells), 1), block)])
            for name, cells in zip(header, columns) if name in wanted}


def _infer(cells: Sequence[str]) -> np.ndarray:
    """One block of a column as the C reader types it: int64 when every
    cell is an integer, else float64 (missing cells NaN), else bool (objects
    with NaN where a cell is missing), else strings with NaN."""
    n = len(cells)
    if NA_VALUES.isdisjoint(cells):
        na, vals = np.zeros(n, bool), cells
    else:
        na = np.fromiter(map(NA_VALUES.__contains__, cells), bool, n)
        if na.all():
            return np.full(n, np.nan)
        vals = [c for c, m in zip(cells, na) if not m]
    if not na.any() and _INT_CELLS.fullmatch("\x00".join(vals) + "\x00"):
        try:
            return np.fromiter(map(int, vals), np.int64, n)
        except OverflowError:
            raise UnsupportedCSV("integers outside int64 (pandas reads them as uint64 or "
                                 "Python ints)") from None
    if max(map(len, vals)) <= 15 and _PLAIN_DECIMALS.fullmatch("\x00".join(vals) + "\x00"):
        # at most 15 digits and no exponent: pandas' parser is exact up to
        # one division by a power of ten, so float() gives its bits
        floats = np.fromiter(map(float, vals), np.float64, len(vals))
    else:
        floats = _parse_floats(vals)
    if floats is not None:
        out = np.full(n, np.nan)
        out[~na] = floats
        return out
    lower = [c.lower() if c.isascii() else "" for c in vals]
    if all(c in ("true", "false") for c in lower):
        if not na.any():
            return np.array([c == "true" for c in lower])
        out = np.full(n, np.nan, object)
        out[~na] = [c == "true" for c in lower]
        return out
    out = np.full(n, np.nan, object)
    out[~na] = vals
    return out


def _parse_floats(vals: Sequence[str]) -> Optional[np.ndarray]:
    """float64 of every cell as pandas' ``precise_xstrtod`` reads it (at most
    17 significant digits accumulated in a double, then one multiply or
    divide by a power of ten; leading and trailing whitespace allowed; an
    out-of-range value fails), with ``inf`` / ``infinity`` (any case, signed)
    as the reader's fallback takes them; None when a cell is no float."""
    n = len(vals)
    chars = np.array(vals)
    width = chars.dtype.itemsize // 4
    ch = np.zeros((n, width + 1), np.uint32)  # a 0 column ends every cell
    ch[:, :width] = chars.view(np.uint32).reshape(n, width)
    LEAD, INT, FRAC, EXP, EXP_SIGN, EXP_DIGITS, TRAIL, DONE, FAIL = range(9)
    state = np.full(n, LEAD, np.int8)
    number = np.zeros(n)
    exponent = np.zeros(n, np.int64)
    n_digits = np.zeros(n, np.int64)
    neg = np.zeros(n, bool)
    exp_value = np.zeros(n, np.int64)
    exp_digits = np.zeros(n, np.int64)
    exp_neg = np.zeros(n, bool)
    space = np.zeros(128, bool)
    space[[ord(c) for c in _SPACE]] = True
    for j in range(width + 1):
        c = ch[:, j]
        is_digit = (c >= 48) & (c <= 57)
        d = c.astype(np.int64) - 48
        is_space = (c < 128) & space[np.minimum(c, 127)]
        is_end = c == 0
        is_sign = (c == 43) | (c == 45)
        is_dot = c == 46
        is_e = (c == 101) | (c == 69)
        new = np.full(n, FAIL, np.int8)
        s = state
        # leading whitespace, then a sign, a digit or the decimal point
        m = s == LEAD
        new[m & is_space] = LEAD
        neg |= m & (c == 45)
        new[m & (is_sign | is_digit)] = INT
        new[m & is_dot] = FRAC
        # digits of the integer part: past 17 they only scale the exponent
        m_int = (s == INT) | (m & is_digit)
        m_frac = (s == FRAC) & is_digit
        take = (m_int & is_digit | m_frac) & (n_digits < 17)
        number = np.where(take, number * 10.0 + d, number)
        exponent += (m_int & is_digit & ~take).astype(np.int64) - (m_frac & take)
        n_digits += take
        new[m_int & is_digit] = INT
        new[m_frac] = FRAC
        m = (s == INT) | (s == FRAC)
        new[(s == INT) & is_dot] = FRAC
        has = n_digits > 0
        new[m & is_e & has] = EXP
        new[m & is_space & has] = TRAIL
        new[m & is_end & has] = DONE
        # the exponent: a sign, then at least one digit (else the 'e' is
        # not consumed and the cell fails)
        m = s == EXP
        new[m & is_sign] = EXP_SIGN
        exp_neg |= m & (c == 45)
        m = ((s == EXP) | (s == EXP_SIGN) | (s == EXP_DIGITS)) & is_digit
        exp_value = np.where(m, exp_value * 10 + d, exp_value)
        exp_digits += m
        new[m] = EXP_DIGITS
        m = s == EXP_DIGITS
        new[m & is_space] = TRAIL
        new[m & is_end] = DONE
        m = s == TRAIL
        new[m & is_space] = TRAIL
        new[m & is_end] = DONE
        new[s == DONE] = DONE
        state = new
    if ((exp_digits > 9) & (state == DONE)).any():
        raise UnsupportedCSV("an exponent of more than 9 digits (pandas' parser overflows a C int)")
    number = np.where(neg, -number, number)
    exponent += np.where(exp_neg, -exp_value, exp_value)
    ok = (state == DONE) & (exponent <= 308)
    e = np.clip(exponent, -616, 308)
    with np.errstate(over="ignore"):
        out = np.where(e > 0, number * _POW10[np.clip(e, 0, 308)],
                       number / _POW10[np.clip(-e, 0, 308)])
        sub = (e < -308) & (exponent >= -616)
        out[sub] = number[sub] / _POW10[-308 - e[sub]] / _POW10[308]
    out[exponent < -616] = 0.0
    ok &= ~np.isinf(out)
    if not ok.all():
        for i in np.flatnonzero(~ok):
            word = vals[i].lower() if vals[i].isascii() else ""
            if word not in _INF_WORDS:
                return None
            out[i] = _INF_WORDS[word]
    return out


def _join_blocks(parts: List[np.ndarray]) -> np.ndarray:
    """The blocks of one column joined as pandas' ``_concatenate_chunks``
    joins them: numbers promote to float64 where one block is float, equal
    types stay, any other mix becomes objects."""
    kinds = {p.dtype.kind for p in parts}
    if len(kinds) == 1 or kinds == {"i", "f"}:
        return np.concatenate(parts)
    return np.concatenate([p.astype(object) for p in parts])


def _concat(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """One column of ``pd.concat([train_df, test_df])`` (pandas 3): equal
    types stay; int64 with float64, and float64 followed by bool, give
    float64; bool beside int64 gives int64; bool followed by float64, and
    anything beside objects, give objects."""
    kinds = (a.dtype.kind, b.dtype.kind)
    if "O" in kinds or kinds == ("b", "f"):
        return np.concatenate([a.astype(object), b.astype(object)])
    return np.concatenate([a, b])


def _is_nan(v) -> bool:
    return isinstance(v, float) and v != v


def _astype_str(col: np.ndarray) -> np.ndarray:
    """``Series.astype(str)`` in pandas 3: ``str()`` of every value, a
    missing value kept missing (pandas 2 wrote ``"nan"``)."""
    return np.array([np.nan if _is_nan(v) else str(v) for v in col.tolist()], object)


def _not_equal(col: np.ndarray, value: str) -> np.ndarray:
    """``series != value`` for a string ``value``: every row of a numeric or
    bool column (no number equals a string), elementwise for objects."""
    if col.dtype.kind != "O":
        return np.ones(len(col), bool)
    return np.array([v != value for v in col.tolist()], bool)


def _minmax(col: np.ndarray) -> np.ndarray:
    """``MinMaxScaler().fit_transform`` of one column (scikit-learn 1.9):
    float64, NaN ignored by the min and max and kept, a span below 10 eps
    scaled by 1, then ``X * scale_ + min_``."""
    x = np.array(col, dtype=np.float64)  # objects through float(), as sklearn converts
    if np.isinf(x).any():
        raise ValueError("Input X contains infinity or a value too large for dtype('float64').")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)  # an all-NaN column
        lo, hi = np.nanmin(x, axis=0), np.nanmax(x, axis=0)
    span = np.asarray(hi - lo)
    span[span < 10 * np.finfo(np.float64).eps] = 1.0
    scale = 1 / span
    x *= scale
    x += 0 - lo * scale
    return x


def _label_encode(col: np.ndarray) -> np.ndarray:
    """``LabelEncoder().fit_transform`` of one column (scikit-learn 1.9):
    int64 codes of the sorted unique values, a missing value after all
    others; objects are sorted as Python values, and strings beside numbers
    raise sklearn's TypeError."""
    if col.dtype.kind != "O":
        uniques, codes = np.unique(col, return_inverse=True)
        if uniques.size and _is_nan(float(uniques[-1])):
            nan_idx = np.searchsorted(uniques, np.nan)
            codes[codes > nan_idx] = nan_idx
        return codes.reshape(-1).astype(np.int64)
    values = col.tolist()
    try:
        present = {v for v in set(values) if not _is_nan(v)}
        uniques = sorted(present)
    except TypeError:
        types = sorted(t.__qualname__ for t in {type(v) for v in values})
        raise TypeError("Encoders require their input argument must be uniformly strings or "
                        f"numbers. Got {types}") from None
    table = {v: i for i, v in enumerate(uniques)}
    nan_code = len(uniques)
    return np.array([nan_code if _is_nan(v) else table[v] for v in values], np.int64)
