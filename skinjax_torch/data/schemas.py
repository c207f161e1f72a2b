"""Dataset schemas (counterpart of ``skinjax/data/schemas.py``), without
pandas: the machine with the card has none, so the CSV is read with the
standard library's ``csv`` module and numpy.

``prepare_dataset`` gives the arrays skinjax's pandas path gives for the
same file, and the same featurizer JSON. For that it reproduces what pandas
does to a cell on the way:

  ``read_csv``     the default missing-value strings ("", "NA", "NaN",
                   "nan", "N/A", "NULL", "None", …) are missing; a column
                   whose other cells all parse as integers is int64 (float64
                   if one is missing), as numbers float64, as
                   True/TRUE/true/False/FALSE/false booleans; any other
                   column is strings
  cleaning         the dataset's exact-cell rules (PAD-UFES-20: missing,
                   " ", "  " and "NÃO  ENCONTRADO" → "EMPTY", "BRASIL" →
                   "BRAZIL")
  ``astype(str)``  a categorical cell renders as pandas renders it: an int
                   as "3", a float as Python's ``str`` ("3.0" in a column
                   with blanks, such as PAD-UFES-20's ``fitspatrick``), a
                   boolean as "True"
  ``to_numeric``   numerical columns parse each cell, "EMPTY" and
                   unparsable ones become -1

PAD-UFES-20 is the one schema ported so far. The other datasets raise
``NotImplementedError``: their images are JPEGs, which the card's machine
cannot decode yet (ROADMAP.md).
"""

from __future__ import annotations

import csv
import dataclasses
import os
import re
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from skinjax_torch.data.featurizer import MetadataFeaturizer

EMPTY = "EMPTY"

# pandas' default na_values (pandas._libs.parsers.STR_NA_VALUES)
NA_VALUES = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan", "1.#IND",
    "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a", "nan", "null",
})
_BOOLS = {"True": True, "TRUE": True, "true": True, "False": False, "FALSE": False,
          "false": False}
_INT = re.compile(r"\s*[+-]?[0-9]+\s*", re.ASCII)
_FLOAT = re.compile(r"\s*[+-]?([0-9]+\.?[0-9]*([eE][+-]?[0-9]+)?|\.[0-9]+([eE][+-]?[0-9]+)?"
                    r"|(?i:inf|infinity))\s*", re.ASCII)
_INT64 = (-(2 ** 63), 2 ** 63 - 1)

# A table: column name → (kind, cells). kind is "int", "float", "bool" or
# "object" (pandas' dtype); a missing cell is None until cleaning fills it.
Table = Dict[str, tuple]


@dataclasses.dataclass
class DatasetSpec:
    name: str
    label_col: str
    image_col: str
    drop_cols: Sequence[str]
    numerical_cols: Sequence[str]
    group_col: str  # patient/lesion grouping for CV splits
    clean: Callable[[Table], Table]


def _column(cells: List[Optional[str]]) -> tuple:
    """read_csv's type inference over one column of raw strings (None = missing)."""
    present = [c for c in cells if c is not None]
    if present and all(_INT.fullmatch(c) for c in present):
        ints = [int(c) for c in present]
        if all(_INT64[0] <= i <= _INT64[1] for i in ints):
            if len(present) == len(cells):
                return "int", ints
            return "float", [None if c is None else float(int(c)) for c in cells]
    if all(_FLOAT.fullmatch(c) for c in present):  # an empty column too: all missing
        return "float", [None if c is None else float(c) for c in cells]
    if present and all(c in _BOOLS for c in present):
        return ("bool" if len(present) == len(cells) else "object"), \
            [None if c is None else _BOOLS[c] for c in cells]
    return "object", cells


def read_csv(path: str) -> Table:
    """A CSV as pandas' ``read_csv`` with its defaults reads it."""
    with open(path, newline="", encoding="utf-8-sig") as f:
        rows = [r for r in csv.reader(f) if r]
    if not rows:
        raise ValueError(f"{path}: no header")
    header, body = rows[0], rows[1:]
    for i, r in enumerate(body):
        if len(r) > len(header):
            raise ValueError(f"{path}: row {i + 2} has {len(r)} fields, the header {len(header)}")
    return {name: _column([r[j] if j < len(r) and r[j] not in NA_VALUES else None
                           for r in body])
            for j, name in enumerate(header)}


def _fill_and_replace(table: Table, replace: Dict[str, str]) -> Table:
    """``fillna(EMPTY)`` then exact-cell string replacements. A float or
    boolean column with a missing cell becomes an object column."""
    out = {}
    for name, (kind, cells) in table.items():
        if any(c is None for c in cells):
            kind = "object"
        out[name] = (kind, [EMPTY if c is None else replace.get(c, c) if isinstance(c, str)
                            else c for c in cells])
    return out


def _clean_pad20(table: Table) -> Table:
    # skinLesionDatasets.py:123-128 (the reference): NaN→EMPTY, stray
    # spaces→EMPTY, "NÃO  ENCONTRADO"→EMPTY, BRASIL→BRAZIL
    return _fill_and_replace(table, {" ": EMPTY, "  ": EMPTY, "NÃO  ENCONTRADO": EMPTY,
                                     "BRASIL": "BRAZIL"})


def to_numeric(cells: Sequence) -> np.ndarray:
    """``pd.to_numeric(errors="coerce").fillna(-1)`` of a cleaned column, as float64."""
    return np.asarray([(float(c) if _FLOAT.fullmatch(c) else -1.0) if isinstance(c, str)
                       else float(c) for c in cells], np.float64)


def column_array(kind: str, cells: Sequence) -> np.ndarray:
    """A cleaned column as ``Series.to_numpy()`` gives it."""
    dtype = {"int": np.int64, "float": np.float64, "bool": np.bool_}.get(kind, object)
    return np.asarray(cells, dtype=dtype)


SPECS: Dict[str, DatasetSpec] = {
    "pad-ufes-20": DatasetSpec(
        name="pad-ufes-20",
        label_col="diagnostic",
        image_col="img_id",
        drop_cols=("patient_id", "lesion_id", "img_id", "biopsed", "diagnostic"),
        numerical_cols=("age", "diameter_1", "diameter_2"),
        group_col="patient_id",
        clean=_clean_pad20,
    ),
}


@dataclasses.dataclass
class PreparedDataset:
    """Dataset-agnostic output of a schema adapter."""

    name: str
    image_files: List[str]
    features: np.ndarray  # (N, F) float32 featurized metadata
    labels: np.ndarray  # (N,) int32
    groups: np.ndarray  # (N,) group ids for grouped CV
    class_names: List[str]
    featurizer: MetadataFeaturizer
    raw: Optional[Dict[str, np.ndarray]]  # the cleaned table, column by column

    @property
    def num_classes(self) -> int:
        return len(self.class_names)

    @property
    def feature_dim(self) -> int:
        return self.features.shape[1]


def prepare_dataset(
    dataset: str,
    metadata_csv: str,
    featurizer_path: Optional[str] = None,
) -> PreparedDataset:
    """Read and clean a CSV and featurize it under the dataset's schema. If
    ``featurizer_path`` exists it is loaded (the training feature space);
    otherwise the featurizer is fitted and, when a path is given, saved."""
    if dataset not in SPECS:
        raise NotImplementedError(
            f"dataset '{dataset}' is not ported to PyTorch yet (ported: {sorted(SPECS)}); "
            "ROADMAP.md lists when it comes")
    spec = SPECS[dataset]
    table = spec.clean(read_csv(metadata_csv))

    features_cols = [c for c in table if c not in spec.drop_cols]
    numerical = [c for c in spec.numerical_cols if c in features_cols]
    categorical = [c for c in features_cols if c not in numerical]
    # astype(str) of a cleaned cell is Python's str of its value: "3" of an
    # int, "3.0" of a float, "True" of a boolean
    feats = {c: np.asarray([str(v) for v in table[c][1]], dtype=object) for c in categorical}
    feats.update({c: to_numeric(table[c][1]) for c in numerical})
    labels_raw = np.asarray([str(v) for v in table[spec.label_col][1]])

    if featurizer_path and os.path.exists(featurizer_path):
        fz = MetadataFeaturizer.load(featurizer_path)
    else:
        fz = MetadataFeaturizer(categorical_cols=categorical,
                                numerical_cols=numerical).fit(feats, labels_raw)
        if featurizer_path:
            fz.save(featurizer_path)

    groups = (column_array(*table[spec.group_col]) if spec.group_col in table
              else np.arange(len(labels_raw)))
    return PreparedDataset(
        name=dataset,
        image_files=[str(v) for v in table[spec.image_col][1]],
        features=fz.transform(feats),
        labels=fz.label_encoder.transform(labels_raw),
        groups=groups,
        class_names=list(fz.label_encoder.classes),
        featurizer=fz,
        raw={c: column_array(*table[c]) for c in table},
    )
