"""Tabular (index-encoded) metadata for the TabTransformer tower (a numpy
copy of ``skinjax/data/tabular.py``, built on the port's featurizer).

The one-hot featurizer serves the MLP towers; TabTransformer takes per-column
categorical indices plus scaled numerics instead. The index encoding comes
from the same persisted featurizer vocabulary, so both paths share one
category space and one rule for unknown categories.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from skinjax_torch.data.featurizer import MetadataFeaturizer


def index_encode(featurizer: MetadataFeaturizer, table: Dict[str, np.ndarray]
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """(categorical indices (N, n_cat) int32, numerics (N, n_num) float32).
    An unknown category maps to its column's last index, one past the
    known ones (the embedding table's analogue of handle_unknown='ignore')."""
    n = len(next(iter(table.values()))) if table else 0
    cats = np.zeros((n, len(featurizer.categorical_cols)), dtype=np.int32)
    for ci, (col, categories) in enumerate(zip(featurizer.categorical_cols,
                                               featurizer.ohe.categories)):
        lookup = {c: i for i, c in enumerate(categories)}
        unknown = len(categories)
        cats[:, ci] = [lookup.get(str(v), unknown) for v in table[col]]
    if featurizer.numerical_cols:
        num = np.stack([np.asarray(table[c], dtype=np.float64)
                        for c in featurizer.numerical_cols], axis=1)
        num = (featurizer.scaler.transform(num)
               if featurizer.scale_numerics and featurizer.scaler.mean is not None
               else num.astype(np.float32))
    else:
        num = np.zeros((n, 0), dtype=np.float32)
    return cats, num.astype(np.float32)


def cardinalities(featurizer: MetadataFeaturizer) -> Tuple[int, ...]:
    """Each column's embedding-table size: its categories + 1 for unknowns."""
    return tuple(len(c) + 1 for c in featurizer.ohe.categories)


class TabularSource:
    """Images (an (N, H, W, 3) uint8 array, or an ``ImageStore`` and file
    names) + index-encoded metadata + labels. A batch's metadata is the dict
    ``{"categorical": int32 (B, n_cat), "numerical": float32 (B, n_num)}``
    that the tabular input mode takes."""

    def __init__(self, images_or_store, image_files, categorical: np.ndarray,
                 numerical: np.ndarray, labels: np.ndarray):
        self._store = None
        self._images = None
        if isinstance(images_or_store, np.ndarray):
            self._images = images_or_store
        else:
            self._store = images_or_store
            self._files = list(image_files)
        self.categorical = categorical.astype(np.int32)
        self.numerical = numerical.astype(np.float32)
        self.labels = labels.astype(np.int32)

    @classmethod
    def from_prepared(cls, prepared, images_or_store, image_files=None):
        """From a ``PreparedDataset`` (its cleaned table and featurizer). The
        numeric columns are coerced as the featurizer's inputs are
        (``schemas.to_numeric``: a missing cell, ``EMPTY`` in the cleaned
        table, is -1); skinjax passes the cleaned cells as they are, which
        fails on PAD-UFES-20's missing numerics."""
        from skinjax_torch.data.schemas import to_numeric

        fz = prepared.featurizer
        table = {c: np.asarray(prepared.raw[c]) for c in fz.categorical_cols}
        table.update({c: to_numeric(prepared.raw[c]) for c in fz.numerical_cols})
        cats, nums = index_encode(fz, table)
        return cls(images_or_store, image_files or prepared.image_files, cats, nums,
                   prepared.labels)

    def __len__(self):
        return len(self.labels)

    def batch(self, idx: np.ndarray) -> Dict[str, object]:
        idx = np.asarray(idx)
        if self._images is not None:
            imgs = self._images[idx]
        else:
            imgs = self._store.gather([self._files[i] for i in idx])
        return {
            "image": imgs,
            "metadata": {"categorical": self.categorical[idx],
                         "numerical": self.numerical[idx]},
            "label": self.labels[idx],
        }
