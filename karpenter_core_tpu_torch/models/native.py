"""Row grouping for the columnar ingestion path (models.columnar), numpy only.

The reference package binds a C++ runtime library here through ctypes; this
port keeps the numpy path, which computes the same grouping (first-seen class
order) with batch operations.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def group_rows(matrix: np.ndarray) -> Tuple[np.ndarray, int]:
    """(class_ids i64[n], n_classes): group identical rows of a u64 matrix,
    classes numbered in first-seen order."""
    matrix = np.ascontiguousarray(matrix, dtype=np.uint64)
    _, first_idx, inverse = np.unique(
        matrix, axis=0, return_index=True, return_inverse=True
    )
    order = np.argsort(np.argsort(first_idx))
    return order[inverse.reshape(-1)].astype(np.int64), len(first_idx)


def class_totals(
    matrix: np.ndarray, class_ids: np.ndarray, n_classes: int
) -> Tuple[np.ndarray, np.ndarray]:
    """(totals f32[n_classes, w], counts i64[n_classes]): per-class row sums."""
    matrix = np.ascontiguousarray(matrix, dtype=np.float32)
    class_ids = np.ascontiguousarray(class_ids, dtype=np.int64)
    out = np.zeros((n_classes, matrix.shape[1]), dtype=np.float32)
    np.add.at(out, class_ids, matrix)
    counts = np.bincount(class_ids, minlength=n_classes).astype(np.int64)
    return out, counts
