"""Deterministic train/test split with sklearn parity.

Counterpart of ``art_sbir_tpu/data/split.py``.

The reference splits with ``sklearn.model_selection.train_test_split(*,
test_size=0.1, random_state=42, shuffle=True)`` (reference
`data_preparation.py:91`). That is exactly: ``np.random.RandomState(seed)
.permutation(n)``; the first ``ceil(test_size * n)`` permuted indices are
test, the next ``n - n_test`` are train. Re-implemented here so the split
is identical without the sklearn dependency (verified against sklearn in
tests).
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np


def split_indices(
    n: int, test_size: float = 0.1, seed: int = 42
) -> Tuple[np.ndarray, np.ndarray]:
    """(train_idx, test_idx) with sklearn ShuffleSplit semantics."""
    n_test = int(math.ceil(test_size * n))
    n_train = n - n_test
    perm = np.random.RandomState(seed).permutation(n)
    test = perm[:n_test]
    train = perm[n_test : n_test + n_train]
    return train, test


def split_arrays(arrays, test_size: float = 0.1, seed: int = 42, mode: str = "train"):
    """Apply the split to parallel sequences; returns the selected views."""
    n = len(arrays[0])
    train, test = split_indices(n, test_size, seed)
    idx = train if mode == "train" else test
    return [[a[i] for i in idx] for a in arrays]
