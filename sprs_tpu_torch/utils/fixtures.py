"""Shared test fixtures: small matrices with dense twins, the counterpart
of ``sprs_tpu/utils/fixtures.py``.

The same matrices as the JAX package's; ground truth is computed from
the dense twin with numpy rather than hard-coded.
"""

from __future__ import annotations

import numpy as np

from ..formats.csmat import CsMat, from_dense
from ..formats.util import DEFAULT_DEVICE


def dense_a() -> np.ndarray:
    """5×5, mixed pattern with an empty row and an empty column."""
    return np.array(
        [
            [2.0, 0.0, 0.0, -1.0, 0.0],
            [0.0, 0.0, 0.0, 0.0, 0.0],
            [3.5, 0.0, 1.0, 0.0, 0.0],
            [0.0, -2.0, 0.0, 4.0, 0.0],
            [0.0, 0.5, 0.0, 0.0, 1.5],
        ]
    )


def dense_b() -> np.ndarray:
    """5×5, overlaps A on some entries, disjoint on others."""
    return np.array(
        [
            [0.0, 1.0, 0.0, 0.0, 2.0],
            [0.0, 0.0, -3.0, 0.0, 0.0],
            [0.0, 0.0, 1.0, 1.0, 0.0],
            [5.0, 0.0, 0.0, -4.0, 0.0],
            [0.0, 0.0, 0.0, 0.0, 0.25],
        ]
    )


def dense_rect() -> np.ndarray:
    """4×6 rectangular."""
    return np.array(
        [
            [1.0, 0.0, 0.0, 2.0, 0.0, 0.0],
            [0.0, 0.0, 3.0, 0.0, 0.0, -1.0],
            [0.0, 0.0, 0.0, 0.0, 0.0, 0.0],
            [4.0, 0.0, 0.0, 0.0, 5.0, 0.0],
        ]
    )


def dense_spd(n: int = 10, seed: int = 7) -> np.ndarray:
    """Sparse-ish SPD matrix: diagonally dominant symmetric."""
    rng = np.random.default_rng(seed)
    a = np.zeros((n, n))
    for _ in range(2 * n):
        i, j = rng.integers(0, n, size=2)
        if i != j:
            v = rng.uniform(-1.0, 1.0)
            a[i, j] += v
            a[j, i] += v
    a += np.diag(np.abs(a).sum(axis=1) + 1.0)
    return a


def all_fixtures():
    return {
        "a": dense_a(),
        "b": dense_b(),
        "rect": dense_rect(),
        "spd": dense_spd(),
    }


def sparse_of(dense: np.ndarray, storage: str = "csr", *, device=DEFAULT_DEVICE) -> CsMat:
    return from_dense(dense, storage=storage, device=device)
