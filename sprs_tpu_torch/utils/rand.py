"""Reproducible random sparse matrices, the counterpart of
``sprs_tpu/utils/rand.py``.

The structure and the values are drawn on the host from numpy's PCG64 in
the JAX package's order, so one seed gives the same matrix in both
packages, array for array; the result then moves to ``device``.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from ..formats.csmat import CSR, CsMat, csmat
from ..formats.util import DEFAULT_DEVICE, as_tensor


def rand_csr(
    shape: tuple,
    density: float,
    *,
    seed: int = 0,
    dtype=np.float64,
    values: Optional[Callable] = None,
    storage: str = CSR,
    cap: Optional[int] = None,
    device=DEFAULT_DEVICE,
) -> CsMat:
    """Random CSR with expected ``density`` fill, reproducible by seed.

    Row lengths are a histogram of ``density·rows·cols`` uniform row
    draws (at most ``cols`` each); each row's columns are distinct and
    sorted.  ``values(rng, nnz)`` sets the value distribution (default:
    standard normal).
    """
    if not (0.0 <= density <= 1.0):
        raise ValueError("density must be within [0, 1]")
    rows, cols = shape
    rng = np.random.default_rng(np.random.PCG64(seed))
    exp_nnz = int(density * rows * cols)
    row_hits = rng.integers(0, rows, size=exp_nnz) if exp_nnz else np.empty(0, np.int64)
    counts = np.minimum(np.bincount(row_hits, minlength=rows), cols)
    indptr = np.zeros(rows + 1, dtype=np.int64)
    indptr[1:] = np.cumsum(counts)
    nnz = int(indptr[-1])
    indices = np.empty(nnz, dtype=np.int64)
    for r in range(rows):
        k = counts[r]
        if k == 0:
            continue
        if k > cols // 2:
            chosen = rng.permutation(cols)[:k]
        else:
            # rejection-sample distinct columns, in the JAX package's draw order
            seen = set()
            while len(seen) < k:
                seen.add(int(rng.integers(0, cols)))
            chosen = np.fromiter(seen, dtype=np.int64, count=k)
        chosen.sort()
        indices[indptr[r] : indptr[r + 1]] = chosen
    raw = rng.standard_normal(nnz) if values is None else values(rng, nnz)
    data = as_tensor(raw, dtype=dtype, device="cpu")  # torch's cast rounds as numpy's and ml_dtypes' do
    m = csmat(
        (rows, cols),
        indptr.astype(np.int32),
        indices.astype(np.int32),
        data,
        storage=CSR,
        cap=cap,
        validate=False,
        device=device,
    )
    return m if storage == CSR else m.to_csc()
