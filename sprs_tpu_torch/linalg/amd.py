"""Minimum-degree fill-reducing ordering (the CAMD role), the counterpart
of ``sprs_tpu/linalg/amd.py``.

The port's native library holds a quotient-graph approximate minimum
degree ordering; without the library a greedy exact minimum degree in
numpy takes its place, which is O(n²) and so refuses inputs past
n = 4,096.  Selected with ``Ldl().fill_in_reduction('camd')``.
"""

from __future__ import annotations

import numpy as np

from .. import native
from ..errors import NonSquareMatrixError
from ..formats.csmat import CsMat
from ..ops.permutation import Permutation


def _symmetrized_pattern(indptr, indices, n):
    """Pattern of A + Aᵀ as CSR arrays (AMD requires symmetry)."""
    nnz = int(indptr[-1])
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    cols = indices[:nnz].astype(np.int64)
    key = np.concatenate([rows * n + cols, cols * n + rows])
    key = np.unique(key)
    srows = (key // n).astype(np.int64)
    scols = (key % n).astype(np.int32)
    sptr = np.zeros(n + 1, dtype=np.int32)
    np.cumsum(np.bincount(srows, minlength=n), out=sptr[1:])
    return sptr, scols


def camd_order(mat: CsMat) -> Permutation:
    """Fill-reducing AMD permutation of a symmetric pattern.

    Uses the native quotient-graph approximate-minimum-degree ordering
    (``csrc/sprs_host.cpp::sprs_amd``).  Falls back to a greedy exact
    minimum degree in pure numpy when the native library is unavailable
    (small inputs only).  The permutation lands on the matrix's device."""
    if mat.shape[0] != mat.shape[1]:
        raise NonSquareMatrixError("ordering requires a square matrix")
    csr = mat.to_csr()
    n = csr.shape[0]
    indptr = csr.indptr.cpu().numpy()
    indices = csr.indices.cpu().numpy()

    if native.available():
        sptr, scols = _symmetrized_pattern(indptr, indices, n)
        fast = native.amd(sptr, scols, n)
        if fast is not None:
            return Permutation.from_array(fast, check=False, device=mat.device)

    # numpy fallback: greedy minimum degree with clique fill-in —
    # O(n²)+ pure Python; fail loudly instead of silently hanging on
    # large inputs when the native library is unavailable.
    if n > 4096:
        raise RuntimeError(
            f"camd_order numpy fallback is O(n²) and n={n}; build the "
            "native library (sprs_tpu_torch.native) or use "
            "fill_in_reduction('rcm')"
        )
    adj = [set() for _ in range(n)]
    for i in range(n):
        for j in indices[indptr[i] : indptr[i + 1]]:
            if j != i:
                adj[i].add(int(j))
    eliminated = np.zeros(n, dtype=bool)
    perm = np.empty(n, dtype=np.int64)
    for step in range(n):
        live = np.flatnonzero(~eliminated)
        degs = [sum(1 for u in adj[v] if not eliminated[u]) for v in live]
        v = int(live[int(np.argmin(degs))])
        perm[step] = v
        eliminated[v] = True
        nbrs = [u for u in adj[v] if not eliminated[u]]
        for a in nbrs:
            for b in nbrs:
                if a != b:
                    adj[a].add(b)
    return Permutation.from_array(perm.astype(np.int32), check=False, device=mat.device)
