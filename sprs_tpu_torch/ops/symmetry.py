"""Symmetry check, the PyTorch counterpart of ``sprs_tpu/ops/symmetry.py``.

A is compared with its re-sorted transpose: both land in the same CSR
order iff the pattern is symmetric, and one elementwise comparison over
(indptr, indices, data) on the device decides the rest.
"""

from __future__ import annotations

import torch

from ..formats.csmat import CsMat


def is_symmetric(mat: CsMat, *, rtol: float = 0.0, atol: float = 0.0) -> bool:
    """True iff A == Aᵀ in pattern and values; exact with the default
    tolerances, else |a - aᵀ| <= atol + rtol·|aᵀ| entry by entry."""
    if mat.shape[0] != mat.shape[1]:
        return False
    a = mat.to_csr()
    at = mat.T.to_csr().with_cap(a.cap)
    if not (torch.equal(a.indptr, at.indptr) and torch.equal(a.indices, at.indices)):
        return False
    if rtol == 0.0 and atol == 0.0:
        return bool(torch.equal(a.data, at.data))
    return bool(((a.data - at.data).abs() <= atol + rtol * at.data.abs()).all())
