"""Kronecker product, the PyTorch counterpart of ``sprs_tpu/ops/kron.py``.

nnz(A ⊗ B) = nnz(A)·nnz(B): every output entry has its own (row, col), so
the expand needs no dedup; one sort-and-compress on the operands' device
restores CSR order.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..formats.csmat import CsMat
from ..formats.util import compress_coo


def kronecker_product(a: CsMat, b: CsMat, *, out_cap: Optional[int] = None) -> CsMat:
    """Sparse Kronecker product A ⊗ B as CSR; ``out_cap`` defaults to
    nnz(A)·nnz(B).

    >>> import numpy as np
    >>> import sprs_tpu_torch as st
    >>> a = st.from_dense(np.array([[1.0, 2.0]]), device="cpu")
    >>> b = st.from_dense(np.array([[0.0, 3.0]]), device="cpu")
    >>> st.kronecker_product(a, b).to_dense().tolist()
    [[0.0, 3.0, 0.0, 6.0]]
    """
    a_csr, b_csr = a.to_csr(), b.to_csr()
    ra, ca, va = a_csr.coo_arrays()
    rb, cb, vb = b_csr.coo_arrays()
    br, bc = b.shape
    live = (a_csr.live_mask()[:, None] & b_csr.live_mask()[None, :]).reshape(-1)
    rows = (
        ra.clamp(max=a.shape[0] - 1).to(torch.int64)[:, None] * br
        + rb.clamp(max=br - 1).to(torch.int64)[None, :]
    ).reshape(-1)
    cols = (ca.to(torch.int64)[:, None] * bc + cb.to(torch.int64)[None, :]).reshape(-1)
    vals = (va[:, None] * vb[None, :]).reshape(-1)
    n_rows = a.shape[0] * br
    if out_cap is None:
        out_cap = max(a.nnz * b.nnz, 1)
    res = compress_coo(
        torch.where(live, rows, n_rows),
        cols,
        (torch.where(live, vals, torch.zeros_like(vals)),),
        rows.shape[0],
        n_rows,
        a.shape[1] * bc,
        out_cap,
    )
    return CsMat(res.indptr, res.indices, res.values[0], (n_rows, a.shape[1] * bc), "csr")
