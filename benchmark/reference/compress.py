"""Plain assembly of a CSR operator from COO triplets, duplicates summed
in float64, and the program's stated routing rule worked out from that
structure: DIA when at most 32 diagonals are populated (or at most 64 at
a fill of 0.25 or more), else ELL when rows_pad·width/nnz - 1 is under
1.2 (rows padded to 8), else CSR."""

from __future__ import annotations

import torch


def compress(rows, cols, vals, n_rows: int, n_cols: int):
    """(indptr int64, indices int64, data float64) of the summed matrix."""
    key = rows.to(torch.int64) * n_cols + cols.to(torch.int64)
    uniq, inv = torch.unique(key, return_inverse=True)
    data = torch.zeros(uniq.numel(), dtype=torch.float64, device=vals.device)
    data.index_add_(0, inv, vals.to(torch.float64))
    r = uniq // n_cols
    indptr = torch.zeros(n_rows + 1, dtype=torch.int64, device=vals.device)
    indptr[1:] = torch.cumsum(torch.bincount(r, minlength=n_rows), 0)
    return indptr, uniq % n_cols, data


def route(indptr, indices, n_rows: int) -> str:
    nnz = int(indptr[-1])
    r = torch.repeat_interleave(torch.arange(n_rows, device=indptr.device), indptr.diff())
    k = int(torch.unique(indices - r).numel())
    fill = nnz / max(k * max(n_rows, 1), 1)
    if k <= 32 or (k <= 64 and fill >= 0.25):
        return "dia"
    width = max(int(indptr.diff().max()), 1)
    rows_pad = -(-max(n_rows, 1) // 8) * 8
    if rows_pad * width / max(nnz, 1) - 1.0 < 1.2:
        return "ell"
    return "csr"
