"""Permutations and permuted matrix transforms, the PyTorch counterpart of
``sprs_tpu/ops/permutation.py``.

A ``Permutation`` stores the forward map and its inverse.  Conventions,
as in the JAX package:

* ``perm @ x``      → y with y[i] = x[perm[i]]
* ``permute_rows(A, p)``  → B with B[i, :] = A[p[i], :]
* ``permute_cols(A, p)``  → B with B[:, j] = A[:, p[j]]
* ``transform_mat_papt(A, p)`` → P·A·Pᵀ, i.e. B[i, j] = A[p[i], p[j]]:
  the symmetric reordering that fill-reducing orderings apply before LDLᵀ
* ``transform_mat_paq(A, p, q)`` → B[i, j] = A[p[i], q[j]]

A matrix transform relabels the COO coordinates through the inverse maps
and restores the storage order with one sort-and-compress, on the
matrix's device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..errors import ShapeError, StructureError
from ..formats.csmat import CsMat
from ..formats.util import DEFAULT_DEVICE, INDEX_DTYPE, as_tensor, compress_coo


@dataclasses.dataclass(frozen=True)
class Permutation:
    """Dense permutation with its inverse, both int32 on one device."""

    perm: torch.Tensor
    inv: torch.Tensor

    @classmethod
    def identity(cls, n: int, *, device=DEFAULT_DEVICE) -> "Permutation":
        i = torch.arange(n, dtype=INDEX_DTYPE, device=device)
        return cls(i, i)

    @classmethod
    def from_array(cls, perm, *, check: bool = True, device=DEFAULT_DEVICE) -> "Permutation":
        """From the forward map; with ``check``, anything but a
        permutation of 0..n-1 raises (one sorted compare on the device)."""
        perm = as_tensor(perm, dtype=INDEX_DTYPE, device=device)
        n = perm.shape[0]
        ids = torch.arange(n, dtype=INDEX_DTYPE, device=perm.device)
        if check and not torch.equal(torch.sort(perm).values, ids):
            raise StructureError.out_of_range("not a permutation of 0..n")
        inv = torch.zeros(n, dtype=INDEX_DTYPE, device=perm.device)
        inv[perm.to(torch.int64)] = ids
        return cls(perm, inv)

    @property
    def dim(self) -> int:
        return self.perm.shape[0]

    @property
    def device(self) -> torch.device:
        return self.perm.device

    def inverse(self) -> "Permutation":
        return Permutation(self.inv, self.perm)

    def apply_vec(self, x) -> torch.Tensor:
        """y[i] = x[perm[i]]."""
        return as_tensor(x, device=self.device)[self.perm.to(torch.int64)]

    def apply_inv_vec(self, x) -> torch.Tensor:
        return as_tensor(x, device=self.device)[self.inv.to(torch.int64)]

    def __matmul__(self, x):
        return self.apply_vec(x)

    def compose(self, other: "Permutation") -> "Permutation":
        """(self ∘ other): ``other`` first, then ``self``."""
        return Permutation(other.perm[self.perm.to(torch.int64)],
                           self.inv[other.inv.to(torch.int64)])

    def __repr__(self):
        return f"Permutation(dim={self.dim}, device={self.device})"


def _relabel(mat: CsMat, row_map: Optional[torch.Tensor], col_map: Optional[torch.Tensor]) -> CsMat:
    """Relabel the COO coordinates and re-sort into the original storage."""
    rows, cols, vals = mat.coo_arrays()
    live = mat.live_mask()
    rows = rows.clamp(max=mat.shape[0] - 1).to(torch.int64)
    cols = cols.clamp(max=mat.shape[1] - 1).to(torch.int64)
    if row_map is not None:
        rows = row_map[rows]
    if col_map is not None:
        cols = col_map[cols]
    outer, inner = (rows, cols) if mat.is_csr else (cols, rows)
    res = compress_coo(
        torch.where(live, outer, mat.outer_dims),
        torch.where(live, inner, 0),
        (torch.where(live, vals, torch.zeros_like(vals)),),
        mat.cap,
        mat.outer_dims,
        mat.inner_dims,
        mat.cap,
    )
    return CsMat(res.indptr, res.indices, res.values[0], mat.shape, mat.storage)


def permute_rows(mat: CsMat, perm: Permutation) -> CsMat:
    """B[i, :] = A[perm[i], :]."""
    if perm.dim != mat.shape[0]:
        raise ShapeError("permute_rows: dimension mismatch")
    return _relabel(mat, perm.inv, None)


def permute_cols(mat: CsMat, perm: Permutation) -> CsMat:
    """B[:, j] = A[:, perm[j]]."""
    if perm.dim != mat.shape[1]:
        raise ShapeError("permute_cols: dimension mismatch")
    return _relabel(mat, None, perm.inv)


def transform_mat_papt(mat: CsMat, perm: Permutation) -> CsMat:
    """P·A·Pᵀ: B[i, j] = A[perm[i], perm[j]]."""
    if mat.shape[0] != mat.shape[1]:
        raise ShapeError("papt requires a square matrix")
    if perm.dim != mat.shape[0]:
        raise ShapeError("papt: dimension mismatch")
    return _relabel(mat, perm.inv, perm.inv)


def transform_mat_paq(mat: CsMat, p: Permutation, q: Permutation) -> CsMat:
    """B[i, j] = A[p[i], q[j]]."""
    if p.dim != mat.shape[0] or q.dim != mat.shape[1]:
        raise ShapeError("paq: dimension mismatch")
    return _relabel(mat, p.inv, q.inv)
