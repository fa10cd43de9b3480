"""Sparse vector with sorted indices, capacity-padded: the PyTorch
counterpart of ``sprs_tpu/formats/csvec.py``.

A CsVec has the layout of one CSR row, so ``row_view`` / ``col_view``
reinterpret it as a 1×n / n×1 CsMat without copying.  Live entries fill
slots [0, nnz); padding has ``indices == 0`` and ``data == 0``.  For the
binary searches the padding is remapped on the fly to the out-of-range
sentinel ``dim``, so the index array stays sorted end to end.  ``nnz`` is
a 0-d int32 tensor on the vector's device (``nnz_arr``), as in the JAX
package, so that a result sized on the device needs no host read.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..errors import CapacityError, ShapeError, StructureError
from .csmat import CSC, CSR, CsMat
from .util import (
    DEFAULT_DEVICE,
    INDEX_DTYPE,
    as_tensor,
    compress_coo,
    host_array,
    torch_dtype,
    valid_mask,
)


@dataclasses.dataclass(frozen=True)
class CsVec:
    """Sparse vector: ``indices (cap,) i32``, ``data (cap,)``, ``nnz_arr``
    (0-d i32), all on one device; ``dim`` is a plain int."""

    indices: torch.Tensor
    data: torch.Tensor
    nnz_arr: torch.Tensor
    dim: int

    # -- properties --------------------------------------------------------
    @property
    def nnz(self) -> int:
        return int(self.nnz_arr)

    @property
    def cap(self) -> int:
        return self.indices.shape[0]

    @property
    def dtype(self) -> torch.dtype:
        return self.data.dtype

    @property
    def device(self) -> torch.device:
        return self.data.device

    @property
    def shape(self) -> Tuple[int]:
        return (self.dim,)

    def live_mask(self) -> torch.Tensor:
        return valid_mask(self.cap, self.nnz_arr, self.device)

    def search_indices(self) -> torch.Tensor:
        """Indices with padding remapped to ``dim`` (the array stays sorted)."""
        return torch.where(self.live_mask(), self.indices, self.dim)

    # -- conversions ---------------------------------------------------------
    def to_dense(self) -> torch.Tensor:
        out = torch.zeros(self.dim + 1, dtype=self.dtype, device=self.device)
        return out.index_add_(0, self.search_indices().to(torch.int64), self.data)[: self.dim]

    scatter = to_dense

    def to_set(self):
        """Host-side dict {index: value} of the live entries."""
        n = self.nnz
        idx = self.indices[:n].cpu().numpy()
        val = host_array(self.data[:n])
        return {int(i): v for i, v in zip(idx, val)}

    def items(self):
        return iter(self.to_set().items())

    def _view_indptr(self) -> torch.Tensor:
        return torch.stack([torch.zeros_like(self.nnz_arr), self.nnz_arr]).to(INDEX_DTYPE)

    def row_view(self) -> CsMat:
        """Reinterpret as a 1×dim CSR matrix."""
        return CsMat(self._view_indptr(), self.indices, self.data, (1, self.dim), CSR)

    def col_view(self) -> CsMat:
        """Reinterpret as a dim×1 CSC matrix."""
        return CsMat(self._view_indptr(), self.indices, self.data, (self.dim, 1), CSC)

    # -- access ----------------------------------------------------------------
    def _find(self, index) -> Tuple[torch.Tensor, torch.Tensor]:
        """(slot, hit): the binary-search slot of ``index``, clamped into
        the array, and whether it holds ``index``."""
        si = self.search_indices()
        target = torch.as_tensor(index, dtype=si.dtype, device=si.device)
        pos = torch.searchsorted(si, target).clamp(max=self.cap - 1)
        return pos, si[pos] == target

    def get(self, index: int) -> torch.Tensor:
        """Value at ``index`` (0 if absent), by binary search."""
        pos, hit = self._find(index)
        return torch.where(hit, self.data[pos], torch.zeros((), dtype=self.dtype, device=self.device))

    def __getitem__(self, index):
        return self.get(index)

    def nnz_index(self, index: int) -> torch.Tensor:
        """Storage slot of ``index`` as an int32 scalar, -1 if absent."""
        pos, hit = self._find(index)
        return torch.where(hit, pos.to(INDEX_DTYPE), torch.tensor(-1, dtype=INDEX_DTYPE, device=self.device))

    def iter_perm(self, perm):
        """Host-side ``(perm[index], value)`` over the live entries in
        stored order; ``perm`` is a Permutation or an index array."""
        p = getattr(perm, "perm", perm)
        p = p.cpu().numpy() if isinstance(p, torch.Tensor) else np.asarray(p)
        n = self.nnz
        idx = self.indices[:n].cpu().numpy()
        val = host_array(self.data[:n])
        for i, v in zip(idx, val):
            yield int(p[int(i)]), v

    # -- elementwise --------------------------------------------------------------
    def map(self, fn) -> "CsVec":
        new = fn(self.data)
        new = torch.where(self.live_mask(), new, torch.zeros_like(new))
        return CsVec(self.indices, new, self.nnz_arr, self.dim)

    def scale(self, alpha) -> "CsVec":
        return self.map(lambda d: d * alpha)

    def __neg__(self) -> "CsVec":
        return self.map(torch.neg)

    # -- reductions ------------------------------------------------------------------
    def squared_l2_norm(self) -> torch.Tensor:
        return (self.data * self.data).sum()

    def l2_norm(self) -> torch.Tensor:
        return torch.sqrt(self.squared_l2_norm())

    def sum(self) -> torch.Tensor:
        return self.data.sum()

    def mean(self) -> torch.Tensor:
        """Mean over the full dense extent (zeros count)."""
        return self.sum() / self.dim

    def l1_norm(self) -> torch.Tensor:
        return self.data.abs().sum()

    def norm(self, p: float) -> torch.Tensor:
        """p-norm, with p = inf (max |x|), p = -inf (min |x| over the
        stored entries) and p = 0 (the count of nonzero stored entries)."""
        a = self.data.abs()
        if p == np.inf:
            return a.max()
        if p == -np.inf:
            return torch.where(self.live_mask(), a, torch.full_like(a, float("inf"))).min()
        if p == 0:
            return ((a != 0) & self.live_mask()).sum().to(a.dtype)
        return (a**p).sum() ** (1.0 / p)

    def unit_normalize(self) -> "CsVec":
        n = self.l2_norm()
        safe = torch.where(n == 0, torch.ones_like(n), n)
        return self.map(lambda d: d / safe)

    # -- products -------------------------------------------------------------
    def dot(self, other) -> torch.Tensor:
        """Sparse·sparse dot by binary search of the smaller operand's
        indices in the larger one, or sparse·dense by a gather."""
        if isinstance(other, CsVec):
            if self.dim != other.dim:
                raise ShapeError("dot: dimension mismatch")
            a, b = (self, other) if self.cap <= other.cap else (other, self)
            bi = b.search_indices()
            ai = a.search_indices()
            pos = torch.searchsorted(bi, ai).clamp(max=b.cap - 1)
            hit = bi[pos] == ai
            prod = a.data * b.data[pos]
            return torch.where(hit, prod, torch.zeros_like(prod)).to(self.dtype).sum()
        other = as_tensor(other, device=self.device)
        if other.shape != (self.dim,):
            raise ShapeError("dot: dimension mismatch")
        return self.dot_dense(other)

    def dot_dense(self, dense: torch.Tensor) -> torch.Tensor:
        return (self.data * dense[self.indices.to(torch.int64)] * self.live_mask()).sum()

    # -- ops through the shared merge ----------------------------------------
    def _binop(self, other: "CsVec", op, out_cap: Optional[int] = None) -> "CsVec":
        """``op`` over the union of both patterns (one sort-and-compress,
        each operand in its own value channel).  ``out_cap`` defaults to
        nnz(self) + nnz(other); a union larger than it raises."""
        if self.dim != other.dim:
            raise ShapeError("binop: dimension mismatch")
        cap = self.cap + other.cap
        live = torch.cat([self.live_mask(), other.live_mask()])
        rows = (~live).to(INDEX_DTYPE)  # padding of both operands: row 1, dropped
        cols = torch.cat([self.indices, other.indices])
        va = torch.cat([self.data, self.data.new_zeros(other.cap)])
        vb = torch.cat([other.data.new_zeros(self.cap), other.data])
        if out_cap is None:
            out_cap = max(self.nnz + other.nnz, 1)
        res = compress_coo(rows, cols, (va, vb), cap, 1, self.dim, out_cap)
        required = int(res.required_nnz)
        if required > out_cap:
            raise CapacityError(
                required,
                out_cap,
                f"CsVec binop union has {required} entries but out_cap={out_cap}; "
                "pass a larger out_cap",
            )
        out = op(res.values[0], res.values[1])
        out = torch.where(valid_mask(out_cap, res.nnz, out.device), out, torch.zeros_like(out))
        return CsVec(res.indices, out, res.nnz, self.dim)

    def __add__(self, other):
        if isinstance(other, CsVec):
            return self._binop(other, torch.add)
        return self.to_dense() + as_tensor(other, device=self.device)

    def __sub__(self, other):
        if isinstance(other, CsVec):
            return self._binop(other, torch.sub)
        return self.to_dense() - as_tensor(other, device=self.device)

    def __mul__(self, other):
        if isinstance(other, CsVec):
            return self._binop(other, torch.mul)
        return self.scale(other)

    def __rmul__(self, alpha):
        return self.scale(alpha)

    def __truediv__(self, alpha):
        return self.map(lambda d: d / alpha)

    def __matmul__(self, other):
        from ..ops import rmatmul

        if isinstance(other, CsVec):
            return self.dot(other)
        return rmatmul(self, other)

    def __repr__(self):
        return (
            f"CsVec(dim={self.dim}, nnz={self.nnz}, cap={self.cap}, "
            f"dtype={self.dtype}, device={self.device})"
        )


# ---------------------------------------------------------------------------
# Constructors
# ---------------------------------------------------------------------------


def _nnz_scalar(n, device) -> torch.Tensor:
    return torch.tensor(n, dtype=INDEX_DTYPE, device=device)


def csvec(dim: int, indices, data, *, cap: Optional[int] = None, validate: bool = True,
          device=DEFAULT_DEVICE) -> CsVec:
    """Build from strictly increasing indices; checked on the host when
    ``validate``."""
    indices = as_tensor(indices, dtype=INDEX_DTYPE, device=device)
    data = as_tensor(data, device=device)
    n = indices.shape[0]
    cap = cap or max(n, 1)
    if n > cap:
        raise StructureError.size_mismatch(f"nnz {n} exceeds cap {cap}")
    if validate and n:
        ih = indices.cpu().numpy()
        if ih.min() < 0 or ih.max() >= dim:
            raise StructureError.out_of_range("index out of range")
        if n > 1 and np.any(np.diff(ih) <= 0):
            raise StructureError.unsorted("indices must be strictly increasing")
    return CsVec(
        torch.cat([indices, indices.new_zeros(cap - n)]),
        torch.cat([data, data.new_zeros(cap - n)]),
        _nnz_scalar(n, indices.device),
        dim,
    )


def csvec_from_unsorted(dim: int, indices, data, *, cap=None, device=DEFAULT_DEVICE) -> CsVec:
    """Sort the entries and sum duplicates."""
    indices = as_tensor(indices, dtype=INDEX_DTYPE, device=device)
    data = as_tensor(data, device=device)
    n = indices.shape[0]
    cap = cap or max(n, 1)
    res = compress_coo(torch.zeros_like(indices), indices, (data,), n, 1, dim, cap)
    return CsVec(res.indices, res.values[0], res.nnz, dim)


def csvec_from_dense(x, *, eps: float = 0.0, cap=None, device=DEFAULT_DEVICE) -> CsVec:
    """Entries with |x_i| > eps; ``cap`` defaults to their count."""
    x = as_tensor(x, device=device)
    (dim,) = x.shape
    keep = x.abs() > eps
    if cap is None:
        cap = max(int(keep.sum()), 1)
    res = compress_coo(
        (~keep).to(INDEX_DTYPE),
        torch.arange(dim, dtype=INDEX_DTYPE, device=x.device),
        (torch.where(keep, x, torch.zeros_like(x)),),
        dim,
        1,
        dim,
        cap,
    )
    return CsVec(res.indices, res.values[0], res.nnz, dim)


def empty_csvec(dim: int, dtype=torch.float32, *, cap: int = 1, device=DEFAULT_DEVICE) -> CsVec:
    return CsVec(
        torch.zeros(cap, dtype=INDEX_DTYPE, device=device),
        torch.zeros(cap, dtype=torch_dtype(dtype), device=device),
        _nnz_scalar(0, device),
        dim,
    )
