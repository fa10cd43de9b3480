"""ELLPACK (padded-row) sparse format, the PyTorch counterpart of
``sprs_tpu/formats/ell.py``.

Every row is padded to a common ``width`` so that ``data``/``indices``
are dense ``(rows_pad, width)`` arrays and SpMV is
``sum(data * x[indices], axis=1)``: one gather and one row reduction.
Pad slots carry ``indices == 0`` (an always-valid gather address) and
``data == 0``.  Rows are padded to a multiple of ``row_align``.

A square operator may be stored renumbered (``order``, set by
``ops/prod.py::prepare_spmv`` where it speeds up K5: ``ops/renumber.py``):
stored row ``i`` is the caller's row ``order[i]``, its slots in their
order, its columns mapped to new positions.  Every product here takes x
and gives y in the caller's order, bit-equal to the product of the
operator as given.

The plain torch products live here; :func:`ell_spmv` is also the plain
version of the ELL SpMV kernel K5, whose wrapper and prepared-path use
are in ``ops/cuda/ell_spmv.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..errors import ShapeError
from .csmat import CsMat
from .util import INDEX_DTYPE, round_up


@dataclasses.dataclass(frozen=True)
class EllMat:
    """Row-major ELLPACK matrix: ``indices`` and ``data`` of shape
    ``(rows_pad, width)``; rows beyond ``shape[0]`` are all padding.

    ``order`` (int32, ``(rows,)``, square matrices only), where set, says
    the rows are stored renumbered: stored row ``i`` is row ``order[i]``
    of the operator, and column ``c`` is stored as ``inv[c]``, ``inv``
    the inverse of ``order``; in a renumbered row the pad slots read
    ``inv[0]``, so that every slot reads the x entry it read before."""

    indices: torch.Tensor
    data: torch.Tensor
    shape: Tuple[int, int]
    order: Optional[torch.Tensor] = None

    @property
    def rows(self) -> int:
        return self.shape[0]

    @property
    def cols(self) -> int:
        return self.shape[1]

    @property
    def rows_pad(self) -> int:
        return self.indices.shape[0]

    @property
    def width(self) -> int:
        return self.indices.shape[1]

    @property
    def dtype(self) -> torch.dtype:
        return self.data.dtype

    @property
    def nnz(self) -> int:
        """Count of slots holding a nonzero (pad slots hold zeros)."""
        return int((self.data != 0).sum())

    @property
    def renumbered(self) -> bool:
        return self.order is not None

    def to_dense(self) -> torch.Tensor:
        if self.renumbered:
            return ell_in_caller_order(self).to_dense()
        out = torch.zeros(
            (self.rows_pad, self.cols), dtype=self.dtype, device=self.data.device
        )
        rows = torch.arange(self.rows_pad, device=self.data.device)
        out.index_put_(
            (rows[:, None].expand(-1, self.width), self.indices.to(torch.int64)),
            self.data,
            accumulate=True,
        )
        return out[: self.rows]

    def __repr__(self):
        return (
            f"EllMat(shape={self.shape}, width={self.width}, "
            f"rows_pad={self.rows_pad}, dtype={self.dtype})"
        )


def ell_from_csmat(
    mat: CsMat, *, width: Optional[int] = None, row_align: int = 8,
    order: Optional[torch.Tensor] = None,
) -> EllMat:
    """Convert a CSR matrix to ELL; ``width`` defaults to the max row nnz
    and entries beyond ``width`` in a row are dropped.  With ``order``
    (a permutation, new position -> original index) the square matrix is
    stored renumbered by it (:class:`EllMat`), built in one pass."""
    mat = mat.to_csr()
    if width is None:
        width = max(mat.max_outer_nnz(), 1)
    rows_pad = round_up(max(mat.rows, 1), row_align)
    nnz = mat.nnz
    outer = mat.outer_ids()[:nnz].to(torch.int64)
    slot = torch.arange(nnz, device=mat.device) - mat.indptr.to(torch.int64)[outer]
    keep = slot < width
    cols = mat.indices[:nnz]
    idx = torch.zeros((rows_pad, width), dtype=INDEX_DTYPE, device=mat.device)
    if order is not None:
        if mat.rows != mat.cols or tuple(order.shape) != (mat.rows,):
            raise ShapeError(f"ell_from_csmat: order of {tuple(order.shape)} for {mat.shape}")
        order = order.to(device=mat.device, dtype=INDEX_DTYPE)
        inv = torch.empty_like(order)
        inv[order.long()] = torch.arange(mat.rows, dtype=INDEX_DTYPE, device=mat.device)
        outer, cols = inv[outer].long(), inv[cols.long()]
        idx[: mat.rows] = inv[0]
    dat = torch.zeros((rows_pad, width), dtype=mat.dtype, device=mat.device)
    idx[outer[keep], slot[keep]] = cols[keep]
    dat[outer[keep], slot[keep]] = mat.data[:nnz][keep]
    return EllMat(idx, dat, mat.shape, order)


def ell_in_caller_order(ell: EllMat) -> EllMat:
    """``ell`` stored in the caller's order: itself where it is not
    renumbered, else a copy with the rows and columns put back."""
    if not ell.renumbered:
        return ell
    order, n = ell.order.long(), ell.rows
    idx, dat = ell.indices.clone(), ell.data.clone()
    idx[order] = ell.order[ell.indices[:n].long()]
    dat[order] = ell.data[:n]
    return EllMat(idx, dat, ell.shape)


def in_stored_order(ell: EllMat, x: torch.Tensor, product) -> torch.Tensor:
    """``product(x)`` where ``ell`` is not renumbered; else ``product``
    of x brought into the stored order (rows of x for an SpMM), its rows
    sent back to the caller's.  ``product`` computes the stored rows."""
    if not ell.renumbered:
        return product(x)
    order = ell.order.long()
    ys = product(x[order])
    y = torch.empty_like(ys)
    y[order] = ys
    return y


def ell_to_csmat(ell: EllMat, *, cap: Optional[int] = None) -> CsMat:
    """Back to CSR, dropping the slots that hold zeros (explicit zeros
    included, as in the JAX package).  ``cap`` defaults to the count of
    kept entries (at least 1); kept entries beyond it are dropped."""
    ell = ell_in_caller_order(ell)
    live = ell.data[: ell.rows] != 0
    counts = live.sum(1)
    indptr = torch.zeros(ell.rows + 1, dtype=INDEX_DTYPE, device=ell.data.device)
    indptr[1:] = torch.cumsum(counts, 0)
    if cap is None:
        cap = max(int(indptr[-1]), 1)
    flat = live.reshape(-1)
    order = torch.argsort((~flat).to(torch.uint8), stable=True)  # live slots first, in row order
    take = order[torch.arange(cap, device=flat.device).clamp(max=max(order.shape[0] - 1, 0))]
    ok = torch.arange(cap, device=flat.device) < indptr[-1]
    indices = torch.where(ok, ell.indices[: ell.rows].reshape(-1)[take], 0)
    data = ell.data[: ell.rows].reshape(-1)[take]
    return CsMat(indptr, indices, torch.where(ok, data, torch.zeros_like(data)), ell.shape, "csr")


def ell_spmv(ell: EllMat, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x, plain torch (gather + row reduction; a renumbered
    operand's rows summed as stored, x and y in the caller's order)."""
    if x.shape != (ell.cols,):
        raise ShapeError(f"ell_spmv: A is {ell.shape}, x is {tuple(x.shape)}")
    idx = ell.indices.to(torch.int64)
    return in_stored_order(ell, x, lambda v: (ell.data * v[idx]).sum(1)[: ell.rows])


def ell_spmm(ell: EllMat, x: torch.Tensor) -> torch.Tensor:
    """Y = A @ X for dense X of shape (cols, k)."""
    if x.ndim != 2 or x.shape[0] != ell.cols:
        raise ShapeError(f"ell_spmm: A is {ell.shape}, X is {tuple(x.shape)}")
    idx = ell.indices.to(torch.int64)
    return in_stored_order(
        ell, x, lambda v: torch.einsum("rw,rwk->rk", ell.data, v[idx])[: ell.rows])


def ell_overhead(mat: CsMat) -> float:
    """Padding overhead of converting ``mat`` to ELL: padded slots /
    live slots.  The dispatch keeps ELL when this is small."""
    nnz = max(mat.nnz, 1)
    width = max(mat.max_outer_nnz(), 1)
    rows_pad = round_up(max(mat.rows, 1), 8)
    return rows_pad * width / nnz - 1.0
