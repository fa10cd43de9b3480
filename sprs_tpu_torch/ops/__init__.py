"""Operation layer: sparse products, SpGEMM, construction, permutations,
the ``@`` operator dispatch (``matmul`` / ``rmatmul``), and the ``+ - *``
dispatch (``add`` / ``sub`` / ``elementwise_mul``)."""

import numbers

import numpy as np
import torch

from ..errors import ShapeError
from ..formats.csmat import CsMat
from ..formats.csvec import CsVec
from ..formats.util import INDEX_DTYPE, as_tensor
from .batch import (
    BatchedCsMat,
    BatchedLdl,
    batch_spgemm,
    batch_spmm,
    batch_spmv,
)
from .binop import add as _add_sparse
from .binop import (
    add_dense,
    csmat_binop,
    maximum,
    minimum,
    mul_dense,
    mul_elementwise,
)
from .binop import sub as _sub_sparse
from .construct import block_diag, bmat, hstack, vstack
from .cuda import (
    DiaTiledMat,
    bsr_group,
    bsr_spmm_grouped_kernel,
    bsr_spmm_kernel,
    bsr_spmv_kernel,
    dia_spmm_kernel,
    dia_spmm_plain,
    dia_spmv_kernel,
    dia_spmv_plain,
    dia_tile,
    ell_spmv_kernel,
    ell_spmv_plain,
    sort_rows_kernel,
    sort_rows_plain,
)
from .kron import kronecker_product
from .permutation import (
    Permutation,
    permute_cols,
    permute_rows,
    transform_mat_papt,
    transform_mat_paq,
)
from .prod import dense_matmul_sparse, prepare_spmm, prepare_spmv, spmm, spmv
from .spgemm import spgemm, spgemm_caps, spgemm_dense, spgemm_dense_bsr
from .symmetry import is_symmetric

__all__ = [
    "matmul",
    "rmatmul",
    "add",
    "sub",
    "elementwise_mul",
    "spmv",
    "spmm",
    "prepare_spmm",
    "prepare_spmv",
    "spgemm",
    "spgemm_caps",
    "spgemm_dense",
    "spgemm_dense_bsr",
    "dense_matmul_sparse",
    "csmat_binop",
    "mul_elementwise",
    "mul_dense",
    "add_dense",
    "maximum",
    "minimum",
    "kronecker_product",
    "vstack",
    "hstack",
    "block_diag",
    "bmat",
    "Permutation",
    "permute_rows",
    "permute_cols",
    "transform_mat_papt",
    "transform_mat_paq",
    "is_symmetric",
    "assign_to_dense",
    "BatchedCsMat",
    "BatchedLdl",
    "batch_spgemm",
    "batch_spmm",
    "batch_spmv",
]


def _mat_times_csvec(mat: CsMat, v: CsVec, **kw) -> CsVec:
    """A @ v for a sparse v: SpGEMM against v's n×1 column view, the
    result column read back as a CsVec."""
    if mat.cols != v.dim:
        raise ShapeError(f"matmul: {mat.shape} @ ({v.dim},)")
    c = spgemm(mat.to_csr(), v.col_view().to_csr(), **kw).to_csr()
    outer = c.outer_ids()
    return CsVec(
        torch.where(c.live_mask(), outer.clamp(max=mat.rows - 1), 0).to(INDEX_DTYPE),
        c.data,
        c.indptr[-1].to(INDEX_DTYPE),
        mat.rows,
    )


def _csvec_times_mat(v: CsVec, mat: CsMat, **kw) -> CsVec:
    """vᵀ @ A through v's 1×n row view."""
    if mat.rows != v.dim:
        raise ShapeError(f"matmul: ({v.dim},) @ {mat.shape}")
    c = spgemm(v.row_view(), mat.to_csr(), **kw).to_csr()
    return CsVec(c.indices, c.data, c.indptr[-1].to(INDEX_DTYPE), mat.cols)


def matmul(lhs, rhs, **kw):
    """Linear-algebra product dispatch (the ``@`` operator).

    * ``BsrMat @ dense`` runs the block kernel K3 (on a CUDA tensor, at
      every block order: the kernel walks a row pointer, so it does not
      need the blocks sorted by row) and returns the JAX ``@``'s type,
      X's where the blocks share it, else float32; ``CsMat @ dense`` runs ``spmv`` or
      ``spmm``.  A dense ``rhs`` that is not a tensor goes to ``lhs``'s
      device.
    * ``CsMat @ CsMat`` is :func:`spgemm` (ESC); ``kw`` goes to it.
    * A sparse product with a BSR side, ``CsMat @ BsrMat`` or ``BsrMat @
      CsMat / BsrMat``, is :func:`spgemm_dense_bsr` at the BSR operand's
      block size and returns a BsrMat, so a chained product never pays a
      per-element CSR compaction and the next ``@ X`` runs K3.
    * ``CsMat @ CsVec`` is a CsVec (SpGEMM against its column view);
      ``CsVec @ CsMat`` lands in :func:`rmatmul`.
    """
    from ..formats.bsr import BsrMat

    if isinstance(lhs, BsrMat):
        if isinstance(rhs, (CsMat, BsrMat)):
            return spgemm_dense_bsr(lhs, rhs, block_size=lhs.block_size, **kw)
        rhs = as_tensor(rhs, device=lhs.device)
        if rhs.ndim not in (1, 2):
            raise ShapeError(f"matmul: rhs ndim {rhs.ndim} unsupported")
        y = bsr_spmv_kernel(lhs, rhs) if rhs.ndim == 1 else bsr_spmm_kernel(lhs, rhs)
        # the JAX ``@``'s type (``bsr_spmm_xla``): X's where blocks and X
        # share it, else float32; the kernel's float32 sums, held in
        # promote(blocks, X), cast to it exactly
        return y if rhs.dtype == lhs.dtype else y.to(torch.float32)
    if isinstance(lhs, CsMat):
        if isinstance(rhs, BsrMat):
            return spgemm_dense_bsr(lhs, rhs, block_size=rhs.block_size, **kw)
        if isinstance(rhs, CsMat):
            return spgemm(lhs, rhs, **kw)
        if isinstance(rhs, CsVec):
            return _mat_times_csvec(lhs, rhs, **kw)
        rhs = as_tensor(rhs, device=lhs.device)
        if rhs.ndim not in (1, 2):
            raise ShapeError(f"matmul: rhs ndim {rhs.ndim} unsupported")
        return spmv(lhs, rhs) if rhs.ndim == 1 else spmm(lhs, rhs)
    raise TypeError(f"matmul: unsupported lhs {type(lhs)}")


def rmatmul(lhs, rhs: CsMat):
    """``lhs @ rhs`` for a CsMat ``rhs`` and a CsVec or dense ``lhs``."""
    if isinstance(lhs, CsVec):
        return _csvec_times_mat(lhs, rhs)
    return dense_matmul_sparse(as_tensor(lhs, device=rhs.device), rhs)


def add(a, b, **kw):
    """``+``: sparse + sparse is sparse; sparse + dense is dense."""
    if isinstance(a, CsMat) and isinstance(b, CsMat):
        return _add_sparse(a, b, **kw)
    if isinstance(a, CsMat):
        return add_dense(a, b)
    return add_dense(b, a)


def sub(a, b, **kw):
    """``-``: sparse - sparse is sparse; with a dense operand, dense."""
    if isinstance(a, CsMat) and isinstance(b, CsMat):
        return _sub_sparse(a, b, **kw)
    if isinstance(a, CsMat):
        return a.to_dense() - as_tensor(b, device=a.device)
    return as_tensor(a, device=b.device) - b.to_dense()


def elementwise_mul(a, b, **kw):
    """``*``: scalar scale, sparse∘sparse, or sparse∘dense (2-D)."""
    if isinstance(a, CsMat) and isinstance(b, CsMat):
        return mul_elementwise(a, b, **kw)
    if not isinstance(a, CsMat):
        return elementwise_mul(b, a, **kw)
    if isinstance(b, numbers.Number):
        return a.scale(b)
    if not isinstance(b, torch.Tensor):
        b = np.asarray(b)
        if b.ndim == 0:  # a numpy scalar scales like the Python number
            return a.scale(b.item())
    if b.ndim == 0:
        return a.scale(b)
    if b.ndim == 2:
        return mul_dense(a, b)
    raise ShapeError("elementwise mul: 1-D dense operand unsupported")


def assign_to_dense(dense, mat: CsMat) -> torch.Tensor:
    """A copy of ``dense`` with ``mat``'s stored entries written over it;
    the other positions keep their values."""
    out = as_tensor(dense, device=mat.device).clone()
    if tuple(out.shape) != mat.shape:
        raise ShapeError(f"assign_to_dense: {tuple(out.shape)} vs {mat.shape}")
    rows, cols, vals = mat.coo_arrays()
    nnz = mat.nnz
    out[rows[:nnz].to(torch.int64), cols[:nnz].to(torch.int64)] = vals[:nnz].to(out.dtype)
    return out
