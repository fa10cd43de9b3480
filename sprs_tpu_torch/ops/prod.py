"""Sparse×dense products: SpMV and SpMM, and the structure dispatch that
picks a format per matrix.  The counterpart of ``sprs_tpu/ops/prod.py``.

A CSR product on a CUDA device, in a (data, x) form of
``ops/cuda/forms.py::FORMS`` with int32 indices, runs kernel K7
(``ops/cuda/csr_spmv.py``: a merge-path CSR SpMV written for the card,
which sums each row in its own fixed order and gives the same bits from
run to run).  Every other product, on the card too, reduces to two
plain torch primitives (``formats/util.py::contributions`` and
``csr_spmv_plain``):

* CSR (gather form):   y[row_ids] += data * x[indices]
* CSC (scatter form):  y[indices] += data * x[col_ids]

each summed by ``util.index_sum_`` in one fixed order on each device:
index order on the CPU (the JAX package's), an order of torch's own that
repeats from run to run on the card (``index_add_`` adds with atomics in
no fixed order there, and two runs of one product differed in their last
bits).  Padding
entries carry the row sentinel ``n_outer`` and ``data == 0``; torch raises
on an out-of-range id where JAX's ``segment_sum`` drops it, so padding is
masked to row 0 with a zero contribution.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from .._span import span
from ..errors import ShapeError
from ..formats.csmat import CsMat
from ..formats.util import contributions, csr_spmv_plain, index_sum_
from .cuda.csr_spmv import csr_spmv_kernel, takes

# prepare_spmv / prepare_spmm routing, kept identical to the JAX
# package so that both pick the same format for the same matrix.
DIA_MAX_DIAGS = 32
DIA_MAX_DIAGS_DENSE = 64
DIA_MIN_FILL = 0.25
ELL_MAX_OVERHEAD = 1.2


def spmv(mat: CsMat, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x for a dense vector x.

    A fixed dispatch by storage, device and type: a CSR matrix on a CUDA
    device in a (data, x) form of ``FORMS`` with int32 indices runs K7,
    its operands made contiguous first; every other product runs the
    plain gather or scatter product (``formats/util.py::
    csr_spmv_plain``): CPU tensors, CSC storage, and on the card the
    types K7 lacks (complex or integer values, int64 indices)."""
    if x.shape != (mat.cols,):
        raise ShapeError(f"spmv: A is {mat.shape}, x is {tuple(x.shape)}")
    if not takes(mat, x):
        return csr_spmv_plain(mat, x)
    if not (mat.indptr.is_contiguous() and mat.indices.is_contiguous()
            and mat.data.is_contiguous()):
        mat = CsMat(mat.indptr.contiguous(), mat.indices.contiguous(), mat.data.contiguous(),
                    mat.shape, mat.storage)
    return csr_spmv_kernel(mat, x.contiguous())


def spmm(mat: CsMat, x: torch.Tensor) -> torch.Tensor:
    """Y = A @ X for a dense matrix X of shape (cols, k)."""
    if x.ndim != 2 or x.shape[0] != mat.cols:
        raise ShapeError(f"spmm: A is {mat.shape}, X is {tuple(x.shape)}")
    dst, contrib = contributions(mat, x)
    y = torch.zeros(
        (mat.rows, x.shape[1]), dtype=contrib.dtype, device=contrib.device
    )
    return index_sum_(y, dst, contrib)


def _route(mat: CsMat) -> str:
    """'dia', 'ell' or 'csr' for ``mat`` (host-side, once per matrix).

    DIA when few diagonals are populated (k <= 32, or k <= 64 with fill
    >= 0.25); else ELL when its padding overhead is below 1.2; else the
    CSR index-add.
    """
    from ..formats.dia import n_diags_of
    from ..formats.ell import ell_overhead

    k = n_diags_of(mat)
    dia_fill = mat.nnz / max(k * max(mat.rows, 1), 1)
    if k <= DIA_MAX_DIAGS or (k <= DIA_MAX_DIAGS_DENSE and dia_fill >= DIA_MIN_FILL):
        return "dia"
    if ell_overhead(mat) < ELL_MAX_OVERHEAD:
        return "ell"
    return "csr"


def prepare_spmv(mat: CsMat) -> Tuple[Callable, object]:
    """Structure-dispatched SpMV: ``(fn, prepared)`` with
    ``fn(prepared, x) -> y``.

    * few populated diagonals → :class:`DiaTiledMat` through kernel K1
      (every band width: the kernel has no window to outgrow),
    * modest ELL padding overhead → ELL through kernel K5 (every x: the
      JAX package's VMEM limit on x has no counterpart; its own ELL arm
      runs the plain XLA product, since the TPU could not compile K5),
    * otherwise → the CSR matrix itself, whose product :func:`spmv` runs
      through K7 on the card.

    Runs in a ``sprs.prepare_spmv`` profiler span.
    """
    with span("sprs.prepare_spmv"):
        route = _route(mat)
        if route == "dia":
            from ..formats.dia import dia_from_csmat
            from .cuda.dia_spmv import dia_tile

            return (lambda m, x: m.spmv(x)), dia_tile(dia_from_csmat(mat))
        if route == "ell":
            from ..formats.ell import ell_from_csmat
            from .cuda.ell_spmv import ell_spmv_kernel

            return ell_spmv_kernel, ell_from_csmat(mat)
        return spmv, mat


def prepare_spmm(mat: CsMat) -> Tuple[Callable, object]:
    """Structure-dispatched SpMM: ``(fn, prepared)`` with
    ``fn(prepared, X) -> Y`` for a dense RHS ``X (cols, k)``.

    * few populated diagonals → :class:`DiaTiledMat` through kernel K2
      at every RHS width (the JAX package's ``k >= 256`` cut is a TPU
      measurement),
    * modest ELL padding overhead → ELL gather SpMM, plain torch (the
      JAX package has no ELL SpMM kernel),
    * otherwise → CSR index-add.
    """
    route = _route(mat)
    if route == "dia":
        from ..formats.dia import dia_from_csmat
        from .cuda.dia_spmv import dia_tile

        return (lambda m, x: m.spmm(x)), dia_tile(dia_from_csmat(mat))
    if route == "ell":
        from ..formats.ell import ell_from_csmat, ell_spmm

        return ell_spmm, ell_from_csmat(mat)
    return spmm, mat


def dense_matmul_sparse(x: torch.Tensor, mat: CsMat) -> torch.Tensor:
    """X @ A via the transpose identity X·A = (Aᵀ·Xᵀ)ᵀ."""
    if x.ndim == 1:
        return spmv(mat.T, x)
    if x.shape[-1] != mat.rows:
        raise ShapeError(f"dense@sparse: X is {tuple(x.shape)}, A is {mat.shape}")
    return spmm(mat.T, x.T).T
