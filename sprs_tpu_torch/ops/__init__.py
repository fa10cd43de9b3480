"""Sparse×dense products, their structure dispatch, the ``@`` operator
dispatch (``matmul`` / ``rmatmul``), and the ``+ - *`` dispatch
(``add`` / ``sub`` / ``elementwise_mul``)."""

import numbers

import numpy as np
import torch

from ..errors import ShapeError
from ..formats.csmat import CsMat
from ..formats.util import as_tensor
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
from .prod import dense_matmul_sparse, prepare_spmm, prepare_spmv, spmm, spmv


def matmul(lhs, rhs):
    """Linear-algebra product dispatch (the ``@`` operator).

    ``BsrMat @ dense`` runs the block kernel K3 (on a CUDA tensor, at
    every block order: the kernel walks a row pointer, so it does not
    need the blocks sorted by row); ``CsMat @ dense`` runs ``spmv`` or
    ``spmm``.  A dense ``rhs`` that is not a tensor goes to ``lhs``'s
    device.  A sparse ``rhs`` is SpGEMM, which is not ported yet.
    """
    from ..formats.bsr import BsrMat

    if not isinstance(lhs, (CsMat, BsrMat)):
        raise TypeError(f"matmul: unsupported lhs {type(lhs)}")
    if isinstance(rhs, (CsMat, BsrMat)):
        raise NotImplementedError(
            "sparse @ sparse is SpGEMM, which the port does not have yet: it "
            "comes with the SpGEMM slice (ROADMAP Queue 1, item 6)"
        )
    rhs = as_tensor(rhs, device=lhs.device)
    if rhs.ndim not in (1, 2):
        raise ShapeError(f"matmul: rhs ndim {rhs.ndim} unsupported")
    if isinstance(lhs, BsrMat):
        return bsr_spmv_kernel(lhs, rhs) if rhs.ndim == 1 else bsr_spmm_kernel(lhs, rhs)
    return spmv(lhs, rhs) if rhs.ndim == 1 else spmm(lhs, rhs)


def rmatmul(lhs, rhs: CsMat):
    """``lhs @ rhs`` for a dense ``lhs`` and a CsMat ``rhs``."""
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
