"""Sparse×dense products, their structure dispatch, and the ``@`` operator
dispatch (``matmul`` / ``rmatmul``)."""

from ..errors import ShapeError
from ..formats.csmat import CsMat
from ..formats.util import as_tensor
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
