"""Shared matvec binding for the iterative solvers.

Every Krylov and block solver accepts either a CsMat or a matvec
callable.  A CsMat is checked for squareness and bound to the
structure-dispatched product (``ops.prod.prepare_spmv``, or
``prepare_spmm`` for a block of columns), unless its values require a
gradient: the prepared formats copy the values, so such a matrix stays
on the generic product, through which autograd reaches ``mat.data``.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple, Union

import torch

from ..errors import NonSquareMatrixError
from ..formats.csmat import CsMat
from ..formats.util import DEFAULT_DEVICE, as_tensor


def as_matvec(
    mat: Union[CsMat, Callable],
    *,
    square: bool = True,
    multi_rhs: bool = False,
) -> Tuple[Callable, Optional[int]]:
    """Return ``(a_op, n_rows)``; ``n_rows`` is None for callables.

    ``multi_rhs`` binds the SpMM dispatch (``prepare_spmm``) instead of
    SpMV, for block methods (LOBPCG, svds, block ``expm_multiply``);
    ``square=False`` lets a rectangular matrix through (svds)."""
    if not isinstance(mat, CsMat):
        return mat, None
    if square and mat.shape[0] != mat.shape[1]:
        raise NonSquareMatrixError(
            f"iterative solver needs square, got {mat.shape}"
        )
    from ..ops.prod import prepare_spmm, prepare_spmv, spmm, spmv

    if mat.data.requires_grad:
        op = spmm if multi_rhs else spmv
        return (lambda v: op(mat, v)), mat.shape[0]
    fn, prepared = (prepare_spmm if multi_rhs else prepare_spmv)(mat)
    return (lambda v: fn(prepared, v)), mat.shape[0]


def as_vector(v, like) -> torch.Tensor:
    """``v`` as a tensor.  A tensor keeps its device; an array goes to the
    device of ``like`` (a CsMat or tensor), or the default device when
    ``like`` is a matvec callable."""
    if isinstance(v, torch.Tensor):
        return v
    device = like.device if isinstance(like, (CsMat, torch.Tensor)) else DEFAULT_DEVICE
    return as_tensor(v, device=device)
