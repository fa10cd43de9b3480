"""LSQR, least squares and minimum-norm solutions: the counterpart of
``sprs_tpu/linalg/lsqr.py``.

Paige–Saunders Golub–Kahan bidiagonalization: one ``A v`` and one
``Aᴴ u`` per step.  For a CsMat both directions go through
``as_matvec(..., square=False)``, so a rectangular A and its transpose
reach the structure-dispatched kernels (DIA → K1, ELL → K5).  The
rotation scalars stay real for complex A; only the Krylov vectors are
complex.  A Python loop over the JAX ``while_loop``'s updates, one host
read of the stopping test per step.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Tuple, Union

import torch

from ..errors import ShapeError
from ..formats.csmat import CsMat
from ._dispatch import as_matvec, as_vector


@dataclasses.dataclass
class LsqrResult:
    x: torch.Tensor
    iterations: int
    residual_norm: float  # ‖b − A x‖
    atr_norm: float  # ‖Aᴴ(b − A x)‖, the normal-equation residual
    converged: bool


def lsqr(
    mat: Union[CsMat, Tuple[Callable, Callable]],
    b,
    *,
    tol: float = 1e-8,
    max_iter: int = 1000,
) -> LsqrResult:
    """min ‖A x − b‖.  ``mat`` is a CsMat, or a pair of callables
    ``(matvec, rmatvec)`` applying A and Aᴴ.  Stops when ‖r‖ ≤ tol·‖b‖ or
    ‖Aᴴr‖ ≤ tol·‖Aᴴb‖ (the JAX package's two tests).

    >>> import numpy as np
    >>> import sprs_tpu_torch as st
    >>> from sprs_tpu_torch.linalg import lsqr
    >>> a = st.from_dense(np.array([[1.0, 0.0], [0.0, 2.0], [1.0, 1.0]]), device="cpu")
    >>> res = lsqr(a, np.array([1.0, 2.0, 2.0]))
    >>> res.converged, np.allclose(res.x.numpy(), [1.0, 1.0])
    (True, True)
    """
    if isinstance(mat, CsMat):
        b = as_vector(b, mat)
        ah_mat = mat.T.to_csr()
        if b.is_complex() or mat.dtype.is_complex:
            ah_mat = ah_mat.map(torch.conj)
        a_op, _ = as_matvec(mat, square=False)
        at_op, _ = as_matvec(ah_mat, square=False)
        if b.shape != (mat.shape[0],):
            raise ShapeError(f"rhs shape {tuple(b.shape)}, expected ({mat.shape[0]},)")
    else:
        a_op, at_op = mat
        b = as_vector(b, None)
    rdtype = torch.zeros((), dtype=b.dtype).real.dtype
    tiny = 1e-300 if rdtype == torch.float64 else 1e-30
    norm = torch.linalg.vector_norm

    beta1 = norm(b)
    u = b / beta1.clamp(min=tiny)
    v = at_op(u)
    alpha = norm(v)
    v = v / alpha.clamp(min=tiny)
    x = torch.zeros_like(v)
    w = v
    threshold = tol * max(float(beta1), tiny)
    atr_threshold = tol * max(float(alpha * beta1), tiny)
    phibar, rhobar = beta1, alpha
    resid, atr = float(beta1), float(alpha * beta1)
    it = 0
    while resid > threshold and atr > atr_threshold and it < max_iter:
        u = a_op(v) - alpha * u
        beta = norm(u)
        u = u / beta.clamp(min=tiny)
        v = at_op(u) - beta * v
        alpha = norm(v)
        v = v / alpha.clamp(min=tiny)

        rho = torch.sqrt(rhobar**2 + beta**2)
        rho_safe = rho.clamp(min=tiny)
        c = rhobar / rho_safe
        sn = beta / rho_safe
        theta = sn * alpha
        rhobar = -c * alpha
        phi = c * phibar
        phibar = sn * phibar
        x = x + (phi / rho_safe) * w
        w = v - (theta / rho_safe) * w
        it += 1
        resid, atr = (float(s) for s in torch.stack([phibar, phibar * alpha * c.abs()]).tolist())

    r = b - a_op(x)
    resid = float(norm(r))
    atr = float(norm(at_op(r)))
    return LsqrResult(
        x=x,
        iterations=it,
        residual_norm=resid,
        atr_norm=atr,
        converged=(resid <= threshold) or (atr <= atr_threshold),
    )
