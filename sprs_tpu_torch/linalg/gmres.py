"""Restarted GMRES(m) with optional right preconditioning, the
counterpart of ``sprs_tpu/linalg/gmres.py``.

* The Arnoldi basis is a fixed ``(m+1, n)`` array, one contiguous row
  per basis vector (the kernels take contiguous vectors); each step
  orthogonalizes against every column under a ``j``-mask by classical
  Gram–Schmidt applied twice (CGS2), so a step is two dense matrix-vector
  products, as in the JAX package.
* The ``(m+1, m)`` least-squares problem of a cycle is solved on the host
  by SVD (``gelsd``, the rank-revealing solve the JAX package's ``lstsq``
  is), one small copy per cycle.
* Each cycle ends on the TRUE residual of its new iterate; a cycle that
  does not improve it keeps the old iterate and stops the loop.

Matvecs: the first product A·x0 gives the working type and the first
residual (the JAX solver computes it twice, with the same result); each
cycle then makes m Arnoldi products and one residual, which is also the
next cycle's starting residual.  So a solve of c cycles makes
1 + c·(m + 1) products.  ``precond`` applies M⁻¹ on the right.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Union

import torch

from ..errors import ShapeError
from ..formats.csmat import CsMat
from ..formats.csvec import CsVec
from ._dispatch import as_matvec, as_vector


@dataclasses.dataclass
class GmresResult:
    x: torch.Tensor
    converged: bool
    iterations: int  # total inner (Arnoldi) steps
    residual_norm: float


def _tiny(dtype: torch.dtype) -> float:
    real = torch.zeros((), dtype=dtype).real.dtype
    return 1e-300 if real == torch.float64 else 1e-30


def _dense(v, like):
    return v.to_dense() if isinstance(v, CsVec) else as_vector(v, like)


def gmres(
    mat: Union[CsMat, Callable],
    b,
    x0=None,
    *,
    tol: float = 1e-8,
    restart: int = 30,
    max_iter: int = 1000,
    precond: Optional[Callable] = None,
) -> GmresResult:
    """Solve A x = b; ``mat`` is a CsMat or a matvec callable.

    ``restart`` is the Krylov dimension m; ``max_iter`` bounds the total
    inner steps over all cycles.  Converged when the true residual is at
    most ``tol``·‖b‖.

    >>> import numpy as np
    >>> import sprs_tpu_torch as st
    >>> from sprs_tpu_torch.linalg import gmres
    >>> a = st.from_dense(np.array([[4.0, 1.0], [2.0, 3.0]]), device="cpu")
    >>> res = gmres(a, np.array([1.0, 2.0]), restart=2)
    >>> res.converged, np.allclose(res.x.numpy(), [0.1, 0.6])
    (True, True)
    """
    a_op, n = as_matvec(mat)
    m_op = precond if precond is not None else (lambda v: v)
    b = _dense(b, mat)
    if n is not None and b.shape != (n,):
        raise ShapeError(f"rhs shape {tuple(b.shape)}, expected ({n},)")
    n = b.shape[0]
    x = torch.zeros_like(b) if x0 is None else _dense(x0, b)

    m = int(restart)
    ax = a_op(x)
    # the working type joins b, x0 and the operator's output: a complex
    # matrix with a real rhs must not cast the Krylov basis to real
    dtype = torch.promote_types(torch.promote_types(b.dtype, x.dtype), ax.dtype)
    b = b.to(dtype)
    if x.dtype != dtype:
        x = x.to(dtype)
        ax = a_op(x)
    tiny = _tiny(dtype)
    norm = torch.linalg.vector_norm
    threshold = tol * max(float(norm(b)), tiny)
    col = torch.arange(m + 1, device=b.device)

    r = b - ax
    res = float(norm(r))
    it = 0
    while res > threshold and it < max_iter:
        V = torch.zeros((m + 1, n), dtype=dtype, device=b.device)
        V[0] = r / max(res, tiny)
        H = torch.zeros((m + 1, m), dtype=dtype, device=b.device)
        for j in range(m):
            w = a_op(m_op(V[j]))
            mask = (col <= j).to(w.real.dtype)
            h1 = (V.conj() @ w) * mask
            w = w - h1 @ V
            h2 = (V.conj() @ w) * mask  # CGS2: orthogonalize again
            w = w - h2 @ V
            hj1 = norm(w)
            H[:, j] = h1 + h2
            H[j + 1, j] = hj1
            V[j + 1] = w / hj1.clamp(min=tiny)
        rhs = torch.zeros((m + 1, 1), dtype=dtype)
        rhs[0] = res
        y = torch.linalg.lstsq(H.cpu(), rhs, driver="gelsd").solution[:, 0].to(b.device)
        x_new = x + m_op(y @ V[:m])
        r_new = b - a_op(x_new)
        res_new = float(norm(r_new))
        it += m
        if not res_new < res:
            # GMRES(m) restarted from the same x repeats itself: stop
            break
        x, r, res = x_new, r_new, res_new
    return GmresResult(x=x, converged=res <= threshold, iterations=it, residual_norm=res)
