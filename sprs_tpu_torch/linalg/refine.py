"""Mixed-precision iterative refinement for direct solves, the
counterpart of ``sprs_tpu/linalg/refine.py``.

Factor once in a low precision, then recover forward accuracy with a few
refinement sweeps whose residuals are computed in f64 (Wilkinson; each
step costs one O(nnz) residual and one O(lnz) solve).

Residual precision: the JAX package computes the f64 residual on the
host through scipy, because the TPU has no f64.  The H100 has f64, so
here the residual is computed on the matrix's own device: A cast to f64
and bound once per call to the structure-dispatched product
(``as_matvec``, which reaches the DIA or ELL kernel on the card and the
plain product on the CPU).  The JAX package's traced branch (an on-device
f32 residual under ``jit``) has no counterpart: every port tensor is
concrete.
"""

from __future__ import annotations

from typing import Callable, Union

import torch

from ..formats.csmat import CsMat
from ._dispatch import as_matvec, as_vector


def refine_solve(
    mat: CsMat,
    solve: Union[Callable, "object"],
    b,
    *,
    steps: int = 2,
    rtol: float = 0.0,
):
    """Solve ``A x = b`` through ``solve`` with iterative refinement.

    ``solve`` is a callable ``r -> A⁻¹r`` (approximate, e.g. an f32
    factor's solve) or an object with a ``.solve`` method (``LdlNumeric``,
    ``SpLu``).  Runs ``x ← x + solve(b − A·x)`` up to ``steps`` times,
    stopping early once the f64 relative backward error
    ``‖b−Ax‖∞/(‖A‖∞‖x‖∞+‖b‖∞)`` is at most ``rtol`` (0 = always run all
    steps).

    Returns ``(x, info)``: ``x`` in f64 on the matrix's device, and
    ``info["backward_errors"]``, one entry per residual computed.

    >>> import numpy as np
    >>> from sprs_tpu_torch.linalg import Ldl, refine_solve
    >>> from sprs_tpu_torch.utils import dirichlet_laplacian
    >>> a = dirichlet_laplacian((16, 16), device="cpu")
    >>> num = Ldl().fill_in_reduction('nd').check_symmetry(False).numeric(a)
    >>> x, info = refine_solve(a, num, np.ones(256), steps=2)
    >>> bool(info["backward_errors"][-1] < 1e-12)
    True
    """
    solve_fn = solve.solve if hasattr(solve, "solve") else solve
    a64 = mat.astype(torch.float64)
    a_op, _ = as_matvec(a64.with_data(a64.data.detach()))
    b = as_vector(b, mat).to(mat.device)
    b64 = b.to(torch.float64)
    norm_a = float(a64.norm("inf"))
    b_max = float(b64.abs().max())

    def backward_error(r, x):
        return float(r.abs().max()) / (norm_a * float(x.abs().max()) + b_max + 1e-300)

    x64 = solve_fn(b).to(torch.float64)
    errs = []
    for _ in range(max(steps, 0)):
        r = b64 - a_op(x64)
        errs.append(backward_error(r, x64))
        if rtol and errs[-1] <= rtol:
            break
        x64 = x64 + solve_fn(r).to(torch.float64)
    errs.append(backward_error(b64 - a_op(x64), x64))
    return x64, {"backward_errors": errs}
