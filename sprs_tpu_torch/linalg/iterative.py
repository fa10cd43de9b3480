"""Stationary iterative methods: weighted Jacobi on the device and the
host Gauss–Seidel sweep, the counterparts of
``sprs_tpu/linalg/iterative.py``.

Jacobi runs the same update as the JAX ``while_loop`` in a Python loop
with one host synchronisation per iteration.  Gauss–Seidel sweeps on
the host through the port's native library when it is built, else in
the numpy row sweep (the same arithmetic in the same order).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import native
from ..errors import NonSquareMatrixError
from ..formats.csmat import CsMat
from ..formats.util import host_array
from ..ops.prod import spmv
from ._dispatch import as_vector


@dataclasses.dataclass
class IterativeResult:
    x: torch.Tensor
    iterations: int
    residual_norm: float
    converged: bool


def _check_square(mat: CsMat, name: str) -> None:
    if mat.shape[0] != mat.shape[1]:
        raise NonSquareMatrixError(f"{name} needs square, got {mat.shape}")


def jacobi(
    mat: CsMat,
    b,
    x0=None,
    *,
    tol: float = 1e-8,
    max_iter: int = 1000,
    omega: float = 1.0,
) -> IterativeResult:
    """(Weighted) Jacobi: x ← x + ω·D⁻¹·(b − A·x) until ‖A·x − b‖₂ ≤ tol."""
    _check_square(mat, "jacobi")
    b = as_vector(b, mat)
    x = torch.zeros_like(b) if x0 is None else as_vector(x0, b)
    d = mat.diag()
    norm = torch.linalg.vector_norm

    res = norm(b - spmv(mat, x))
    it = 0
    while it < max_iter and bool(res > tol):
        r = b - spmv(mat, x)
        x = x + omega * (r / d)
        res = norm(b - spmv(mat, x))
        it += 1
    return IterativeResult(x, it, float(res), bool(res <= tol))


def gauss_seidel(
    mat: CsMat,
    b,
    x0=None,
    *,
    tol: float = 1e-8,
    max_iter: int = 300,
) -> IterativeResult:
    """Host Gauss–Seidel row sweep in f64, with the residual ‖A·x − b‖₂
    checked after every sweep; ``x`` returns on ``mat``'s device.  The
    native library's sweep runs when it is built, else the numpy one."""
    _check_square(mat, "gauss_seidel")
    csr = mat.to_csr()
    n = csr.shape[0]
    indptr = csr.indptr.cpu().numpy()
    nnz = int(indptr[-1])
    indices = csr.indices[:nnz].cpu().numpy()
    data = host_array(csr.data[:nnz])
    rows = np.repeat(np.arange(n), np.diff(indptr))
    b_h = as_vector(b, mat).cpu().numpy().astype(np.float64)
    x = (
        np.zeros(n, dtype=np.float64)
        if x0 is None
        else as_vector(x0, mat).cpu().numpy().astype(np.float64)
    )

    fast = native.gauss_seidel(indptr, indices, data, b_h, x, tol, max_iter)
    if fast is not None:
        xf, it, res = fast
        return IterativeResult(torch.from_numpy(xf).to(mat.device), it, res, res <= tol)

    def residual() -> float:
        ax = np.bincount(rows, weights=data * x[indices], minlength=n)
        return float(np.linalg.norm(ax - b_h))

    res = residual()
    it = 0
    while res > tol and it < max_iter:
        for i in range(n):
            sigma = 0.0
            diag = 0.0
            for p in range(indptr[i], indptr[i + 1]):
                j = indices[p]
                if j == i:
                    diag = data[p]
                else:
                    sigma += data[p] * x[j]
            x[i] = (b_h[i] - sigma) / diag
        it += 1
        res = residual()
    return IterativeResult(
        torch.from_numpy(x).to(mat.device), it, res, res <= tol
    )
