"""High-level differentiable solve x = A⁻¹ b, the counterpart of
``sprs_tpu/linalg/solve.py``.

The JAX package wraps the factored solve in ``lax.custom_linear_solve``;
here a ``torch.autograd.Function`` does the same: the forward pass solves
through the factor (or the iterative method), the backward pass solves
the adjoint system once, λ = A⁻ᵀ·g, and returns ∂b = λ and
∂data = −λ[row]·x[col] on the stored pattern.  The factorization itself
is never differentiated: it runs on detached values before the Function
is applied, so no op of it enters the autograd graph.
"""

from __future__ import annotations

from typing import Callable

import torch

from .. import native
from ..formats.csmat import CsMat
from ..ops.symmetry import is_symmetric
from ._dispatch import as_matvec, as_vector
from .ldl import Ldl
from .lu import splu


class _Solve(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, b, mat, fwd, tr):
        x = fwd(b)
        ctx.save_for_backward(x)
        ctx.mat, ctx.tr = mat, tr
        return x

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        lam = ctx.tr(g)
        grad_data = None
        if ctx.needs_input_grad[0]:
            mat = ctx.mat
            rows, cols, _ = mat.coo_arrays()
            live = mat.live_mask()
            rows = torch.where(live, rows, 0).to(torch.int64)
            cols = torch.where(live, cols, 0).to(torch.int64)
            prod = lam[rows] * x[cols]
            if prod.ndim == 2:
                prod = prod.sum(1)
            grad_data = torch.where(live, -prod, torch.zeros_like(prod))
        return grad_data, lam, None, None, None


def _columns(solver: Callable) -> Callable:
    """Apply a 1-D solver to each column of an (n, k) right-hand side."""
    def run(rhs):
        if rhs.ndim == 1:
            return solver(rhs)
        return torch.stack([solver(rhs[:, j]) for j in range(rhs.shape[1])], 1)

    return run


def resolve_method(mat: CsMat, method: str = "auto") -> str:
    """The method :func:`solve` takes: "auto" is "ldl" for a symmetric
    matrix, else "lu"; any other name is kept."""
    if method == "auto":
        return "ldl" if is_symmetric(mat) else "lu"
    return method


def solve(mat: CsMat, b, *, method: str = "auto", fill: str = "auto", **factor_kw):
    """Solve A x = b differentiably in ``b`` and ``mat.data``.

    ``method``: "auto" (LDLᵀ if the matrix is symmetric, else LU), "ldl",
    "lu", or an iterative solver "cg" / "bicgstab" / "gmres" (options
    ``tol``, ``max_iter``, ``precond``, and ``restart`` for gmres; the
    adjoint solve runs the same method on Aᵀ without the
    preconditioner).  LDLᵀ factors by ``Ldl``'s "auto" backend (the host
    numeric, or on a CUDA matrix of 256 rows or more the level-batched
    numeric on the card), LU on the host; the solves run on ``mat``'s
    device.  ``fill``: the LDLᵀ ordering ("auto" = "camd"
    when the native library is built, else "rcm"; "camd", "rcm", "nd" or
    "none" to force).  The solution is ordering-independent.
    """
    method = resolve_method(mat, method)
    const = mat.with_data(mat.data.detach())
    if method == "ldl":
        if fill == "auto":
            fill = "camd" if native.available() else "rcm"
        fac = Ldl().fill_in_reduction(fill).check_symmetry(False).numeric(const, **factor_kw)
        fwd = tr = fac.solve  # symmetric: the adjoint solve is the solve
    elif method == "lu":
        fac = splu(const, **factor_kw)
        fwd, tr = fac.solve, fac.solve_transposed
    elif method in ("cg", "bicgstab", "gmres"):
        tol = factor_kw.pop("tol", 1e-10)
        max_iter = factor_kw.pop("max_iter", 10000)
        precond = factor_kw.pop("precond", None)
        it_kw = {"restart": factor_kw.pop("restart", 30)} if method == "gmres" else {}
        if factor_kw:
            raise TypeError(f"unknown solve options {sorted(factor_kw)}")
        from .bicgstab import bicgstab
        from .cg import cg
        from .gmres import gmres

        it = {"cg": cg, "bicgstab": bicgstab, "gmres": gmres}[method]
        a_op, _ = as_matvec(const)
        fwd = _columns(lambda rhs: it(a_op, rhs, tol=tol, max_iter=max_iter, precond=precond,
                                      **it_kw).x)
        if method == "cg":
            tr = fwd  # SPD: the adjoint solve is the solve
        else:
            at_op, _ = as_matvec(const.T.to_csr())
            tr = _columns(lambda rhs: it(at_op, rhs, tol=tol, max_iter=max_iter, **it_kw).x)
    else:
        raise ValueError(f"unknown solve method {method!r}")
    b = as_vector(b, mat).to(mat.device)
    b = b.to(torch.promote_types(mat.dtype, b.dtype))
    return _Solve.apply(mat.data, b, mat, fwd, tr)
