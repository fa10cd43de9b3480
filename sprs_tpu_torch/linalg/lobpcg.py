"""LOBPCG: smallest eigenpairs of a symmetric (or Hermitian) operator, the
counterpart of ``sprs_tpu/linalg/lobpcg.py``.

Locally optimal block preconditioned conjugate gradient (Knyazev 2001):
per iteration, one block SpMM for the Ritz values, one on the (n, 3m)
basis span[X, W, P] for the Rayleigh–Ritz projection, and small dense
algebra (``torch.linalg.qr`` on the basis, ``torch.linalg.eigh`` on the
3m×3m projected problem, as the JAX solver calls ``jnp.linalg``).  A
CsMat goes through ``prepare_spmm``: a banded matrix on the card runs
kernel K2.  The JAX ``lax.while_loop`` is a Python loop with one host
synchronisation per iteration to read the stopping test.  SpMMs: one
before the loop, two per iteration, one after: 2·iterations + 2.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Union

import torch

from ..formats.csmat import CsMat
from ._dispatch import as_matvec, as_vector


@dataclasses.dataclass
class LobpcgResult:
    eigenvalues: torch.Tensor  # (m,) ascending
    eigenvectors: torch.Tensor  # (n, m)
    iterations: int
    residual_norms: torch.Tensor  # (m,)
    converged: bool


def _orthonormalize(s: torch.Tensor) -> torch.Tensor:
    return torch.linalg.qr(s)[0]


def _ritz(x: torch.Tensor, ax: torch.Tensor, rdtype) -> torch.Tensor:
    """Hermitian Rayleigh quotients xᴴ A x per column, real."""
    return (x.conj() * ax).sum(0).real.to(rdtype)


def lobpcg(
    mat: Union[CsMat, Callable],
    x0,
    *,
    tol: float = 1e-6,
    max_iter: int = 200,
    precond: Optional[Callable] = None,
) -> LobpcgResult:
    """Smallest ``m`` eigenpairs of symmetric A; ``x0`` is the (n, m)
    starting block (its column count sets m).  ``precond`` applies M⁻¹
    to the residual block.  A numpy ``x0`` goes to ``mat``'s device.

    >>> import numpy as np
    >>> from sprs_tpu_torch.linalg import lobpcg
    >>> from sprs_tpu_torch.utils import dirichlet_laplacian
    >>> a = dirichlet_laplacian((6, 6), device="cpu")
    >>> x0 = np.random.default_rng(0).standard_normal((36, 2))
    >>> res = lobpcg(a, x0, tol=1e-9, max_iter=300)
    >>> res.converged
    True
    >>> [round(float(v), 6) for v in res.eigenvalues]
    [0.396125, 0.951083]
    """
    a_op, _ = as_matvec(mat, multi_rhs=True)
    m_op = precond if precond is not None else (lambda v: v)

    x = as_vector(x0, mat)
    m = x.shape[1]
    rdtype = x.real.dtype  # Ritz values are real
    x = _orthonormalize(x)
    # The JAX solver takes the starting block's Rayleigh quotients into
    # its loop state, which the loop overwrites before reading: one SpMM,
    # kept so that both solvers make the same 2·iterations + 2.
    a_op(x)
    p = torch.zeros_like(x)
    res = torch.full((m,), float("inf"), dtype=rdtype, device=x.device)
    it = 0
    while it < max_iter and bool(res.max() > tol):
        ax = a_op(x)
        lam = _ritz(x, ax, rdtype)
        r = ax - x * lam[None, :]
        res = torch.linalg.vector_norm(r, dim=0).to(rdtype)
        w = m_op(r)
        # Rayleigh–Ritz over span[x, w, p]; p == 0 on the first pass is
        # harmless after orthonormalizing the concatenated basis
        s = _orthonormalize(torch.cat([x, w, p], dim=1))
        sh = s.conj().T
        t = sh @ a_op(s)
        t = (t + t.conj().T) / 2  # Hermitian projection
        c = torch.linalg.eigh(t)[1]
        cm = c[:, :m]
        x_new = s @ cm
        # the P direction: the non-X part of the update
        p = s @ (cm - (sh @ x) @ (x.conj().T @ x_new))
        p = p / torch.clamp(torch.linalg.vector_norm(p, dim=0), min=1e-30)[None, :]
        x = _orthonormalize(x_new)
        it += 1

    ax = a_op(x)
    lam = _ritz(x, ax, rdtype)
    order = torch.argsort(lam)
    x, lam = x[:, order], lam[order]
    res = torch.linalg.vector_norm(ax[:, order] - x * lam[None, :], dim=0).to(rdtype)
    return LobpcgResult(
        eigenvalues=lam,
        eigenvectors=x,
        iterations=it,
        residual_norms=res,
        converged=bool(res.max() <= tol),
    )
