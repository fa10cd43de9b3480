"""BiCGSTAB iterative solver, the counterpart of
``sprs_tpu/linalg/bicgstab.py``.

Unpreconditioned BiCGSTAB (optionally right-preconditioned) with two
safeguards, carried over arithmetic for arithmetic as masked updates:

* **soft restart** when the shadow residual r̂ becomes (near-)orthogonal
  to the residual (rho → 0): restart with r̂ = r;
* **hard restart** before declaring convergence: the recursive residual
  drifts from the true one, so every iteration recomputes b − A·x and
  stops only when the true residual passes the tolerance too.

The JAX solver is one ``lax.while_loop``; here it is a Python loop over
the same masked ``torch.where`` updates, with one host synchronisation
per iteration to read ``done``.  Each iteration makes three matvecs
(A·p̂, A·ŝ and the true residual), and the solve two more (the initial
and the final residual): 3·iterations + 2 in all.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Union

import torch

from ..errors import ShapeError
from ..formats.csmat import CsMat
from ._dispatch import as_matvec, as_vector


@dataclasses.dataclass
class BiCgStabResult:
    x: torch.Tensor
    converged: bool
    iterations: int
    residual_norm: float


def _dot(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return torch.vdot(u, v).real.to(u.dtype)


def bicgstab(
    mat: Union[CsMat, Callable],
    b,
    x0=None,
    *,
    tol: float = 1e-8,
    max_iter: int = 1000,
    restart_eps: float = 1e-30,
    precond: Callable = None,
) -> BiCgStabResult:
    """Solve A x = b.  ``mat`` may be a CsMat or a matvec callable.

    ``tol`` is relative: converged when ‖b − A·x‖ ≤ tol·‖b‖ on the true
    residual.  ``precond`` applies M⁻¹ (right preconditioning).  A numpy
    ``b`` goes to ``mat``'s device.

    >>> import numpy as np
    >>> import sprs_tpu_torch as st
    >>> from sprs_tpu_torch.linalg import bicgstab
    >>> a = st.from_dense(np.array([[4.0, 1.0], [1.0, 3.0]]), device="cpu")
    >>> res = bicgstab(a, np.array([1.0, 2.0]), tol=1e-6)
    >>> res.converged
    True
    >>> np.allclose(res.x.numpy(), [1.0 / 11.0, 7.0 / 11.0], atol=1e-5)
    True
    """
    a_op, n = as_matvec(mat)
    m_op = precond if precond is not None else (lambda v: v)
    b = as_vector(b, mat)
    if n is not None and b.shape != (n,):
        raise ShapeError(f"rhs shape {tuple(b.shape)}, expected ({n},)")
    x = torch.zeros_like(b) if x0 is None else as_vector(x0, b)
    norm = torch.linalg.vector_norm

    tiny = b.new_tensor(1e-300)  # 0 in float32, as in the JAX solver
    threshold = tol * torch.maximum(norm(b), tiny)

    r = b - a_op(x)
    rhat, p = r, r
    v = torch.zeros_like(b)
    rho = _dot(r, r)
    it = 0
    done = norm(r) <= threshold
    while it < max_iter and not bool(done):
        phat = m_op(p)
        v = a_op(phat)
        rhat_v = _dot(rhat, v)
        safe = rhat_v.abs() > restart_eps
        alpha = torch.where(safe, rho / torch.where(safe, rhat_v, 1.0), 0.0)
        sres = r - alpha * v
        shat = m_op(sres)
        t = a_op(shat)
        tt = _dot(t, t)
        omega = torch.where(
            tt > restart_eps,
            _dot(t, sres) / torch.where(tt > restart_eps, tt, 1.0),
            0.0,
        )
        x_new = x + alpha * phat + omega * shat
        r_new = sres - omega * t

        rho_new = _dot(rhat, r_new)
        # soft restart: the shadow residual lost its orthogonality signal
        soft = rho_new.abs() < restart_eps * torch.maximum(
            norm(r_new) * norm(rhat), tiny
        )
        rhat_new = torch.where(soft, r_new, rhat)
        rho_next = torch.where(soft, _dot(r_new, r_new), rho_new)
        beta = torch.where(
            safe & ~soft,
            (rho_next / torch.where(rho.abs() > 0, rho, 1.0))
            * (alpha / torch.where(omega.abs() > 0, omega, 1.0)),
            0.0,
        )
        p_new = torch.where(soft, r_new, r_new + beta * (p - omega * v))

        # hard restart / convergence: verify with the true residual
        rec_small = norm(r_new) <= threshold
        true_r = b - a_op(x_new)
        true_small = norm(true_r) <= threshold
        done = rec_small & true_small
        # the recursive residual lied: continue from the true residual
        lied = rec_small & ~true_small
        r = torch.where(lied, true_r, r_new)
        rhat = torch.where(lied, true_r, rhat_new)
        p = torch.where(lied, true_r, p_new)
        rho = torch.where(lied, _dot(true_r, true_r), rho_next)
        x = x_new
        it += 1

    return BiCgStabResult(
        x=x,
        converged=bool(done),
        iterations=it,
        residual_norm=float(norm(b - a_op(x))),
    )
