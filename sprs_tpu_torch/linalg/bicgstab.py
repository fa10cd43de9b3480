"""BiCGSTAB iterative solver, the counterpart of
``sprs_tpu/linalg/bicgstab.py``.

Unpreconditioned BiCGSTAB (optionally right-preconditioned) with two
safeguards, carried over arithmetic for arithmetic as masked updates:

* **soft restart** when the shadow residual r̂ becomes (near-)orthogonal
  to the residual (rho → 0): restart with r̂ = r;
* **hard restart** before declaring convergence: the recursive residual
  drifts from the true one, so every iteration recomputes b − A·x and
  stops only when the true residual passes the tolerance too.

The JAX solver is one ``lax.while_loop``; here it is a Python loop with
one host synchronisation per iteration to read ``done``, in one of two
forms chosen by ``ops/cuda/krylov.py::takes``:

* :func:`_fused`, for a real float32 or float64 b on a CUDA device: the
  iteration's updates, reductions and scalar logic run in the six passes
  of kernel K8 (``ops/cuda/krylov.py``), with the scalars on the device;
* :func:`_plain`, for everything else (CPU tensors, complex and 16-bit
  types, and under grad mode a solve through which a gradient can flow):
  the same masked ``torch.where`` updates op by op, which autograd
  follows.

Both do the same arithmetic in the same order and type.  Each iteration
makes three matvecs (A·p̂, A·ŝ and the true residual), and the solve two
more (the initial and the final residual): 3·iterations + 2 in all.
Each host read of a device value runs in a ``sprs.bicgstab.sync``
profiler span.

:func:`bicgstab_sparse` keeps the iterates as ``CsVec``; its matvec is
SpGEMM against the vector's column view.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Union

import torch

from .._span import host, span
from ..errors import CapacityError, ShapeError
from ..formats.csmat import CsMat
from ..formats.csvec import CsVec, empty_csvec
from ..ops.cuda import krylov
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
    b = as_vector(b, mat)
    if n is not None and b.shape != (n,):
        raise ShapeError(f"rhs shape {tuple(b.shape)}, expected ({n},)")
    x = torch.zeros_like(b) if x0 is None else as_vector(x0, b)
    r = b - a_op(x)
    loop = _fused if krylov.takes(b, _grads(mat, precond, x, r)) else _plain
    return loop(a_op, precond, b, x, r, tol, max_iter, restart_eps)


def _grads(mat, precond, x, r):
    """The tensors besides b through which a gradient can reach the
    solution, for K8's rule (``krylov.takes``), which reads them only
    under grad mode on the card: x0, the first residual (which carries
    the parameters a matvec closes over), a CsMat's values, and, with a
    preconditioner, its result on r, applied once for this."""
    yield x
    yield r
    if isinstance(mat, CsMat):
        yield mat.data
    if precond is not None:
        yield precond(r)


def _plain(a_op, precond, b, x, r, tol, max_iter, restart_eps) -> BiCgStabResult:
    """The masked loop, op by op in torch, from x and its residual
    r = b − A·x."""
    m_op = precond if precond is not None else (lambda v: v)
    norm = torch.linalg.vector_norm

    b_norm = norm(b)
    # the floor in the norm's real type: 0 in float32 (and complex64), as
    # in the JAX solver; torch.maximum takes no complex operand
    tiny = b_norm.new_tensor(1e-300)
    threshold = tol * torch.maximum(b_norm, tiny)

    rhat, p = r, r
    v = torch.zeros_like(b)
    rho = _dot(r, r)
    it = 0
    done = norm(r) <= threshold
    while it < max_iter and not host(span("sprs.bicgstab.sync"), bool, done):
        phat = m_op(p)
        v = a_op(phat)
        rhat_v = _dot(rhat, v)
        safe = rhat_v.abs() > restart_eps
        alpha = torch.where(safe, rho / torch.where(safe, rhat_v, 1.0), 0.0)
        sres = r - alpha * v
        shat = m_op(sres)
        t = a_op(shat)
        tt = _dot(t, t)
        # tt is real-valued; its ``real`` view orders it in complex solves
        # too (JAX compares complex values by their real part first)
        big = tt.real > restart_eps
        omega = torch.where(big, _dot(t, sres) / torch.where(big, tt, 1.0), 0.0)
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
        krylov.COUNTS.plain_iterations += 1

    converged = host(span("sprs.bicgstab.sync"), bool, done)
    return BiCgStabResult(
        x=x,
        converged=converged,
        iterations=it,
        residual_norm=host(span("sprs.bicgstab.sync"), float, norm(b - a_op(x))),
    )


def _fused(a_op, precond, b, x0, r0, tol, max_iter, restart_eps) -> BiCgStabResult:
    """The loop through K8's passes (``ops/cuda/krylov.py``) from x0 and
    its residual r0 = b − A·x0.  x, r, r̂, p and s are buffers of their
    own, allocated once and updated in place by the passes; ``x0`` and
    ``r0`` are copied, never written.  The set-up and the final residual are
    :func:`_plain`'s; the scalars live in the workspace's ``sc``, of
    which the host reads ``done`` once an iteration.  A matvec or
    preconditioner result of another shape, type or device than b
    raises."""
    m_op = (lambda v: v) if precond is None else (
        lambda v: krylov.vector(precond(v), b, "the preconditioner's result"))

    def a_op_checked(v):
        return krylov.vector(a_op(v), b, "the matvec's result")

    norm = torch.linalg.vector_norm
    x = krylov.vector(x0, b, "x0").clone()
    b_norm = norm(b)
    tiny = b_norm.new_tensor(1e-300)
    threshold = tol * torch.maximum(b_norm, tiny)
    r = krylov.vector(r0, b, "the first residual").clone()
    rhat, p, s = r.clone(), r.clone(), torch.empty_like(r)
    w = krylov.workspace(b, _dot(r, r), threshold, norm(r) <= threshold, restart_eps, tiny)
    done = w.sc[krylov.DONE]
    it = 0
    while it < max_iter and not host(span("sprs.bicgstab.sync"), bool, done):
        phat = m_op(p)
        v = a_op_checked(phat)
        krylov.rhat_dot_v(rhat, v, w)
        krylov.s_update(r, v, s, w)
        shat = m_op(s)
        t = a_op_checked(shat)
        krylov.t_sums(t, s, w)
        krylov.xr_update(x, phat, shat, s, t, r, rhat, w)
        ax = a_op_checked(x)
        krylov.true_residual(b, ax, w)
        krylov.p_update(b, ax, r, rhat, p, v, w)
        it += 1
        krylov.COUNTS.fused_iterations += 1

    converged = host(span("sprs.bicgstab.sync"), bool, done)
    return BiCgStabResult(
        x=x,
        converged=converged,
        iterations=it,
        residual_norm=host(span("sprs.bicgstab.sync"), float, norm(b - a_op(x))),
    )


def _with_cap(v: CsVec, cap: int) -> CsVec:
    """Re-pad a CsVec to capacity ``cap``; more live entries raise."""
    if v.cap == cap:
        return v
    if v.nnz > cap:
        raise CapacityError(v.nnz, cap)
    k = min(v.cap, cap)
    idx = v.indices.new_zeros(cap)
    dat = v.data.new_zeros(cap)
    idx[:k] = v.indices[:k]
    dat[:k] = v.data[:k]
    return CsVec(idx, dat, v.nnz_arr, v.dim)


def bicgstab_sparse(
    mat: CsMat,
    b: CsVec,
    x0: CsVec = None,
    *,
    cap: int = None,
    tol: float = 1e-8,
    max_iter: int = 200,
    restart_eps: float = 1e-30,
) -> BiCgStabResult:
    """BiCGSTAB whose iterates x, r, p, v, s, t stay :class:`CsVec` of
    one capacity ``cap`` (default: the dimension, always enough).  Every
    merge, scale and sparse matvec (``A @ v``, SpGEMM against the
    vector's column view) gives capacity-``cap`` vectors, and support
    outgrowing ``cap`` raises :class:`CapacityError`.

    A host-driven loop with the dense solver's two safeguards: a soft
    restart when the shadow residual decorrelates, and a hard restart
    that checks the TRUE residual before declaring convergence.  It suits
    problems whose iterates stay sparse, such as a point source on a
    short horizon.
    """
    from ..ops import matmul

    if not isinstance(b, CsVec):
        raise ShapeError("bicgstab_sparse needs a CsVec rhs")
    if mat.shape[0] != mat.shape[1] or mat.shape[1] != b.dim:
        raise ShapeError(f"bicgstab_sparse: {mat.shape} @ ({b.dim},)")
    n = b.dim
    if cap is None:
        cap = n
    a = mat.to_csr()

    def mv(v):
        return _with_cap(matmul(a, v, out_cap=cap, prod_cap=None), cap)

    def lc(u, alpha, v):
        """u + alpha·v at capacity ``cap``."""
        return u._binop(v.scale(alpha), torch.add, out_cap=cap)

    b = _with_cap(b, cap)
    threshold = tol * max(float(b.l2_norm()), 1e-300)
    if x0 is None:
        x = _with_cap(empty_csvec(n, b.dtype, device=b.device), cap)
        r = b
    else:
        x = _with_cap(x0, cap)
        r = lc(b, -1.0, mv(x))
    r_hat = r  # frozen shadow residual
    rho = float(r_hat.dot(r))
    p = r
    converged = float(r.l2_norm()) <= threshold
    it = 0
    while not converged and it < max_iter:
        it += 1
        v = mv(p)
        denom = float(r_hat.dot(v))
        if abs(denom) < restart_eps:
            # soft restart: the shadow residual decorrelated
            r_hat = r
            rho = float(r_hat.dot(r))
            p = r
            v = mv(p)
            denom = float(r_hat.dot(v))
            if abs(denom) < restart_eps:
                break
        alpha = rho / denom
        s = lc(r, -alpha, v)
        t = mv(s)
        tt = float(t.dot(t))
        omega = float(t.dot(s)) / tt if tt > 0 else 0.0
        x = lc(lc(x, alpha, p), omega, s)
        r = lc(s, -omega, t)
        if float(r.l2_norm()) <= threshold:
            # hard restart: check the TRUE residual
            r = lc(b, -1.0, mv(x))
            if float(r.l2_norm()) <= threshold:
                converged = True
                break
            r_hat = r
            rho = float(r_hat.dot(r))
            p = r
            continue
        rho_new = float(r_hat.dot(r))
        if abs(rho_new) < restart_eps:
            r_hat = r
            rho = float(r_hat.dot(r))
            p = r
            continue
        beta = (rho_new / rho) * (alpha / omega if omega != 0 else 0.0)
        p = lc(r, beta, lc(p, -omega, v))
        rho = rho_new
    return BiCgStabResult(
        x=x, converged=bool(converged), iterations=it, residual_norm=float(r.l2_norm())
    )
