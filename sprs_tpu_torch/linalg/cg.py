"""Conjugate gradient (optionally preconditioned) for SPD systems, the
counterpart of ``sprs_tpu/linalg/cg.py``.

The same recurrences and masked guards as the JAX solver's
``lax.while_loop``, run as a Python loop with one host synchronisation
per iteration to read ``done``.  One matvec per iteration, plus the
initial and the final residual: iterations + 2 in all.  Each host read
of a device value runs in a ``sprs.cg.sync`` profiler span.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Union

import torch

from .._span import span
from ..errors import ShapeError
from ..formats.csmat import CsMat
from ._dispatch import as_matvec, as_vector
from .bicgstab import _dot


@dataclasses.dataclass
class CgResult:
    x: torch.Tensor
    converged: bool
    iterations: int
    residual_norm: float


def _host(cast, value):
    """``cast(value)`` for a device value: the host waits for the device
    here."""
    with span("sprs.cg.sync"):
        return cast(value)


def cg(
    mat: Union[CsMat, Callable],
    b,
    x0=None,
    *,
    tol: float = 1e-8,
    max_iter: int = 1000,
    precond: Optional[Callable] = None,
) -> CgResult:
    """Solve A x = b for SPD A; ``mat`` may be a CsMat or a matvec
    callable.  ``precond`` applies M⁻¹ (must also be SPD).  Converged
    when the recursive residual satisfies ‖r‖ ≤ tol·‖b‖."""
    a_op, n = as_matvec(mat)
    m_op = precond if precond is not None else (lambda v: v)
    b = as_vector(b, mat)
    if n is not None and b.shape != (n,):
        raise ShapeError(f"rhs shape {tuple(b.shape)}, expected ({n},)")
    x = torch.zeros_like(b) if x0 is None else as_vector(x0, b)
    norm = torch.linalg.vector_norm

    b_norm = norm(b)
    # the floor in the norm's real type: 0 in float32 (and complex64), as
    # in the JAX solver; torch.maximum takes no complex operand
    threshold = tol * torch.maximum(b_norm, b_norm.new_tensor(1e-300))

    r = b - a_op(x)
    z = m_op(r)
    p = z
    rz = _dot(r, z)
    it = 0
    done = norm(r) <= threshold
    while it < max_iter and not _host(bool, done):
        ap = a_op(p)
        pap = _dot(p, ap)
        safe = pap.abs() > 1e-300
        alpha = torch.where(safe, rz / torch.where(safe, pap, 1.0), 0.0)
        x = x + alpha * p
        r = r - alpha * ap
        z = m_op(r)
        rz_new = _dot(r, z)
        beta = torch.where(
            rz.abs() > 0, rz_new / torch.where(rz.abs() > 0, rz, 1.0), 0.0
        )
        p = z + beta * p
        rz = rz_new
        done = norm(r) <= threshold
        it += 1

    converged = _host(bool, done)
    return CgResult(
        x=x,
        converged=converged,
        iterations=it,
        residual_norm=_host(float, norm(b - a_op(x))),
    )
