"""Action of the matrix exponential, y = exp(t·A) @ b: the counterpart of
``sprs_tpu/linalg/expm.py``.

Substepped truncated Taylor series (the Al-Mohy–Higham "expmv" family,
simplified): t is split into ``s`` substeps with ‖tA‖₁ / s ≤ θ = 3, and
each substep sums (hA)ʲ b / j! until the term's norm falls below ``tol``
times the sum's (at most ``m_max`` terms).  The substep count comes from
``norm(1)`` on the host.  The JAX loops (``fori_loop`` over substeps, a
masked ``while_loop`` over terms) are Python loops here, with one host
synchronisation per term to read the stopping test.  Each term is one
product through the structure dispatch: ``prepare_spmv`` (K1 on a banded
matrix on the card) for a vector ``b``, ``prepare_spmm`` (K2) for a
block ``b``.
"""

from __future__ import annotations

import math
from typing import Callable, Union

import torch

from ..formats.csmat import CsMat
from ._dispatch import as_matvec, as_vector

THETA = 3.0  # per-substep series budget: about 20 terms at tol 1e-10


def expm_multiply(
    mat: Union[CsMat, Callable],
    b,
    *,
    t: float = 1.0,
    tol: float = 1e-10,
    m_max: int = 55,
) -> torch.Tensor:
    """y = exp(t A) b for a square sparse A (or a product callable).

    ``b`` may be a vector (n,) or a block (n, k); a numpy ``b`` goes to
    ``mat``'s device.  A callable gets the fixed budget ‖A‖₁ = 16.

    >>> import numpy as np
    >>> import sprs_tpu_torch as st
    >>> from sprs_tpu_torch.linalg import expm_multiply
    >>> a = st.from_dense(np.array([[0.0, 1.0], [-1.0, 0.0]]), device="cpu")
    >>> y = expm_multiply(a, np.array([1.0, 0.0]), t=np.pi / 2, tol=1e-14)
    >>> np.allclose(y.numpy(), [0.0, -1.0], atol=1e-12)
    True
    """
    b = as_vector(b, mat)
    a_op, _ = as_matvec(mat, multi_rhs=b.ndim == 2)
    if isinstance(mat, CsMat):
        anorm = float(mat.norm(1)) * abs(t)
    else:
        anorm = 16.0 * abs(t)
    s = max(1, math.ceil(anorm / THETA))
    h = t / s
    norm = torch.linalg.vector_norm

    y = b
    for _ in range(s):
        term, acc, j = y, y, 1
        while j <= m_max and bool(norm(term) > tol * torch.clamp(norm(acc), min=1e-300)):
            term = a_op(term) * (h / j)
            acc = acc + term
            j += 1
        y = acc
    return y
