"""Truncated sparse SVD: largest singular triplets via LOBPCG, the
counterpart of ``sprs_tpu/linalg/svds.py``.

The largest singular values of A are the square roots of the largest
eigenvalues of the Gram operator G = AᵀA; LOBPCG finds the smallest
eigenpairs, so it runs on −G.  Each Gram product is two prepared SpMMs,
A·V then Aᵀ·(AV), both through ``prepare_spmm`` (kernel K2 for a banded
matrix on the card); Aᵀ is a storage flip and one re-sort.  Left vectors
come out as A·v / σ.  SpMMs: 2·(2·iterations + 2) inside LOBPCG and one
for the left vectors, 4·iterations + 5 in all.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..formats.csmat import CsMat
from ._dispatch import as_matvec
from .lobpcg import lobpcg


@dataclasses.dataclass
class SvdsResult:
    u: torch.Tensor  # (m, k) left singular vectors
    s: torch.Tensor  # (k,) singular values, descending
    vt: torch.Tensor  # (k, n) right singular vectors (rows)
    iterations: int
    converged: bool


def svds(
    mat: CsMat,
    k: int = 4,
    *,
    tol: float = 1e-6,
    max_iter: int = 300,
    x0=None,
    seed: int = 0,
) -> SvdsResult:
    """Largest ``k`` singular triplets of a (possibly rectangular) sparse
    matrix.  The default starting block is numpy's standard normals from
    ``seed`` (the JAX package's), in the matrix's real type."""
    a_op, _ = as_matvec(mat, square=False, multi_rhs=True)
    at_op, _ = as_matvec(mat.T.to_csr(), square=False, multi_rhs=True)

    def neg_gram(v):
        return -at_op(a_op(v))

    if x0 is None:
        x0 = np.random.default_rng(seed).standard_normal((mat.shape[1], k))
        x0 = torch.from_numpy(x0).to(mat.device, mat.data.real.dtype)
    res = lobpcg(neg_gram, x0, tol=tol, max_iter=max_iter)
    s = torch.sqrt(torch.clamp(-res.eigenvalues, min=0.0))
    v = res.eigenvectors
    u = a_op(v) / torch.clamp(s, min=1e-300)[None, :]
    return SvdsResult(
        u=u, s=s, vt=v.T, iterations=res.iterations, converged=res.converged
    )
