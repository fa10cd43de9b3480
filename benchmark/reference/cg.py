"""Plain conjugate gradient: ``iters`` steps from x = 0, no
preconditioner, no early stop; returns x and the true residual norm."""

from __future__ import annotations

import torch


def cg(matvec, b: torch.Tensor, iters: int):
    x = torch.zeros_like(b)
    r = b.clone()
    p = r.clone()
    rz = torch.dot(r, r)
    for _ in range(iters):
        ap = matvec(p)
        alpha = rz / torch.dot(p, ap)
        x = x + alpha * p
        r = r - alpha * ap
        rz_new = torch.dot(r, r)
        p = r + (rz_new / rz) * p
        rz = rz_new
    return x, float(torch.linalg.vector_norm(b - matvec(x)))
