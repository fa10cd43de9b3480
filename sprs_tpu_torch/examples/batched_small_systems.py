"""Same-pattern batching: N small systems as the lanes of one batched
factor, one batched solve and one batched product, the port of
``examples/batched_small_systems.py``.

A parameter sweep / ensemble workload: the same sparsity pattern with N
value sets (a Dirichlet Laplacian scaled per member, the
refactorization shape).  One symbolic analysis and plan serve the whole
family; ``BatchedLdl`` factors and solves the N members together and
``batch_spmv`` checks the N residuals in one product.

Run: python -m sprs_tpu_torch.examples.batched_small_systems [side] [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from sprs_tpu_torch.linalg import Ldl
from sprs_tpu_torch.ops import BatchedLdl, batch_spmv
from sprs_tpu_torch.utils.special import dirichlet_laplacian


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("side", type=int, nargs="?", default=12)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    mat = dirichlet_laplacian((args.side, args.side), device=args.device)
    n = mat.shape[0]
    N = 8
    rng = np.random.default_rng(0)
    scales = rng.random(N) + 0.5

    # one symbolic analysis + plan for the whole family
    sym = Ldl().fill_in_reduction("camd").check_symmetry(False).symbolic(mat)
    bl = BatchedLdl(sym)

    a = mat.to_csr()
    data = a.data[None] * torch.from_numpy(scales).to(a.device)[:, None]  # (N, nnz)

    # N factorizations as the lanes of one batched factor
    lx, d = bl.factor(data)

    # N solves (the panel solve works in the permuted space)
    b = torch.from_numpy(rng.standard_normal((N, n))).to(a.device)
    b_p = b[:, sym.perm.perm.long()] if sym.perm is not None else b
    x = bl.solve(lx, d, b_p)
    if sym.perm is not None:
        x = x[:, sym.perm.inv.long()]

    # N residual checks in one product: r = A_i x_i - b_i
    r = batch_spmv(mat, data, x) - b
    rel = (r.abs().amax(dim=1) / b.abs().amax(dim=1)).cpu().numpy()
    print("max relative residual over", N, "systems:", float(rel.max()))
    assert rel.max() < 1e-4
    print("OK")
    return {"x": x, "b": b, "data": data, "rel": rel}


if __name__ == "__main__":
    main()
