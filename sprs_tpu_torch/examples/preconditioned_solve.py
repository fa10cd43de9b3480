"""Preconditioned iterative solves: the port of
``examples/preconditioned_solve.py``.

Zero-fill incomplete factorizations (ILU(0)/IC(0): host numeric,
level-scheduled application on the device) plugged into CG, BiCGSTAB and
LOBPCG.  Prints the iteration counts on:

* the SPD interior Laplacian (CG vs IC(0)-PCG),
* a nonsymmetric operator with an advection term on the Laplacian's
  pattern (BiCGSTAB vs ILU(0)-BiCGSTAB),
* the three smallest eigenpairs of the Laplacian (LOBPCG vs IC(0)-LOBPCG).

Run: python -m sprs_tpu_torch.examples.preconditioned_solve [side] [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np

from sprs_tpu_torch.formats.csmat import from_dense
from sprs_tpu_torch.linalg import bicgstab, cg, ic0, ilu0, lobpcg
from sprs_tpu_torch.utils import dirichlet_laplacian


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("side", type=int, nargs="?", default=24)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    side, device = args.side, args.device
    lap = dirichlet_laplacian((side, side), device=device)
    n = lap.shape[0]
    b = np.ones(n)

    out = {}
    out["cg"] = cg(lap, b, tol=1e-8, max_iter=4 * n)
    out["ic0_cg"] = cg(lap, b, tol=1e-8, max_iter=4 * n, precond=ic0(lap))
    for key, label in (("cg", "cg      plain"), ("ic0_cg", "cg   ic0-pcg")):
        r = out[key]
        print(f"{label}: iters={r.iterations} residual={r.residual_norm:.2e} "
              f"converged={r.converged}")

    # nonsymmetric: an advection term on the Laplacian's off-diagonal pattern
    d = lap.to_dense().cpu().numpy()
    rng = np.random.default_rng(0)
    adv = np.zeros_like(d)
    off_diag = (d != 0) & ~np.eye(n, dtype=bool)
    adv[off_diag] = 0.3 * rng.standard_normal(int(off_diag.sum()))
    a = from_dense(d + adv, device=device)
    out["bicgstab"] = bicgstab(a, b, tol=1e-8, max_iter=4 * n)
    out["ilu0_bicgstab"] = bicgstab(a, b, tol=1e-8, max_iter=4 * n, precond=ilu0(a))
    for key, label in (("bicgstab", "bicgstab plain"), ("ilu0_bicgstab", "bicgstab ilu0")):
        r = out[key]
        print(f"{label}: iters={r.iterations} residual={r.residual_norm:.2e} "
              f"converged={r.converged}")

    x0 = np.random.default_rng(1).standard_normal((n, 3))
    out["lobpcg"] = lobpcg(lap, x0, tol=1e-7, max_iter=300)
    out["ic0_lobpcg"] = lobpcg(lap, x0, tol=1e-7, max_iter=300, precond=ic0(lap))
    for key, label in (("lobpcg", "lobpcg  plain"), ("ic0_lobpcg", "lobpcg ic0   ")):
        r = out[key]
        print(f"{label}: iters={r.iterations} "
              f"eigs={np.round(r.eigenvalues.cpu().numpy(), 5)}")
    return out


if __name__ == "__main__":
    main()
