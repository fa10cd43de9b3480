"""Heat diffusion on a 2-D grid: the port of ``examples/heat.py``.

Builds the 5-point grid Laplacian with Dirichlet borders and solves the
steady state for a unit heat source at the centre three ways:

* host Gauss–Seidel,
* weighted Jacobi on the device,
* BiCGSTAB on the device through ``prepare_spmv`` (the DIA kernel K1).

Up to side 20 it prints the Laplacian's nonzero pattern first.

Run: python -m sprs_tpu_torch.examples.heat [side] [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np

from sprs_tpu_torch.linalg import bicgstab, gauss_seidel, jacobi
from sprs_tpu_torch.utils import grid_laplacian, nnz_pattern_str


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("side", type=int, nargs="?", default=10)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    side = args.side
    lap = grid_laplacian((side, side), device=args.device)

    if side <= 20:
        print("Laplacian nonzero pattern:")
        print(nnz_pattern_str(lap))

    rhs = np.zeros(side * side)
    rhs[(side // 2) * side + side // 2] = 1.0

    gs = gauss_seidel(lap, rhs, tol=1e-8, max_iter=300)
    print(
        f"gauss-seidel: iters={gs.iterations} residual={gs.residual_norm:.2e} "
        f"converged={gs.converged}"
    )
    jac = jacobi(lap, rhs, tol=1e-7, max_iter=8000, omega=0.9)
    print(
        f"jacobi(w=0.9): iters={jac.iterations} residual={jac.residual_norm:.2e} "
        f"converged={jac.converged}"
    )
    res = bicgstab(lap, rhs, tol=1e-8, max_iter=500)
    print(
        f"bicgstab(dia): iters={res.iterations} residual={res.residual_norm:.2e} "
        f"converged={res.converged}"
    )

    x_gs = gs.x.cpu().numpy()
    x_j = jac.x.cpu().numpy()
    x_b = res.x.cpu().numpy()
    print("max |jacobi - gauss_seidel| =", float(np.abs(x_j - x_gs).max()))
    print("max |bicgstab - gauss_seidel| =", float(np.abs(x_b - x_gs).max()))
    if side <= 12:
        print("steady-state grid (gauss-seidel):")
        for i in range(side):
            print(" ".join(f"{x_gs[i * side + j]:6.3f}" for j in range(side)))
    return {"gauss_seidel": gs, "jacobi": jac, "bicgstab": res}


if __name__ == "__main__":
    main()
