"""Mixed-precision direct solve: the port of
``examples/mixed_precision_refinement.py``.

An f32 LDLᵀ factor (nested-dissection ordering) of the grid Poisson
matrix is backward-stable, but its forward error grows with cond(A).
``refine_solve`` runs iterative refinement with f64 residuals, computed
on the matrix's device (the DIA kernel on the card): each step costs one
O(nnz) residual and one O(lnz) solve, and the backward error reaches the
f64 level while the factor stays f32.

Run: python -m sprs_tpu_torch.examples.mixed_precision_refinement [grid] [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from sprs_tpu_torch.linalg import Ldl, refine_solve
from sprs_tpu_torch.utils import dirichlet_laplacian


def main(argv=None) -> list:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("grid", type=int, nargs="?", default=64)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    a = dirichlet_laplacian((args.grid, args.grid), device=args.device)
    n = a.shape[0]
    print(f"Poisson system: n={n}")

    num = Ldl().fill_in_reduction("nd").check_symmetry(False).numeric(a.astype(torch.float32))
    b = np.linspace(1.0, 2.0, n)
    x, info = refine_solve(a, num, b, steps=4, rtol=1e-14)
    errs = info["backward_errors"]
    print("backward error per refinement step:")
    for i, e in enumerate(errs):
        print(f"  step {i}: {e:.3e}")
    if not errs[-1] < 1e-12:
        raise RuntimeError(f"refinement stopped at backward error {errs[-1]:.3e}")
    print("refined solve reached f64-class backward error with an f32 factor")
    return errs


if __name__ == "__main__":
    main()
