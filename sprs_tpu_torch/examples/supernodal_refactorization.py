"""Supernodal refactorization in a time-stepping loop, the port of
``examples/supernodal_refactorization.py``.

An implicit time stepper refactorizes the same sparsity pattern with
new values every step:

  1. symbolic once on the host — AMD fill-reducing ordering, etree,
     supernode detection with relaxed amalgamation (``linalg/ldl_super.py``);
  2. per step, the supernodal numeric on the device (dense panel
     products) and the supernodal solves.

Workload: the implicit heat step (I + dt·c(t)·L) x_new = x on an n×n
Dirichlet grid with a time-varying diffusion coefficient c(t): the
values change, the pattern does not.  A(c)'s values are linear in c on
the fixed pattern, so each step forms them from two value vectors.

Run: python -m sprs_tpu_torch.examples.supernodal_refactorization [n] [steps] [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from sprs_tpu_torch.formats.csmat import eye
from sprs_tpu_torch.linalg import Ldl
from sprs_tpu_torch.linalg.ldl import LdlNumeric
from sprs_tpu_torch.linalg.ldl_super import numeric_supernodal
from sprs_tpu_torch.ops import add
from sprs_tpu_torch.utils.special import dirichlet_laplacian


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("n", type=int, nargs="?", default=32)
    parser.add_argument("steps", type=int, nargs="?", default=3)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    n, dt, device = args.n, 1e-2, args.device

    lap = dirichlet_laplacian((n, n), device=device)
    m = lap.shape[0]
    ident = eye(m, torch.float64, device=device)
    # A(c) = I + dt*c*L; its values are linear in c on a fixed pattern:
    # data(c) = d1 + (c-1)*(d2-d1) with d1=A(1), d2=A(2)
    a1 = add(ident, lap.scale(dt)).to_csr()
    a2 = add(ident, lap.scale(2 * dt)).to_csr()
    d1, dd = a1.data, a2.data - a1.data

    t0 = time.perf_counter()
    sym = Ldl().fill_in_reduction("camd").check_symmetry(False).symbolic(a1)
    plan = sym.super_plan()
    t_sym = time.perf_counter() - t0
    print(f"symbolic: n={sym.n} l_nnz={sym.nnz} "
          f"supernodes={plan.S} ({t_sym*1e3:.1f} ms, host, once)")

    def step(c, b):
        lx, d = numeric_supernodal(plan, d1 + (c - 1.0) * dd)
        return LdlNumeric(sym, lx, d).solve(b, method="super")

    rng = np.random.default_rng(0)
    b0 = torch.from_numpy(rng.standard_normal(m)).to(device)
    x = b0
    for k in range(args.steps):
        c = 1.0 + 0.5 * np.sin(0.3 * k)
        t0 = time.perf_counter()
        x = step(c, x)
        float(x[0])
        print(f"step {k}: c={c:.3f} factor+solve {1e3*(time.perf_counter()-t0):.1f} ms")

    # verify one step against the dense oracle
    c = 0.7
    xs = step(c, b0).cpu().numpy()
    a_np = np.eye(m) + dt * c * lap.to_dense().cpu().numpy()
    b_np = b0.cpu().numpy()
    res = np.linalg.norm(a_np @ xs - b_np) / np.linalg.norm(b_np)
    print(f"relative residual at c={c}: {res:.2e}")
    assert res < 1e-10
    return {"n": sym.n, "l_nnz": sym.nnz, "supernodes": plan.S, "x": xs, "residual": res}


if __name__ == "__main__":
    main()
