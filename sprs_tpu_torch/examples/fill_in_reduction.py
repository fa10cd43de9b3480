"""Fill-in reduction with RCM and minimum-degree orderings: the port of
``examples/fill_in_reduction.py``.

Factor a random SPD system with no ordering, with reverse Cuthill–McKee
and with the minimum-degree (CAMD-class) ordering, and compare the LDLᵀ
factor fill and the matrix bandwidth; up to n = 60 print the pattern before and
after RCM.

Run: python -m sprs_tpu_torch.examples.fill_in_reduction [n] [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np

from sprs_tpu_torch.formats.csmat import from_dense
from sprs_tpu_torch.linalg import (
    FILL_CAMD,
    FILL_NONE,
    FILL_RCM,
    Ldl,
    bandwidth,
    reverse_cuthill_mckee,
)
from sprs_tpu_torch.ops.permutation import transform_mat_papt
from sprs_tpu_torch.utils import nnz_pattern_str


def random_spd(n, density=0.05, seed=0):
    rng = np.random.default_rng(seed)
    d = rng.standard_normal((n, n))
    d[rng.random((n, n)) > density] = 0.0
    d = (d + d.T) / 2
    d += np.eye(n) * (np.abs(d).sum(axis=1).max() + 1.0)
    return d


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("n", type=int, nargs="?", default=120)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    n = args.n
    dense = random_spd(n)
    mat = from_dense(dense, device=args.device)
    print(f"matrix: {mat.shape}, nnz={mat.nnz}, bandwidth={bandwidth(mat)}")

    rcm = reverse_cuthill_mckee(mat)
    permuted = transform_mat_papt(mat, rcm.permutation())
    print(f"after RCM: bandwidth={bandwidth(permuted)}")

    out = {"bandwidth": bandwidth(mat), "rcm_bandwidth": bandwidth(permuted)}
    b = np.linspace(1.0, 2.0, n)
    for name, fill in (("none", FILL_NONE), ("rcm", FILL_RCM), ("min-degree", FILL_CAMD)):
        num = Ldl().fill_in_reduction(fill).numeric(mat)
        x = num.solve(b).cpu().numpy()
        err = float(np.abs(dense @ x - b).max())
        out[name] = (num.l().nnz, err)
        print(f"LDL fill with {name:>10}: nnz(L) = {num.l().nnz}")
        print(f"    solve residual (inf-norm): {err:.2e}")

    if n <= 60:
        print("pattern before / after RCM:")
        print(nnz_pattern_str(mat))
        print()
        print(nnz_pattern_str(permuted))
    return out


if __name__ == "__main__":
    main()
