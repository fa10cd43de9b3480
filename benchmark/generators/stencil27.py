"""HPCG's operator: the 27-point stencil on an nx × ny × nz grid
(GenerateProblem_ref: 26 on the diagonal, -1 for each neighbour that
lies inside the grid), as COO triplets in HPCG's row order, row
``ix + nx·(iy + ny·iz)``, each row's columns ascending.  The operator
has no random part; the seed goes to the right-hand sides."""

from __future__ import annotations

import torch


def offsets(nx: int, ny: int):
    """The 27 (dz, dy, dx) neighbour steps and their column offsets, in
    HPCG's loop order (z outer, x inner), which is ascending offset."""
    steps = [(dz, dy, dx) for dz in (-1, 0, 1) for dy in (-1, 0, 1) for dx in (-1, 0, 1)]
    return steps, [dz * nx * ny + dy * nx + dx for dz, dy, dx in steps]


def operator(config: dict, device) -> dict:
    """{'n', 'rows', 'cols' (int32), 'vals' (float64)} of the stencil."""
    nx, ny, nz = (int(config[k]) for k in ("nx", "ny", "nz"))
    n = nx * ny * nz
    idx = torch.arange(n, dtype=torch.int64, device=device)
    ix, iy, iz = idx % nx, (idx // nx) % ny, idx // (nx * ny)
    steps, offs = offsets(nx, ny)
    ok = torch.stack([
        (ix + dx >= 0) & (ix + dx < nx) & (iy + dy >= 0) & (iy + dy < ny)
        & (iz + dz >= 0) & (iz + dz < nz)
        for dz, dy, dx in steps
    ], 1)  # (n, 27): row-major, so the triplets come out row by row
    off = torch.tensor(offs, dtype=torch.int64, device=device)
    cols = (idx[:, None] + off[None, :])[ok]
    rows = idx[:, None].expand(n, 27)[ok]
    diag = torch.tensor([float(o == 0) for o in offs], dtype=torch.float64, device=device)
    vals = (diag * 27.0 - 1.0).expand(n, 27)[ok]  # 26 on the diagonal, -1 off it
    return {"n": n, "rows": rows.to(torch.int32), "cols": cols.to(torch.int32), "vals": vals}
