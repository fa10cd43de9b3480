"""Special matrix constructors, the counterparts of
``sprs_tpu/utils/special.py``.

* :func:`grid_laplacian` — the 2-D 5-point Laplacian with identity
  border rows (interior rows are [4, -1, -1, -1, -1]): the structure of
  the heat-diffusion example.  Nonsymmetric because of the border rows.
* :func:`dirichlet_laplacian` — the SPD interior 5-point operator
  kron(I,T) + kron(T,I) with T = tridiag(-1,2,-1): the operator for CG.
* :func:`tri_mesh_graph_laplacian` — the graph Laplacian of a triangle
  mesh (degree on the diagonal, −1 for each undirected edge).

The grid operators assemble sorted CSR in numpy, then move it to
``device``; the mesh Laplacian goes through :class:`TriMat` and is
compressed on ``device``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..errors import StructureError
from ..formats.csmat import CsMat, csmat
from ..formats.triplet import TriMat
from ..formats.util import DEFAULT_DEVICE, as_tensor


def _assemble(n, rows, cols, vals, dtype, device) -> CsMat:
    rows = np.concatenate(rows)
    cols = np.concatenate(cols)
    vals = np.concatenate(vals)
    order = np.lexsort((cols, rows))
    rows, cols, vals = rows[order], cols[order], vals[order]
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(indptr, rows + 1, 1)
    return csmat(
        (n, n),
        np.cumsum(indptr).astype(np.int32),
        cols.astype(np.int32),
        as_tensor(vals, dtype=dtype, device="cpu"),
        validate=False,
        device=device,
    )


def grid_laplacian(
    shape: tuple, dtype=torch.float64, *, device=DEFAULT_DEVICE
) -> CsMat:
    """5-point Laplacian on an nx×ny grid with identity boundary rows."""
    nx, ny = shape
    ii, jj = np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij")
    interior = ((ii > 0) & (ii < nx - 1) & (jj > 0) & (jj < ny - 1)).ravel()
    row = (ii * ny + jj).ravel()
    rows, cols, vals = [row], [row], [np.where(interior, 4.0, 1.0)]
    r_int = row[interior]
    for off in (-ny, -1, 1, ny):
        rows.append(r_int)
        cols.append(r_int + off)
        vals.append(np.full(r_int.size, -1.0))
    return _assemble(nx * ny, rows, cols, vals, dtype, device)


def dirichlet_laplacian(
    shape: tuple, dtype=torch.float64, *, device=DEFAULT_DEVICE
) -> CsMat:
    """SPD 5-point Laplacian on the interior of an nx×ny grid
    (homogeneous Dirichlet conditions eliminated)."""
    nx, ny = shape
    n = nx * ny
    ii, jj = np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij")
    row = (ii * ny + jj).ravel()
    ii, jj = ii.ravel(), jj.ravel()
    rows, cols, vals = [row], [row], [np.full(n, 4.0)]
    for off, ok in (
        (-ny, ii > 0),
        (-1, jj > 0),
        (1, jj < ny - 1),
        (ny, ii < nx - 1),
    ):
        rows.append(row[ok])
        cols.append(row[ok] + off)
        vals.append(np.full(int(ok.sum()), -1.0))
    return _assemble(n, rows, cols, vals, dtype, device)


def tri_mesh_graph_laplacian(
    n_vertices: int, triangles, *, device=DEFAULT_DEVICE
) -> CsMat:
    """Graph Laplacian of a triangle mesh, float64.

    ``triangles``: (m, 3) integer array.  L[i,i] = degree(i) (stored for
    every vertex, 0 included); L[i,j] = −1 for each mesh edge {i, j}; an
    edge shared by several triangles counts once.  The JAX version dedups
    the edges in a Python set; here one ``np.unique`` of the packed edge
    keys does it, which gives the same matrix array for array.
    """
    n = int(n_vertices)
    tri = np.asarray(triangles, dtype=np.int64).reshape(-1, 3)
    if tri.size and (tri.min() < 0 or tri.max() >= n):
        raise StructureError.out_of_range("triangle vertex out of range")
    u = np.concatenate([tri[:, 0], tri[:, 1], tri[:, 0]])
    v = np.concatenate([tri[:, 1], tri[:, 2], tri[:, 2]])
    keep = u != v
    edges = np.unique(np.minimum(u, v)[keep] * n + np.maximum(u, v)[keep])
    lo, hi = np.divmod(edges, n) if n else (edges, edges)
    deg = np.bincount(lo, minlength=n) + np.bincount(hi, minlength=n)
    diag = np.arange(n)
    minus = np.full(edges.size, -1.0)
    return TriMat.from_triplets(
        (n, n),
        np.concatenate([lo, hi, diag]),
        np.concatenate([hi, lo, diag]),
        np.concatenate([minus, minus, deg.astype(np.float64)]),
    ).to_csr(device=device)
