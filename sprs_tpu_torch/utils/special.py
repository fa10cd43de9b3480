"""Special matrix constructors, the counterparts of
``sprs_tpu/utils/special.py``.

* :func:`grid_laplacian` — the 2-D 5-point Laplacian with identity
  border rows (interior rows are [4, -1, -1, -1, -1]): the structure of
  the heat-diffusion example.  Nonsymmetric because of the border rows.
* :func:`dirichlet_laplacian` — the SPD interior 5-point operator
  kron(I,T) + kron(T,I) with T = tridiag(-1,2,-1): the operator for CG.
* :func:`tri_mesh_graph_laplacian` — the graph Laplacian of a triangle
  mesh (degree on the diagonal, −1 for each undirected edge).

:func:`grid_laplacian` builds on ``device`` itself: its pattern, row by
row in ascending column order, is already sorted, so no host array of
the grid's size is made.  :func:`dirichlet_laplacian` assembles sorted
CSR in numpy, then moves it to ``device``; the mesh Laplacian goes
through :class:`TriMat` and is compressed on ``device``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..errors import StructureError
from ..formats.csmat import CsMat, csmat
from ..formats.triplet import TriMat
from ..formats.util import (
    DEFAULT_DEVICE,
    INDEX_DTYPE,
    as_tensor,
    check_index_capacity,
    torch_dtype,
)


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
    """5-point Laplacian on an nx×ny grid with identity boundary rows.

    Row ``i·ny + j`` is grid point (i, j).  An interior row holds
    [-1, -1, 4, -1, -1] at columns row − ny, row − 1, row, row + 1,
    row + ny, ascending; a border row holds 1 on the diagonal.  Built on
    ``device``: ``indptr`` is a cumulative sum of the rows' counts, and
    the entries are taken from an (n, 5) table of each row's candidates
    by a mask, in row-major order, so they come out sorted.
    """
    nx, ny = (int(s) for s in shape)
    n = nx * ny
    check_index_capacity(rows=n)
    dt = torch_dtype(dtype)
    row = torch.arange(n, dtype=torch.int64, device=device)
    ii, jj = row // max(ny, 1), row % max(ny, 1)
    interior = (ii > 0) & (ii < nx - 1) & (jj > 0) & (jj < ny - 1)
    keep = interior[:, None].repeat(1, 5)
    keep[:, 2] = True
    steps = torch.tensor([-ny, -1, 0, 1, ny], dtype=torch.int64, device=device)
    vals = torch.full((n, 5), -1, dtype=dt, device=device)
    vals[:, 2] = 1
    vals[:, 2].masked_fill_(interior, 4)
    take = keep.view(-1).nonzero().squeeze(1)
    indptr = torch.zeros(n + 1, dtype=INDEX_DTYPE, device=device)
    indptr[1:] = torch.cumsum(keep.sum(1), 0)
    return csmat(
        (n, n),
        indptr,
        (row[:, None] + steps).view(-1)[take].to(INDEX_DTYPE),
        vals.view(-1)[take],
        validate=False,
        device=device,
    )


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
