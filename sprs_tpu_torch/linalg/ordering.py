"""Fill-reducing orderings: (reverse) Cuthill–McKee, the counterpart of
``sprs_tpu/linalg/ordering.py``.

A customizable Cuthill–McKee with pluggable start-vertex strategies
(next, minimum degree, George–Liu pseudo-peripheral) and direction
(forward or reversed), returning the permutation plus the
connected-component boundaries.  Host-side symbolic analysis
(sequential BFS over an irregular graph); the pseudo-peripheral case
runs in the port's native library where it is built.  The permutation
it produces lands on the matrix's device.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

import torch

from .. import native
from ..errors import NonSquareMatrixError
from ..formats.csmat import CsMat
from ..ops.permutation import Permutation


@dataclasses.dataclass
class OrderingResult:
    """Permutation + connected-component delimiters .

    ``perm`` maps new index -> old index; component k spans
    ``perm[connected_parts[k]:connected_parts[k+1]]``.
    """

    perm: np.ndarray
    connected_parts: List[int]
    device: torch.device = torch.device("cpu")

    def permutation(self) -> Permutation:
        """The ordering as a Permutation on the matrix's device."""
        return Permutation.from_array(self.perm.astype(np.int32), check=False,
                                      device=self.device)


def _graph_csr(mat: CsMat):
    if mat.shape[0] != mat.shape[1]:
        raise NonSquareMatrixError("ordering requires a square symmetric matrix")
    csr = mat.to_csr()
    indptr = csr.indptr.cpu().numpy()
    nnz = int(indptr[-1])
    return indptr, csr.indices[:nnz].cpu().numpy(), csr.shape[0]


def _degrees(indptr, indices, n):
    deg = np.zeros(n, dtype=np.int64)
    for i in range(n):
        row = indices[indptr[i] : indptr[i + 1]]
        deg[i] = row.size - np.count_nonzero(row == i)
    return deg


def _rooted_level_structure(indptr, indices, root, visited_global):
    """BFS levels from root, restricted to unvisited vertices."""
    levels = [[root]]
    seen = {root}
    while True:
        nxt = []
        for v in levels[-1]:
            for u in indices[indptr[v] : indptr[v + 1]]:
                u = int(u)
                if u not in seen and not visited_global[u]:
                    seen.add(u)
                    nxt.append(u)
        if not nxt:
            return levels
        levels.append(nxt)


def pseudo_peripheral_vertex(indptr, indices, deg, start, visited) -> int:
    """George–Liu pseudo-peripheral finder: walk to
    a min-degree vertex of the deepest BFS level until eccentricity stops
    growing."""
    x = start
    levels = _rooted_level_structure(indptr, indices, x, visited)
    ecc = len(levels)
    while True:
        last = levels[-1]
        y = min(last, key=lambda v: deg[v])
        levels_y = _rooted_level_structure(indptr, indices, y, visited)
        if len(levels_y) <= ecc:
            return y
        x, levels, ecc = y, levels_y, len(levels_y)


def cuthill_mckee_custom(
    mat: CsMat,
    *,
    start: str = "pseudo_peripheral",
    reversed_order: bool = True,
) -> OrderingResult:
    """Customizable Cuthill–McKee.

    ``start``: "next" (first unvisited), "min_degree", or
    "pseudo_peripheral" (default, matching ordering.rs:546-559).
    ``reversed_order=True`` gives Reverse Cuthill–McKee.
    """
    indptr, indices, n = _graph_csr(mat)
    if start == "pseudo_peripheral":
        fast = native.rcm(indptr, indices, n, reversed_order=reversed_order)
        if fast is not None:
            perm, parts = fast
            return OrderingResult(
                perm=perm.astype(np.int64), connected_parts=parts, device=mat.device
            )
    deg = _degrees(indptr, indices, n)
    visited = np.zeros(n, dtype=bool)
    perm = np.empty(n, dtype=np.int64)
    pos = 0
    parts = [0]

    while pos < n:
        unvisited = np.flatnonzero(~visited)
        if start == "next":
            root = int(unvisited[0])
        elif start == "min_degree":
            root = int(unvisited[np.argmin(deg[unvisited])])
        elif start == "pseudo_peripheral":
            seed = int(unvisited[0])
            root = pseudo_peripheral_vertex(indptr, indices, deg, seed, visited)
        else:
            raise ValueError(f"unknown start strategy {start!r}")

        # BFS with neighbors visited in increasing-degree order
        # (ordering.rs:476-521)
        queue = [root]
        visited[root] = True
        while queue:
            v = queue.pop(0)
            perm[pos] = v
            pos += 1
            nbrs = [
                int(u)
                for u in indices[indptr[v] : indptr[v + 1]]
                if not visited[u]
            ]
            nbrs.sort(key=lambda u: deg[u])
            for u in nbrs:
                visited[u] = True
                queue.append(u)
        parts.append(pos)

    if reversed_order:
        perm = perm[::-1].copy()
        total = parts[-1]
        parts = [total - p for p in reversed(parts)]
    return OrderingResult(perm=perm, connected_parts=parts, device=mat.device)


def reverse_cuthill_mckee(mat: CsMat) -> OrderingResult:
    """Default RCM: pseudo-peripheral start, reversed ."""
    return cuthill_mckee_custom(
        mat, start="pseudo_peripheral", reversed_order=True
    )


def cuthill_mckee(mat: CsMat) -> OrderingResult:
    return cuthill_mckee_custom(
        mat, start="pseudo_peripheral", reversed_order=False
    )


def bandwidth(mat: CsMat) -> int:
    """Matrix bandwidth max|i-j| over stored entries — the quantity RCM
    minimizes; used by tests to assert ordering quality."""
    csr = mat.to_csr()
    nnz = csr.nnz
    if nnz == 0:
        return 0
    rows = csr.outer_ids()[:nnz].to(torch.int64)
    return int((rows - csr.indices[:nnz].to(torch.int64)).abs().max())
