"""Nested-dissection fill-reducing ordering, the counterpart of
``sprs_tpu/linalg/nd.py``.

Nested dissection recursively splits the graph with small vertex
separators and eliminates them last: the etree becomes a balanced
hierarchy whose leaves are many independent subtrees and whose top is a
logarithmic stack of wide separator blocks.  On 2-D meshes fill is
O(n log n) (George 1973), and the level schedules of the factor's
triangular solves are far shallower than under RCM or minimum degree.

Algorithm: recursive BFS bisection.  Per subgraph, a two-sweep BFS
from a pseudo-peripheral vertex builds level sets; the smallest level
set near the median cut becomes the vertex separator (level sets are
valid separators: BFS edges never skip a level).  Halves recurse,
separator vertices are appended after both halves.  Pure numpy,
vectorized per level; leaves below ``leaf_size`` keep natural order.
The port's native library runs the same steps and gives the same order.
"""

from __future__ import annotations

import numpy as np

from .. import native
from ..errors import NonSquareMatrixError
from ..formats.csmat import CsMat
from ..ops.permutation import Permutation
from .amd import _symmetrized_pattern


def _neighbors(indptr, indices, front):
    """Concatenated neighbor lists of the ``front`` vertices."""
    cnt = (indptr[front + 1] - indptr[front]).astype(np.int64)
    total = int(cnt.sum())
    if total == 0:
        return np.zeros(0, dtype=indices.dtype)
    offs = np.zeros(front.shape[0], dtype=np.int64)
    np.cumsum(cnt[:-1], out=offs[1:])
    pos = (
        np.arange(total, dtype=np.int64)
        - np.repeat(offs, cnt)
        + np.repeat(indptr[front].astype(np.int64), cnt)
    )
    return indices[pos]


def _bfs_levels(indptr, indices, seed, in_sub, level):
    """BFS level assignment inside the masked subgraph.

    ``level`` is scratch (−1 outside/unvisited); returns the list of
    level sets.  Visited vertices get their level; caller must reset.
    """
    levels = []
    front = np.asarray([seed], dtype=np.int64)
    level[seed] = 0
    ln = 0
    while front.size:
        levels.append(front)
        nbr = _neighbors(indptr, indices, front)
        if nbr.size:
            nbr = nbr[in_sub[nbr] & (level[nbr] < 0)]
            nbr = np.unique(nbr).astype(np.int64)
        ln += 1
        level[nbr] = ln
        front = nbr
    return levels


def nd_order(
    mat: CsMat, *, leaf_size: int = 64, balance_window: float = 0.2
) -> Permutation:
    """Nested-dissection permutation of a symmetric pattern.

    ``leaf_size`` stops the recursion; ``balance_window`` is the
    fraction of vertices around the median BFS level searched for the
    thinnest separator.  Select via ``Ldl().fill_in_reduction('nd')``.
    """
    if mat.shape[0] != mat.shape[1]:
        raise NonSquareMatrixError("ordering requires a square matrix")
    csr = mat.to_csr()
    n = csr.shape[0]
    if n == 0:
        return Permutation.identity(0, device=mat.device)
    indptr, indices = _symmetrized_pattern(
        csr.indptr.cpu().numpy(), csr.indices.cpu().numpy(), n
    )
    fast = native.nd_order_native(
        indptr, indices, n, leaf_size, balance_window
    )
    if fast is not None:
        return Permutation.from_array(fast, check=False, device=mat.device)

    indptr = indptr.astype(np.int64)
    indices = indices.astype(np.int64)

    order = np.empty(n, dtype=np.int64)
    out_pos = 0
    level = np.full(n, -1, dtype=np.int64)
    in_sub = np.zeros(n, dtype=bool)

    # explicit stack of (vertices, emitted_separator_stack) — separators
    # are appended AFTER both halves, i.e. post-visit, so the stack
    # carries ('visit', verts) and ('emit', seps) entries.
    stack = [("visit", np.arange(n, dtype=np.int64))]
    while stack:
        tag, verts = stack.pop()
        if tag == "emit":
            order[out_pos : out_pos + verts.size] = verts
            out_pos += verts.size
            continue
        m = verts.size
        if m <= leaf_size:
            order[out_pos : out_pos + m] = verts
            out_pos += m
            continue
        in_sub[verts] = True
        # two-sweep pseudo-peripheral BFS
        levels = _bfs_levels(indptr, indices, int(verts[0]), in_sub, level)
        far = int(levels[-1][0])
        level[np.concatenate(levels)] = -1
        levels = _bfs_levels(indptr, indices, far, in_sub, level)
        visited = np.concatenate(levels)
        level[visited] = -1
        if visited.size < m:
            # disconnected: component splits off with an empty separator
            comp = visited
            rest = verts[~np.isin(verts, comp, assume_unique=True)]
            in_sub[verts] = False
            stack.append(("visit", rest))
            stack.append(("visit", comp))
            continue
        in_sub[verts] = False
        if len(levels) < 3:
            # ball-shaped (diameter < 2): no useful separator — emit
            # in natural order (dense-ish block)
            order[out_pos : out_pos + m] = verts
            out_pos += m
            continue
        sizes = np.asarray([lv.size for lv in levels], dtype=np.int64)
        csize = np.cumsum(sizes)
        half = m // 2
        lmed = int(np.searchsorted(csize, half))
        win = max(1, int(m * balance_window))
        lo = int(np.searchsorted(csize, max(half - win, 1)))
        hi = int(np.searchsorted(csize, min(half + win, m - 1)))
        lo = max(lo, 1)
        hi = min(max(hi, lo), len(levels) - 2)
        cut = lo + int(np.argmin(sizes[lo : hi + 1])) if hi >= lo else lmed
        cut = min(max(cut, 1), len(levels) - 2)
        sep = levels[cut]
        a = np.concatenate(levels[:cut]) if cut > 0 else levels[0][:0]
        b = (
            np.concatenate(levels[cut + 1 :])
            if cut + 1 < len(levels)
            else sep[:0]
        )
        # post-visit order: A, B, then the separator
        stack.append(("emit", sep))
        stack.append(("visit", b))
        stack.append(("visit", a))

    if out_pos != n:
        raise RuntimeError(f"nd_order emitted {out_pos} of {n} vertices")
    return Permutation.from_array(order.astype(np.int32), check=False, device=mat.device)
