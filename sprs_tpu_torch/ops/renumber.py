"""Locality renumbering of a far-gathering square operator, for K5.

Under a numbering without locality (an unstructured mesh's, a random
one) a row of a sparse operator reads entries of x from all over the
vector.  Where x outgrows the card's L2, each such gather is a 32-byte
sector read from device memory for the 2 to 8 bytes it uses, and K5
(``csrc/ell_spmv.cu``) runs at a fraction of its byte bound: 10.9 % on
HPCG's 27-point stencil at 256³ under a random numbering, 79 % for K1 on
the same operator in its natural order.  ``ops/prod.py::prepare_spmv``'s
ELL arm therefore renumbers such an operator once, by Cuthill–McKee
levels, so that the rows a wave of K5 reads together gather from a
window of x that stays in L2; K5 runs on the renumbered copy
(``EllMat.order``), bringing x into its order and y back to the
caller's in hand-written passes.  The arithmetic is unchanged: each row
keeps its slots in their order, so y is bit-equal to the product of the
operator as given.

:func:`locality_order` is the rule, a pure function of the matrix and an
L2 size; :func:`cuthill_mckee_levels` the ordering, level-synchronous in
torch ops on the matrix's device (no copy to the host: at 256³ the
indices are 1.8 GB); :func:`mean_gather` the distance both read.
"""

from __future__ import annotations

from typing import Iterator, Optional, Tuple

import torch

from ..formats.csmat import CsMat
from .cuda.forms import SHORT

# Levels of the ordering at most; the vertices not placed by then follow
# in their original order (any order gives the right product, only its
# speed depends on it).  A level costs a fixed handful of launches and
# four host reads, a fraction of a millisecond on the card where the level
# is small, so the bound holds the fixed cost near a second.  HPCG's
# stencil at 256³ takes 256 levels from a corner: 0.42 s in all on an
# H100, its levels of up to 196K vertices included.
MAX_LEVELS = 4096
# The ordering is kept only if it cuts the mean gather distance this much.
MIN_CUT = 4.0
# Stored entries read at a time by mean_gather: its int64 temporaries stay
# near 0.3 GB however large the matrix.
CHUNK = 1 << 25
_NONE = torch.iinfo(torch.int64).max


def l2_bytes(device: torch.device) -> Optional[int]:
    """The L2 size of ``device`` in bytes; None off a CUDA device, where
    no kernel runs and nothing is renumbered."""
    if device.type != "cuda":
        return None
    return torch.cuda.get_device_properties(device).L2_cache_size


def _entries(csr: CsMat) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
    """(row, column), both int64, of the stored entries of ``csr``, about
    :data:`CHUNK` at a time."""
    n, nnz = csr.rows, csr.nnz
    step = max(1, n * CHUNK // max(nnz, 1))
    for a in range(0, n, step):
        b = min(n, a + step)
        lo, hi = csr.indptr[[a, b]].tolist()
        counts = (csr.indptr[a + 1 : b + 1] - csr.indptr[a:b]).long()
        rows = torch.repeat_interleave(
            torch.arange(a, b, device=csr.device), counts, output_size=hi - lo)
        yield rows, csr.indices[lo:hi].long()


def mean_gather(csr: CsMat, inv: Optional[torch.Tensor] = None) -> float:
    """Mean |column - row| over the stored entries of ``csr``, in entries
    of x; with ``inv`` (original index -> new position) that of the
    renumbered operator."""
    total = torch.zeros((), dtype=torch.int64, device=csr.device)
    for rows, cols in _entries(csr):
        if inv is not None:
            rows, cols = inv[rows], inv[cols]
        total += (cols - rows).abs().sum()
    return float(total) / max(csr.nnz, 1)


def inverse(order: torch.Tensor) -> torch.Tensor:
    """The inverse permutation of ``order``, int64: inv[order[i]] = i."""
    inv = torch.empty(order.shape[0], dtype=torch.int64, device=order.device)
    inv[order.long()] = torch.arange(order.shape[0], device=order.device)
    return inv


def _next_level(csr, indptr, level, first, visited, best):
    """The unvisited neighbours of ``level`` (placed from position
    ``first`` on), ordered by (least position of a placed neighbour,
    vertex id): each candidate's key is that pair in one int64, its least
    key found by a scatter-min over the level's edges."""
    n = csr.rows
    starts = indptr[level]
    counts = indptr[level + 1] - starts
    total = int(counts.sum())
    if total == 0:
        return level[:0]
    src = torch.repeat_interleave(
        torch.arange(level.shape[0], device=level.device), counts, output_size=total)
    firsts = torch.cumsum(counts, 0) - counts
    edge = starts[src] + torch.arange(total, device=level.device) - firsts[src]
    v = csr.indices[edge].long()
    fresh = ~visited[v]
    v, src = v[fresh], src[fresh]
    key = (src + first) * n + v
    best.scatter_reduce_(0, v, key, "amin")
    # unique: sorts the keys and drops an edge repeated in the structure
    return torch.unique(key[best[v] == key]) % n


def _lone(csr: CsMat) -> torch.Tensor:
    """Bool per row: the row stores no entry off its diagonal (an identity
    Dirichlet row, an empty row)."""
    lone = torch.ones(csr.rows, dtype=torch.bool, device=csr.device)
    for rows, cols in _entries(csr):
        lone[rows[rows != cols]] = False
    return lone


def cuthill_mckee_levels(csr: CsMat) -> torch.Tensor:
    """A Cuthill–McKee ordering of the square ``csr``'s structure (each
    row's stored entries, explicit zeros included) as int64 ``order``,
    new position -> original index, computed on the matrix's device.

    Starts at a vertex of least degree (the lowest id on ties); each next
    level is the unvisited neighbours of the last, ordered by the least
    position of an already placed neighbour, then by id; a part that the
    levels do not reach restarts at the least-degree unvisited vertex.
    A vertex whose row holds nothing off its diagonal has no neighbour to
    follow, so it starts no part: it is placed where a level reaches it,
    else at the end.  Deterministic.  Not reversed: reversal changes fill,
    not the locality of a product.  After :data:`MAX_LEVELS` levels (a
    restart counts as one) the vertices left follow in their original
    order."""
    n, dev = csr.rows, csr.device
    indptr = csr.indptr.long()
    ids = torch.arange(n, device=dev)
    start_key = torch.where(_lone(csr), _NONE, (indptr[1:] - indptr[:-1]) * n + ids)
    visited = torch.zeros(n, dtype=torch.bool, device=dev)
    best = torch.full((n,), _NONE, dtype=torch.int64, device=dev)
    order = torch.empty(n, dtype=torch.int64, device=dev)
    placed = levels = 0
    level = ids[:0]
    while placed < n and levels < MAX_LEVELS:
        if level.shape[0]:
            level = _next_level(csr, indptr, level, placed - level.shape[0], visited, best)
        if not level.shape[0]:
            start = int(torch.where(visited, _NONE, start_key).min())
            if start == _NONE:
                break
            level = ids[start % n : start % n + 1]
        order[placed : placed + level.shape[0]] = level
        visited[level] = True
        placed += level.shape[0]
        levels += 1
    if placed < n:
        order[placed:] = torch.nonzero(~visited).reshape(-1)
    return order


def locality_order(csr: CsMat, l2: Optional[int]) -> Optional[torch.Tensor]:
    """``order`` (int32, new position -> original index) where the square
    CSR ``csr`` should run renumbered on a card whose L2 holds ``l2``
    bytes, else None.

    A pure function of the matrix and ``l2``.  It renumbers only a square
    matrix of a type K5 takes, with ``l2`` given, whose x outgrows the L2
    and whose entries gather far: rows run in order, so those in flight
    at once read x over about twice the mean gather distance in bytes of
    x, and that window must outgrow the L2 too.  The ordering is kept
    only if it cuts the mean distance :data:`MIN_CUT` times.  So a grid
    or mesh in its natural order, and any x that fits the L2, never pay
    for an ordering, and one that does not help (a random graph of small
    diameter) is dropped."""
    n = csr.rows
    if l2 is None or csr.cols != n or csr.dtype not in SHORT:
        return None
    item = csr.dtype.itemsize
    if n * item <= l2:
        return None
    before = mean_gather(csr) * item
    if 2 * before <= l2:
        return None
    order = cuthill_mckee_levels(csr)
    if mean_gather(csr, inverse(order)) * item * MIN_CUT > before:
        return None
    return order.to(torch.int32)
