"""Stacking and block construction, the PyTorch counterpart of
``sprs_tpu/ops/construct.py``: ``vstack`` (CSR result), ``hstack`` (CSC
result), scipy-style ``bmat`` over an optional grid, and ``block_diag``.

Every variant offsets the COO coordinates of each block, concatenates
them and sort-compresses once on the blocks' device.  No entry of one
block meets an entry of another, so the compress only restores the
storage order; the capacity is the sum of the blocks' entry counts.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..errors import ShapeError
from ..formats.csmat import CSC, CSR, CsMat
from ..formats.util import compress_coo


def _stack_coo(blocks, row_offsets, col_offsets, shape, storage):
    n_outer, n_inner = shape if storage == CSR else (shape[1], shape[0])
    outer_l, inner_l, vals_l = [], [], []
    dtype = blocks[0].dtype
    for m, ro, co in zip(blocks, row_offsets, col_offsets):
        r, c, v = m.coo_arrays()
        live = m.live_mask()
        r = r.clamp(max=m.shape[0] - 1).to(torch.int64) + ro
        c = c.clamp(max=m.shape[1] - 1).to(torch.int64) + co
        o, i = (r, c) if storage == CSR else (c, r)
        v = v.to(dtype)
        outer_l.append(torch.where(live, o, n_outer))
        inner_l.append(torch.where(live, i, 0))
        vals_l.append(torch.where(live, v, torch.zeros_like(v)))
    rows = torch.cat(outer_l)
    res = compress_coo(
        rows,
        torch.cat(inner_l),
        (torch.cat(vals_l),),
        rows.shape[0],
        n_outer,
        n_inner,
        max(sum(m.nnz for m in blocks), 1),
    )
    return CsMat(res.indptr, res.indices, res.values[0], shape, storage)


def vstack(blocks: Sequence[CsMat]) -> CsMat:
    """Stack matrices vertically; the result is CSR."""
    blocks = list(blocks)
    if not blocks:
        raise ShapeError("vstack of zero matrices")
    cols = blocks[0].shape[1]
    if any(m.shape[1] != cols for m in blocks):
        raise ShapeError("vstack: inconsistent column counts")
    row_offsets, acc = [], 0
    for m in blocks:
        row_offsets.append(acc)
        acc += m.shape[0]
    return _stack_coo(blocks, row_offsets, [0] * len(blocks), (acc, cols), CSR)


def hstack(blocks: Sequence[CsMat]) -> CsMat:
    """Stack matrices horizontally; the result is CSC."""
    blocks = list(blocks)
    if not blocks:
        raise ShapeError("hstack of zero matrices")
    rows = blocks[0].shape[0]
    if any(m.shape[0] != rows for m in blocks):
        raise ShapeError("hstack: inconsistent row counts")
    col_offsets, acc = [], 0
    for m in blocks:
        col_offsets.append(acc)
        acc += m.shape[1]
    return _stack_coo(blocks, [0] * len(blocks), col_offsets, (rows, acc), CSC)


def bmat(grid: Sequence[Sequence[Optional[CsMat]]]) -> CsMat:
    """Block matrix from an optional grid, scipy-style: ``None`` blocks
    are zero, their shapes inferred from their block row and column,
    every one of which must hold at least one matrix.  CSR result."""
    nrows_g = len(grid)
    if nrows_g == 0 or len(grid[0]) == 0:
        raise ShapeError("bmat of empty grid")
    ncols_g = len(grid[0])
    if any(len(row) != ncols_g for row in grid):
        raise ShapeError("bmat: ragged grid")
    row_h = [None] * nrows_g
    col_w = [None] * ncols_g
    for i, row in enumerate(grid):
        for j, m in enumerate(row):
            if m is None:
                continue
            if row_h[i] is None:
                row_h[i] = m.shape[0]
            elif row_h[i] != m.shape[0]:
                raise ShapeError(f"bmat: block row {i} height mismatch")
            if col_w[j] is None:
                col_w[j] = m.shape[1]
            elif col_w[j] != m.shape[1]:
                raise ShapeError(f"bmat: block col {j} width mismatch")
    if any(h is None for h in row_h):
        raise ShapeError("bmat: a block row has no entries")
    if any(w is None for w in col_w):
        raise ShapeError("bmat: a block col has no entries")
    row_off = [sum(row_h[:i]) for i in range(nrows_g)]
    col_off = [sum(col_w[:j]) for j in range(ncols_g)]
    shape = (row_off[-1] + row_h[-1], col_off[-1] + col_w[-1])
    blocks, ros, cos = [], [], []
    for i, row in enumerate(grid):
        for j, m in enumerate(row):
            if m is not None:
                blocks.append(m)
                ros.append(row_off[i])
                cos.append(col_off[j])
    return _stack_coo(blocks, ros, cos, shape, CSR)


def block_diag(mats: Sequence[CsMat]) -> CsMat:
    """Block-diagonal matrix (scipy.sparse.block_diag): a diagonal
    :func:`bmat`."""
    mats = list(mats)
    n = len(mats)
    if n == 0:
        raise ShapeError("block_diag needs at least one block")
    return bmat([[mats[i] if i == j else None for j in range(n)] for i in range(n)])
