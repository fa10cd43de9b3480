"""Sparse binary operations (add, sub, elementwise) by merge-compress, the
PyTorch counterpart of ``sprs_tpu/ops/binop.py``.

Both operands' entries are concatenated with two value channels (the lhs
rides channel 0, the rhs channel 1), one sort-and-compress merges them,
and the operator is applied to the per-position channel sums.  The result
is sorted by construction.

Contract, as in the JAX package: ``op(0, 0) == 0``, because unstored
entries are implicit zeros.  Stored zeros that the operator produces are
kept.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..errors import ShapeError
from ..formats.csmat import CsMat
from ..formats.util import as_tensor, compress_coo, valid_mask


def csmat_binop(
    a: CsMat, b: CsMat, op: Callable, *, out_cap: Optional[int] = None
) -> CsMat:
    """Elementwise ``op`` over the union pattern of A and B.

    The result takes the lhs's storage (the rhs is reoriented if needed).
    ``out_cap`` defaults to nnz(A) + nnz(B), the union's bound; the result
    is then re-padded to the true union size.
    """
    if a.shape != b.shape:
        raise ShapeError(f"binop: shape mismatch {a.shape} vs {b.shape}")
    if a.storage != b.storage:
        b = b.to_other_storage()
    if out_cap is None:
        out_cap = max(a.nnz + b.nnz, 1)
    # outer_ids put each operand's padding on the sentinel row outer_dims,
    # which compress_coo drops
    res = compress_coo(
        torch.cat([a.outer_ids(), b.outer_ids()]),
        torch.cat([a.indices, b.indices]),
        (
            torch.cat([a.data, a.data.new_zeros(b.cap)]),
            torch.cat([b.data.new_zeros(a.cap), b.data]),
        ),
        a.cap + b.cap,
        a.outer_dims,
        a.inner_dims,
        out_cap,
    )
    out = op(res.values[0], res.values[1])
    out = torch.where(valid_mask(out_cap, res.nnz, out.device), out, torch.zeros_like(out))
    c = CsMat(res.indptr, res.indices, out, a.shape, a.storage)
    return c.with_cap(max(int(res.required_nnz), 1))


def add(a: CsMat, b: CsMat, **kw) -> CsMat:
    return csmat_binop(a, b, torch.add, **kw)


def sub(a: CsMat, b: CsMat, **kw) -> CsMat:
    return csmat_binop(a, b, torch.sub, **kw)


def mul_elementwise(a: CsMat, b: CsMat, **kw) -> CsMat:
    """Hadamard product over the union pattern."""
    return csmat_binop(a, b, torch.mul, **kw)


def maximum(a: CsMat, b: CsMat, **kw) -> CsMat:
    return csmat_binop(a, b, torch.maximum, **kw)


def minimum(a: CsMat, b: CsMat, **kw) -> CsMat:
    return csmat_binop(a, b, torch.minimum, **kw)


def mul_dense(a: CsMat, dense) -> CsMat:
    """Hadamard product with a dense matrix: only A's stored entries can be
    nonzero, so the result keeps A's pattern."""
    dense = as_tensor(dense, device=a.device)
    if tuple(dense.shape) != a.shape:
        raise ShapeError(f"mul_dense: {a.shape} vs {tuple(dense.shape)}")
    outer = a.outer_ids().to(torch.int64).clamp(max=a.outer_dims - 1)
    inner = a.indices.to(torch.int64)
    r, c = (outer, inner) if a.is_csr else (inner, outer)
    prod = a.data * dense[r.clamp(min=0), c.clamp(min=0)]
    return a.with_data(torch.where(a.live_mask(), prod, torch.zeros_like(prod)))


def add_dense(a: CsMat, dense) -> torch.Tensor:
    """Sparse + dense is dense."""
    dense = as_tensor(dense, device=a.device)
    if tuple(dense.shape) != a.shape:
        raise ShapeError(f"add_dense: {a.shape} vs {tuple(dense.shape)}")
    return a.to_dense() + dense
