"""Same-pattern batch API, the counterpart of ``sprs_tpu/ops/batch.py``.

N matrices that share one ``indptr/indices`` structure carry a leading
batch axis on their values only, and each entry point runs the N
members together: the products as one segment sum over an (N, cap)
value array, SpGEMM as one pattern pass and one batched
gather-multiply-sum, LDLᵀ as the level-batched numeric and the panel
solves with a leading member axis.  The JAX package reaches the same by
``jax.vmap``; here the batch axis is explicit.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..errors import ShapeError
from ..formats.csmat import CsMat
from ..formats.util import as_tensor, compress_coo, index_sum_


def _batched(arr: torch.Tensor, n: int) -> bool:
    if arr.ndim == n:
        return False
    if arr.ndim == n + 1:
        return True
    raise ShapeError(f"expected {n}- or {n + 1}-D operand, got {arr.ndim}-D")


def _segment_sum(mat: CsMat, data: torch.Tensor, x: torch.Tensor, vec: bool) -> torch.Tensor:
    """Σ over stored slots of data·x[src] into dst, with a leading batch
    axis on ``data`` (N, cap) and/or ``x`` (N, cols[, k])."""
    outer = mat.outer_ids()
    live = outer < mat.outer_dims
    outer = torch.where(live, outer, 0).to(torch.int64)
    inner = mat.indices.to(torch.int64)
    src, dst = (inner, outer) if mat.is_csr else (outer, inner)
    data = data if data.ndim == 2 else data[None]
    x = x if x.ndim == (2 if vec else 3) else x[None]
    if vec:
        contrib = torch.where(live, data * x[:, src], 0)
    else:
        contrib = torch.where(live[:, None], data[:, :, None] * x[:, src], 0)
    N = max(data.shape[0], x.shape[0])
    rest = contrib.shape[2:]
    y = torch.zeros((N * mat.rows,) + rest, dtype=contrib.dtype, device=contrib.device)
    # member i's rows at i·rows + dst, each summed in one fixed order (index_sum_)
    # (ops/prod.py)
    slot = (torch.arange(N, device=dst.device)[:, None] * mat.rows + dst).reshape(-1)
    y = index_sum_(y, slot, contrib.expand((N,) + contrib.shape[1:]).reshape((-1,) + rest))
    return y.view((N, mat.rows) + rest)


def batch_spmv(mat: CsMat, data, x) -> torch.Tensor:
    """y[i] = A(data[i]) @ x[i] for N same-pattern matrices.

    ``data`` is (N, cap) (or (cap,) to broadcast one matrix), ``x`` is
    (N, cols) (or (cols,) to broadcast one vector); with neither batched
    this is ``spmv``.

    >>> import numpy as np
    >>> import sprs_tpu_torch as st
    >>> m = st.from_dense(np.array([[2.0, 0.0], [0.0, 3.0]]), device="cpu")
    >>> d = np.stack([m.data.numpy(), 2 * m.data.numpy()])
    >>> st.ops.batch_spmv(m, d, np.ones(2)).tolist()
    [[2.0, 3.0], [4.0, 6.0]]
    """
    from .prod import spmv

    data = as_tensor(data, device=mat.device)
    x = as_tensor(x, device=mat.device)
    if not (_batched(data, 1) or _batched(x, 1)):
        return spmv(mat, x)
    return _segment_sum(mat, data, x, vec=True)


def batch_spmm(mat: CsMat, data, x) -> torch.Tensor:
    """Y[i] = A(data[i]) @ X[i], the multi-RHS twin of :func:`batch_spmv`
    (``X`` is (N, cols, k) or (cols, k))."""
    from .prod import spmm

    data = as_tensor(data, device=mat.device)
    x = as_tensor(x, device=mat.device)
    if not (_batched(data, 1) or _batched(x, 2)):
        return spmm(mat, x)
    return _segment_sum(mat, data, x, vec=False)


@dataclasses.dataclass(frozen=True)
class BatchedCsMat:
    """N same-pattern matrices: shared structure, batched values.

    ``indptr``/``indices`` are the one shared pattern; ``data`` is
    (N, cap).  ``member(i)`` materializes one :class:`CsMat`."""

    indptr: torch.Tensor
    indices: torch.Tensor
    data: torch.Tensor  # (N, cap)
    shape: Tuple[int, int]
    storage: str

    @property
    def n_batch(self) -> int:
        return self.data.shape[0]

    def member(self, i) -> CsMat:
        return CsMat(self.indptr, self.indices, self.data[i], self.shape, self.storage)


def batch_spgemm(a: CsMat, b: CsMat, a_data, b_data, *, prod_cap: Optional[int] = None,
                 out_cap: Optional[int] = None) -> BatchedCsMat:
    """C[i] = A(a_data[i]) @ B(b_data[i]) over shared CSR patterns.

    The ESC pattern pass (expand, sort, compress) depends only on the
    patterns, so it runs once: it gives C's structure and, for every
    partial product, its A slot, B slot and C slot.  The N members'
    values are then one gather-multiply over (N, products) and one
    accumulating ``index_put_`` into (N, out_cap) (ordered sums on the
    card).  Caps default to the exact symbolic counts
    (:func:`~sprs_tpu_torch.ops.spgemm.spgemm_caps`)."""
    from .spgemm import _expand_slots, spgemm_caps

    if not (a.is_csr and b.is_csr):
        raise ShapeError("batch_spgemm takes CSR operands (the values follow their slots)")
    if a.cols != b.rows:
        raise ShapeError(f"batch_spgemm: {a.shape} @ {b.shape}")
    a_data = as_tensor(a_data, device=a.device)
    b_data = as_tensor(b_data, device=a.device)
    for arr in (a_data, b_data):
        _batched(arr, 1)
    a_data = a_data if a_data.ndim == 2 else a_data[None]
    b_data = b_data if b_data.ndim == 2 else b_data[None]
    if prod_cap is None or out_cap is None:
        p, o = spgemm_caps(a, b)
        prod_cap = prod_cap if prod_cap is not None else max(p, 1)
        out_cap = out_cap if out_cap is not None else max(o, 1)
    owner, q, valid, total = _expand_slots(a, b.indptr[:-1], b.indptr[1:] - b.indptr[:-1],
                                           b.cap, prod_cap)
    rows = torch.where(valid, a.outer_ids()[owner].to(torch.int64), a.rows)
    cols = torch.where(valid, b.indices[q].to(torch.int64), 0)
    c = compress_coo(rows, cols, (), total, a.rows, b.cols, out_cap)
    # each product's C slot: its (row, col) key among C's sorted keys
    nnz = int(c.nnz)
    c_rows = torch.repeat_interleave(torch.arange(a.rows, device=a.device),
                                     (c.indptr[1:] - c.indptr[:-1]).to(torch.int64))
    c_keys = c_rows * b.cols + c.indices[:nnz].to(torch.int64)
    keys = rows * b.cols + cols
    if nnz:
        slot = torch.searchsorted(c_keys, keys).clamp_(max=nnz - 1)
        slot = torch.where(valid & (c_keys[slot] == keys), slot, out_cap)
    else:
        slot = torch.full_like(keys, out_cap)
    vals = a_data[:, owner] * b_data[:, q]  # (N, products)
    N = vals.shape[0]
    data = torch.zeros((out_cap + 1, N), dtype=vals.dtype, device=a.device)
    index_sum_(data, slot, vals.T)
    return BatchedCsMat(c.indptr, c.indices, data[:out_cap].T.contiguous(), (a.rows, b.cols),
                        "csr")


class BatchedLdl:
    """Batched same-pattern LDLᵀ refactorization and solves.

    One symbolic, plan and round schedule (host, once); ``factor`` runs
    the level-batched numeric over (N, nnz) value sets and ``solve`` the
    panel solves over (N, n) right-hand sides, N members as lanes of the
    same phases.

    >>> import numpy as np, torch
    >>> from sprs_tpu_torch.linalg import Ldl
    >>> from sprs_tpu_torch.ops import BatchedLdl
    >>> from sprs_tpu_torch.utils import dirichlet_laplacian
    >>> a = dirichlet_laplacian((6, 6), device="cpu")
    >>> bl = BatchedLdl(Ldl().fill_in_reduction("nd").symbolic(a), kind="mf")
    >>> lx, d = bl.factor(torch.stack([a.data, 2 * a.data]))
    >>> tuple(d.shape)
    (2, 36)
    """

    def __init__(self, sym, *, kind: str = "super", **plan_kwargs):
        self.sym = sym
        self.plan = sym.mf_plan(**plan_kwargs) if kind == "mf" else sym.super_plan(**plan_kwargs)
        self.sched = sym.round_schedule(self.plan)

    def factor(self, data):
        """(N, nnz_a) CSR values -> ``(l_data (N, lnz), d (N, n))``."""
        data = data if isinstance(data, torch.Tensor) else as_tensor(data)
        return batched_ldl_factor(self.plan, self.sched, data)

    def solve(self, l_data: torch.Tensor, d: torch.Tensor, b):
        """Per-member panel solve in the permuted space; ``b`` is (N, n)
        or (n,)."""
        return batched_ldl_solve(self.plan, l_data, d, as_tensor(b, device=l_data.device),
                                 sched=self.sched)


def batched_ldl_factor(plan, sched, data: torch.Tensor):
    """The level-batched numeric over (N, nnz) (or (nnz,)) value sets."""
    from ..linalg.ldl_batched import numeric_batched

    return numeric_batched(plan, sched, data)


def batched_ldl_solve(plan, l_data: torch.Tensor, d: torch.Tensor, b: torch.Tensor, *,
                      sched=None):
    """Panel solves on batched factor values.  With ``sched`` (the
    factor's round schedule) the sweeps are round-batched once
    ``plan.S`` reaches the device's ``solve_batched_min_s``; else one
    supernode per step."""
    from ..linalg.ldl_super import panels_from_csc

    return batched_panel_solve(plan, panels_from_csc(plan, l_data), d, b, sched=sched)


def batched_panel_solve(plan, panels: torch.Tensor, d: torch.Tensor, b: torch.Tensor, *,
                        sched=None):
    """:func:`batched_ldl_solve` on panels already built from the factor
    values (``panels_from_csc``)."""
    from ..linalg.ldl_batched import solve_batched, solve_batched_min_s
    from ..linalg.ldl_super import solve_supernodal

    if sched is not None and plan.S >= solve_batched_min_s(panels.device):
        return solve_batched(plan, sched, panels, d, b)
    return solve_supernodal(plan, panels, d, b)
