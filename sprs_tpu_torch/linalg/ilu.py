"""Incomplete factorizations: ILU(0) and IC(0) preconditioners, the
counterpart of ``sprs_tpu/linalg/ilu.py``.

Zero-fill incomplete LU / Cholesky: the numeric runs on the host (the
port's native library where it is built, else numpy, the same sweep in
the same order, so the values are the same bits), and the factors'
triangular solves run level by level on the operand's device
(:class:`~sprs_tpu_torch.linalg.trisolve.LevelPlan`), so ``M⁻¹ r`` is a
fixed sequence of batched device sweeps inside CG, BiCGSTAB or LOBPCG
iterations.  ``__call__`` takes a vector or an (n, k) block.

Algorithm (IKJ ILU(0), Saad, Iterative Methods §10.3): for each row i,
for each k < i in pattern(i): a_ik /= u_kk, then for j > k in
pattern(i) ∩ pattern(k): a_ij -= a_ik · u_kj.  IC(0) is the symmetric
restriction producing A ≈ L·Lᵀ.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import native
from ..errors import NonSquareMatrixError, SingularMatrixError
from ..formats.csmat import CsMat, csmat
from ..formats.util import as_tensor, host_array
from .trisolve import LevelPlan, TriSchedule, build_schedule


def _ilu0_host(indptr, indices, data):
    """In-place ILU(0) numeric on CSR arrays (host numpy).

    Returns the combined factor values (L strictly-lower with implicit
    unit diagonal, U upper including diagonal) in A's own pattern."""
    n = indptr.shape[0] - 1
    vals = data.copy()
    diag_pos = np.full(n, -1, np.int64)
    for i in range(n):
        lo, hi = indptr[i], indptr[i + 1]
        cols = indices[lo:hi]
        pos = np.searchsorted(cols, i)
        if pos < hi - lo and cols[pos] == i:
            diag_pos[i] = lo + pos
    if (diag_pos < 0).any():
        missing = int(np.nonzero(diag_pos < 0)[0][0])
        raise SingularMatrixError(
            f"ilu0: structurally zero diagonal at row {missing}"
        )
    for i in range(n):
        lo, hi = int(indptr[i]), int(indptr[i + 1])
        cols = indices[lo:hi]
        for t in range(lo, hi):
            k = int(indices[t])
            if k >= i:
                break
            ukk = vals[diag_pos[k]]
            if ukk == 0:
                raise SingularMatrixError(f"ilu0: zero pivot at row {k}")
            lik = vals[t] / ukk
            vals[t] = lik
            # row k's upper part folds into row i where patterns meet
            for s in range(diag_pos[k] + 1, int(indptr[k + 1])):
                j = int(indices[s])
                p = np.searchsorted(cols, j)
                if p < hi - lo and cols[p] == j:
                    vals[lo + p] -= lik * vals[s]
    return vals, diag_pos


def _ic0_host(indptr, indices, data):
    """IC(0) on the LOWER triangle pattern of an SPD matrix: returns L
    values (CSR lower incl diagonal) with pattern = lower(A)."""
    n = indptr.shape[0] - 1
    vals = data.copy()
    diag_pos = np.empty(n, np.int64)
    for i in range(n):
        lo, hi = int(indptr[i]), int(indptr[i + 1])
        if hi == lo or indices[hi - 1] != i:
            raise SingularMatrixError(
                f"ic0: row {i} has no diagonal entry"
            )
        diag_pos[i] = hi - 1
        cols = indices[lo:hi]
        for t in range(lo, hi - 1):
            k = int(indices[t])
            # l_ik = (a_ik - sum_{j<k, j in both} l_ij l_kj) / l_kk
            # NB: sequential accumulation in ascending-column order so
            # the C++ fast path (sprs_ic0) is bit-identical
            s = 0.0
            klo, khi = int(indptr[k]), int(indptr[k + 1])
            kcols = indices[klo : khi - 1]
            common = np.intersect1d(
                cols[: t - lo], kcols, assume_unique=True
            )
            if common.size:
                pi = lo + np.searchsorted(cols, common)
                pk = klo + np.searchsorted(kcols, common)
                for a_, b_ in zip(vals[pi], vals[pk]):
                    s += float(a_) * float(b_)
            lkk = vals[diag_pos[k]]
            vals[t] = (vals[t] - s) / lkk
        d = float(vals[hi - 1])
        for p in range(lo, hi - 1):
            d -= float(vals[p]) * float(vals[p])
        if d <= 0:
            raise SingularMatrixError(
                f"ic0: non-positive pivot at row {i} (matrix not SPD "
                "enough for zero-fill factorization)"
            )
        vals[hi - 1] = np.sqrt(d)
    return vals


def _host_csr(mat: CsMat, what: str):
    """(indptr, live indices, live data) of ``mat`` in CSR with stored
    zeros dropped, on the host; bfloat16 data as float32 (``host_array``),
    which :func:`_tri` casts back."""
    if mat.shape[0] != mat.shape[1]:
        raise NonSquareMatrixError(f"{what} needs square, got {mat.shape}")
    a = mat.to_csr().compact()
    indptr = a.indptr.cpu().numpy()
    nnz = int(indptr[-1])
    return indptr, a.indices[:nnz].cpu().numpy(), host_array(a.data[:nnz])


def _tri(n, indptr, indices, vals, mat: CsMat) -> CsMat:
    """A factor on ``mat``'s device in ``mat``'s type, as the JAX
    package's factors are."""
    return csmat((n, n), np.asarray(indptr).astype(np.int32), np.asarray(indices).astype(np.int32),
                 as_tensor(vals, dtype=mat.dtype, device=mat.device), device=mat.device)


def _plan(mat: CsMat, sched: TriSchedule) -> LevelPlan:
    indptr = mat.indptr.cpu().numpy()
    return LevelPlan.build(indptr, mat.indices[: int(indptr[-1])].cpu().numpy(), sched,
                           device=mat.device)


def _apply(first: CsMat, first_plan: LevelPlan, second: CsMat, second_plan: LevelPlan, r):
    """second⁻¹ (first⁻¹ r) for a vector or an (n, k) block on the
    factors' device; the diagonals were checked when the factor was
    built."""
    r = r if isinstance(r, torch.Tensor) else torch.as_tensor(np.asarray(r))
    r = r.to(first.device)
    r = r.to(torch.promote_types(first.dtype, r.dtype))
    return second_plan.solve(second.data, first_plan.solve(first.data, r))


@dataclasses.dataclass
class Ilu0:
    """ILU(0) preconditioner: A ≈ L·U with pattern(L+U) = pattern(A).

    ``solve`` applies M⁻¹ = U⁻¹·L⁻¹ by level-scheduled device sweeps."""

    l: CsMat
    u: CsMat
    l_schedule: TriSchedule
    u_schedule: TriSchedule
    l_plan: LevelPlan
    u_plan: LevelPlan

    @classmethod
    def factor(cls, mat: CsMat) -> "Ilu0":
        indptr, indices, data = _host_csr(mat, "ilu0")
        vals = None
        if data.dtype == np.float64:
            try:
                vals = native.ilu0_numeric(indptr, indices, data)
            except ValueError as e:
                raise SingularMatrixError(str(e)) from None
        if vals is None:
            vals, _ = _ilu0_host(indptr, indices, data)
        n = mat.shape[0]
        rows = np.repeat(np.arange(n), np.diff(indptr))
        lower = indices < rows
        upper = ~lower
        # L: strictly-lower entries + explicit unit diagonal
        l_rows = np.concatenate([rows[lower], np.arange(n)])
        l_cols = np.concatenate([indices[lower], np.arange(n)])
        l_vals = np.concatenate([vals[lower], np.ones(n, vals.dtype)])
        order = np.lexsort((l_cols, l_rows))
        l_indptr = np.zeros(n + 1, np.int64)
        np.add.at(l_indptr, l_rows + 1, 1)
        lmat = _tri(n, np.cumsum(l_indptr), l_cols[order], l_vals[order], mat)
        u_indptr = np.zeros(n + 1, np.int64)
        np.add.at(u_indptr, rows[upper] + 1, 1)
        umat = _tri(n, np.cumsum(u_indptr), indices[upper], vals[upper], mat)
        l_sched = build_schedule(lmat, lower=True)
        u_sched = build_schedule(umat, lower=False)
        return cls(lmat, umat, l_sched, u_sched, _plan(lmat, l_sched), _plan(umat, u_sched))

    def solve(self, r) -> torch.Tensor:
        """M⁻¹ r = U⁻¹ (L⁻¹ r)."""
        return _apply(self.l, self.l_plan, self.u, self.u_plan, r)

    def __call__(self, r) -> torch.Tensor:
        return self.solve(r)


@dataclasses.dataclass
class Ic0:
    """IC(0) preconditioner for SPD systems: A ≈ L·Lᵀ."""

    l: CsMat
    lt: CsMat
    l_schedule: TriSchedule
    lt_schedule: TriSchedule
    l_plan: LevelPlan
    lt_plan: LevelPlan

    @classmethod
    def factor(cls, mat: CsMat) -> "Ic0":
        indptr, indices, data = _host_csr(mat, "ic0")
        n = mat.shape[0]
        # restrict to the lower triangle (incl diagonal)
        rows = np.repeat(np.arange(n), np.diff(indptr))
        keep = indices <= rows
        l_indptr = np.zeros(n + 1, np.int64)
        np.add.at(l_indptr, rows[keep] + 1, 1)
        l_indptr = np.cumsum(l_indptr)
        l_cols = indices[keep]
        l_data = data[keep]
        vals = None
        if l_data.dtype == np.float64:
            try:
                vals = native.ic0_numeric(l_indptr, l_cols, l_data)
            except ValueError as e:
                raise SingularMatrixError(str(e)) from None
        if vals is None:
            vals = _ic0_host(l_indptr, l_cols, l_data)
        lmat = _tri(n, l_indptr, l_cols, vals, mat)
        ltmat = lmat.T.to_csr().compact()
        l_sched = build_schedule(lmat, lower=True)
        lt_sched = build_schedule(ltmat, lower=False)
        return cls(lmat, ltmat, l_sched, lt_sched, _plan(lmat, l_sched), _plan(ltmat, lt_sched))

    def solve(self, r) -> torch.Tensor:
        """M⁻¹ r = L⁻ᵀ (L⁻¹ r)."""
        return _apply(self.l, self.l_plan, self.lt, self.lt_plan, r)

    def __call__(self, r) -> torch.Tensor:
        return self.solve(r)


def ilu0(mat: CsMat) -> Ilu0:
    """Factor an ILU(0) preconditioner (host numeric, device solves)."""
    return Ilu0.factor(mat)


def ic0(mat: CsMat) -> Ic0:
    """Factor an IC(0) preconditioner for an SPD matrix."""
    return Ic0.factor(mat)
