"""Sparse LU factorization with partial pivoting (UMFPACK-class), the
counterpart of ``sprs_tpu/linalg/lu.py``.

* **Factorization on the host** — a left-looking Gilbert–Peierls LU with
  threshold partial pivoting and optional max-abs row scaling, in the
  port's native library where it is built, else in numpy.
* **Solves on the operand's device** — L and U come back as CsMats on the
  input's device with level schedules, so ``solve`` and
  ``solve_transposed`` are level-scheduled device sweeps.

Conventions (matching UMFPACK): ``P R A Q = L U`` where P is the row
permutation chosen by pivoting, R the diagonal row scaling, Q an optional
fill-reducing column permutation, L unit-lower-triangular, U
upper-triangular.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from .. import native
from ..errors import NonSquareMatrixError, SingularMatrixError
from ..formats.csmat import CSC, CsMat, csmat
from ..formats.util import as_tensor, host_array
from ..ops.permutation import Permutation
from .trisolve import LevelPlan, TriSchedule, build_schedule


def _lu_gilbert_peierls(
    indptr: np.ndarray,
    indices: np.ndarray,
    data: np.ndarray,
    n: int,
    pivot_threshold: float,
):
    """Left-looking sparse LU, one column at a time.

    For column k: solve L y = A[:,k] on the symbolic reach (DFS through
    the partially-built L, Gilbert & Peierls 1988 — the same reach used
    by the sparse-RHS trisolve, trisolve.rs:286-358), then pick the pivot
    row among not-yet-pivoted entries by threshold partial pivoting.

    Returns (L, U) in column-major python lists plus the row permutation
    ``perm_r`` (perm_r[i] = original row of pivoted row i).
    """
    pinv = np.full(n, -1, dtype=np.int64)  # original row -> pivot position
    perm_r = np.full(n, -1, dtype=np.int64)
    # L columns in pivot-position row space; diag (==1) implicit.
    l_rows, l_vals = [], []  # per column: arrays
    u_rows, u_vals = [], []
    x = np.zeros(n, dtype=data.dtype)  # dense work, original row space

    for k in range(n):
        col = slice(indptr[k], indptr[k + 1])
        a_rows = indices[col]
        a_vals = data[col]

        # --- symbolic: reach of a_rows through pivoted columns of L ----
        visited = np.zeros(n, dtype=bool)
        topo: list = []
        for s in a_rows:
            s = int(s)
            if visited[s]:
                continue
            stack = [(s, 0)]
            visited[s] = True
            while stack:
                node, it = stack.pop()
                j = pinv[node]
                pushed = False
                if j >= 0:
                    rows_j = l_rows[j]
                    while it < len(rows_j):
                        nxt = int(rows_j[it])
                        it += 1
                        if not visited[nxt]:
                            visited[nxt] = True
                            stack.append((node, it))
                            stack.append((nxt, 0))
                            pushed = True
                            break
                if not pushed:
                    topo.append(node)
        topo.reverse()

        # --- numeric: x = A[:,k]; for pivoted j in topo order eliminate -
        x[a_rows] = a_vals
        for node in topo:
            j = pinv[node]
            if j < 0:
                continue
            xj = x[node]
            if xj != 0:
                x[l_rows[j]] -= l_vals[j] * xj

        # --- pivot among unpivoted entries of the reach ----------------
        cand = [r for r in topo if pinv[r] < 0]
        if not cand:
            raise SingularMatrixError(f"structurally singular at column {k}")
        cand = np.asarray(cand)
        absx = np.abs(x[cand])
        max_abs = absx.max()
        if max_abs == 0:
            raise SingularMatrixError(f"numerically singular at column {k}")
        # prefer the diagonal when within threshold of the max
        pivot = int(cand[int(np.argmax(absx))])
        if pivot_threshold < 1.0 and pinv[k] < 0 and k in cand:
            if abs(x[k]) >= pivot_threshold * max_abs:
                pivot = k
        pv = x[pivot]

        pinv[pivot] = k
        perm_r[k] = pivot

        urows, uvals_k = [], []
        lrows, lvals_k = [], []
        for node in topo:
            v = x[node]
            x[node] = 0
            if v == 0:
                continue
            j = pinv[node]
            if j >= 0 and node != pivot:
                urows.append(j)
                uvals_k.append(v)
            elif node != pivot:
                lrows.append(node)
                lvals_k.append(v / pv)
        urows.append(k)
        uvals_k.append(pv)
        order = np.argsort(urows)
        u_rows.append(np.asarray(urows, dtype=np.int64)[order])
        u_vals.append(np.asarray(uvals_k, dtype=data.dtype)[order])
        l_rows.append(np.asarray(lrows, dtype=np.int64))
        l_vals.append(np.asarray(lvals_k, dtype=data.dtype))

    # renumber L rows into pivot positions (now all assigned)
    l_rows = [pinv[r] for r in l_rows]
    return l_rows, l_vals, u_rows, u_vals, perm_r


def _cols_to_csc(cols_rows, cols_vals, n, dtype, unit_diag: bool):
    """Assemble per-column (rows, vals) lists into CSC arrays."""
    counts = np.array(
        [len(r) + (1 if unit_diag else 0) for r in cols_rows], dtype=np.int64
    )
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    nnz = int(indptr[-1])
    indices = np.empty(nnz, dtype=np.int64)
    data = np.empty(nnz, dtype=dtype)
    for k in range(n):
        lo = indptr[k]
        rows = cols_rows[k]
        vals = cols_vals[k]
        if unit_diag:
            indices[lo] = k
            data[lo] = 1
            lo += 1
        order = np.argsort(rows)
        indices[lo : lo + len(rows)] = np.asarray(rows)[order]
        data[lo : lo + len(rows)] = np.asarray(vals)[order]
    return indptr, indices, data


def _plan(mat: CsMat, lower: bool) -> Tuple[TriSchedule, LevelPlan]:
    """The level schedule of ``mat`` and its plan into ``mat.data`` (a CSC
    matrix is solved as its CSR form, whose values are a gather of
    ``mat.data`` through the plan's slots)."""
    sched = build_schedule(mat, lower=lower)
    n = mat.shape[0]
    indptr = mat.indptr.cpu().numpy().astype(np.int64)
    nnz = int(indptr[-1])
    indices = mat.indices[:nnz].cpu().numpy().astype(np.int64)
    if mat.is_csr:
        return sched, LevelPlan.build(indptr, indices, sched, device=mat.device)
    # CSR order of the CSC entries: a stable sort by row
    outer = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    order = np.argsort(indices * max(n, 1) + outer, kind="stable")
    csr_indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(indices, minlength=n), out=csr_indptr[1:])
    return sched, LevelPlan.build(csr_indptr, outer[order], sched, slot_map=order,
                                  device=mat.device)


@dataclasses.dataclass
class SpLu:
    """LU factorization context: ``P R A Q = L U``.

    ``l()``/``u()`` extract the factors, ``row_perm``/``col_perm`` the
    permutations, ``scale`` the row scaling; ``solve`` and
    ``solve_transposed`` run on the factors' device.
    """

    _l: CsMat
    _u: CsMat
    row_perm: Permutation
    col_perm: Permutation
    scale: torch.Tensor  # R diagonal (1.0 when scaling disabled)
    _l_sched: TriSchedule
    _u_sched: TriSchedule
    _l_plan: LevelPlan
    _u_plan: LevelPlan

    def l(self) -> CsMat:  # noqa: E743
        return self._l

    def u(self) -> CsMat:
        return self._u

    @property
    def shape(self):
        return self._l.shape

    def lu_nnz(self) -> Tuple[int, int]:
        """(nnz(L), nnz(U))."""
        return self._l.nnz, self._u.nnz

    def _rhs(self, b) -> torch.Tensor:
        b = b if isinstance(b, torch.Tensor) else torch.as_tensor(np.asarray(b))
        b = b.to(self.scale.device)
        return b.to(torch.promote_types(self.scale.dtype, b.dtype))

    def _scaled(self, b: torch.Tensor) -> torch.Tensor:
        return (self.scale if b.ndim == 1 else self.scale[:, None]) * b

    def solve(self, b) -> torch.Tensor:
        """x with A x = b: x = Q · U⁻¹ L⁻¹ P R b."""
        b = self._rhs(b)
        pb = self._scaled(b)[self.row_perm.perm.to(torch.int64)]
        y = self._l_plan.solve(self._l.data, pb)
        z = self._u_plan.solve(self._u.data, y)
        out = torch.zeros_like(z)
        out[self.col_perm.perm.to(torch.int64)] = z
        return out

    def solve_transposed(self, b) -> torch.Tensor:
        """x with Aᵀ x = b.  From A = R⁻¹ Pᵀ L U Qᵀ: Aᵀ = Q Uᵀ Lᵀ P R⁻¹,
        so x = R · Pᵀ · L⁻ᵀ · U⁻ᵀ · Qᵀ b.  The transposed sweeps' plans
        are built on first use and cached."""
        b = self._rhs(b)
        if not hasattr(self, "_ut_plan"):
            # Uᵀ is lower-triangular: U's CSC arrays read as CSR
            self._ut_plan = _plan(self._u.T, lower=True)[1]
            self._lt_plan = _plan(self._l.T, lower=False)[1]
        qb = b[self.col_perm.perm.to(torch.int64)]
        w = self._ut_plan.solve(self._u.data, qb)
        v = self._lt_plan.solve(self._l.data, w)
        out = torch.zeros_like(v)
        out[self.row_perm.perm.to(torch.int64)] = v
        return self._scaled(out)

    def det(self) -> torch.Tensor:
        """Determinant from the factorization: ±prod(diag U)/prod(R)."""
        sign = (_perm_sign(self.row_perm.perm.cpu().numpy())
                * _perm_sign(self.col_perm.perm.cpu().numpy()))
        return sign * torch.prod(self._u.diag()) / torch.prod(self.scale)


def _perm_sign(p: np.ndarray) -> float:
    n = len(p)
    seen = np.zeros(n, dtype=bool)
    sign = 1.0
    for i in range(n):
        if seen[i]:
            continue
        j, ln = i, 0
        while not seen[j]:
            seen[j] = True
            j = p[j]
            ln += 1
        if ln % 2 == 0:
            sign = -sign
    return sign


def splu(
    mat: CsMat,
    *,
    col_perm: Optional[str] = None,
    scale: bool = True,
    pivot_threshold: float = 0.1,
) -> SpLu:
    """Factor a square sparse matrix: P R A Q = L U, on the host; the
    factors land on ``mat``'s device.

    ``col_perm``: None (natural) or "min_degree" (the ``camd_order``
    fill-reducing column pre-ordering).  ``pivot_threshold``: 1.0 =
    strict partial pivoting; smaller values prefer the diagonal when it
    is within the threshold of the column max.
    """
    if mat.shape[0] != mat.shape[1]:
        raise NonSquareMatrixError(f"LU needs a square matrix, got {mat.shape}")
    n = mat.shape[0]
    device = mat.device

    if col_perm == "min_degree":
        from .amd import camd_order

        q = camd_order(mat).perm.cpu().numpy().astype(np.int64)
    elif col_perm is None or col_perm == "natural":
        q = np.arange(n, dtype=np.int64)
    else:
        raise ValueError(f"unknown col_perm {col_perm!r}")

    csc = mat.to_csc()
    indptr = csc.indptr.cpu().numpy().astype(np.int64)
    nnz = int(indptr[-1])
    indices = csc.indices[:nnz].cpu().numpy().astype(np.int64)
    data = host_array(csc.data[:nnz])  # bfloat16 as float32: exact
    data = data.astype(np.float64 if data.dtype.kind == "f" else data.dtype)
    dtype = csc.dtype  # the factors' and the scale's, as the JAX package's

    # row scaling R = 1/max|row|
    if scale:
        rmax = np.zeros(n, dtype=np.float64)
        np.maximum.at(rmax, indices, np.abs(data))
        if np.any(rmax == 0):
            raise SingularMatrixError(f"zero row at index {int(np.argmax(rmax == 0))}")
        r = 1.0 / rmax
    else:
        r = np.ones(n, dtype=np.float64)

    # apply Q (column gather) and R (row scale) to build the work matrix
    qptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum((indptr[1:] - indptr[:-1])[q], out=qptr[1:])
    qidx = np.empty(nnz, dtype=np.int64)
    qdat = np.empty(nnz, dtype=data.dtype)
    for kk in range(n):
        src = slice(indptr[q[kk]], indptr[q[kk] + 1])
        dst = slice(qptr[kk], qptr[kk + 1])
        qidx[dst] = indices[src]
        qdat[dst] = data[src] * r[indices[src]]

    native_out = None
    if data.dtype == np.float64:
        try:
            native_out = native.lu(qptr, qidx, qdat, n, pivot_threshold)
        except ValueError as e:  # singular:<col>
            col = int(str(e).split(":")[1])
            raise SingularMatrixError(f"singular at column {col}") from None
    if native_out is not None:
        li, lx, ld, ui, ux, ud, perm_r = native_out
        perm_r = perm_r.astype(np.int64)
    else:
        l_rows, l_vals, u_rows, u_vals, perm_r = _lu_gilbert_peierls(
            qptr, qidx, qdat, n, pivot_threshold)
        li, lx, ld = _cols_to_csc(l_rows, l_vals, n, data.dtype, unit_diag=True)
        ui, ux, ud = _cols_to_csc(u_rows, u_vals, n, data.dtype, unit_diag=False)
    l_mat = csmat((n, n), li.astype(np.int32), lx.astype(np.int32), as_tensor(ld, dtype=dtype, device=device),
                  storage=CSC, validate=False, device=device)
    u_mat = csmat((n, n), ui.astype(np.int32), ux.astype(np.int32), as_tensor(ud, dtype=dtype, device=device),
                  storage=CSC, validate=False, device=device)
    l_sched, l_plan = _plan(l_mat, lower=True)
    u_sched, u_plan = _plan(u_mat, lower=False)
    return SpLu(
        _l=l_mat,
        _u=u_mat,
        row_perm=Permutation.from_array(perm_r.astype(np.int32), device=device),
        col_perm=Permutation.from_array(q.astype(np.int32), device=device),
        scale=as_tensor(r, dtype=dtype, device=device),
        _l_sched=l_sched,
        _u_sched=u_sched,
        _l_plan=l_plan,
        _u_plan=u_plan,
    )
