"""LDLᵀ factorization with a fill-reducing ordering, the counterpart of
``sprs_tpu/linalg/ldl.py``.

* **Symbolic (host)** — everything data-independent is computed once, in
  numpy or the port's native library, with the JAX package's arrays:
  the elimination tree, column counts, the static pattern of L (CSC with
  an explicit unit diagonal first in each column), per-row update lists
  with the storage slot of every L entry, gather maps from the input's
  data into the permuted upper rows, the CSR twin of L, and level
  schedules for both triangular solves.
* **Numeric** — ``backend="host"`` is the exact f64 up-looking numeric in
  numpy, stored in the input's dtype on the input's device.
  ``backend="device"`` is the JAX package's row scan on the input's
  device: a Python loop over rows and their update lists.  The panel
  numerics run on the input's device from host plans cached on the
  symbolic (``super_plan``, ``mf_plan``, ``round_schedule``):
  "supernodal" and "mf" one task at a time (``ldl_super``, ``ldl_mf``),
  "super-batched" and "mf-batched" in rounds of independent tasks
  (``ldl_batched``).  The device numerics NaN-poison a zero pivot instead
  of raising.  ``backend="auto"`` is "host" on the CPU; on a CUDA tensor
  with n ≥ 256 it takes the JAX package's device order ("mf-batched",
  else "super-batched", else "device").
* **Solve (operand's device)** — permute, unit-lower solve, diagonal
  scale, unit-upper solve, inverse permute: by level schedules
  ("levels", "flat", their gather maps cached on the symbolic per
  device) or on the panels ("super": one supernode per step, or the
  factor's rounds once the plan has ``solve_batched_min_s`` supernodes).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .. import native
from ..errors import (
    CapacityError,
    LinalgError,
    NonSquareMatrixError,
    ShapeError,
    SingularMatrixError,
)
from ..formats.csmat import CSC, CSR, CsMat
from ..formats.util import MAX_INDEX
from ..ops.permutation import Permutation
from ..ops.symmetry import is_symmetric
from .ordering import reverse_cuthill_mckee
from .trisolve import (
    FlatPlan,
    LevelPlan,
    TriSchedule,
    flat_schedule_from_arrays,
    schedule_from_arrays,
)

PANEL_BACKENDS = ("supernodal", "mf", "super-batched", "mf-batched")

# the level solve's (level width × max row nnz) window past which the
# flat entry stream takes over, as in the JAX package
FLAT_ESCAPE = 1 << 24


# ---------------------------------------------------------------------------
# symbolic phase (host)
# ---------------------------------------------------------------------------


def _check_factor_capacity(lnz: int) -> None:
    """CSC slots are i32 positions: a factor past the i32 ceiling would
    wrap silently, so it fails loudly instead."""
    if lnz > MAX_INDEX:
        raise CapacityError.index_limit(
            "factor nnz",
            lnz,
            hint="reduce fill with Ldl().fill_in_reduction('nd') "
            "(O(n log n) fill on mesh-like problems), or switch to an "
            "iterative solve — solve(..., method='cg'/'bicgstab') with "
            "an ILU/IC preconditioner needs O(nnz(A)) memory",
        )


def _permuted_upper_maps(indptr, indices, p, pinv):
    """Gather maps for the upper rows of PAPᵀ (row k, cols ≤ k), vectorized."""
    n = p.shape[0]
    cnt = (indptr[p + 1] - indptr[p]).astype(np.int64)
    total = int(cnt.sum())
    rowid = np.repeat(np.arange(n, dtype=np.int64), cnt)
    offs = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(cnt, out=offs[1:])
    pos = (np.arange(total, dtype=np.int64) - np.repeat(offs[:-1], cnt)
           + np.repeat(indptr[p].astype(np.int64), cnt))
    cols = pinv[indices[pos]].astype(np.int64)
    keep = cols <= rowid
    kept_row, kept_pos, kept_col = rowid[keep], pos[keep], cols[keep]
    kcount = np.bincount(kept_row, minlength=n).astype(np.int64) if n else np.zeros(0, np.int64)
    wa = max(int(kcount.max()) if n else 1, 1)
    koffs = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(kcount, out=koffs[1:])
    rank = np.arange(kept_row.size, dtype=np.int64) - koffs[kept_row]
    a_pos = np.zeros((n, wa), dtype=np.int64)
    a_col = np.full((n, wa), n, dtype=np.int64)
    a_live = np.zeros((n, wa), dtype=bool)
    a_pos[kept_row, rank] = kept_pos
    a_col[kept_row, rank] = kept_col
    a_live[kept_row, rank] = True
    return kept_col, koffs, a_pos, a_col, a_live


def _pattern_numpy(kept_col, koffs, n):
    """(parent, col_count, l_indptr, l_indices, rp_indptr, rp_cols,
    rp_slots) by the up-looking symbolic sweep in numpy."""
    parent = np.full(n, -1, dtype=np.int64)
    flag = np.full(n, -1, dtype=np.int64)
    col_count = np.zeros(n, dtype=np.int64)  # sub-diagonal entries
    patterns: list = []
    for k in range(n):
        flag[k] = k
        pat = []
        for j0 in kept_col[koffs[k] : koffs[k + 1]]:
            j = int(j0)
            if j >= k:
                continue
            while flag[j] != k:
                if parent[j] == -1:
                    parent[j] = k
                pat.append(j)
                col_count[j] += 1
                flag[j] = k
                j = int(parent[j])
        pat.sort()  # ascending index is topological order here
        patterns.append(pat)
    l_indptr = np.zeros(n + 1, dtype=np.int64)
    l_indptr[1:] = np.cumsum(col_count + 1)
    lnz = int(l_indptr[-1])
    l_indices = np.zeros(lnz, dtype=np.int64)
    fill = l_indptr[:-1].copy() + 1  # slot after the diagonal
    l_indices[l_indptr[:-1]] = np.arange(n)  # unit diagonal
    rp_indptr = np.zeros(n + 1, dtype=np.int64)
    rp_indptr[1:] = np.cumsum([len(pt) for pt in patterns], dtype=np.int64)
    rp_cols = np.zeros(int(rp_indptr[-1]), dtype=np.int64)
    rp_slots = np.zeros(int(rp_indptr[-1]), dtype=np.int64)
    for k in range(n):
        base = rp_indptr[k]
        for t, j in enumerate(patterns[k]):
            rp_cols[base + t] = j
            rp_slots[base + t] = fill[j]
            l_indices[fill[j]] = k
            fill[j] += 1
    return parent, col_count, l_indptr, l_indices, rp_indptr, rp_cols, rp_slots


@dataclasses.dataclass(frozen=True)
class LdlSymbolic:
    """Static factorization plan; reusable across same-pattern matrices.
    Every array is numpy on the host, equal to the JAX package's."""

    n: int
    perm: Optional[Permutation]
    parent: np.ndarray  # etree, (n,)
    # L stored CSC with explicit unit diagonal (diag entry first per col)
    l_indptr: np.ndarray  # (n+1,)
    l_indices: np.ndarray  # (lnz,)
    # per-row update lists (ascending == topological) and insert slots,
    # stored flat: row k's entries live at rp_indptr[k]:rp_indptr[k+1]
    rp_indptr: np.ndarray  # (n+1,)
    rp_cols: np.ndarray  # update column j of L[k, j]
    rp_slots: np.ndarray  # absolute CSC slot of L[k, j]
    # gather map from the input's CSR data into permuted upper rows
    a_pos: np.ndarray  # (n, wa) positions into data
    a_col: np.ndarray  # (n, wa) permuted column (== row index for diag)
    a_live: np.ndarray  # (n, wa) bool
    # CSR twin of L: lcsr_data = l_data[lcsr_gather]; Lᵀ as CSR is L's
    # CSC arrays with the storage flag flipped
    lcsr_indptr: np.ndarray
    lcsr_indices: np.ndarray
    lcsr_gather: np.ndarray
    sched_lower: TriSchedule
    sched_upper: TriSchedule
    wc: int  # max column count of L

    @property
    def nnz(self) -> int:
        """Stored entries of L including the unit diagonal."""
        return int(self.l_indptr[-1])

    @property
    def problem_size(self) -> int:
        return self.n

    @classmethod
    def from_matrix(cls, mat: CsMat, *, perm: Optional[Permutation] = None,
                    check_symmetry: bool = True, postorder: bool = False) -> "LdlSymbolic":
        if mat.shape[0] != mat.shape[1]:
            raise NonSquareMatrixError(f"LDLᵀ needs square, got {mat.shape}")
        if check_symmetry and not is_symmetric(mat):
            raise LinalgError("matrix is not symmetric (pass check_symmetry=False to skip)")
        n = mat.shape[0]
        a = mat.to_csr()
        indptr = a.indptr.cpu().numpy()
        indices = a.indices.cpu().numpy()
        if perm is not None:
            p = perm.perm.cpu().numpy().astype(np.int64)
            pinv = perm.inv.cpu().numpy().astype(np.int64)
        else:
            p = pinv = np.arange(n)
        kept_col, koffs, a_pos, a_col, a_live = _permuted_upper_maps(indptr, indices, p, pinv)

        if postorder and n:
            # postordering the etree is a fill-invariant relabeling (Liu):
            # every etree subtree becomes a contiguous column range
            from .etree import etree_from_pattern
            from .etree import postorder as po

            post = po(etree_from_pattern(koffs, kept_col, n))
            if not np.array_equal(post, np.arange(n)):
                p = np.asarray(p)[post]
                pinv = np.empty(n, dtype=np.int64)
                pinv[p] = np.arange(n)
                perm = Permutation.from_array(p.astype(np.int32), check=False, device=mat.device)
                kept_col, koffs, a_pos, a_col, a_live = _permuted_upper_maps(
                    indptr, indices, p, pinv)

        # --- etree, column counts and row patterns -------------------------
        row_ptr = koffs.astype(np.int32)
        row_cols = kept_col.astype(np.int32)
        nat = native.ldl_symbolic(row_ptr, row_cols, n)
        if nat is not None:
            parent32, col_count32, row_count32, _total = nat
            parent = parent32.astype(np.int64)
            col_count = col_count32.astype(np.int64)
            l_indptr = np.zeros(n + 1, dtype=np.int64)
            l_indptr[1:] = np.cumsum(col_count + 1)
            rp_indptr = np.zeros(n + 1, dtype=np.int64)
            rp_indptr[1:] = np.cumsum(row_count32.astype(np.int64))
            rp_cols32, rp_slots, l_indices32 = native.ldl_pattern_flat(
                row_ptr, row_cols, n, parent32, l_indptr, rp_indptr, int(l_indptr[-1]))
            rp_cols = rp_cols32.astype(np.int64)
            l_indices = l_indices32.astype(np.int64)
        else:
            (parent, col_count, l_indptr, l_indices, rp_indptr, rp_cols,
             rp_slots) = _pattern_numpy(kept_col, koffs, n)
        col_size = col_count + 1
        lnz = int(l_indptr[-1])
        wc = max(int(col_size.max()), 1) if n else 1
        _check_factor_capacity(lnz)

        # --- CSR twin of L (lower, row-major) + value gather ---------------
        # entries are column-sorted (CSC), so ONE stable sort by row yields
        # (row, col) order
        cols_of = np.repeat(np.arange(n), col_size)
        order = np.argsort(l_indices, kind="stable")
        lcsr_indptr = np.zeros(n + 1, dtype=np.int64)
        np.add.at(lcsr_indptr, l_indices[order] + 1, 1)
        lcsr_indptr = np.cumsum(lcsr_indptr)
        lcsr_indices = cols_of[order]

        return cls(
            n=n,
            perm=perm,
            parent=parent,
            l_indptr=l_indptr,
            l_indices=l_indices,
            rp_indptr=rp_indptr,
            rp_cols=rp_cols,
            rp_slots=rp_slots,
            a_pos=a_pos,
            a_col=a_col,
            a_live=a_live,
            lcsr_indptr=lcsr_indptr,
            lcsr_indices=lcsr_indices,
            lcsr_gather=order,
            sched_lower=schedule_from_arrays(lcsr_indptr, lcsr_indices, lower=True),
            sched_upper=schedule_from_arrays(l_indptr, l_indices, lower=False),
            wc=wc,
        )

    def _cached(self, key, build):
        cached = self.__dict__.get(key)
        if cached is None:
            cached = build()
            object.__setattr__(self, key, cached)
        return cached

    def flat_scheds(self):
        """Flat O(lnz) trisolve schedules for both sweeps (lazy, cached)."""
        return self._cached("_flat_scheds", lambda: (
            flat_schedule_from_arrays(self.lcsr_indptr, self.lcsr_indices, lower=True),
            flat_schedule_from_arrays(self.l_indptr, self.l_indices, lower=False),
        ))

    def level_plans(self, device) -> tuple:
        """(L, Lᵀ) level-solve gather maps into ``l_data`` on ``device``
        (lazy, cached per device)."""
        plans = self._cached("_level_plans", dict)
        key = str(torch.device(device))
        if key not in plans:
            plans[key] = (
                LevelPlan.build(self.lcsr_indptr, self.lcsr_indices, self.sched_lower,
                                slot_map=self.lcsr_gather, device=device),
                LevelPlan.build(self.l_indptr, self.l_indices, self.sched_upper, device=device),
            )
        return plans[key]

    def flat_plans(self, device) -> tuple:
        """(L, Lᵀ) flat-solve streams into ``l_data`` on ``device``."""
        plans = self._cached("_flat_plans", dict)
        key = str(torch.device(device))
        if key not in plans:
            lo, up = self.flat_scheds()
            plans[key] = (FlatPlan.build(lo, slot_map=self.lcsr_gather, device=device),
                          FlatPlan.build(up, device=device))
        return plans[key]

    @property
    def wl(self) -> int:
        """Max per-row update-list length."""
        counts = np.diff(self.rp_indptr)
        return max(int(counts.max()) if counts.size else 0, 1)

    def _padded_pattern(self):
        """(n, wl) ``row_pattern``/``insert_pos`` twins of the flat arrays
        (lazy, cached): O(n·wl) memory."""
        def build():
            n, wl = self.n, self.wl
            counts = np.diff(self.rp_indptr)
            rows = np.repeat(np.arange(n, dtype=np.int64), counts)
            rank = np.arange(self.rp_indptr[-1], dtype=np.int64) - np.repeat(
                self.rp_indptr[:-1], counts)
            row_pattern = np.full((n, wl), n, dtype=np.int64)
            insert_pos = np.zeros((n, wl), dtype=np.int64)
            row_pattern[rows, rank] = self.rp_cols
            insert_pos[rows, rank] = self.rp_slots
            return row_pattern, insert_pos

        return self._cached("_padded", build)

    @property
    def row_pattern(self) -> np.ndarray:
        return self._padded_pattern()[0]

    @property
    def insert_pos(self) -> np.ndarray:
        return self._padded_pattern()[1]

    def super_plan(self, **kwargs):
        """The supernodal schedule of this pattern (built on first use and
        cached; ``kwargs`` apply to the first build).  Raises
        ``SupernodalPlanError`` if infeasible."""
        from .ldl_super import build_super_plan

        return self._cached("_super_plan", lambda: build_super_plan(self, **kwargs))

    def mf_plan(self, **kwargs):
        """The multifrontal-lite schedule of this pattern (cached as
        ``super_plan``)."""
        from .ldl_mf import build_mf_plan

        return self._cached("_mf_plan", lambda: build_mf_plan(self, **kwargs))

    def panel_plan(self):
        """The panel plan a factorization built (mf first), or None."""
        return self.__dict__.get("_mf_plan") or self.__dict__.get("_super_plan")

    def round_schedule(self, plan, **kwargs):
        """The level-batched round schedule of ``plan`` (cached per plan:
        plans are cached on this symbolic, so identity keys are sound)."""
        from .ldl_batched import build_round_schedule

        scheds = self._cached("_round_scheds", dict)
        if id(plan) not in scheds:
            scheds[id(plan)] = build_round_schedule(plan, **kwargs)
        return scheds[id(plan)]

    def factor(self, mat: CsMat, *, backend: str = "auto") -> "LdlNumeric":
        return LdlNumeric.factor(self, mat, backend=backend)


# ---------------------------------------------------------------------------
# numeric phase
# ---------------------------------------------------------------------------


def _numeric_host(sym: LdlSymbolic, data: np.ndarray):
    """Exact f64 up-looking numeric (Davis's LDL algorithm)."""
    n = sym.n
    lx = np.zeros(sym.nnz, dtype=data.dtype)
    d = np.zeros(n, dtype=data.dtype)
    y = np.zeros(n, dtype=data.dtype)
    lp, li = sym.l_indptr, sym.l_indices
    rp, rc, rs = sym.rp_indptr, sym.rp_cols, sym.rp_slots
    lx[lp[:-1]] = 1.0  # unit diagonal
    for k in range(n):
        vals = data[sym.a_pos[k]] * sym.a_live[k]
        cols = sym.a_col[k]
        dk = vals[cols == k].sum()
        off = cols < k
        y[cols[off]] += vals[off]
        for t in range(rp[k], rp[k + 1]):
            j = rc[t]
            yj = y[j]
            y[j] = 0.0
            lo, hi = lp[j] + 1, rs[t]
            y[li[lo:hi]] -= lx[lo:hi] * yj
            if d[j] == 0:
                raise SingularMatrixError(f"zero pivot at column {int(j)}")
            l_kj = yj / d[j]
            dk -= l_kj * yj
            lx[rs[t]] = l_kj
        if dk == 0:
            raise SingularMatrixError(f"zero pivot at column {k}")
        d[k] = dk
    return lx, d


def _numeric_device(sym: LdlSymbolic, data: torch.Tensor):
    """The row-scan numeric on ``data``'s device: for each row k, scatter
    A's upper row into y, then for each update column j of row k (host
    ints from the symbolic) eliminate column j's stored part and write
    L[k, j].  The arithmetic of the JAX package's ``lax.scan`` /
    ``fori_loop``, whose dead (padded) iterations are skipped here.  A
    zero pivot NaN-poisons instead of raising."""
    n, dev = sym.n, data.device
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    li = t(sym.l_indices)
    a_pos, a_col, a_live = t(sym.a_pos), t(sym.a_col), t(sym.a_live)
    lp, rp, rc, rs = sym.l_indptr, sym.rp_indptr, sym.rp_cols, sym.rp_slots
    lx = torch.zeros(sym.nnz, dtype=data.dtype, device=dev)
    lx[t(lp[:-1])] = 1.0
    d = torch.zeros(n, dtype=data.dtype, device=dev)
    y = torch.zeros(n + 1, dtype=data.dtype, device=dev)  # slot n: dropped
    for k in range(n):
        vals = data[a_pos[k]] * a_live[k]
        cols = a_col[k]
        dk = torch.where(cols == k, vals, torch.zeros_like(vals)).sum()
        off = cols < k
        y.index_add_(0, torch.where(off, cols, n), torch.where(off, vals, torch.zeros_like(vals)))
        for s in range(int(rp[k]), int(rp[k + 1])):
            j, ins = int(rc[s]), int(rs[s])
            yj = y[j].clone()
            y[j] = 0
            base = int(lp[j]) + 1
            y.index_add_(0, li[base:ins], lx[base:ins] * -yj)
            l_kj = yj / d[j]
            dk = dk - l_kj * yj
            lx[ins] = l_kj
        d[k] = dk
    return lx, d


@dataclasses.dataclass(frozen=True)
class LdlNumeric:
    """A computed LDLᵀ factorization: PᵀAP = L·D·Lᵀ with unit-lower L;
    ``l_data`` and ``d`` lie on the factored matrix's device."""

    symbolic: LdlSymbolic
    l_data: torch.Tensor  # values in the static CSC pattern (unit diag stored)
    d: torch.Tensor  # diagonal of D

    @classmethod
    def factor(cls, sym: LdlSymbolic, mat: CsMat, *, backend: str = "auto") -> "LdlNumeric":
        """``backend``: "host", "device", "supernodal", "mf",
        "super-batched", "mf-batched" or "auto" (the module docstring's
        rule)."""
        a = mat.to_csr()
        if a.shape != (sym.n, sym.n):
            raise ShapeError("matrix shape differs from symbolic plan")
        if backend == "auto":
            backend = _auto_backend(sym, a.data)
        if backend == "host":
            lx, d = _numeric_host(sym, a.data.detach().to(torch.float64).cpu().numpy())
            # exact f64 compute, stored in the input's floating dtype
            out = a.dtype if a.dtype.is_floating_point else torch.float64
            return cls(sym, torch.from_numpy(lx).to(a.device, out),
                       torch.from_numpy(d).to(a.device, out))
        if backend in PANEL_BACKENDS:
            plan = sym.super_plan() if backend in ("supernodal", "super-batched") else sym.mf_plan()
            if backend == "supernodal":
                from .ldl_super import numeric_supernodal

                lx, d = numeric_supernodal(plan, a.data.detach())
            elif backend == "mf":
                from .ldl_mf import numeric_multifrontal

                lx, d = numeric_multifrontal(plan, a.data.detach())
            else:
                from .ldl_batched import numeric_batched

                lx, d = numeric_batched(plan, sym.round_schedule(plan), a.data.detach())
            return cls(sym, lx, d)
        if backend != "device":
            raise ValueError(f"unknown LDLᵀ backend {backend!r}")
        if sym.n * sym.wl > 1 << 28:
            # the JAX package's guard on the row scan's padded (n, wl) pattern
            raise LinalgError(
                f"row-scan numeric needs a {sym.n}x{sym.wl} padded pattern (too large); "
                "use backend='host' or an iterative solver")
        lx, d = _numeric_device(sym, a.data)
        return cls(sym, lx, d)

    def update(self, mat: CsMat, *, backend: str = "auto") -> "LdlNumeric":
        """Refactorize a matrix with the same pattern."""
        return LdlNumeric.factor(self.symbolic, mat, backend=backend)

    # -- factors as matrices ---------------------------------------------
    def _index(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a.astype(np.int32)).to(self.l_data.device)

    def l(self) -> CsMat:  # noqa: E743
        """Unit-lower L as a CSC matrix (diagonal stored)."""
        s = self.symbolic
        return CsMat(self._index(s.l_indptr), self._index(s.l_indices), self.l_data,
                     (s.n, s.n), CSC)

    def l_csr(self) -> CsMat:
        """L in CSR order via the static value gather (no runtime sort)."""
        s = self.symbolic
        gather = torch.from_numpy(s.lcsr_gather).to(self.l_data.device)
        return CsMat(self._index(s.lcsr_indptr), self._index(s.lcsr_indices),
                     self.l_data[gather], (s.n, s.n), CSR)

    def lt(self) -> CsMat:
        """Lᵀ as CSR: L's CSC arrays with the storage flag flipped."""
        s = self.symbolic
        return CsMat(self._index(s.l_indptr), self._index(s.l_indices), self.l_data,
                     (s.n, s.n), CSR)

    def d_diag(self) -> torch.Tensor:
        return self.d

    @property
    def nnz(self) -> int:
        return self.symbolic.nnz

    @property
    def problem_size(self) -> int:
        return self.symbolic.n

    def solve_method(self, method: str = "auto") -> str:
        """The method ``solve`` takes.  "auto" is "super" when a panel
        plan is cached on the symbolic (the factor ran on panels), else
        "levels"; "levels" escapes to "flat" when n·max_row_nnz of L or
        Lᵀ exceeds 2²⁴."""
        if method not in ("auto", "levels", "flat", "super"):
            raise ValueError(f"unknown solve method {method!r}")
        s = self.symbolic
        if method == "auto" and s.panel_plan() is not None:
            return "super"
        if method in ("flat", "super"):
            return method
        w = max(int(np.diff(s.lcsr_indptr).max(initial=1)),
                int(np.diff(s.l_indptr).max(initial=1)))
        return "flat" if s.n * w > FLAT_ESCAPE else "levels"

    def _panels(self, plan) -> torch.Tensor:
        """The factor's values as ``plan``'s flat panels (cached per plan
        and dtype)."""
        from .ldl_super import panels_from_csc

        key = (id(plan), self.l_data.dtype)
        cached = self.__dict__.get("_panel_cache")
        if cached is None or cached[0] != key:
            cached = (key, panels_from_csc(plan, self.l_data))
            object.__setattr__(self, "_panel_cache", cached)
        return cached[1]

    def _solve_super(self, x: torch.Tensor) -> torch.Tensor:
        from .ldl_batched import solve_batched, solve_batched_min_s
        from .ldl_super import SupernodalPlanError, solve_supernodal

        s = self.symbolic
        plan = s.panel_plan()
        if plan is None:
            try:
                plan = s.mf_plan()
            except SupernodalPlanError:
                plan = s.super_plan()
        panels = self._panels(plan)
        sched = s.__dict__.get("_round_scheds", {}).get(id(plan))
        if sched is not None and plan.S >= solve_batched_min_s(x.device):
            return solve_batched(plan, sched, panels, self.d, x)
        return solve_supernodal(plan, panels, self.d, x)

    def solve(self, b, *, method: str = "auto") -> torch.Tensor:
        """x with A x = b for a vector or an (n, k) block, on the factor's
        device.  ``method``: "levels" (level-scheduled solves), "flat"
        (the O(lnz) entry-stream solve), "super" (the panel solves; the
        round-batched sweeps when the factor's round schedule is cached
        and the plan has at least ``solve_batched_min_s`` supernodes) or
        "auto" (``solve_method``'s rule)."""
        s = self.symbolic
        method = self.solve_method(method)
        if not isinstance(b, torch.Tensor):
            b = torch.as_tensor(np.asarray(b))
        b = b.to(self.l_data.device)
        if b.shape[0] != s.n:
            raise ShapeError(f"rhs dim {tuple(b.shape)} vs n={s.n}")
        b = b.to(torch.promote_types(self.l_data.dtype, b.dtype))
        x = b if s.perm is None else b[s.perm.perm.to(torch.int64)]
        if method == "super":
            x = self._solve_super(x)
        else:
            plans = (s.level_plans if method == "levels" else s.flat_plans)(self.l_data.device)
            x = plans[0].solve(self.l_data, x)
            x = x / (self.d if x.ndim == 1 else self.d[:, None])
            x = plans[1].solve(self.l_data, x)
        if s.perm is not None:
            x = x[s.perm.inv.to(torch.int64)]
        return x


def _auto_backend(sym: LdlSymbolic, data: torch.Tensor) -> str:
    """"host" on the CPU and below 256 rows; on a CUDA tensor the JAX
    package's device order: the level-batched multifrontal numeric, else
    the level-batched supernodal one, else the row scan.  Chosen from
    chip_smoke.py phase 5h on an NVIDIA H100 (PERF.md): at 256² nd the
    mf-batched numeric beat the host numeric 11.8–14.7× in f64 and
    5.9–15.1× in f32 over five runs."""
    if not data.is_cuda or sym.n < 256:
        return "host"
    from .ldl_super import SupernodalPlanError

    for backend, build in (("mf-batched", sym.mf_plan), ("super-batched", sym.super_plan)):
        try:
            build()
            return backend
        except SupernodalPlanError:
            pass
    return "device"


# ---------------------------------------------------------------------------
# builder
# ---------------------------------------------------------------------------


FILL_NONE = "none"
FILL_RCM = "rcm"
FILL_CAMD = "camd"  # the native AMD ordering where the library is built
FILL_ND = "nd"  # nested dissection


@dataclasses.dataclass
class Ldl:
    """Builder: Ldl().fill_in_reduction('rcm').numeric(mat).solve(b).

    >>> import numpy as np
    >>> import sprs_tpu_torch as st
    >>> from sprs_tpu_torch.linalg import Ldl
    >>> a = st.from_dense(np.array([[4.0, 1.0, 0.0],
    ...                             [1.0, 3.0, 1.0],
    ...                             [0.0, 1.0, 2.0]]), device="cpu")
    >>> num = Ldl().fill_in_reduction('rcm').numeric(a)
    >>> x = num.solve(np.array([5.0, 5.0, 3.0]))
    >>> bool(np.allclose(x.numpy(), [1.0, 1.0, 1.0]))
    True
    """

    check_symmetry_flag: bool = True
    check_perm_flag: bool = True
    fill_red_method: str = FILL_NONE
    postorder_flag: Optional[bool] = None  # None = on for camd and nd

    def check_symmetry(self, flag: bool) -> "Ldl":
        self.check_symmetry_flag = flag
        return self

    def check_perm(self, flag: bool) -> "Ldl":
        self.check_perm_flag = flag
        return self

    def fill_in_reduction(self, method: str) -> "Ldl":
        self.fill_red_method = method
        return self

    def postorder(self, flag: bool) -> "Ldl":
        """Force etree postordering on/off (default: on for 'camd' and
        'nd', off otherwise).  Fill and flops are invariant either way."""
        self.postorder_flag = flag
        return self

    def _perm(self, mat: CsMat) -> Optional[Permutation]:
        if self.fill_red_method == FILL_NONE:
            return None
        if self.fill_red_method == FILL_RCM:
            return reverse_cuthill_mckee(mat).permutation()
        if self.fill_red_method == FILL_CAMD:
            from .amd import camd_order

            return camd_order(mat)
        if self.fill_red_method == FILL_ND:
            from .nd import nd_order

            return nd_order(mat)
        raise ValueError(f"unknown fill-in reduction {self.fill_red_method!r}")

    def symbolic(self, mat: CsMat) -> LdlSymbolic:
        po = self.postorder_flag
        if po is None:
            po = self.fill_red_method in (FILL_CAMD, FILL_ND)
        return LdlSymbolic.from_matrix(mat, perm=self._perm(mat),
                                       check_symmetry=self.check_symmetry_flag, postorder=po)

    def numeric(self, mat: CsMat, *, backend: str = "auto") -> LdlNumeric:
        return self.symbolic(mat).factor(mat, backend=backend)

