"""Sparse triangular solves with dense and sparse right-hand sides, the
counterpart of ``sprs_tpu/linalg/trisolve.py``.

Three device methods, each on the matrix's device:

* ``method="scan"``: a row (CSR) or column (CSC) sweep, one row per
  step, as the JAX package's ``lax.scan``.  A reference path: it makes
  several launches per row.
* ``method="levels"``: the production path.  A host symbolic pass
  computes the dependency *level schedule* of the triangle
  (:class:`TriSchedule`, the same arrays as the JAX package's); the
  device then updates every row of a level at once.
* ``method="flat"``: the off-diagonal entries streamed in (level, row)
  order and cut into blocks of ``E`` entries (:class:`FlatTriSchedule`),
  O(lnz) memory at any level shape.

The level loops are Python loops over the schedule's host extents: each
step slices device tensors with Python ints, so the loop makes no host
synchronisation.  An (n, k) right-hand side is solved in one pass, each
level gathering rows × k values; the JAX package maps the solve over
columns instead, so a column agrees with a single solve to f64 rounding.
Within a level or block the port sums in its own order (the JAX package's
``jnp.sum`` / scatter-add order differs), so the two agree to rounding.

A zero diagonal raises :class:`~sprs_tpu_torch.errors.SingularMatrixError`
on every call of :func:`lsolve` / :func:`usolve` (all port data is
concrete), as on the JAX package's concrete path.  Factor objects whose
diagonals were checked when they were built (ILU(0), IC(0), LU, LDLᵀ)
solve through :class:`LevelPlan` / :class:`FlatPlan` directly, without
the per-call check, which would read the data back to the host.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from .. import native
from ..errors import NonSquareMatrixError, ShapeError, SingularMatrixError
from ..formats.csmat import CsMat
from ..formats.csvec import CsVec, csvec
from ..formats.util import as_tensor, host_array


def _check_square(mat: CsMat):
    if mat.shape[0] != mat.shape[1]:
        raise NonSquareMatrixError(f"triangular solve needs square, got {mat.shape}")


def _check_rhs(mat: CsMat, b) -> torch.Tensor:
    b = b if isinstance(b, torch.Tensor) else as_tensor(b, device=mat.device)
    if b.shape[0] != mat.shape[0]:
        raise ShapeError(f"rhs dim {tuple(b.shape)} vs matrix {mat.shape}")
    return b


def _host_csr(mat: CsMat):
    """(indptr int64, live indices int64) of ``mat`` in CSR, on the host."""
    csr = mat.to_csr()
    indptr = csr.indptr.cpu().numpy().astype(np.int64)
    return indptr, csr.indices[: int(indptr[-1])].cpu().numpy().astype(np.int64)


def _host_diag_check(mat: CsMat):
    """Raise on a zero (or missing) diagonal entry; one device reduction
    and one scalar read."""
    d = mat.diag()
    zero = d == 0
    if bool(zero.any()):
        raise SingularMatrixError(f"zero diagonal at index {int(torch.argmax(zero.to(torch.int8)))}")


def diag_solve(mat: CsMat, b) -> torch.Tensor:
    """Solve D x = b for the diagonal of ``mat``."""
    _check_square(mat)
    b = _check_rhs(mat, b)
    _host_diag_check(mat)
    d = mat.diag()
    if b.ndim == 2:
        return b / d[:, None]
    return b / d


def _row_window_width(mat: CsMat, window: Optional[int] = None) -> int:
    if window is not None:
        return max(min(window, mat.cap), 1)
    return max(mat.max_outer_nnz(), 1)


def _levels_of(indptr, indices, n, lower):
    """(level per row, level count): native where built, else numpy."""
    fast = native.tri_levels(indptr, indices, n, lower=lower)
    if fast is not None:
        return fast
    level = np.zeros(n, dtype=np.int64)
    order = range(n) if lower else range(n - 1, -1, -1)
    for i in order:
        deps = indices[indptr[i] : indptr[i + 1]]
        deps = deps[deps < i] if lower else deps[deps > i]
        if deps.size:
            level[i] = level[deps].max() + 1
    return level, int(level.max()) + 1 if n else 1


# ---------------------------------------------------------------------------
# scan method (outer-dimension sweep, CSR gather / CSC scatter)
# ---------------------------------------------------------------------------


def _scan_solve(mat: CsMat, b: torch.Tensor, lower: bool, window: Optional[int]) -> torch.Tensor:
    """Row sweep (CSR): x[i] = (b[i] − Σ_{j on the solved side} a_ij x_j)/a_ii;
    column sweep (CSC): after x[j], subtract x[j]·A[:, j] from the running
    rhs.  Entries on the wrong side of the diagonal are ignored.  A row
    (column) wider than ``window`` NaN-poisons its component and reaches
    only the entries inside the window, as in the JAX package."""
    n = mat.shape[0]
    w = _row_window_width(mat, window)
    indptr = mat.indptr.cpu().numpy().astype(np.int64)
    idx_all = mat.indices.to(torch.int64)
    rhs = b.clone()
    x = torch.zeros_like(b)
    for step in range(n):
        i = step if lower else n - 1 - step
        lo, hi = int(indptr[i]), int(indptr[i + 1])
        # the JAX package's static window: w slots from the row start,
        # shifted back to end at the capacity
        hi_w = min(hi, min(lo, max(mat.cap - w, 0)) + w)
        idx, val = idx_all[lo:hi_w], mat.data[lo:hi_w]
        diag = torch.where(idx == i, val, torch.zeros_like(val)).sum()
        if mat.is_csr:
            side = (idx < i) if lower else (idx > i)
            xs = x[idx]
            contrib = torch.where(side.view(-1, *([1] * (b.ndim - 1))),
                                  val.view(-1, *([1] * (b.ndim - 1))) * xs,
                                  torch.zeros_like(xs)).sum(0)
            xi = (b[i] - contrib) / diag
        else:
            xi = rhs[i] / diag
        if hi - lo > w:
            xi = torch.full_like(xi, float("nan"))
        x[i] = xi
        if mat.is_csc:
            side = (idx > i) if lower else (idx < i)
            upd = torch.where(side, val, torch.zeros_like(val))
            upd = upd[:, None] * xi if b.ndim == 2 else upd * xi
            rhs.index_add_(0, idx, -upd)
    return x


# ---------------------------------------------------------------------------
# level-scheduled method
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TriSchedule:
    """Host-computed dependency levels of a triangular matrix.

    Rows are stored sorted by level (``order``) with per-level extents
    (``offsets``) — O(n) memory.  Built once per pattern and reusable for
    every numeric solve with that pattern (the LDLᵀ use case).  The same
    arrays as the JAX package's.
    """

    order: np.ndarray  # (n + width,) int32 rows by level, tail-padded n
    offsets: np.ndarray  # (n_levels + 1,) int64 level extents in order
    width: int  # max rows per level
    n: int
    lower: bool

    @property
    def n_levels(self) -> int:
        return self.offsets.shape[0] - 1


def build_schedule(mat: CsMat, *, lower: bool = True) -> TriSchedule:
    """Compute the level schedule on the host (symbolic, O(nnz))."""
    _check_square(mat)
    return schedule_from_arrays(*_host_csr(mat), lower=lower)


def schedule_from_arrays(indptr: np.ndarray, indices: np.ndarray, *, lower: bool = True
                         ) -> TriSchedule:
    """:func:`build_schedule` of the CSR pattern (indptr, live indices)."""
    n = indptr.shape[0] - 1
    level, n_levels = _levels_of(indptr, indices, n, lower)
    counts = np.bincount(level, minlength=n_levels)
    width = max(int(counts.max()), 1) if n else 1
    offsets = np.zeros(n_levels + 1, dtype=np.int64)
    np.cumsum(counts, out=offsets[1:])
    order = np.argsort(level, kind="stable").astype(np.int32)
    order = np.concatenate([order, np.full(width, n, dtype=np.int32)])
    return TriSchedule(order=order, offsets=offsets, width=width, n=n, lower=lower)


def _side_entries(indptr, indices, lower):
    """Per entry: row, the solved-side mask and the diagonal mask."""
    n = indptr.shape[0] - 1
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    side = (indices < rows) if lower else (indices > rows)
    return rows, side, indices == rows


@dataclasses.dataclass(frozen=True)
class LevelPlan:
    """Device gather maps of a level solve for one pattern.

    Level l holds the rows ``rows[s:e]`` and, in a (e − s) × w_l window
    stored flat at ``slot[fs:fe]`` / ``col[fs:fe]``, their solved-side
    entries: ``slot`` indexes the values array (one past its end is a
    zero), ``col`` the solution (index n is a zero), ``frow`` the entry's
    row position in level order.  ``bounds`` holds (s, e, fs, fe, w_l)
    per level as Python ints, so the solve loop slices without reading
    the device.
    """

    n: int
    rows: torch.Tensor  # (n,) int64 rows in level order
    diag_slot: torch.Tensor  # (n,) int64, in level order
    slot: torch.Tensor  # (F,) int64
    col: torch.Tensor  # (F,) int64
    frow: torch.Tensor  # (F,) int64
    bounds: List[Tuple[int, int, int, int, int]]

    @classmethod
    def build(cls, indptr: np.ndarray, indices: np.ndarray, sched: TriSchedule, *,
              slot_map: Optional[np.ndarray] = None, device="cpu") -> "LevelPlan":
        """The plan of the CSR pattern (indptr, live indices) under
        ``sched``, on ``device``.  ``slot_map`` re-targets the CSR value
        positions into another values array (LDLᵀ solves index
        ``l_data`` directly)."""
        n = indptr.shape[0] - 1
        indptr = indptr.astype(np.int64)
        indices = indices.astype(np.int64)
        nnz = int(indptr[-1])
        zero_slot = nnz if slot_map is None else int(slot_map.shape[0])
        pos = np.arange(nnz, dtype=np.int64) if slot_map is None else slot_map.astype(np.int64)
        rows_e, side, on_diag = _side_entries(indptr, indices, sched.lower)
        order = sched.order[:n].astype(np.int64)
        rank_of = np.empty(n, dtype=np.int64)
        rank_of[order] = np.arange(n, dtype=np.int64)
        # first stored diagonal per row; a missing one reads the zero slot
        dslot = np.full(n, zero_slot, dtype=np.int64)
        pd = np.nonzero(on_diag)[0]
        dslot[rows_e[pd][::-1]] = pos[pd][::-1]
        # solved-side entries: count and rank within their row
        pe = np.nonzero(side)[0]
        erow = rows_e[pe]
        cnt = np.bincount(erow, minlength=n)
        first = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(cnt, out=first[1:])
        erank = np.arange(pe.shape[0], dtype=np.int64) - first[erow]
        offs = sched.offsets.astype(np.int64)
        nl = sched.n_levels
        lvl_of_pos = np.repeat(np.arange(nl, dtype=np.int64), np.diff(offs))
        cnt_sorted = cnt[order]
        wl = np.zeros(nl, dtype=np.int64)
        np.maximum.at(wl, lvl_of_pos, cnt_sorted)
        fsize = np.diff(offs) * wl
        fbase = np.zeros(nl + 1, dtype=np.int64)
        np.cumsum(fsize, out=fbase[1:])
        slot = np.full(int(fbase[-1]), zero_slot, dtype=np.int64)
        col = np.full(int(fbase[-1]), n, dtype=np.int64)
        p = rank_of[erow]
        lv = lvl_of_pos[p]
        flat = fbase[lv] + (p - offs[lv]) * wl[lv] + erank
        slot[flat] = pos[pe]
        col[flat] = indices[pe]
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
        bounds = [
            (int(offs[l]), int(offs[l + 1]), int(fbase[l]), int(fbase[l + 1]), int(wl[l]))
            for l in range(nl)
        ]
        frow = np.repeat(np.arange(n, dtype=np.int64), wl[lvl_of_pos])
        return cls(n, t(order), t(dslot[order]), t(slot), t(col), t(frow), bounds)

    def solve(self, values: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """x of the triangle whose values are ``values`` (indexed by the
        plan's slots), for a vector or an (n, k) block ``b``.

        Each row is x_i = b_i/d_i − Σ_j (a_ij/d_i)·x_j: the scaled values
        and right-hand side are formed once for all levels, so a level is
        one gather, one batched multiply-subtract and one copy."""
        n = self.n
        vec = b.ndim == 1
        bk = b[:, None] if vec else b
        k = bk.shape[1]
        vals = torch.cat([values, values.new_zeros(1)]).to(bk.dtype)
        d = vals[self.diag_slot]
        v = (vals[self.slot] / d[self.frow]).unsqueeze(1)
        bd = (bk[self.rows] / d[:, None]).unsqueeze(1)
        x = torch.zeros((n + 1, k), dtype=bk.dtype, device=bk.device)
        for s, e, fs, fe, w in self.bounds:
            if w:
                xg = x.index_select(0, self.col[fs:fe]).view(e - s, w, k)
                out = torch.baddbmm(bd[s:e], v[fs:fe].view(e - s, 1, w), xg, alpha=-1)
            else:
                out = bd[s:e]
            x.index_copy_(0, self.rows[s:e], out.view(e - s, k))
        return x[:n, 0] if vec else x[:n]


# ---------------------------------------------------------------------------
# flat blocked level method — O(lnz) at any depth
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FlatTriSchedule:
    """Entry-stream level schedule: O(lnz + n_levels·E) memory.

    The OFF-DIAGONAL entries are streamed in (level, row) order and cut
    into static ``E``-entry blocks that never cross a level boundary; a
    row wider than a block spans several blocks (its dot product
    accumulates in ``acc``), and each block first finalizes the rows
    whose last entry an earlier block held:
    ``x[r] = (b[r] − acc[r]) / diag[r]``.  Pattern-only (positions into
    the matrix's data array); the same arrays as the JAX package's.
    """

    n: int
    lower: bool
    E: int  # entries per block
    nblocks: int
    # per-block entry streams, (nblocks, E); sentinel: row = n
    e_slot: np.ndarray  # position into mat.data (0 for the sentinel)
    e_col: np.ndarray  # column of the entry (0 for the sentinel)
    e_row: np.ndarray  # target row (n for padding)
    # per-block finalize streams, (nblocks, F); sentinel row = n
    f_row: np.ndarray
    f_dslot: np.ndarray  # diag position into mat.data


def build_flat_schedule(mat: CsMat, *, lower: bool = True, block_entries: int = 2048
                        ) -> FlatTriSchedule:
    """Host symbolic pass for the flat blocked level solve."""
    _check_square(mat)
    return flat_schedule_from_arrays(*_host_csr(mat), lower=lower, block_entries=block_entries)


def flat_schedule_from_arrays(indptr: np.ndarray, indices: np.ndarray, *, lower: bool = True,
                              block_entries: int = 2048) -> FlatTriSchedule:
    """:func:`build_flat_schedule` of the CSR pattern (indptr, live
    indices)."""
    n = indptr.shape[0] - 1
    indptr = indptr.astype(np.int64)
    indices = indices.astype(np.int64)
    nnz = int(indptr[-1])
    level, _ = _levels_of(indptr, indices, n, lower)

    rows_all, side, on_diag = _side_entries(indptr, indices, lower)
    # diag slot per row (the first stored diagonal entry wins)
    dslot = np.full(n, nnz, dtype=np.int64)
    pos_d = np.nonzero(on_diag)[0]
    dslot[rows_all[pos_d][::-1]] = pos_d[::-1]
    if np.any(dslot == nnz):
        raise SingularMatrixError(f"zero diagonal at index {int(np.argmax(dslot == nnz))}")

    # off-diagonal entries sorted by (level of their row, row)
    pos_e = np.nonzero(side)[0]
    erow = rows_all[pos_e]
    order_e = np.argsort(level[erow] * np.int64(n) + erow, kind="stable")
    pos_e = pos_e[order_e]
    erow = erow[order_e]
    ecol = indices[pos_e]
    elvl = level[erow]

    E = int(block_entries)
    # blocks: every E entries, and a cut at every level boundary (a row
    # may straddle an E-cut; its partial sums accumulate)
    ne = pos_e.shape[0]
    lvl_starts = (np.nonzero(np.concatenate([[True], elvl[1:] != elvl[:-1]]))[0]
                  if ne else np.zeros(0, np.int64))
    cuts = sorted({0, ne, *(int(s) for s in lvl_starts)})
    blocks = []  # half-open entry ranges
    for a, bnd in zip(cuts[:-1], cuts[1:]):
        for p in range(a, bnd, E):
            blocks.append((p, min(p + E, bnd)))
    if not blocks:
        blocks = [(0, 0)]
    nb = len(blocks)

    e_slot = np.zeros((nb, E), dtype=np.int64)
    e_col = np.zeros((nb, E), dtype=np.int64)
    e_row = np.full((nb, E), n, dtype=np.int64)
    for bi, (a, bnd) in enumerate(blocks):
        k = bnd - a
        e_slot[bi, :k] = pos_e[a:bnd]
        e_col[bi, :k] = ecol[a:bnd]
        e_row[bi, :k] = erow[a:bnd]

    # a row finalizes at the start of the block after its last entry (one
    # extra entry-empty tail block); rows with no off-diagonal entries
    # (level 0) finalize at the start of block 0
    nb_f = nb + 1
    fin_block = np.zeros(n, dtype=np.int64)
    if ne:
        last_of_row = np.full(n, -1, dtype=np.int64)
        last_of_row[erow] = np.arange(ne, dtype=np.int64)
        bstart = np.asarray([a for a, _ in blocks], dtype=np.int64)
        has = last_of_row >= 0
        fin_block[has] = np.searchsorted(bstart, last_of_row[has], side="right")
    fcount = np.bincount(fin_block, minlength=nb_f)
    F = max(int(fcount.max()), 1) if n else 1
    f_row = np.full((nb_f, F), n, dtype=np.int64)
    f_dslot = np.full((nb_f, F), max(nnz - 1, 0), dtype=np.int64)
    order_r = np.argsort(fin_block, kind="stable")
    fb_sorted = fin_block[order_r]
    foffs = np.zeros(nb_f + 1, dtype=np.int64)
    np.cumsum(fcount, out=foffs[1:])
    rank = np.arange(n, dtype=np.int64) - foffs[fb_sorted]
    f_row[fb_sorted, rank] = order_r
    f_dslot[fb_sorted, rank] = dslot[order_r]

    pad_e = np.zeros((1, E), dtype=np.int64)
    return FlatTriSchedule(
        n=n,
        lower=lower,
        E=E,
        nblocks=nb_f,
        e_slot=np.concatenate([e_slot, pad_e]).astype(np.int32),
        e_col=np.concatenate([e_col, pad_e]).astype(np.int32),
        e_row=np.concatenate([e_row, np.full((1, E), n, dtype=np.int64)]).astype(np.int32),
        f_row=f_row.astype(np.int32),
        f_dslot=f_dslot.astype(np.int32),
    )


@dataclasses.dataclass(frozen=True)
class FlatPlan:
    """A :class:`FlatTriSchedule`'s streams on the device.  Sentinel rows
    and columns point at a spare slot n of the solution and the
    accumulator, where their values are dropped."""

    n: int
    e_slot: torch.Tensor  # (nblocks, E) int64 into the values array
    e_col: torch.Tensor
    e_row: torch.Tensor
    f_row: torch.Tensor
    f_dslot: torch.Tensor

    @classmethod
    def build(cls, sched: FlatTriSchedule, *, slot_map: Optional[np.ndarray] = None,
              device="cpu") -> "FlatPlan":
        """``slot_map`` re-targets the data positions into another values
        array, as in :meth:`LevelPlan.build`."""
        def t(a, slots=False):
            a = a.astype(np.int64)
            if slots and slot_map is not None:
                a = slot_map.astype(np.int64)[a]
            return torch.from_numpy(a).to(device)

        return cls(sched.n, t(sched.e_slot, True), t(sched.e_col), t(sched.e_row),
                   t(sched.f_row), t(sched.f_dslot, True))

    def solve(self, values: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Each block finalizes x_r = b_r/d_r − acc_r/d_r for its rows, then
        adds its entries' products into ``acc``; the scaled right-hand
        side and the reciprocal diagonals are gathered once for all
        blocks."""
        n = self.n
        vec = b.ndim == 1
        bk = b[:, None] if vec else b
        k = bk.shape[1]
        v = values[self.e_slot].to(bk.dtype)[..., None]
        dinv = 1.0 / values[self.f_dslot].to(bk.dtype)[..., None]
        b_ext = torch.cat([bk, bk.new_zeros(1, k)])
        bd = b_ext[self.f_row] * dinv
        x = torch.zeros((n + 1, k), dtype=bk.dtype, device=bk.device)
        acc = torch.zeros_like(x)
        for blk in range(self.e_slot.shape[0]):
            fr = self.f_row[blk]
            x.index_copy_(0, fr, torch.addcmul(bd[blk], acc.index_select(0, fr), dinv[blk],
                                               value=-1))
            acc.index_add_(0, self.e_row[blk], x.index_select(0, self.e_col[blk]) * v[blk])
        return x[:n, 0] if vec else x[:n]


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------


def lsolve(mat: CsMat, b, *, method: str = "auto", schedule=None,
           window: Optional[int] = None) -> torch.Tensor:
    """Solve L x = b using the lower-triangular part of ``mat``.

    ``method``: "scan", "levels", "flat", or "auto" ("levels" — or "flat"
    for a :class:`FlatTriSchedule` — and "flat" once n·max_row_nnz
    exceeds 2²⁴, the JAX package's rule for concrete input).  ``window``
    bounds the scan method's per-row width; a wider row NaN-poisons its
    component.

    >>> import numpy as np
    >>> import sprs_tpu_torch as st
    >>> from sprs_tpu_torch.linalg import lsolve
    >>> l = st.from_dense(np.array([[2.0, 0.0], [1.0, 4.0]]), device="cpu")
    >>> lsolve(l, np.array([2.0, 9.0])).tolist()
    [1.0, 2.0]
    """
    return _trisolve(mat, b, lower=True, method=method, schedule=schedule, window=window)


def usolve(mat: CsMat, b, *, method: str = "auto", schedule=None,
           window: Optional[int] = None) -> torch.Tensor:
    """Solve U x = b using the upper-triangular part of ``mat``."""
    return _trisolve(mat, b, lower=False, method=method, schedule=schedule, window=window)


def _trisolve(mat, b, *, lower, method, schedule, window=None):
    _check_square(mat)
    b = _check_rhs(mat, b)
    # numpy-style promotion: an f64 matrix with an f32 rhs solves in f64
    b = b.to(torch.promote_types(mat.dtype, b.dtype))
    _host_diag_check(mat)
    if method == "auto":
        if schedule is not None:
            method = "flat" if isinstance(schedule, FlatTriSchedule) else "levels"
        else:
            # the level method's window is (level width × max row nnz);
            # past this product the flat blocked stream takes over
            method = "flat" if mat.shape[0] * _row_window_width(mat) > 1 << 24 else "levels"
    if method == "levels":
        if schedule is None:
            schedule = build_schedule(mat, lower=lower)
        if schedule.lower != lower:
            raise ValueError("schedule direction mismatch")
        return LevelPlan.build(*_host_csr(mat), schedule, device=mat.device).solve(
            mat.to_csr().data, b)
    if method == "flat":
        if not isinstance(schedule, FlatTriSchedule):
            schedule = build_flat_schedule(mat, lower=lower)
        if schedule.lower != lower:
            raise ValueError("schedule direction mismatch")
        return FlatPlan.build(schedule, device=mat.device).solve(mat.to_csr().data, b)
    if method == "scan":
        return _scan_solve(mat, b, lower, window)
    raise ValueError(f"unknown trisolve method {method!r}")


def lsolve_csc_sparse_rhs(l_mat: CsMat, b: CsVec) -> CsVec:
    """Sparse-RHS lower solve via Gilbert–Peierls reach, on the host.

    The solution's pattern is the graph reach of the rhs pattern through
    L's DAG (by DFS); only reached columns are solved.  The result lands
    on ``l_mat``'s device.
    """
    _check_square(l_mat)
    if l_mat.shape[0] != b.dim:
        raise ShapeError("sparse rhs dim mismatch")
    csc = l_mat.to_csc()
    n = csc.shape[0]
    indptr = csc.indptr.cpu().numpy()
    indices = csc.indices.cpu().numpy()
    data = host_array(csc.data)  # bfloat16 as float32: exact
    b_idx = b.indices[: b.nnz].cpu().numpy()
    b_val = host_array(b.data[: b.nnz])

    visited = np.zeros(n, dtype=bool)
    topo: list = []
    for s in b_idx:
        if visited[s]:
            continue
        stack = [(int(s), indptr[s])]
        visited[s] = True
        while stack:
            node, it = stack.pop()
            pushed = False
            while it < indptr[node + 1]:
                nxt = indices[it]
                it += 1
                if nxt > node and not visited[nxt]:
                    visited[nxt] = True
                    stack.append((node, it))
                    stack.append((int(nxt), indptr[nxt]))
                    pushed = True
                    break
            if not pushed:
                topo.append(node)
    topo.reverse()  # topological order of the reach

    x = np.zeros(n, dtype=b_val.dtype)
    x[b_idx] = b_val
    for j in topo:
        lo, hi = indptr[j], indptr[j + 1]
        col_idx = indices[lo:hi]
        col_val = data[lo:hi]
        dmask = col_idx == j
        if not dmask.any() or col_val[dmask][0] == 0:
            raise SingularMatrixError(f"zero diagonal at column {j}")
        x[j] /= col_val[dmask][0]
        below = col_idx > j
        x[col_idx[below]] -= col_val[below] * x[j]

    pattern = np.sort(np.asarray(topo, dtype=np.int64))
    return csvec(n, pattern.astype(np.int32),
                 as_tensor(x[pattern], dtype=b.data.dtype, device=l_mat.device), device=l_mat.device)
