"""Supernodal left-looking LDLᵀ numeric, the counterpart of
``sprs_tpu/linalg/ldl_super.py``.

Columns of L are partitioned into supernodes (shared below-diagonal row
structure, see ``supernodes.py``); each is factored as one dense
trapezoidal panel, and every inter-supernode Schur update is one
(MR×W)·(W×W) product instead of the row scan's scalar-sized updates.

Why this is exact: supernode s spans columns ``[c0, c1)`` and every
column j is padded to the structure ``[j+1..c1) ∪ rows(s)``, where
``rows(s)`` is the union of the member columns' below-c1 structures, so
containment holds for any contiguous column partition.  Entries
introduced by padding are exactly 0.0 (every update term carries a
padded, exactly-zero factor), so gathering the simplicial CSC slots out
of the panels reproduces the row-scan factorization up to summation
order.

Memory layout: panels lie back to back in one flat array with a row
stride of W (the widest supernode, padded to a multiple of 8); panel s
occupies ``off[s] + r*W + c`` for row slot r < rows[s].  Row slots: the
first w[s] are the diagonal-block rows c0..c1−1, the rest are rows(s)
ascending.  The plan is host numpy, the same integers as the JAX
package's.  The device side runs one task at a time as plain torch on
the operand's device: every offset and width is a Python int from the
plan, so a task reads its panels through views and makes no host sync.
The flat array carries MR·W zeros past P (the batched numeric's zero
scratch), so every window stays in bounds.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..errors import LinalgError
from .supernodes import amalgamate_subtree, amalgamate_union


class SupernodalPlanError(LinalgError):
    """Raised when a supernodal plan would be infeasible (memory);
    callers fall back to another numeric."""


def _ceil8(x: int) -> int:
    return max(8, (int(x) + 7) & ~7)


@dataclasses.dataclass(frozen=True, eq=False)
class SuperPlan:
    """Static supernodal factorization schedule (host-precomputed)."""

    n: int
    S: int  # number of supernodes
    W: int  # max supernode width, padded to a multiple of 8
    MR: int  # max panel rows (width + below-rows), padded, >= W
    P: int  # flat panel array length (includes MR*W read slack)
    # per-supernode geometry
    c0: np.ndarray  # (S,) first column
    w: np.ndarray  # (S,) width
    rows: np.ndarray  # (S,) valid panel rows (w + |below|)
    off: np.ndarray  # (S,) flat panel offsets
    # assembly: scatter A's lower-triangle values into the panels
    asm_src: np.ndarray  # (nnz_low,) positions into the input data array
    asm_dst: np.ndarray  # (nnz_low,) flat panel positions
    # task schedule: per-target updates (type 0) then its factor (type 1)
    t_type: np.ndarray  # (T,)
    t_src: np.ndarray  # (T,) descendant supernode (== snode for factor)
    t_dst: np.ndarray  # (T,) target supernode
    t_rmap: np.ndarray  # (T, MR) target row-slot -> source panel row-slot
    #   (MR = "no shared row")
    # extraction: CSC slot -> flat panel position
    csc_gather: np.ndarray  # (lnz,)
    # below-row structure (for the panel solves): supernode s's below
    # rows are below_flat[below_ptr[s]:below_ptr[s+1]], ascending, with an
    # MR-long tail of the sentinel n
    below_ptr: np.ndarray  # (S+1,)
    below_flat: np.ndarray  # (total_below + MR,)

    @property
    def n_tasks(self) -> int:
        return self.t_type.shape[0]


@dataclasses.dataclass
class _Prelude:
    """Shared host-side plan machinery: supernode geometry, membership
    queries, assembly/extraction maps, and the update-pair list, consumed
    by ``build_super_plan`` and ``ldl_mf.build_mf_plan``."""

    n: int
    S: int
    W: int
    MR: int
    P: int
    of: np.ndarray  # (n,) column -> supernode
    c0: np.ndarray
    c1: np.ndarray
    w: np.ndarray
    rows: np.ndarray
    off: np.ndarray  # (S+1,)
    below_ptr: np.ndarray
    below_flat: np.ndarray
    total_below: int
    below_owner: np.ndarray
    asm_src: np.ndarray
    asm_dst: np.ndarray
    pair_d: np.ndarray
    pair_t: np.ndarray
    csc_gather: np.ndarray
    member_slot: object  # vectorized (snode, g) -> (slot, found)


def _build_prelude(sym, *, max_width: int, max_zeros: int, rel_zeros: float,
                   panel_limit: int, align: str = "subtree") -> _Prelude:
    n = sym.n
    if n == 0:
        raise SupernodalPlanError("empty matrix")
    lp = np.asarray(sym.l_indptr, dtype=np.int64)
    li = np.asarray(sym.l_indices, dtype=np.int64)
    col_size = np.diff(lp)
    # union-structure relaxed amalgamation; align='subtree' cuts along
    # complete etree subtrees instead, which keeps the level-batched
    # numeric's critical path short
    amalgamate_fn = amalgamate_subtree if align == "subtree" else amalgamate_union
    sn, below_ptr, below_flat = amalgamate_fn(
        lp, li, np.asarray(sym.parent), col_size,
        max_zeros=max_zeros, max_width=max_width, rel_zeros=rel_zeros,
    )
    ptr = sn.ptr
    of = sn.of
    S = sn.n_snodes
    c0 = ptr[:-1].astype(np.int64)
    c1 = ptr[1:].astype(np.int64)
    w = c1 - c0
    W = _ceil8(int(w.max()))
    counts = np.diff(below_ptr)
    total_below = int(below_ptr[-1])
    rows = w + counts
    MR = max(_ceil8(int(rows.max())), W)
    off = np.zeros(S + 1, dtype=np.int64)
    np.cumsum(rows * W, out=off[1:])
    P = int(off[-1]) + MR * W
    if P > panel_limit:
        raise SupernodalPlanError(f"panel storage {P} elements exceeds limit {panel_limit}")
    if P + MR * W >= 2**31:
        raise SupernodalPlanError(f"panel positions {P + MR * W} exceed int32 range")

    # sorted membership key: (owner supernode, global row); owners ascend
    # and rows ascend within an owner, so one searchsorted answers queries
    below_owner = np.repeat(np.arange(S, dtype=np.int64), counts)
    below_key = below_owner * np.int64(n) + below_flat

    def member_slot(snode: np.ndarray, g: np.ndarray):
        """Panel row slot of global row g inside supernode ``snode``
        (vectorized): (slot, found), found False where g is not in the
        supernode's below structure."""
        qk = snode * np.int64(n) + g
        if total_below:
            pos = np.searchsorted(below_key, qk)
            posc = np.minimum(pos, total_below - 1)
            found = (g >= 0) & (below_key[posc] == qk)
            slot = w[snode] + (posc - below_ptr[snode])
        else:
            found = np.zeros(qk.shape, dtype=bool)
            slot = np.zeros(qk.shape, dtype=np.int64)
        return slot, found

    # assembly map: A lower-triangle entries -> panel positions
    wa = sym.a_pos.shape[1]
    live = np.asarray(sym.a_live).ravel()
    k_ent = np.repeat(np.arange(n, dtype=np.int64), wa)[live]
    j_ent = np.asarray(sym.a_col, dtype=np.int64).ravel()[live]
    asm_src = np.asarray(sym.a_pos, dtype=np.int64).ravel()[live]
    s_ent = of[j_ent]
    in_diag = k_ent < c1[s_ent]
    bslot, bfound = member_slot(s_ent, k_ent)
    if not np.all(in_diag | bfound):
        raise SupernodalPlanError("matrix entry outside the symbolic L pattern")
    rslot = np.where(in_diag, k_ent - c0[s_ent], bslot)
    asm_dst = off[s_ent] + rslot * W + (j_ent - c0[s_ent])

    # update pairs: descendant d touches target t iff a below row of d
    # lands in t's columns
    if total_below:
        pair_key = below_owner * np.int64(S) + of[below_flat]
        uniq = np.unique(pair_key)
        pair_d = uniq // S
        pair_t = uniq % S
    else:
        pair_d = pair_t = np.zeros(0, dtype=np.int64)

    # extraction: CSC slot -> panel position
    colj = np.repeat(np.arange(n, dtype=np.int64), col_size)
    s_c = of[colj]
    in_diag3 = li < c1[s_c]
    bslot3, bfound3 = member_slot(s_c, li)
    if not np.all(in_diag3 | bfound3):
        raise SupernodalPlanError("L pattern row outside supernode structure")
    rslot3 = np.where(in_diag3, li - c0[s_c], bslot3)
    csc_gather = off[s_c] + rslot3 * W + (colj - c0[s_c])

    return _Prelude(
        n=n, S=S, W=W, MR=MR, P=P, of=of, c0=c0, c1=c1, w=w, rows=rows, off=off,
        below_ptr=below_ptr, below_flat=below_flat, total_below=total_below,
        below_owner=below_owner, asm_src=asm_src, asm_dst=asm_dst, pair_d=pair_d,
        pair_t=pair_t, csc_gather=csc_gather, member_slot=member_slot,
    )


def _pair_rmap(pre: _Prelude, pair_d, pair_t):
    """(npairs, MR) target row-slot -> descendant panel row-slot table
    (sentinel MR where the target slot has no shared row)."""
    from .. import native

    if not pair_d.shape[0]:
        return np.zeros((0, pre.MR), dtype=np.int32)
    rmap = native.super_rmap(pair_d, pair_t, pre.c0, pre.w, pre.below_ptr, pre.below_flat,
                             pre.MR)
    if rmap is not None:
        return rmap
    # numpy fallback: broadcast (npairs, MR) membership queries
    MR = pre.MR
    w, rows, c0 = pre.w, pre.rows, pre.c0
    slots = np.arange(MR, dtype=np.int64)
    tw = w[pair_t][:, None]
    trows = rows[pair_t][:, None]
    g_diag = c0[pair_t][:, None] + slots[None, :]
    bidx = pre.below_ptr[pair_t][:, None] + (slots[None, :] - tw)
    in_diag_slot = slots[None, :] < tw
    in_below_slot = (slots[None, :] >= tw) & (slots[None, :] < trows)
    bidx_c = np.clip(bidx, 0, max(pre.total_below - 1, 0))
    g = np.where(in_diag_slot, g_diag,
                 np.where(in_below_slot, pre.below_flat[bidx_c], -1))
    dslot, dfound = pre.member_slot(np.broadcast_to(pair_d[:, None], g.shape), g)
    return np.where(dfound, dslot, MR).astype(np.int32)


def _task_order(S, pair_d, pair_t, slot_of_target):
    """Positions of the update tasks: for each target ascending, its
    descendants ascending, at ``slot_of_target[t] + rank``.  Returns
    (update positions, the pairs' sort order)."""
    order = np.lexsort((pair_d, pair_t))
    pt_sorted = pair_t[order]
    npairs = pair_d.shape[0]
    grp_first = np.zeros(npairs, dtype=np.int64)
    newgrp = np.ones(npairs, dtype=bool)
    newgrp[1:] = pt_sorted[1:] != pt_sorted[:-1]
    grp_first[newgrp] = np.nonzero(newgrp)[0]
    grp_first = np.maximum.accumulate(grp_first)
    rank = np.arange(npairs, dtype=np.int64) - grp_first
    return slot_of_target[pt_sorted] + rank, order


def build_super_plan(sym, *, max_width: int = 128, max_zeros: int = 32,
                     rel_zeros: float = 0.65, panel_limit: int = 1 << 28,
                     map_limit: int = 1 << 27, align: str = "subtree") -> SuperPlan:
    """The supernodal schedule of an ``LdlSymbolic``.

    ``panel_limit`` bounds the flat panel array length (elements) and
    ``map_limit`` the (T, MR) row-map table; exceeding either raises
    ``SupernodalPlanError``.  ``align='subtree'`` cuts supernodes along
    complete etree subtrees (short critical path for the level-batched
    numeric)."""
    pre = _build_prelude(sym, max_width=max_width, max_zeros=max_zeros, rel_zeros=rel_zeros,
                         panel_limit=panel_limit, align=align)
    n, S, MR = pre.n, pre.S, pre.MR
    pair_d, pair_t = pre.pair_d, pre.pair_t
    npairs = pair_d.shape[0]
    T = npairs + S
    if T * MR > map_limit:
        raise SupernodalPlanError(f"row-map table {T}x{MR} exceeds limit {map_limit}")
    rmap = _pair_rmap(pre, pair_d, pair_t)

    # task schedule: for each target s ascending, its updates
    # (descendants ascending), then its factor
    upd_cnt = np.bincount(pair_t, minlength=S) if npairs else np.zeros(S, np.int64)
    task_ptr = np.zeros(S + 1, dtype=np.int64)
    np.cumsum(upd_cnt + 1, out=task_ptr[1:])
    t_type = np.zeros(T, dtype=np.int32)
    t_src = np.zeros(T, dtype=np.int64)
    t_dst = np.zeros(T, dtype=np.int64)
    t_rmap = np.full((T, MR), MR, dtype=np.int32)
    if npairs:
        upd_idx, order = _task_order(S, pair_d, pair_t, task_ptr)
        t_src[upd_idx] = pair_d[order]
        t_dst[upd_idx] = pair_t[order]
        t_rmap[upd_idx] = rmap[order]
    fact_idx = task_ptr[1:] - 1
    t_type[fact_idx] = 1
    t_src[fact_idx] = np.arange(S)
    t_dst[fact_idx] = np.arange(S)

    return SuperPlan(
        n=n, S=S, W=pre.W, MR=MR, P=pre.P,
        c0=pre.c0.astype(np.int32),
        w=pre.w.astype(np.int32),
        rows=pre.rows.astype(np.int32),
        off=pre.off[:-1].astype(np.int32),
        asm_src=pre.asm_src.astype(np.int32),
        asm_dst=pre.asm_dst.astype(np.int32),
        t_type=t_type,
        t_src=t_src.astype(np.int32),
        t_dst=t_dst.astype(np.int32),
        t_rmap=t_rmap,
        csc_gather=pre.csc_gather.astype(np.int32),
        below_ptr=pre.below_ptr,
        below_flat=np.concatenate([pre.below_flat, np.full(MR, n, dtype=np.int64)]).astype(np.int32),
    )


# ---------------------------------------------------------------------------
# device side
# ---------------------------------------------------------------------------


def device_tables(plan, device) -> dict:
    """The plan's index arrays as int64 tensors on ``device`` (built once
    per device, cached on the plan): the panel kernels index them through
    views, so a task copies nothing from the host."""
    key = str(torch.device(device))
    cache = plan.__dict__.setdefault("_device_tables", {})
    if key not in cache:
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.int64)).to(device)  # noqa: E731
        rmap = torch.from_numpy(np.ascontiguousarray(plan.t_rmap)).to(device)
        cache[key] = {
            "asm_src": t(plan.asm_src),
            "asm_dst": t(plan.asm_dst),
            "csc_gather": t(plan.csc_gather),
            "below_flat": t(plan.below_flat),
            "rmap_live": rmap < plan.MR,
            # the sentinel row MR reads row 0, masked to zero by rmap_live
            "rmap_safe": torch.where(rmap < plan.MR, rmap, 0).to(torch.int64),
        }
    return cache[key]


def assemble(plan, data: torch.Tensor):
    """``(Lp, dext)``: A's lower triangle scattered into zeroed panels of
    length P + MR·W (the zero scratch past P), and the (n + W,) pivot
    array.  ``data`` is (nnz,) or (N, nnz); the results carry its leading
    axis."""
    dev = device_tables(plan, data.device)
    # integer data promotes to float32, as in the JAX package
    dtype = data.dtype if data.dtype.is_floating_point else torch.promote_types(data.dtype,
                                                                                torch.float32)
    vals = data.reshape(-1, data.shape[-1])[:, dev["asm_src"]].to(dtype)
    N, length = vals.shape[0], plan.P + plan.MR * plan.W
    member = torch.arange(N, device=data.device)[:, None] * length
    # an accumulating index_put_: ordered sums on the card, not atomics
    lp = torch.zeros(N * length, dtype=dtype, device=data.device).index_put_(
        ((member + dev["asm_dst"]).reshape(-1),), vals.reshape(-1), accumulate=True)
    shape = data.shape[:-1]
    return (lp.view(shape + (length,)),
            torch.zeros(shape + (plan.n + plan.W,), dtype=dtype, device=data.device))


def _panel_kernels(plan, lp: torch.Tensor, dext: torch.Tensor):
    """The two per-task kernels of the left-looking and multifrontal-lite
    numerics, on one member's panels ``lp`` and pivots ``dext``: a
    pairwise Schur update and a dense panel factorization.  Task extents
    are the plan's host ints."""
    from .ldl_batched import blocked_ldl_top

    W, MR = plan.W, plan.MR
    dev = device_tables(plan, lp.device)
    off, c0, w, rows = plan.off, plan.c0, plan.w, plan.rows
    cols = torch.arange(W, device=lp.device)

    def panel(s):
        o = int(off[s])
        return lp[o : o + MR * W].view(MR, W)

    def update(i, src, dst):
        # target[r, c] -= Σ_k Ld[rmap[r], k]·D[k]·Ld[rmap[c], k] over the
        # target's live rows and columns (other rows' rmap is the sentinel)
        ws, wt, rt = int(w[src]), int(w[dst]), int(rows[dst])
        b = torch.where(dev["rmap_live"][i, :rt, None], panel(src)[dev["rmap_safe"][i, :rt], :ws],
                        0)
        g = b[:wt] * dext[int(c0[src]) : int(c0[src]) + ws]
        panel(dst)[:rt, :wt].sub_(b @ g.T)

    def factor(s):
        ws, rs = int(w[s]), int(rows[s])
        pan = panel(s)
        live = cols < ws
        top = torch.where(live, pan[:W], 0)
        top.diagonal().copy_(torch.where(live, top.diagonal(), 1))
        top, dvec = blocked_ldl_top(top[None], live[None], n_live=ws)
        if rs > W:
            bottom = torch.linalg.solve_triangular(top[0].mT, pan[W:rs], upper=True, left=False,
                                                   unitriangular=True)
            pan[W:rs, :ws] = (bottom / dvec)[:, :ws]
        pan[: min(rs, W), :ws] = top[0, : min(rs, W), :ws]
        dext[int(c0[s]) : int(c0[s]) + ws] = dvec[0, :ws]

    return update, factor


def numeric_supernodal(plan: SuperPlan, data: torch.Tensor):
    """The supernodal numeric on ``data``'s device: ``(l_data, d)`` in the
    row-scan numeric's CSC-slot layout.  One task at a time, in the plan's
    order; a zero pivot NaN-poisons the outputs instead of raising."""
    lp, dext = assemble(plan, data)
    update, factor = _panel_kernels(plan, lp, dext)
    for i, (tt, src, dst) in enumerate(zip(plan.t_type.tolist(), plan.t_src.tolist(),
                                           plan.t_dst.tolist())):
        if tt == 1:
            factor(src)
        else:
            update(i, src, dst)
    return lp[device_tables(plan, lp.device)["csc_gather"]], dext[: plan.n]


def panels_from_csc(plan, l_data: torch.Tensor) -> torch.Tensor:
    """The flat panel array (length P) from CSC-slot factor values; padded
    positions stay 0, which the solves rely on.  ``l_data`` may carry a
    leading member axis."""
    gather = device_tables(plan, l_data.device)["csc_gather"]
    out = torch.zeros(l_data.shape[:-1] + (plan.P,), dtype=l_data.dtype, device=l_data.device)
    out[..., gather] = l_data
    return out


def solve_supernodal(plan, panels: torch.Tensor, d: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x = (L D Lᵀ)⁻¹ b on the supernodal panels, one supernode per step.

    Each step is an in-block unit-triangular solve of the supernode's
    w×w corner plus one (rows−w)×w product for the below-row coupling,
    all through views at the plan's host offsets.  ``b`` is (n,) or
    (n, k); ``panels`` (P,) and ``d`` (n,) may carry a leading member
    axis N, and then ``b`` is (N, n), (N, n, k) or one shared (n,).
    Callers apply the fill-reducing permutation outside."""
    n, S, W = plan.n, plan.S, plan.W
    dtype = torch.promote_types(panels.dtype, b.dtype)
    batched = panels.ndim == 2
    pan = (panels if batched else panels[None]).to(dtype)
    dd = (d if batched else d[None]).to(dtype)
    N = pan.shape[0]
    if batched:
        vec = True
        x = b.to(dtype).expand(N, n)[..., None].clone()  # (N, n, 1)
    else:
        vec = b.ndim == 1
        x = b.to(dtype).reshape(n, -1)[None].clone()  # (1, n, k)
    bflat = device_tables(plan, panels.device)["below_flat"]
    off, c0, w, rows, bptr = plan.off, plan.c0, plan.w, plan.rows, plan.below_ptr

    def parts(s):
        o, ws, rs = int(off[s]), int(w[s]), int(rows[s])
        p = pan[:, o : o + rs * W].view(N, rs, W)
        ids = bflat[int(bptr[s]) : int(bptr[s]) + rs - ws]
        return p[:, :ws, :ws], p[:, ws:, :ws], ids, int(c0[s]), ws

    for s in range(S):
        blk, below, ids, c, ws = parts(s)
        sol = torch.linalg.solve_triangular(blk, x[:, c : c + ws], upper=False,
                                            unitriangular=True)
        x[:, c : c + ws] = sol
        if ids.numel():
            x.index_add_(1, ids, below @ sol, alpha=-1)
    x = x / dd[..., None]
    for s in range(S - 1, -1, -1):
        blk, below, ids, c, ws = parts(s)
        rhs = x[:, c : c + ws]
        if ids.numel():
            rhs = rhs - below.mT @ x[:, ids]
        x[:, c : c + ws] = torch.linalg.solve_triangular(blk.mT, rhs, upper=True,
                                                         unitriangular=True)
    if vec:
        x = x[..., 0]
    return x if batched else x[0]
