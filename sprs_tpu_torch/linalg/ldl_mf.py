"""Multifrontal-lite LDLᵀ numeric, the counterpart of
``sprs_tpu/linalg/ldl_mf.py``.

The left-looking supernodal numeric (``ldl_super``) applies one
(MR, W)·(W, W) update per (descendant, target) pair.  Here the
postordered supernode sequence is chunked into F contiguous *fronts* by
a work budget (any contiguous chunking is exact; subtree alignment
merely densifies the intra-front overlap):

* updates between supernodes of the same front use the per-pair
  schedule;
* a front's contribution to all later columns is one dense Schur
  product: with R_f the front's distinct below rows at or beyond its
  column end, B = L[R_f, cols_f] gathered from the factored panels and
  U = (B·D_f)·Bᵀ, scatter-subtracted once into the later panels.

All aggregate tables are window-granular (AW-wide contiguous windows,
AW | W, so a window never crosses a panel row): B's windows are gathered
and U's scattered as rows of the (len/AW, AW) view of the flat panel
array.  A miss (a row outside a member's structure) reads the zero
scratch past P; a patternless target window gets lim 0 and the P
sentinel, its values exact zeros.

The plan is host numpy, the same integers as the JAX package's; the
numeric runs one task at a time as plain torch on the operand's device,
the aggregates through :func:`make_agg_phase`, which the level-batched
numeric shares.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .ldl_super import (
    SupernodalPlanError,
    _build_prelude,
    _pair_rmap,
    _panel_kernels,
    _task_order,
    assemble,
    device_tables,
)


@dataclasses.dataclass(frozen=True, eq=False)
class MfPlan:
    """Static multifrontal-lite schedule (host-precomputed).

    Field layout mirrors ``SuperPlan`` (so ``solve_supernodal`` works on
    either), plus the window-granular front-aggregation maps.  Task
    types: 0 = pair update, 1 = panel factor, 2 = front aggregate
    (``t_src`` is the bucket, ``t_dst`` the slot in the bucket).
    """

    n: int
    S: int
    W: int
    MR: int
    P: int
    F: int  # number of fronts
    RF: int  # max |R_f| over fronts (diagnostic)
    AW: int  # aggregate window width (divides W)
    c0: np.ndarray
    w: np.ndarray
    rows: np.ndarray
    off: np.ndarray
    asm_src: np.ndarray
    asm_dst: np.ndarray
    t_type: np.ndarray
    t_src: np.ndarray  # update: descendant; factor: snode; agg: bucket
    t_dst: np.ndarray  # update/factor: target snode; agg: slot in bucket
    t_rmap: np.ndarray  # (T, MR), sentinel MR
    csc_gather: np.ndarray
    below_ptr: np.ndarray
    below_flat: np.ndarray
    # fronts are bucketed by padded row count; one int32 entry per
    # AW-wide window
    mem_start: tuple  # per bucket: (F_b, RFb, NMb) B window starts, sent P
    memd_start: tuple  # per bucket: (F_b, NMb) D window starts, sent n
    tgt_start: tuple  # per bucket: (F_b, RFb, NTb) scatter starts, sent P
    tgt_lim: tuple  # per bucket: (F_b, RFb, NTb) valid lanes (0 = dead)
    colmap: tuple  # per bucket: (F_b, NTb, AW) U column index, sent RFb

    @property
    def n_tasks(self) -> int:
        return self.t_type.shape[0]

    @property
    def agg_table_elems(self) -> int:
        """Entries of the front-aggregation tables (diagnostic)."""
        return sum(
            sum(t.size for t in tab)
            for tab in (self.mem_start, self.memd_start, self.tgt_start, self.tgt_lim,
                        self.colmap)
        )


def _partition_fronts(pre, parent_col, max_front_cols: int, max_front_rows: int):
    """Subtree-aligned front partition.

    A front that is a COMPLETE subtree of the supernodal etree has
    R_f ⊆ below(root) (every member's below row beyond the subtree
    propagates along the etree path through the root — the classic
    multifrontal update-matrix containment), so subtree fronts keep
    both |R_f| and the intra-front pair count small: measured at the
    262k-row camd Laplacian, subtree cuts collapse intra pairs from
    141k (arbitrary greedy chunks: 71-89k) to ~5.4k.

    Partition: (1) maximal subtrees whose column count fits the budget
    become fronts; (2) the leftover supernodes (ancestors whose
    subtrees exceed the budget) are greedily merged into contiguous
    runs under the column budget and a distinct-below-row estimate —
    in postorder a parent directly follows its last child, so ancestor
    chains are contiguous and merge well.  Any contiguous partition is
    exact (module docstring); alignment is purely an efficiency knob.
    """
    S, n = pre.S, pre.n
    w, bp, bf, of = pre.w, pre.below_ptr, pre.below_flat, pre.of
    c1 = pre.c1
    # supernodal etree: parent(s) = owner of the column-etree parent of
    # s's last column (> s for non-roots; postorder makes subtrees
    # contiguous intervals [dmin[s], s])
    pc = parent_col[c1 - 1]
    par_sn = np.where(pc >= 0, of[np.clip(pc, 0, n - 1)], -1)
    cols_sub = w.astype(np.int64).copy()
    dmin = np.arange(S, dtype=np.int64)
    for s in range(S):
        p = par_sn[s]
        if p >= 0:
            cols_sub[p] += cols_sub[s]
            if dmin[s] < dmin[p]:
                dmin[p] = dmin[s]
    # a complete-subtree front has R_f ⊆ below(root), so the root's
    # below count is the exact row bound for the rows budget
    counts = np.diff(bp)
    fits = (cols_sub <= max_front_cols) & (counts <= max_front_rows)
    pfit = np.ones(S, dtype=bool)
    ok_par = par_sn >= 0
    pfit[ok_par] = ~fits[par_sn[ok_par]]
    is_root = fits & pfit
    starts = {int(dmin[r]): int(r) + 1 for r in np.nonzero(is_root)[0]}

    fb = [0]
    mark = np.full(n, -1, dtype=np.int64)
    cur_cols = 0
    cur_rows = 0
    fid = 0
    pos = 0
    while pos < S:
        if pos in starts:
            # complete-subtree front
            if fb[-1] != pos:
                fb.append(pos)
                fid += 1
            pos = starts[pos]
            fb.append(pos)
            fid += 1
            cur_cols = 0
            cur_rows = 0
            continue
        # leftover supernode: greedy merge into the running front
        seg = bf[bp[pos] : bp[pos + 1]]
        new = int(np.count_nonzero(mark[seg] != fid))
        if pos > fb[-1] and (
            cur_cols + int(w[pos]) > max_front_cols
            or cur_rows + new > max_front_rows
        ):
            fb.append(pos)
            fid += 1
            new = seg.shape[0]
            cur_cols = 0
            cur_rows = 0
        mark[seg] = fid
        cur_cols += int(w[pos])
        cur_rows += new
        pos += 1
    if fb[-1] != S:
        fb.append(S)
    return np.asarray(fb, dtype=np.int64)


def _pick_aw(W: int, agg_window: int) -> int:
    """Largest divisor of W that is <= agg_window (W is a multiple of
    8, so 8 always qualifies)."""
    for cand in (128, 64, 32, 16, 8):
        if cand <= agg_window and W % cand == 0:
            return cand
    return 8 if W % 8 == 0 else W


def build_mf_plan(
    sym,
    *,
    max_width: int = 128,
    max_zeros: int = 32,
    rel_zeros: float = 0.65,
    max_front_cols: int = 512,
    max_front_rows: int = 4096,
    panel_limit: int = 1 << 28,
    map_limit: int = 1 << 27,
    agg_limit: int = 1 << 28,
    align: str = "subtree",
    agg_window: int = 128,
    buckets: str = "fine",
) -> MfPlan:
    """Build the multifrontal-lite schedule from an ``LdlSymbolic``.

    ``agg_limit`` bounds the combined window-table elements;
    ``map_limit`` bounds the intra-front (T, MR) pair table as in
    ``build_super_plan``; ``align='subtree'`` cuts supernodes along
    complete etree subtrees (short batched critical path — see
    ``supernodes.amalgamate_subtree``); ``agg_window`` is the target
    aggregate window width (rounded down to a divisor of W); the
    defaults are the JAX package's, so both build the same plan.
    """
    pre = _build_prelude(
        sym,
        max_width=max_width,
        max_zeros=max_zeros,
        rel_zeros=rel_zeros,
        panel_limit=panel_limit,
        align=align,
    )
    n, S, W, MR, P = pre.n, pre.S, pre.W, pre.MR, pre.P
    of, c0, c1, w = pre.of, pre.c0, pre.c1, pre.w
    bp, bf = pre.below_ptr, pre.below_flat
    AW = _pick_aw(W, agg_window)

    fb = _partition_fronts(
        pre, np.asarray(sym.parent), max_front_cols, max_front_rows
    )
    F = fb.shape[0] - 1
    front_of = np.repeat(np.arange(F, dtype=np.int64), np.diff(fb))

    # --- intra-front pairs (cross-front updates ride the aggregates) ---
    keep = front_of[pre.pair_d] == front_of[pre.pair_t]
    pair_d = pre.pair_d[keep]
    pair_t = pre.pair_t[keep]
    npairs = pair_d.shape[0]

    # --- per-front distinct below rows at/beyond the front's column
    # end, vectorized: one global unique over (front, row) keys ---------
    f_colend = c1[fb[1:] - 1]
    owner_front = front_of[pre.below_owner]
    uk = np.unique(owner_front * np.int64(n) + bf)
    fid_u = uk // n
    row_u = uk % n
    keep_u = row_u >= f_colend[fid_u]
    fid_r = fid_u[keep_u]
    rows_cat = row_u[keep_u]  # per-front ascending (key order)
    nr_arr = np.bincount(fid_r, minlength=F)
    fptr = np.zeros(F + 1, dtype=np.int64)
    np.cumsum(nr_arr, out=fptr[1:])
    RF = int(nr_arr.max()) if F else 0

    # --- member column-chunks (AW-wide, per supernode, grouped by
    # front since supernodes are contiguous per front) -------------------
    nch_s = -(-w // AW)  # >= 1
    mc_s = np.repeat(np.arange(S, dtype=np.int64), nch_s)
    ch_ptr = np.zeros(S + 1, dtype=np.int64)
    np.cumsum(nch_s, out=ch_ptr[1:])
    mc_k = np.arange(mc_s.shape[0], dtype=np.int64) - ch_ptr[mc_s]
    mc_front = front_of[mc_s]
    nm_arr = np.bincount(mc_front, minlength=F)
    mptr = np.zeros(F + 1, dtype=np.int64)
    np.cumsum(nm_arr, out=mptr[1:])

    # --- target runs: rows_cat grouped by owner supernode.  Chunk
    # bases snap to the owner's c0[t] + k*AW grid so every scatter
    # window start (off[t] + rslot*W + k*AW) is AW-ALIGNED — the
    # numeric then runs gathers/scatters as row ops on an (len/AW, AW)
    # 2-D view (costs at most one extra chunk per run vs span-anchored
    # bases). ----------------------------------------------------------
    owner_r = of[rows_cat]
    nrows_tot = rows_cat.shape[0]
    if nrows_tot:
        new = np.ones(nrows_tot, dtype=bool)
        new[1:] = (owner_r[1:] != owner_r[:-1]) | (fid_r[1:] != fid_r[:-1])
        run_id = np.cumsum(new) - 1
        run_start = np.nonzero(new)[0]
        nruns = run_start.shape[0]
        run_len = np.diff(np.append(run_start, nrows_tot))
        run_fid = fid_r[run_start]
        run_t = owner_r[run_start]
        run_clo = rows_cat[run_start]
        run_chi = rows_cat[run_start + run_len - 1]
        run_k0 = (run_clo - c0[run_t]) // AW
        run_k1 = (run_chi - c0[run_t]) // AW
        nch_run = run_k1 - run_k0 + 1
        run_ch0 = np.zeros(nruns + 1, dtype=np.int64)
        np.cumsum(nch_run, out=run_ch0[1:])
        tc_run = np.repeat(np.arange(nruns, dtype=np.int64), nch_run)
        tc_k = np.arange(tc_run.shape[0], dtype=np.int64) - run_ch0[tc_run]
        tc_fid = run_fid[tc_run]
        tc_t = run_t[tc_run]
        tc_cbase = c0[run_t[tc_run]] + (run_k0[tc_run] + tc_k) * AW
        nt_arr = np.bincount(tc_fid, minlength=F)
    else:
        run_id = np.zeros(0, dtype=np.int64)
        run_ch0 = np.zeros(1, dtype=np.int64)
        run_k0 = np.zeros(0, dtype=np.int64)
        run_t = np.zeros(0, dtype=np.int64)
        tc_t = tc_cbase = np.zeros(0, dtype=np.int64)
        nt_arr = np.zeros(F, dtype=np.int64)
    tptr = np.zeros(F + 1, dtype=np.int64)
    np.cumsum(nt_arr, out=tptr[1:])

    # --- bucket fronts by padded row count.  'fine' (8/16/32, then
    # 64-steps) minimizes row padding; 'coarse' (4 pow-4 sizes) trades
    # padding volume for FEWER per-round phases — each bucket is one
    # phase in the level-batched numeric, and with the aligned row-op
    # aggregate the phase FIXED cost rivals its traffic. -----------------
    emit = nr_arr > 0
    if buckets == "coarse":
        bsz = np.where(
            nr_arr <= 64,
            64,
            np.where(
                nr_arr <= 512,
                512,
                np.where(nr_arr <= 2048, 2048, -(-nr_arr // 4096) * 4096),
            ),
        ).astype(np.int64)
    else:
        bsz = np.where(
            nr_arr <= 8,
            8,
            np.where(
                nr_arr <= 16,
                16,
                np.where(nr_arr <= 32, 32, -(-nr_arr // 64) * 64),
            ),
        ).astype(np.int64)
    bucket_sizes = sorted(set(int(b) for b in bsz[emit]))
    nb = len(bucket_sizes)
    fr_bucket = np.full(F, -1, dtype=np.int64)
    fr_slot = np.zeros(F, dtype=np.int64)
    NM_b = np.zeros(nb, dtype=np.int64)
    NT_b = np.zeros(nb, dtype=np.int64)
    fcnt = []
    for bi, b in enumerate(bucket_sizes):
        in_b = emit & (bsz == b)
        fr_bucket[in_b] = bi
        fr_slot[in_b] = np.arange(int(in_b.sum()))
        fcnt.append(int(in_b.sum()))
        NM_b[bi] = int(nm_arr[in_b].max()) if in_b.any() else 0
        NT_b[bi] = int(nt_arr[in_b].max()) if in_b.any() else 0
    total_tab = sum(
        fcnt[bi]
        * (
            bucket_sizes[bi] * NM_b[bi]  # mem_start
            + NM_b[bi]  # memd_start
            + 2 * bucket_sizes[bi] * NT_b[bi]  # tgt_start + tgt_lim
            + NT_b[bi] * AW  # colmap
        )
        for bi in range(nb)
    )
    if total_tab > agg_limit:
        raise SupernodalPlanError(
            f"aggregation tables ({total_tab} elements) exceed limit "
            f"{agg_limit}; raise the front budgets or the limit"
        )
    T = npairs + S + int(emit.sum())
    if T * MR > map_limit:
        raise SupernodalPlanError(
            f"row-map table {T}x{MR} exceeds limit {map_limit}"
        )
    rmap = _pair_rmap(pre, pair_d, pair_t)

    off64 = pre.off
    ef = np.nonzero(emit)[0]

    def _grid_queries(sizes_i, sizes_j):
        """Flat (front, i, j) enumeration over per-front grids."""
        g = sizes_i[ef] * sizes_j[ef]
        fid_q = np.repeat(ef, g)
        gptr = np.zeros(ef.shape[0] + 1, dtype=np.int64)
        np.cumsum(g, out=gptr[1:])
        q = np.arange(gptr[-1], dtype=np.int64) - np.repeat(gptr[:-1], g)
        i = q // sizes_j[fid_q]
        j = q % sizes_j[fid_q]
        return fid_q, i, j

    mem_start = [
        np.full((fcnt[bi], bucket_sizes[bi], NM_b[bi]), P, dtype=np.int32)
        for bi in range(nb)
    ]
    memd_start = [
        np.full((fcnt[bi], NM_b[bi]), n, dtype=np.int32) for bi in range(nb)
    ]
    tgt_start = [
        np.full((fcnt[bi], bucket_sizes[bi], NT_b[bi]), P, dtype=np.int32)
        for bi in range(nb)
    ]
    tgt_lim = [
        np.zeros((fcnt[bi], bucket_sizes[bi], NT_b[bi]), dtype=np.int32)
        for bi in range(nb)
    ]
    colmap = [
        np.full(
            (fcnt[bi], NT_b[bi], AW), bucket_sizes[bi], dtype=np.int32
        )
        for bi in range(nb)
    ]
    if ef.size:
        # ---- B window starts: (row i, member chunk m) ------------------
        # every R_f row is at/beyond the front's column end, hence at or
        # beyond every member's c1 — membership is below-structure only;
        # misses gather the zero-scratch sentinel (structural zeros).
        fid_q, i_q, m_q = _grid_queries(nr_arr, nm_arr)
        r_q = rows_cat[fptr[fid_q] + i_q]
        ch = mptr[fid_q] + m_q
        s_q = mc_s[ch]
        slot, found = pre.member_slot(s_q, r_q)
        pos = np.where(
            found, off64[s_q] + slot * W + mc_k[ch] * AW, P
        )
        for bi in range(nb):
            m = fr_bucket[fid_q] == bi
            RFb, NMb = bucket_sizes[bi], int(NM_b[bi])
            flat = mem_start[bi].reshape(-1)
            flat[
                fr_slot[fid_q[m]] * (RFb * NMb) + i_q[m] * NMb + m_q[m]
            ] = pos[m]

        # ---- D window starts: (member chunk m) -------------------------
        # pad columns beyond w_s multiply exact-zero B entries, so the D
        # window needs no masking; sentinel n reads dext's zero tail.
        ch_all = np.arange(mc_s.shape[0], dtype=np.int64)
        m_of_ch = ch_all - mptr[mc_front]
        dpos = c0[mc_s] + mc_k * AW
        for bi in range(nb):
            m = (fr_bucket[mc_front] == bi) & emit[mc_front]
            NMb = int(NM_b[bi])
            flat = memd_start[bi].reshape(-1)
            flat[fr_slot[mc_front[m]] * NMb + m_of_ch[m]] = dpos[m]

        # ---- colmap: in-window position -> U column index --------------
        if nrows_tot:
            base0 = c0[run_t] + run_k0 * AW  # first chunk base per run
            off_in_run = rows_cat - base0[run_id]
            tc_global = run_ch0[run_id] + off_in_run // AW
            posw = off_in_run % AW
            m_local = tc_global - tptr[fid_r]
            j_local = np.arange(nrows_tot, dtype=np.int64) - fptr[fid_r]
            for bi in range(nb):
                m = fr_bucket[fid_r] == bi
                NTb = int(NT_b[bi])
                flat = colmap[bi].reshape(-1)
                flat[
                    fr_slot[fid_r[m]] * (NTb * AW)
                    + m_local[m] * AW
                    + posw[m]
                ] = j_local[m]

        # ---- scatter window starts + triangle/validity limits ----------
        # target positions: L[r_i, c] for run columns c in the panel of
        # t = of[c]; rows within t's diagonal block use rslot = r_i - c0,
        # below rows use the membership slot.  Patternless (r_i, t)
        # pairs get lim 0 (their U values are exact zeros — see module
        # docstring) and the P sentinel.
        fid_q, i_q, m_q = _grid_queries(nr_arr, nt_arr)
        r_q = rows_cat[fptr[fid_q] + i_q]
        tcq = tptr[fid_q] + m_q
        t_q = tc_t[tcq]
        cb = tc_cbase[tcq]
        in_diag = (r_q >= c0[t_q]) & (r_q < c1[t_q])
        slot, found = pre.member_slot(t_q, r_q)
        rslot = np.where(in_diag, r_q - c0[t_q], slot)
        lim = np.where(
            in_diag,
            np.clip(r_q - cb + 1, 0, AW),
            np.where(found & (r_q >= c1[t_q]), AW, 0),
        )
        pos = np.where(
            lim > 0, off64[t_q] + rslot * W + (cb - c0[t_q]), P
        )
        for bi in range(nb):
            m = fr_bucket[fid_q] == bi
            RFb, NTb = bucket_sizes[bi], int(NT_b[bi])
            flatp = tgt_start[bi].reshape(-1)
            flatl = tgt_lim[bi].reshape(-1)
            idx = fr_slot[fid_q[m]] * (RFb * NTb) + i_q[m] * NTb + m_q[m]
            flatp[idx] = pos[m]
            flatl[idx] = lim[m]

    # --- task schedule: per front, per target (updates then factor),
    # then the front's aggregate (skipped when R_f is empty) -------------
    upd_cnt = (
        np.bincount(pair_t, minlength=S) if npairs else np.zeros(S, np.int64)
    )
    base_ptr = np.zeros(S + 1, dtype=np.int64)
    np.cumsum(upd_cnt + 1, out=base_ptr[1:])
    pre_agg = np.zeros(F + 1, dtype=np.int64)
    np.cumsum(emit, out=pre_agg[1:])
    shift = pre_agg[front_of]  # aggregates of earlier fronts
    t_type = np.zeros(T, dtype=np.int32)
    t_src = np.zeros(T, dtype=np.int64)
    t_dst = np.zeros(T, dtype=np.int64)
    t_rmap = np.full((T, MR), MR, dtype=np.int32)
    if npairs:
        upd_idx, order = _task_order(S, pair_d, pair_t, base_ptr[:-1] + shift)
        t_src[upd_idx] = pair_d[order]
        t_dst[upd_idx] = pair_t[order]
        t_rmap[upd_idx] = rmap[order]
    sArr = np.arange(S, dtype=np.int64)
    fact_idx = base_ptr[1:] - 1 + shift
    t_type[fact_idx] = 1
    t_src[fact_idx] = sArr
    t_dst[fact_idx] = sArr
    agg_idx = base_ptr[fb[1:][emit]] + pre_agg[:-1][emit]
    t_type[agg_idx] = 2
    t_src[agg_idx] = fr_bucket[emit]
    t_dst[agg_idx] = fr_slot[emit]

    return MfPlan(
        n=n,
        S=S,
        W=W,
        MR=MR,
        P=P,
        F=F,
        RF=RF,
        AW=AW,
        c0=c0.astype(np.int32),
        w=w.astype(np.int32),
        rows=pre.rows.astype(np.int32),
        off=off64[:-1].astype(np.int32),
        asm_src=pre.asm_src.astype(np.int32),
        asm_dst=pre.asm_dst.astype(np.int32),
        t_type=t_type,
        t_src=t_src.astype(np.int32),
        t_dst=t_dst.astype(np.int32),
        t_rmap=t_rmap,
        csc_gather=pre.csc_gather.astype(np.int32),
        below_ptr=bp.astype(np.int32),
        below_flat=np.concatenate(
            [bf, np.full(MR, n, dtype=np.int64)]
        ).astype(np.int32),
        mem_start=tuple(mem_start),
        memd_start=tuple(memd_start),
        tgt_start=tuple(tgt_start),
        tgt_lim=tuple(tgt_lim),
        colmap=tuple(colmap),
    )


def make_agg_phase(plan, bi: int, device):
    """The bucket-``bi`` aggregate as a batched phase
    ``(Lp, dext, slots) -> None`` over live slot lanes, in place on
    ``Lp`` (N, len) and ``dext`` (N, n + W).  Every window start is
    AW-aligned, so the B gather and the U scatter are row ops on the
    (len/AW, AW) view; masked lanes add exact zeros, so overlapping
    windows are harmless.  The bucket's tables reach ``device`` once and
    stay cached with the plan's."""
    AW = plan.AW
    tabs = device_tables(plan, device)
    key = f"agg{bi}"
    if key not in tabs:
        t = lambda a: torch.from_numpy(np.asarray(a, dtype=np.int64)).to(device)  # noqa: E731
        tabs[key] = (t(plan.mem_start[bi] // AW), t(plan.memd_start[bi]),
                     t(plan.tgt_start[bi] // AW), t(plan.tgt_lim[bi]), t(plan.colmap[bi]))
    ms_r, md_t, ts_r, lm_t, cm_t = tabs[key]
    RFb, NMb = ms_r.shape[1], ms_r.shape[2]
    NTb = ts_r.shape[2]
    K = NMb * AW
    pos = torch.arange(AW, device=device)

    def phase(lp, dext, sl):
        N = lp.shape[0]
        Ba = sl.shape[0]
        lp2 = lp.view(-1, AW)
        mrow = (torch.arange(N, device=device) * (lp.shape[1] // AW)).view(N, 1, 1, 1)
        mdx = (torch.arange(N, device=device) * dext.shape[1]).view(N, 1, 1, 1)
        b = lp2[mrow + ms_r[sl][None]]  # (N, Ba, RFb, NMb, AW)
        dv = dext.view(-1)[mdx + (md_t[sl][:, :, None] + pos)[None]]  # (N, Ba, NMb, AW)
        bd = (b * dv[:, :, None]).reshape(N * Ba, RFb, K)
        # U's columns in scatter-window order: gather B's rows into window
        # order, so the product emits the window tensor directly
        cm = cm_t[sl]  # (Ba, NTb, AW), sentinel RFb
        lane = torch.arange(Ba, device=device)[:, None]
        bw = b.view(N, Ba, RFb, K)[:, lane, cm.clamp(max=RFb - 1).reshape(Ba, NTb * AW)]
        uw = (bd @ bw.reshape(N * Ba, NTb * AW, K).mT).view(N, Ba, RFb, NTb, AW)
        keep = (cm < RFb)[:, None] & (pos < lm_t[sl][..., None])  # (Ba, RFb, NTb, AW)
        upd = torch.where(keep[None], uw, 0)
        lp2.index_put_(((mrow + ts_r[sl][None]).reshape(-1),), upd.neg_().reshape(-1, AW),
                       accumulate=True)

    return phase


def numeric_multifrontal(plan: MfPlan, data: torch.Tensor):
    """The multifrontal-lite numeric on ``data``'s device: ``(l_data, d)``
    in the CSC-slot layout of ``numeric_supernodal``, one task at a time
    in the plan's order.  A zero pivot NaN-poisons the outputs instead of
    raising."""
    lp, dext = assemble(plan, data)
    update, factor = _panel_kernels(plan, lp, dext)
    aggs = [make_agg_phase(plan, bi, lp.device) for bi in range(len(plan.mem_start))]
    slots = [torch.arange(m.shape[0], device=lp.device) for m in plan.mem_start]
    for i, (tt, src, dst) in enumerate(zip(plan.t_type.tolist(), plan.t_src.tolist(),
                                           plan.t_dst.tolist())):
        if tt == 0:
            update(i, src, dst)
        elif tt == 1:
            factor(src)
        else:
            aggs[src](lp[None], dext[None], slots[src][dst : dst + 1])
    return lp[device_tables(plan, lp.device)["csc_gather"]], dext[: plan.n]
