"""Level-batched LDLᵀ numeric and round-batched panel solves, the
counterpart of ``sprs_tpu/linalg/ldl_batched.py``.

The supernodal (``ldl_super``) and multifrontal-lite (``ldl_mf``)
numerics run one task per step.  This module batches the same tasks
into *rounds* of provably independent work:

* **Rounds** come from longest-path scheduling on the task DAG.  Each
  round has three phase families, applied in order: pair updates, front
  aggregates, panel factors.  A pair update d→t needs factor(d) in a
  strictly earlier round; a factor of s needs every write into s in the
  same round or earlier; a front aggregate needs its member factors
  strictly earlier.  Width caps (``bu``, ``bf``, ``ba``) split over-wide
  levels across consecutive rounds.
* **Batched phases**: panel offsets are multiples of W, so a lane's panel
  rows are row gathers on the (len/W, W) view of the flat panel array;
  the Schur products are batched (B, MR_c, W) × (B, W, W) matmuls; the
  factor's W-step inner loop runs once per round and row class on
  (B, W, W) tiles.  Update and factor lanes are split into pow2-ladder
  row classes, so padding pays per class.
* **Commutative writes**: every panel write is a delta added over a
  window by an accumulating ``index_put_`` (ordered sums on the card,
  not atomics, so a factor repeats bit for bit).  The factor's write is
  ``new − old`` masked to its live rows, exactly 0 on overhang rows, so
  overlapping windows of adjacent panels cannot clobber each other.

The schedule's lane counts are host numpy: a round runs only its
non-empty phases, on its live lanes only (no padding lane reaches the
card), and the factor's inner loop stops at the widest live supernode of
the phase — exact, since a masked column is e_j with a unit pivot.  The
layout keeps the JAX package's zero scratch: [0, P) panels, then
[P, P+MR·W) zeros, the sentinel supernode S's window and the target of
the aggregates' masked zero adds.

A leading member axis (N same-pattern value sets, the batch API) runs as
N·B lanes of one phase: member i's panels start i·(P+MR·W) into one flat
array, so its rows are the shared row indices plus a member offset.

Exactness: the per-lane arithmetic is the sequential kernels'; only the
summation order of commutative adds changes.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .ldl_super import assemble, device_tables


def blocked_ldl_top(top, live_col, *, nbf: int = 8, n_live=None):
    """Blocked right-looking LDL of batched (B, W, W) top blocks.

    Pivots advance through ``nbf``-wide strips (cheap rank-1 mini-steps
    on a (B, W, nbf) strip) and each strip pushes one rank-``nbf``
    trailing update as a batched matmul.  Masked (non-live) columns are
    e_j with unit pivots and never receive updates: a masked pivot
    drifting to 0 would spray inf·0 = NaN into real columns.  Columns at
    or past ``n_live`` (a host int, at least every lane's live width) are
    masked in every lane, so the loop stops there with the same result.

    Returns ``(factored_top, dvec)``: column j replaced by its unit-lower
    column (zeros above the diagonal), dvec the pivots (1 on masked
    columns).
    """
    nB, W, _ = top.shape
    dev, dtype = top.device, top.dtype
    n_live = W if n_live is None else min(int(n_live), W)
    cols = torch.arange(W, device=dev)
    gt = cols[None, :] > cols[:, None]  # gt[j, c]: c > j
    live_gt = gt[None] & live_col[:, None, :]  # (B, j, c)
    eye = torch.eye(W, dtype=dtype, device=dev)
    M = top.clone()
    dv = torch.ones((nB, W), dtype=dtype, device=dev)
    for kb in range(0, n_live, nbf):
        nb = min(nbf, n_live - kb)
        strip = M[:, :, kb : kb + nb]
        lcols, rowvs, djs = [], [], []
        for jj in range(nb):
            j = kb + jj
            colv = strip[:, :, jj]
            dj = colv[:, j : j + 1]  # the step never changes its own column
            lcol = torch.where(gt[j], colv / dj, eye[j])
            rowv = torch.where(live_gt[:, j], colv, 0)
            strip.addcmul_(lcol[:, :, None], rowv[:, None, kb : kb + nb], value=-1)
            lcols.append(lcol)
            rowvs.append(rowv)
            djs.append(dj)
        dv[:, kb : kb + nb] = torch.cat(djs, 1)
        lb = torch.stack(lcols, 2)
        M[:, :, kb : kb + nb] = lb
        if kb + nb < n_live:
            cb = torch.stack(rowvs, 2)[:, kb + nb : n_live]
            M[:, :, kb + nb : n_live] -= lb @ cb.mT
    return M, dv


@dataclasses.dataclass(frozen=True, eq=False)
class RoundSchedule:
    """Host-built batched round schedule for a ``SuperPlan``/``MfPlan``.

    Update and factor lanes are split into row classes: class c runs its
    tasks at a (MR_c, W) shape (pow2-ladder sizes; rows beyond the
    target's live rows carry exact-zero updates)."""

    R: int  # rounds
    upd_mr: tuple  # per class: padded row count MR_c
    fac_mr: tuple
    # updates per class: supernode ids (sentinel S) + row into t_rmap
    upd_src: tuple  # per class (R, Bu_c)
    upd_dst: tuple
    upd_tix: tuple  # (sentinel row = all-MR)
    upd_cnt: tuple  # per class (R,)
    # factors per class: supernode ids (sentinel S)
    fac_s: tuple  # per class (R, Bf_c)
    fac_cnt: tuple
    # aggregates (MfPlan only): per bucket, slot ids (sentinel -1)
    agg_slots: tuple  # per bucket (R, Ba_b)
    agg_cnt: tuple  # per bucket (R,)

    @property
    def n_rounds(self) -> int:
        return self.R

    @property
    def Bu(self) -> int:
        """Update lanes per round over all row classes (diagnostic)."""
        return sum(int(a.shape[1]) for a in self.upd_src)

    @property
    def Bf(self) -> int:
        """Factor lanes per round over all row classes (diagnostic)."""
        return sum(int(a.shape[1]) for a in self.fac_s)


class _Packer:
    """First-fit capacity packer: ``place(e)`` returns the first round
    >= e with a free lane.  ``jump[r]`` points at the first possibly-free
    round >= r (path-halved on traversal), so placement is near O(1)
    amortized; backfilling keeps dependents' earliest rounds low."""

    def __init__(self, cap: int):
        self.cap = cap
        self.count: list = []
        self.jump: list = []

    def place(self, earliest: int) -> int:
        count, jump, cap = self.count, self.jump, self.cap
        if earliest >= len(count):
            count.extend(0 for _ in range(earliest + 1 - len(count)))
            jump.extend(range(len(jump), earliest + 1))
        r = earliest
        while True:
            nxt = jump[r]
            if nxt == r:
                if count[r] < cap:
                    break
                if r + 1 >= len(count):
                    count.append(0)
                    jump.append(r + 1)
                jump[r] = r + 1
                r = r + 1
            else:
                if nxt < len(jump):
                    jump[r] = jump[nxt]
                r = nxt
                if r >= len(count):
                    count.extend(0 for _ in range(r + 1 - len(count)))
                    jump.extend(range(len(jump), r + 1))
        count[r] += 1
        if count[r] >= cap:
            if r + 1 >= len(count):
                count.append(0)
                jump.append(r + 1)
            jump[r] = r + 1
        return r


def _table_owners(table: np.ndarray, off_bounds: np.ndarray, sent: int):
    """Per-slot unique owner supernodes of a (F_b, RFb, X) position
    table: (slot_ptr, owners_flat), CSR-style ragged lists."""
    nslot = table.shape[0]
    pos = table.reshape(nslot, -1).astype(np.int64)
    S = off_bounds.shape[0] - 1
    own = np.searchsorted(off_bounds, pos.ravel(), side="right") - 1
    own = own.reshape(nslot, -1)
    valid = pos != sent
    slot_id = np.broadcast_to(np.arange(nslot, dtype=np.int64)[:, None], pos.shape)
    key = np.unique(slot_id[valid] * np.int64(S + 1) + own[valid])
    slots = key // (S + 1)
    owners = key % (S + 1)
    ptr = np.zeros(nslot + 1, dtype=np.int64)
    np.add.at(ptr, slots + 1, 1)
    np.cumsum(ptr, out=ptr)
    return ptr, owners


def build_round_schedule(plan, *, bu: int = None, bf: int = None, ba=None,
                         agg_lane_budget: int = 256 << 20, max_classes: int = 4) -> RoundSchedule:
    """Pack a plan's task stream into batched rounds (host).

    Works for ``SuperPlan`` (task types 0/1) and ``MfPlan`` (adds type 2
    aggregates).  The stream order is topological, so one forward pass
    assigns rounds by longest path and capacity.  Lane widths default to
    128 below 10,000 tasks and 64 above (the JAX package's rule); unused
    lanes are trimmed to the widest round.
    """
    if bu is None or bf is None:
        wide = np.asarray(plan.t_type).shape[0] < 10_000
        if bu is None:
            bu = 128 if wide else 64
        if bf is None:
            bf = 128 if wide else 64
    t_type = np.asarray(plan.t_type)
    t_src = np.asarray(plan.t_src, dtype=np.int64)
    t_dst = np.asarray(plan.t_dst, dtype=np.int64)
    T = t_type.shape[0]
    S = plan.S
    P = plan.P
    mem_tabs = getattr(plan, "mem_start", ())
    nb = len(mem_tabs)
    off_bounds = np.concatenate([np.asarray(plan.off, dtype=np.int64), [np.int64(P)]])

    # per-(bucket, slot) member/target supernode lists for aggregates,
    # recovered from the window start positions
    mem = [_table_owners(np.asarray(b), off_bounds, P) for b in mem_tabs]
    tgt = [_table_owners(np.asarray(a), off_bounds, P) for a in getattr(plan, "tgt_start", ())]

    # per-bucket aggregate lane width, fitted to a byte budget unless the
    # caller pins ``ba``
    AW = getattr(plan, "AW", 0)
    ba_list = []
    for b in mem_tabs:
        RFb, NMb = b.shape[1], b.shape[2]
        if isinstance(ba, int):
            ba_list.append(ba)
            continue
        NTb = getattr(plan, "tgt_start")[len(ba_list)].shape[2]
        lane_bytes = 4 * (RFb * RFb + RFb * (NMb + 2 * NTb) * AW + RFb * NMb * AW)
        ba_list.append(int(np.clip(agg_lane_budget // max(lane_bytes, 1), 1, 16)))

    # row classes: pow2 ladder of padded panel heights; an update's class
    # is rows[dst] (it writes target slots), a factor's rows[s]
    rows_arr = np.asarray(plan.rows, dtype=np.int64)
    W = plan.W
    MR = plan.MR
    sizes = []
    s_ = W
    while s_ < MR:
        sizes.append(s_)
        s_ *= 2
    sizes.append(MR)
    sizes = np.asarray(sorted(set(sizes)), dtype=np.int64)
    if max_classes is not None and sizes.shape[0] > max_classes:
        # merge the cheapest class upward until the count fits
        while sizes.shape[0] > max_classes:
            counts = np.bincount(np.searchsorted(sizes, rows_arr), minlength=sizes.shape[0])
            added = counts[:-1] * np.diff(sizes)
            sizes = np.delete(sizes, int(np.argmin(added)))
    cls_of_sn = np.searchsorted(sizes, rows_arr)
    nc = sizes.shape[0]

    fac_round = np.full(S, -1, dtype=np.int64)
    last_write = np.zeros(S, dtype=np.int64)
    pk_u = [_Packer(bu) for _ in range(nc)]
    pk_f = [_Packer(bf) for _ in range(nc)]
    pk_a = [_Packer(ba_list[bi]) for bi in range(nb)]

    # the all-MR sentinel rmap row: any factor task's row (never filled)
    fac_rows = np.nonzero(t_type == 1)[0]
    sent_tix = int(fac_rows[0]) if fac_rows.size else 0

    u_r = [[] for _ in range(nc)]
    u_src = [[] for _ in range(nc)]
    u_dst = [[] for _ in range(nc)]
    u_tix = [[] for _ in range(nc)]
    f_r = [[] for _ in range(nc)]
    f_s = [[] for _ in range(nc)]
    a_r = [[] for _ in range(nb)]
    a_slot = [[] for _ in range(nb)]

    for i in range(T):
        tt = int(t_type[i])
        if tt == 0:
            src = int(t_src[i])
            dst = int(t_dst[i])
            c = int(cls_of_sn[dst])
            r = pk_u[c].place(int(fac_round[src]) + 1)
            if r > last_write[dst]:
                last_write[dst] = r
            u_r[c].append(r)
            u_src[c].append(src)
            u_dst[c].append(dst)
            u_tix[c].append(i)
        elif tt == 1:
            s = int(t_src[i])
            c = int(cls_of_sn[s])
            r = pk_f[c].place(int(last_write[s]))
            fac_round[s] = r
            f_r[c].append(r)
            f_s[c].append(s)
        else:
            bi = int(t_src[i])
            slot = int(t_dst[i])
            mptr, mown = mem[bi]
            members = mown[mptr[slot] : mptr[slot + 1]]
            e = 1 + (int(fac_round[members].max()) if members.size else 0)
            r = pk_a[bi].place(e)
            tptr, town = tgt[bi]
            targets = town[tptr[slot] : tptr[slot + 1]]
            if targets.size:
                np.maximum.at(last_write, targets, r)
            a_r[bi].append(r)
            a_slot[bi].append(slot)

    R = 1 + max([max(rr) for rr in u_r if rr] + [max(rr) for rr in f_r if rr]
                + [max(rr) for rr in a_r if rr] + [0])

    def pack(rounds, cols, width, fill):
        """(R, width) lane tables + (R,) counts from (round, value) lists."""
        out = [np.full((R, width), f, dtype=np.int64) for f in fill]
        cnt = np.zeros(R, dtype=np.int32)
        for j, r in enumerate(rounds):
            k = cnt[r]
            for o, colv in zip(out, cols):
                o[r, k] = colv[j]
            cnt[r] = k + 1
        w_eff = max(int(cnt.max()), 1)
        return [o[:, :w_eff].astype(np.int32) for o in out], cnt

    upd_src, upd_dst, upd_tix, upd_cnt = [], [], [], []
    for c in range(nc):
        (a1, a2, a3), cn = pack(u_r[c], (u_src[c], u_dst[c], u_tix[c]), bu, (S, S, sent_tix))
        upd_src.append(a1)
        upd_dst.append(a2)
        upd_tix.append(a3)
        upd_cnt.append(cn)
    fac_s, fac_cnt = [], []
    for c in range(nc):
        (a1,), cn = pack(f_r[c], (f_s[c],), bf, (S,))
        fac_s.append(a1)
        fac_cnt.append(cn)
    agg_slots, agg_cnt = [], []
    for bi in range(nb):
        (a1,), cn = pack(a_r[bi], (a_slot[bi],), ba_list[bi], (-1,))
        agg_slots.append(a1)
        agg_cnt.append(cn)

    return RoundSchedule(
        R=R,
        upd_mr=tuple(int(s) for s in sizes),
        fac_mr=tuple(int(s) for s in sizes),
        upd_src=tuple(upd_src),
        upd_dst=tuple(upd_dst),
        upd_tix=tuple(upd_tix),
        upd_cnt=tuple(upd_cnt),
        fac_s=tuple(fac_s),
        fac_cnt=tuple(fac_cnt),
        agg_slots=tuple(agg_slots),
        agg_cnt=tuple(agg_cnt),
    )


# ---------------------------------------------------------------------------
# device side
# ---------------------------------------------------------------------------


def _geometry(plan, device) -> dict:
    """Per-supernode geometry extended by the sentinel supernode S (the
    zero scratch at P, no columns, no rows), as int64 tensors on
    ``device``; cached beside the plan's other tables."""
    tabs = device_tables(plan, device)
    if "row_off" not in tabs:
        t = lambda a, last: torch.from_numpy(  # noqa: E731
            np.append(np.asarray(a, dtype=np.int64), last)).to(device)
        tabs["row_off"] = t(np.asarray(plan.off, np.int64) // plan.W, plan.P // plan.W)
        tabs["c0"] = t(plan.c0, plan.n)
        tabs["w"] = t(plan.w, 0)
        tabs["rows"] = t(plan.rows, 0)
        tabs["below_ptr"] = t(plan.below_ptr[:-1], plan.below_ptr[-1])
    return tabs


def _lanes(sched: RoundSchedule, device) -> dict:
    """The schedule's lane tables as int64 tensors on ``device``, cached
    on the schedule: a phase takes its lanes as a view of one row."""
    key = str(torch.device(device))
    cache = sched.__dict__.setdefault("_device_lanes", {})
    if key not in cache:
        t = lambda a: torch.from_numpy(np.asarray(a, dtype=np.int64)).to(device)  # noqa: E731
        cache[key] = {f: [t(a) for a in getattr(sched, f)]
                      for f in ("upd_src", "upd_dst", "upd_tix", "fac_s", "agg_slots")}
    return cache[key]


def _members(N: int, stride: int, device) -> torch.Tensor:
    """(N, 1, 1) offsets of each member's block in a flat array."""
    return (torch.arange(N, device=device) * stride).view(N, 1, 1)


def numeric_batched(plan, sched: RoundSchedule, data: torch.Tensor):
    """The level-batched numeric on ``data``'s device: ``(l_data, d)`` in
    the CSC-slot layout of ``numeric_supernodal``.  ``data`` is (nnz,)
    or (N, nnz) (N same-pattern value sets; the results then carry the
    member axis).  A zero pivot NaN-poisons the outputs instead of
    raising."""
    n, W = plan.n, plan.W
    device = data.device
    lp, dext = assemble(plan, data)
    single = lp.ndim == 1
    if single:
        lp, dext = lp[None], dext[None]
    N, length = lp.shape
    lp2 = lp.view(-1, W)
    dflat = dext.view(-1)
    geo = _geometry(plan, device)
    lanes = _lanes(sched, device)
    mrow = _members(N, length // W, device)
    mdx = _members(N, n + W, device)
    cols = torch.arange(W, device=device)
    w_host = np.asarray(plan.w, dtype=np.int64)

    def update(src, dst, tix, mr):
        live = geo["rmap_live"][tix, :mr]
        rows_b = mrow + (geo["row_off"][src][:, None] + geo["rmap_safe"][tix, :mr])[None]
        b = torch.where(live[None, :, :, None], lp2[rows_b], 0)  # (N, B, mr, W)
        dwin = dflat[mdx + (geo["c0"][src][:, None] + cols)[None]]
        dwin = torch.where((cols < geo["w"][src][:, None])[None], dwin, 0)
        g = torch.where((cols < geo["w"][dst][:, None])[None, :, :, None], b[:, :, :W], 0)
        u = b @ (g * dwin[:, :, None, :]).mT  # rows past the target's are 0
        rows_t = mrow + (geo["row_off"][dst][:, None] + torch.arange(mr, device=device))[None]
        lp2.index_put_((rows_t.reshape(-1),), u.neg_().reshape(-1, W), accumulate=True)

    def factor(s, mr, n_live):
        B = s.shape[0]
        rows_s = mrow + (geo["row_off"][s][:, None] + torch.arange(mr, device=device))[None]
        panel = lp2[rows_s]  # (N, B, mr, W)
        live = cols < geo["w"][s][:, None]  # (B, W)
        flat_live = live.expand(N, B, W).reshape(N * B, W)
        top = torch.where(live[None, :, None, :], panel[:, :, :W], 0).reshape(N * B, W, W)
        diag = top.diagonal(dim1=-2, dim2=-1)
        diag.copy_(torch.where(flat_live, diag, 1))
        top, dvec = blocked_ldl_top(top, flat_live, n_live=n_live)
        if mr > W:
            xt = torch.linalg.solve_triangular(
                top.mT, panel[:, :, W:].reshape(N * B, mr - W, W), upper=True, left=False,
                unitriangular=True)
            top = torch.cat([top, xt / dvec[:, None, :]], 1)
        full = torch.where(live[None, :, None, :], top.view(N, B, mr, W), 0)
        own = torch.arange(mr, device=device)[None, :] < geo["rows"][s][:, None]
        delta = torch.where(own[None, :, :, None], full, panel) - panel
        lp2.index_put_((rows_s.reshape(-1),), delta.reshape(-1, W), accumulate=True)
        dwin = torch.where(live[None], dvec.view(N, B, W), 0)
        dflat.index_put_(((mdx + (geo["c0"][s][:, None] + cols)[None]).reshape(-1),),
                         dwin.reshape(-1), accumulate=True)

    if getattr(plan, "mem_start", ()):
        from .ldl_mf import make_agg_phase

        aggs = [make_agg_phase(plan, bi, device) for bi in range(len(plan.mem_start))]
    for r in range(sched.R):
        for c, mr in enumerate(sched.upd_mr):
            k = int(sched.upd_cnt[c][r])
            if k:
                update(lanes["upd_src"][c][r, :k], lanes["upd_dst"][c][r, :k],
                       lanes["upd_tix"][c][r, :k], mr)
        for bi, cnt in enumerate(sched.agg_cnt):
            k = int(cnt[r])
            if k:
                aggs[bi](lp, dext, lanes["agg_slots"][bi][r, :k])
        for c, mr in enumerate(sched.fac_mr):
            k = int(sched.fac_cnt[c][r])
            if k:
                n_live = int(w_host[sched.fac_s[c][r, :k]].max())
                factor(lanes["fac_s"][c][r, :k], mr, n_live)
    lx, d = lp[:, geo["csc_gather"]], dext[:, :n]
    return (lx[0], d[0]) if single else (lx, d)


# The round-batched solve's crossover: LdlNumeric.solve and
# batched_ldl_solve take solve_batched only when plan.S is at least the
# device's constant.  On CPU tensors the JAX package's value, measured on
# a TPU v5e (batched x0.29 of the sequential at S = 968, x1.04 at
# S = 15,182), keeps its routing.
SOLVE_BATCHED_MIN_S = 8192
# On CUDA tensors, from chip_smoke.py phase 5h on an NVIDIA H100 80GB HBM3
# (700 W), ms per solve in two runs, sequential against round-batched:
# 64² nd (S = 133, R = 6) 72.3 / 60.9 against 22.3 / 30.3; 256² nd
# (S = 1,991, R = 26) 785 / 966 against 162 / 189; 256² camd (S = 6,443,
# R = 175) 2,678 / 3,135 against 585 / 816.  The batched sweeps won at
# every measured S; a supernode step costs about 0.5 ms and a round
# about 2 ms of issue, so on chains (S below about 4·R) the sequential
# sweep would win.  Not measured below S = 133.
SOLVE_BATCHED_MIN_S_CUDA = 128


def solve_batched_min_s(device) -> int:
    """The S from which the round-batched solve is taken on ``device``."""
    if torch.device(device).type == "cuda":
        return SOLVE_BATCHED_MIN_S_CUDA
    return SOLVE_BATCHED_MIN_S


def solve_batched(plan, sched: RoundSchedule, panels: torch.Tensor, d: torch.Tensor,
                  b: torch.Tensor) -> torch.Tensor:
    """x = (L D Lᵀ)⁻¹ b with both sweeps round-batched.

    The factor's rounds are a legal level schedule for the solves: a
    solve dependency d→s (a below row of d in s's columns) is a factor
    edge, with ``fac_round[d] < fac_round[s]``.  So the forward sweep
    runs each round's factor lanes batched per row class, the backward
    sweep the rounds in reverse; same-round lanes touch disjoint columns,
    and their column writes are live-masked deltas.  ``b`` is (n,) or
    (n, k); ``panels`` (P,) and ``d`` (n,) may carry a leading member
    axis N, and then ``b`` is (N, n) or one shared (n,).  Callers apply
    the fill-reducing permutation outside.
    """
    n, W, MR = plan.n, plan.W, plan.MR
    device = panels.device
    dtype = torch.promote_types(panels.dtype, b.dtype)
    batched = panels.ndim == 2
    pan = (panels if batched else panels[None]).to(dtype)
    dd = (d if batched else d[None]).to(dtype)
    N = pan.shape[0]
    if batched:
        vec = True
        rhs = b.to(dtype).expand(N, n)[..., None]
    else:
        vec = b.ndim == 1
        rhs = b.to(dtype).reshape(n, -1)[None]
    k = rhs.shape[-1]
    # a zero tail, so sentinel and class windows read exact zeros
    pz = torch.cat([pan, pan.new_zeros(N, MR * W)], 1)
    pz2 = pz.view(-1, W)
    x = torch.cat([rhs, rhs.new_zeros(N, W, k)], 1)  # (N, n + W, k)
    xf = x.view(-1, k)
    geo = _geometry(plan, device)
    bflat = device_tables(plan, device)["below_flat"]
    lanes = _lanes(sched, device)["fac_s"]
    mrow = _members(N, pz.shape[1] // W, device)
    mdx = _members(N, n + W, device)
    cols = torch.arange(W, device=device)
    eye = torch.eye(W, dtype=dtype, device=device)

    def load(s, mr):
        """A lane's panel (rows past its own masked to 0: the window
        crosses into the next panels), its in-block system, below-row
        ids and column window."""
        B = s.shape[0]
        slots = torch.arange(mr, device=device)
        panel = pz2[mrow + (geo["row_off"][s][:, None] + slots)[None]]
        ws = geo["w"][s]
        live = cols < ws[:, None]  # (B, W)
        keep = (slots[None, :] < geo["rows"][s][:, None])[:, :, None] & live[:, None, :]
        panel = torch.where(keep[None], panel, 0)
        blk = torch.where((live[:, None, :] & (cols[None, :, None] < ws[:, None, None]))[None],
                          panel[:, :, :W], eye)
        ids = bflat[geo["below_ptr"][s][:, None] + slots]  # (B, mr); n past the list
        cidx = (mdx + (geo["c0"][s][:, None] + cols)[None]).reshape(-1)
        lane = torch.arange(B, device=device)[:, None]
        return panel, blk, ids, live, cidx, ws, lane, slots

    def fwd(s, mr):
        panel, blk, ids, live, cidx, ws, lane, slots = load(s, mr)
        yd = xf[cidx].view(N, -1, W, k)
        sol = torch.linalg.solve_triangular(blk, yd, upper=False, unitriangular=True)
        sol = torch.where(live[None, :, :, None], sol, 0)
        xf.index_put_((cidx,), torch.where(live[None, :, :, None], sol - yd, 0).reshape(-1, k),
                      accumulate=True)
        u = panel @ sol  # (N, B, mr, k)
        # below slot i holds the value of panel slot ws + i
        u = torch.cat([u, u.new_zeros(N, u.shape[1], W, k)], 2)[:, lane, ws[:, None] + slots]
        xf.index_put_(((mdx + ids[None]).reshape(-1),), u.neg_().reshape(-1, k),
                      accumulate=True)

    def bwd(s, mr):
        panel, blk, ids, live, cidx, ws, lane, slots = load(s, mr)
        xg = torch.where((ids < n)[None, :, :, None], xf[mdx + ids.clamp(max=n - 1)[None]], 0)
        # below values shifted into panel slots ws.. (zeros before)
        xe = torch.cat([xg.new_zeros(N, xg.shape[1], W, k), xg], 2)
        xe = xe[:, lane, (W - ws)[:, None] + slots]
        xd = xf[cidx].view(N, -1, W, k)
        sol = torch.linalg.solve_triangular(blk.mT, xd - panel.mT @ xe, upper=True,
                                            unitriangular=True)
        xf.index_put_((cidx,), torch.where(live[None, :, :, None], sol - xd, 0).reshape(-1, k),
                      accumulate=True)

    def sweep(step, rounds):
        for r in rounds:
            for c, mr in enumerate(sched.fac_mr):
                cnt = int(sched.fac_cnt[c][r])
                if cnt:
                    step(lanes[c][r, :cnt], mr)

    sweep(fwd, range(sched.R))
    x[:, :n] /= dd[..., None]
    sweep(bwd, range(sched.R - 1, -1, -1))
    out = x[:, :n]
    if vec:
        out = out[..., 0]
    return out if batched else out[0]
