"""Supernode detection and amalgamation, the counterpart of
``sprs_tpu/linalg/supernodes.py``.

Partition the columns of L into fundamental supernodes (Liu's criterion:
column j joins column j-1's supernode iff ``parent[j-1] == j`` and
``colcount[j] == colcount[j-1] - 1``, i.e. identical row structure
below the diagonal) with optional relaxed amalgamation (merge a child
supernode into its parent when the introduced explicit zeros stay
under a budget — fewer, wider supernodes mean bigger dense panels).

Host-side numpy; ``amalgamate_union`` runs in the port's native library
where it is built, with the same result.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .. import native


@dataclasses.dataclass(frozen=True)
class Supernodes:
    """Column partition of L: supernode s spans columns
    ``ptr[s]:ptr[s+1]``; ``of[j]`` is the supernode of column j."""

    ptr: np.ndarray  # (n_snodes + 1,)
    of: np.ndarray  # (n,)

    @property
    def n_snodes(self) -> int:
        return self.ptr.shape[0] - 1

    def widths(self) -> np.ndarray:
        return np.diff(self.ptr)


def fundamental_supernodes(
    parent: np.ndarray, colcount: np.ndarray
) -> Supernodes:
    """Liu's fundamental supernodes from the etree and L column counts.

    ``parent`` is the elimination tree (−1 for roots); ``colcount[j]``
    counts L's column j INCLUDING the diagonal.  Assumes columns are in
    a topological (e.g. natural post-RCM) order with parent[j] > j.
    """
    n = parent.shape[0]
    parent = np.asarray(parent)
    colcount = np.asarray(colcount)
    if n == 0:
        return Supernodes(
            ptr=np.zeros(1, dtype=np.int64), of=np.zeros(0, dtype=np.int64)
        )
    # a column also starts a supernode when it has more than one etree
    # child (its structure cannot equal a single child's minus one).
    # Fully vectorized: the symbolic layer must survive 10^6-row inputs.
    n_children = np.bincount(parent[parent >= 0], minlength=n)
    j = np.arange(1, n)
    chain = (
        (parent[:-1] == j)
        & (colcount[1:] == colcount[:-1] - 1)
        & (n_children[1:] == 1)
    )
    starts = np.concatenate([[0], j[~chain]])
    ptr = np.concatenate([starts, [n]]).astype(np.int64)
    of = np.zeros(n, dtype=np.int64)
    of[ptr[1:-1]] = 1
    of = np.cumsum(of)
    return Supernodes(ptr=ptr, of=of)


def amalgamate(
    sn: Supernodes,
    parent: np.ndarray,
    colcount: np.ndarray,
    *,
    max_zeros: int = 32,
    max_width: int = 128,
    rel_zeros: float = 0.125,
) -> Supernodes:
    """Relaxed amalgamation: greedily merge a supernode into its etree
    parent supernode when (a) its last column's parent is the parent
    supernode's first column, (b) the merged width stays ≤
    ``max_width`` (one panel tile), and (c) the explicit zeros introduced
    (children columns padded to the parent's row structure) stay ≤
    ``max_zeros`` OR ≤ ``rel_zeros`` of the merged block's entries
    (CHOLMOD-style relative budget — the absolute budget alone keeps
    banded matrices at width ~8, too narrow for dense panels).

    Zeros introduced when merging child block [c0,c1) into parent block
    starting at p0: each child column j gains
    ``(colcount[p0] + (p0 - j)) - colcount[j]`` explicit entries (its
    structure becomes the parent's plus the chain down to j).
    """
    n = parent.shape[0]
    ptr = list(sn.ptr)
    # accumulated explicit zeros already inside each (merged) block, so
    # repeated merges account for their own padding
    zeros_in = [0] * (len(ptr) - 1)
    s = len(ptr) - 2
    while s >= 0:
        c0, c1 = ptr[s], ptr[s + 1]
        if c1 >= n or parent[c1 - 1] != ptr[s + 1]:
            s -= 1
            continue
        p_first = ptr[s + 1]
        p_end = ptr[s + 2] if s + 2 < len(ptr) else n
        width = p_end - c0
        if width > max_width:
            s -= 1
            continue
        target = int(colcount[p_first])
        js = np.arange(c0, c1)
        zeros = int(
            np.sum((target + (p_first - js)) - colcount[c0:c1])
        )
        if zeros < 0:
            s -= 1
            continue
        total_zeros = zeros + zeros_in[s] + zeros_in[s + 1]
        entries = int(np.sum(colcount[c0:c1])) + int(
            np.sum(colcount[p_first:p_end])
        ) + total_zeros
        if total_zeros > max_zeros and total_zeros > rel_zeros * entries:
            s -= 1
            continue
        del ptr[s + 1]
        zeros_in[s] = total_zeros
        del zeros_in[s + 1]
        # retry the same position: chains collapse in one sweep
        if s + 1 < len(ptr) - 1:
            continue
        s -= 1
    ptr_arr = np.asarray(ptr, dtype=np.int64)
    of = np.zeros(n, dtype=np.int64)
    of[ptr_arr[1:-1]] = 1
    of = np.cumsum(of)
    return Supernodes(ptr=ptr_arr, of=of)


def amalgamate_union(
    l_indptr,
    l_indices,
    parent: np.ndarray,
    colcount: np.ndarray,
    *,
    max_width: int = 128,
    max_zeros: int = 32,
    rel_zeros: float = 0.65,
):
    """CHOLMOD-class relaxed amalgamation with per-supernode row-structure
    UNIONS.

    ``rel_zeros`` is a pure performance knob (exactness holds for any
    contiguous partition): explicit zeros cost dense panel flops while
    wider panels amortize per-task dispatch, so the default is loose
    (0.65 of panel entries; 0.125 gives narrow panels on banded rcm
    factors and many width-5 panels on AMD factors).

    The chain-rule :func:`amalgamate` can only merge a supernode whose
    last column's etree parent is the next block's first column, and its
    panels inherit the LAST column's below structure — sound, but on
    bushy (AMD-ordered, postordered) etrees it leaves thousands of
    width-1..2 supernodes.  With the panel below-structure defined as
    the UNION of the member columns' structures, ANY contiguous column
    partition yields an exact factorization (each column's true pattern
    is contained in its panel's pattern, and padded entries stay exactly
    0.0 — see ldl_super.py's exactness argument), so merging is limited
    only by the explicit-zero budget and ``max_width``.

    Returns ``(Supernodes, below_ptr, below_flat)`` where
    ``below_flat[below_ptr[s]:below_ptr[s+1]]`` are supernode s's
    below-diagonal-block rows, ascending.
    """
    colcount = np.asarray(colcount)
    n = colcount.shape[0]
    l_indptr = np.asarray(l_indptr)
    l_indices = np.asarray(l_indices)
    sn = fundamental_supernodes(np.asarray(parent), colcount)
    ptr = sn.ptr
    S0 = sn.n_snodes
    # fundamental supernode below rows = struct(first col) ∩ [c1, ∞):
    # later member columns' structures are suffixes of the first's.
    # Fundamentals wider than max_width (the dense trailing block of a
    # fill-reducing ordering reaches ~sqrt(n)) are SPLIT into
    # max_width-column strips — any contiguous partition is exact, and
    # an unsplit block would set the global panel row-stride W to its
    # width, multiplying every panel's storage.  A strip's below rows
    # are [strip_end, c1) ∪ (below ∩ [strip_end, ∞)): inside a
    # fundamental the diagonal block is full lower-triangular, so
    # struct(first strip col) ∩ [strip_end, ∞) is exactly the first
    # fundamental column's struct restricted to [strip_end, ∞).
    ccum = np.zeros(colcount.shape[0] + 1, dtype=np.int64)
    np.cumsum(colcount, out=ccum[1:])
    # strip starts: fundamentals wider than max_width split here; the
    # per-strip below rows are struct(strip first col) ∩ [strip_end, ∞)
    # — equal to the fundamental first column's struct restricted, per
    # the in-fundamental suffix property (colcount[j]=colcount[j-1]-1).
    strip_starts = []
    for s in range(S0):
        strip_starts.extend(
            range(int(ptr[s]), int(ptr[s + 1]), max_width)
        )
    ptr0 = np.asarray(strip_starts + [n], dtype=np.int64)

    fast = native.amalgamate_union_native(
        l_indptr, l_indices, n, ptr0, max_width, max_zeros, rel_zeros
    )
    if fast is not None:
        out_ptr, below_ptr, below_flat = fast
        of = np.zeros(n, dtype=np.int64)
        of[out_ptr[1:-1]] = 1
        of = np.cumsum(of)
        return (
            Supernodes(ptr=out_ptr, of=of),
            below_ptr,
            below_flat,
        )

    blocks = []
    for t in range(ptr0.shape[0] - 1):
        c0, c1 = int(ptr0[t]), int(ptr0[t + 1])
        col = l_indices[l_indptr[c0] + 1 : l_indptr[c0 + 1]]
        rows = col[col >= c1]
        blocks.append([c0, c1, rows, int(ccum[c1] - ccum[c0])])
    for _ in range(4):  # merge passes until fixpoint (bounded)
        out = []
        changed = False
        for b in blocks:
            if not out:
                out.append(b)
                continue
            a = out[-1]
            w_new = b[1] - a[0]
            if w_new <= max_width:
                rows_hi = a[2][a[2] >= b[1]]
                rows_new = np.union1d(rows_hi, b[2])
                tn = a[3] + b[3]
                ent = w_new * (w_new + 1) // 2 + w_new * rows_new.size
                zeros = ent - tn
                if zeros <= max_zeros or zeros <= rel_zeros * ent:
                    out[-1] = [a[0], b[1], rows_new, tn]
                    changed = True
                    continue
            out.append(b)
        blocks = out
        if not changed:
            break
    ptr_arr = np.asarray(
        [b[0] for b in blocks] + [n], dtype=np.int64
    )
    of = np.zeros(n, dtype=np.int64)
    of[ptr_arr[1:-1]] = 1
    of = np.cumsum(of)
    below_ptr = np.zeros(len(blocks) + 1, dtype=np.int64)
    np.cumsum([b[2].size for b in blocks], out=below_ptr[1:])
    below_flat = (
        np.concatenate([b[2] for b in blocks])
        if blocks
        else np.zeros(0, dtype=np.int64)
    ).astype(np.int64)
    return Supernodes(ptr=ptr_arr, of=of), below_ptr, below_flat


def amalgamate_subtree(
    l_indptr,
    l_indices,
    parent: np.ndarray,
    colcount: np.ndarray,
    *,
    max_width: int = 128,
    max_zeros: int = 32,
    rel_zeros: float = 0.65,
):
    """Subtree-aligned amalgamation — the batched-schedule variant.

    :func:`amalgamate_union` merges ANY adjacent blocks under the
    zeros budget; exact, but merging across sibling-subtree boundaries
    welds independent branches into one dependency chain: on an
    ND-ordered mesh Laplacian, loose budgets collapse the whole order
    into width-W chunks where EVERY block updates the next, so the
    batched critical path equals the supernode count.

    Here the partition follows the etree instead (the cut rule of the
    JAX package's ``ldl_mf._partition_fronts``, at column level):

    * every maximal COMPLETE subtree whose width and padding fit the
      budget becomes one supernode — its below structure is exactly
      ``below(root)`` (the multifrontal containment property), so it
      has NO edge to the adjacent block and leaf subtrees schedule in
      parallel;
    * leftover columns (ancestors of over-budget subtrees — separator
      paths under nested dissection) merge greedily within contiguous
      runs under the union budget, like :func:`amalgamate_union`.

    Same return contract as :func:`amalgamate_union`.
    """
    colcount = np.asarray(colcount)
    parent = np.asarray(parent)
    n = colcount.shape[0]
    l_indptr = np.asarray(l_indptr)
    l_indices = np.asarray(l_indices)
    if n == 0:
        return (
            Supernodes(
                ptr=np.zeros(1, dtype=np.int64),
                of=np.zeros(0, dtype=np.int64),
            ),
            np.zeros(1, dtype=np.int64),
            np.zeros(0, dtype=np.int64),
        )
    # postorder ⇒ subtree of j is the contiguous range [dmin[j], j]
    dmin = np.arange(n, dtype=np.int64)
    for j in range(n):
        p = parent[j]
        if p >= 0 and dmin[j] < dmin[p]:
            dmin[p] = dmin[j]
    size = np.arange(n, dtype=np.int64) - dmin + 1
    # complete-subtree padding: the merged panel is a w-wide trapezoid
    # over below(root) = struct(root) ∩ [root+1, ∞) — every member's
    # beyond-block rows ride the root's structure (path containment)
    below_cnt = colcount - 1
    ccum = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(colcount, out=ccum[1:])
    w = size
    ent = w * (w + 1) // 2 + w * below_cnt
    true_ent = ccum[np.arange(1, n + 1)] - ccum[dmin]
    zeros = ent - true_ent
    fits = (w <= max_width) & (
        (zeros <= max_zeros) | (zeros <= rel_zeros * np.maximum(ent, 1))
    )
    pfit = np.ones(n, dtype=bool)
    okp = parent >= 0
    pfit[okp] = ~fits[parent[okp]]
    is_root = fits & pfit  # maximal fitting subtrees
    starts = {int(dmin[r]): int(r) + 1 for r in np.nonzero(is_root)[0]}

    ptr = [0]
    kinds = []  # per block: subtree root (>=0) or -1 for leftover
    pos = 0
    while pos < n:
        if pos in starts:
            end = starts[pos]
            if ptr[-1] != pos:
                # flush the pending leftover run
                ptr.append(pos)
                kinds.append(-1)
            ptr.append(end)
            kinds.append(end - 1)
            pos = end
        else:
            pos += 1
    if ptr[-1] != n:
        ptr.append(n)
        kinds.append(-1)

    # split + greedy-merge the leftover runs under the union budget
    out_ptr = [0]
    out_rows = []
    for b in range(len(kinds)):
        c0, c1 = ptr[b], ptr[b + 1]
        if kinds[b] >= 0:
            r = kinds[b]
            rows = l_indices[l_indptr[r] + 1 : l_indptr[r + 1]]
            out_ptr.append(c1)
            out_rows.append(np.asarray(rows, dtype=np.int64))
            continue
        cur0 = c0
        cur_rows = None
        cur_true = 0
        for c in range(c0, c1):
            crow = l_indices[l_indptr[c] + 1 : l_indptr[c + 1]].astype(
                np.int64
            )
            if cur_rows is None:
                cur0, cur_rows, cur_true = c, crow, int(colcount[c])
                continue
            wn = c + 1 - cur0
            if wn <= max_width:
                hi = cur_rows[cur_rows >= c + 1]
                rows_new = np.union1d(hi, crow[crow >= c + 1])
                tn = cur_true + int(colcount[c])
                en = wn * (wn + 1) // 2 + wn * rows_new.size
                zr = en - tn
                if zr <= max_zeros or zr <= rel_zeros * en:
                    cur_rows, cur_true = rows_new, tn
                    continue
            out_ptr.append(c)
            out_rows.append(cur_rows[cur_rows >= c])
            cur0, cur_rows, cur_true = c, crow, int(colcount[c])
        if cur_rows is not None:
            out_ptr.append(c1)
            out_rows.append(cur_rows[cur_rows >= c1])

    ptr_arr = np.asarray(out_ptr, dtype=np.int64)
    of = np.zeros(n, dtype=np.int64)
    of[ptr_arr[1:-1]] = 1
    of = np.cumsum(of)
    below_ptr = np.zeros(len(out_rows) + 1, dtype=np.int64)
    np.cumsum([r.size for r in out_rows], out=below_ptr[1:])
    below_flat = (
        np.concatenate(out_rows)
        if out_rows
        else np.zeros(0, dtype=np.int64)
    ).astype(np.int64)
    return Supernodes(ptr=ptr_arr, of=of), below_ptr, below_flat


def supernode_structure(l_indptr, l_indices, sn: Supernodes):
    """Padded per-supernode row structure from L's (CSC) pattern.

    For supernode s spanning columns [c0, c1), the rows below the
    diagonal BLOCK (i.e. >= c1) are identical for every column in s —
    that is the defining property the detection guarantees; this
    function extracts them once per supernode (from the FIRST column)
    and verifies the property for the remaining columns.

    Returns ``(sn_rows (s, max_rows) padded with -1, sn_nrows (s,))``.
    """
    l_indptr = np.asarray(l_indptr)
    l_indices = np.asarray(l_indices)
    n_snodes = sn.n_snodes
    rows_per = []
    for s in range(n_snodes):
        c0, c1 = int(sn.ptr[s]), int(sn.ptr[s + 1])
        first = l_indices[l_indptr[c0] : l_indptr[c0 + 1]]
        below = first[first >= c1]
        for j in range(c0 + 1, c1):
            col = l_indices[l_indptr[j] : l_indptr[j + 1]]
            colb = col[col >= c1]
            if not np.array_equal(np.sort(colb), np.sort(below)):
                raise ValueError(
                    f"column {j} breaks supernode {s}'s shared "
                    "structure — detection inputs were inconsistent"
                )
        rows_per.append(np.sort(below))
    max_rows = max((r.size for r in rows_per), default=0)
    sn_rows = np.full((n_snodes, max(max_rows, 1)), -1, dtype=np.int64)
    sn_nrows = np.zeros(n_snodes, dtype=np.int64)
    for s, r in enumerate(rows_per):
        sn_rows[s, : r.size] = r
        sn_nrows[s] = r.size
    return sn_rows, sn_nrows
