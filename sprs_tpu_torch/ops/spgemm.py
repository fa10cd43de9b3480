"""Sparse × sparse product (SpGEMM) by expand–sort–compress (ESC), the
PyTorch counterpart of ``sprs_tpu/ops/spgemm.py``.

1. *Expand*: every partial product a_ik·b_kj becomes a COO triple.  An
   owner map (which A entry made flat product t) comes from a scatter of
   ones at each A entry's first product and a prefix sum; A's value and
   B's position are then gathers through it.  The JAX package avoids that
   gather on the TPU with a bit-delta broadcast that needs a hand-written
   VJP; on the GPU a gather is cheap, the values are the same bits, and
   autograd differentiates it (A's gradient is the index-add the JAX VJP
   writes by hand).
2. *Sort* and 3. *compress*: ``formats/util.py::compress_coo``, one sort of
   the int64 keys ``row·n_inner + col`` and a segmented sum.

Everything runs on the operands' device.  The capacities that the JAX
package computes on the host from concrete arrays (the product count,
the chunk boundaries) are computed on the device here, and only those
scalars and the short list of chunk boundaries are read back; the index
arrays never leave the device inside :func:`spgemm`.

CSC operands reduce to CSR through the transpose identity
(A·B) = (Bᵀ·Aᵀ)ᵀ; the result takes the lhs's storage.

Budgets.  On the CPU the module keeps the JAX package's values, so that
both packages take the same branches there.  On a CUDA device the
product budget of one ESC pass and the dense-route byte budget are taken
from the memory torch can still allocate on the card (the device's free
memory and the caching allocator's unused reserve) and the bytes each
route allocates per product or per dense element, below.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import numpy as np
import torch

from ..errors import CapacityError, ShapeError
from ..formats.csmat import CsMat, from_dense
from ..formats.util import INDEX_DTYPE, MAX_INDEX, compress_coo

# The JAX package's values, used for tensors off the card.
CHUNK_PRODUCT_BUDGET = 32 * 1024 * 1024
DENSE_BYTES_BUDGET = 6 << 30
# ``spgemm_sort_batches``' segment sizes, as in the JAX package (the
# port's compress_coo sorts in one pass and ignores the segments).
SORT_BATCH_MIN = 1 << 21
SORT_BATCH_TARGET = 1 << 19

# On a CUDA device.  The ESC pass at its peak holds the expanded
# (row, col, value) triples, the int64 keys, the sort's keys, order and
# scratch, the group ids and the accumulating index_put_'s own sort: the
# peak allocation over the product count, 124.3-126.6 bytes at the three
# points of chip_smoke.py's phase 4 (float32, NVIDIA H100 80GB HBM3),
# rounded up.
ESC_BYTES_PER_PRODUCT = 128
# The dense route at its peak, over (m·k + k·n + m·n)·itemsize, the
# quantity its budget is compared with.  Its allocations bound it by 3:
# the densified operands and the product, or, once they are freed, the
# product, its |.| for the block mask and the gathered blocks (up to m·n
# each), which dominate when k is small.  Phase 4 measured 1.0086 at the
# (15000, 25000) @ (25000, 15000) point.
DENSE_PEAK_PER_BYTE = 3.0
# The share of the free memory either route may plan to take.
FREE_FRACTION = 0.5

# method="auto" switches to the dense route when the partial-product
# count is at least this share of the dense multiply-adds m·k·n: the
# break-even of the ESC time per product and the dense route's time per
# multiply-add (float32, precision "highest"), both measured by
# chip_smoke.py's phase 4 at the d = 5e-3 point on an NVIDIA H100 80GB
# HBM3 (700 W): 139.3 ms for 140.6M products against 224.9 ms for
# 5.625e12 multiply-adds gives 4.04e-5.  (The JAX package's 3e-6 is the
# TPU's break-even.)
AUTO_DENSE_PRODUCTS_PER_MAC = 4e-5


def _on_card(device) -> bool:
    return torch.device(device).type == "cuda"


def _free_bytes(device) -> int:
    """Bytes torch can still allocate on the card: the device's free
    memory (``mem_get_info``) plus what torch's caching allocator holds
    unused."""
    free, _ = torch.cuda.mem_get_info(device)
    return free + torch.cuda.memory_reserved(device) - torch.cuda.memory_allocated(device)


def chunk_product_budget(device) -> int:
    """Products one ESC pass may expand on ``device``."""
    if not _on_card(device):
        return CHUNK_PRODUCT_BUDGET
    return int(_free_bytes(device) * FREE_FRACTION // ESC_BYTES_PER_PRODUCT)


def dense_bytes_budget(device) -> int:
    """Bytes of dense operands and product the dense route may take on
    ``device`` (compared with (m·k + k·n + m·n)·itemsize)."""
    if not _on_card(device):
        return DENSE_BYTES_BUDGET
    return int(_free_bytes(device) * FREE_FRACTION / DENSE_PEAK_PER_BYTE)


# ---------------------------------------------------------------------------
# expand
# ---------------------------------------------------------------------------


def _expand_products(a: CsMat, b: CsMat, prod_cap: int):
    """Partial products of CSR a × CSR b as padded COO arrays
    ``(rows, cols, vals, total)``; ``total`` is the 0-d product count."""
    return _expand_from_rows(
        a, b.indptr[:-1], b.indptr[1:] - b.indptr[:-1], b.indices, b.data, prod_cap
    )


def _b_lens_of_entries(a: CsMat, b_lens: torch.Tensor) -> torch.Tensor:
    """int64 length of the B row each live A entry hits (0 for padding)."""
    k = a.indices.to(torch.int64).clamp(0, max(b_lens.shape[0] - 1, 0))
    lens = b_lens.to(torch.int64)[k] if b_lens.shape[0] else torch.zeros_like(k)
    return torch.where(a.live_mask(), lens, 0)


def _expand_from_rows(a: CsMat, b_starts, b_lens, b_indices, b_data, prod_cap: int):
    """Expand against explicit B row spans: ``b_starts[r]`` / ``b_lens[r]``
    give row r's range inside ``b_indices`` / ``b_data``, which may hold
    gaps between rows."""
    dev = a.device
    t = torch.arange(prod_cap, dtype=torch.int64, device=dev)
    b_len = _b_lens_of_entries(a, b_lens)
    offsets = torch.cumsum(b_len, 0)
    total = offsets[-1] if a.cap else torch.zeros((), dtype=torch.int64, device=dev)
    starts = offsets - b_len
    k = a.indices.to(torch.int64).clamp(0, max(b_starts.shape[0] - 1, 0))
    # q = adj[owner] + t is the B slot of product t
    adj = b_starts.to(torch.int64)[k] - starts if b_starts.shape[0] else -starts
    # owner(t): the last live A entry whose products start at or before
    # t.  Entries of no product start where the next one does and are
    # counted before it, so the count minus one is the owner.
    first = torch.where(a.live_mask(), starts, prod_cap).clamp(max=prod_cap)
    seg = torch.zeros(prod_cap + 1, dtype=torch.int64, device=dev)
    seg.index_add_(0, first, torch.ones_like(first))
    owner = (torch.cumsum(seg[:prod_cap], 0) - 1).clamp_(min=0)
    del seg, first
    valid = t < total
    q = (adj[owner] + t).clamp_(0, max(b_indices.shape[0] - 1, 0))
    rows = torch.where(valid, a.outer_ids()[owner], a.rows).to(INDEX_DTYPE)
    cols = torch.where(valid, b_indices[q], 0)
    prod = a.data[owner] * b_data[q]
    vals = torch.where(valid, prod, torch.zeros((), dtype=prod.dtype, device=dev))
    return rows, cols, vals, total


def _exact_prod_count(a: CsMat, b: CsMat) -> int:
    """Partial products of CSR a × CSR b: one device sum, one scalar read."""
    if a.cap == 0:
        return 0
    return int(_b_lens_of_entries(a, b.indptr[1:] - b.indptr[:-1]).sum())


def _row_product_prefix(a: CsMat, b: CsMat) -> torch.Tensor:
    """int64 (rows+1,) prefix of the products of each A row, on the device."""
    per_entry = _b_lens_of_entries(a, b.indptr[1:] - b.indptr[:-1])
    entry_prefix = torch.zeros(a.cap + 1, dtype=torch.int64, device=a.device)
    entry_prefix[1:] = torch.cumsum(per_entry, 0)
    return entry_prefix[a.indptr.to(torch.int64)]


# ---------------------------------------------------------------------------
# host-side symbolic helpers
# ---------------------------------------------------------------------------


def spgemm_caps(a: CsMat, b: CsMat) -> tuple:
    """Exact ``(prod_cap, out_cap)`` of ``C = A @ B``: a host-side
    symbolic pass (the unique (row, col) keys of the expanded products,
    counted in A-row chunks of at most 2^26 products).

    >>> import numpy as np
    >>> import sprs_tpu_torch as st
    >>> a = st.from_dense(np.array([[1.0, 2.0], [0.0, 3.0]]), device="cpu")
    >>> st.spgemm_caps(a, a)
    (4, 3)
    """
    a = a.to_csr()
    b = b.to_csr()
    if a.cols != b.rows:
        raise ShapeError(f"spgemm_caps: {a.shape} @ {b.shape}")
    prod = _exact_prod_count(a, b)
    if prod == 0:
        return 0, 0
    ap = a.indptr.cpu().numpy().astype(np.int64)
    ai = a.indices.cpu().numpy().astype(np.int64)[: int(ap[-1])]
    bp = b.indptr.cpu().numpy().astype(np.int64)
    bi = b.indices.cpu().numpy().astype(np.int64)[: int(bp[-1])]
    lens = np.diff(bp)[ai]
    ent_cum = np.zeros(ai.size + 1, np.int64)
    np.cumsum(lens, out=ent_cum[1:])
    row_of_ent = np.repeat(np.arange(a.rows, dtype=np.int64), np.diff(ap))
    budget = 1 << 26
    out = 0
    e0 = 0
    while e0 < ai.size:
        # extend to the last row whose products still fit the budget
        e_hi = int(np.searchsorted(ent_cum, ent_cum[e0] + budget, side="right") - 1)
        e_hi = max(e_hi, e0 + 1)
        e1 = int(ap[row_of_ent[min(e_hi, ai.size) - 1] + 1])
        cnt = lens[e0:e1]
        total = int(ent_cum[e1] - ent_cum[e0])
        rr = np.repeat(row_of_ent[e0:e1], cnt)
        within = np.arange(total, dtype=np.int64) - np.repeat(ent_cum[e0:e1] - ent_cum[e0], cnt)
        cc = bi[np.repeat(bp[ai[e0:e1]], cnt) + within]
        out += np.unique(rr * np.int64(b.cols) + cc).size
        e0 = e1
    return prod, int(out)


def spgemm_sort_batches(a: CsMat, b: CsMat, target: int = None):
    """Host-side ``(starts, lens)`` product segments split at A-row
    boundaries and balanced by product count, as the JAX package hands
    its batched sort; None below ``SORT_BATCH_MIN`` products.  The
    port's :func:`spgemm` accepts them and sorts in one pass."""
    if target is None:
        target = SORT_BATCH_TARGET
    row_prefix = _row_product_prefix(a, b).cpu().numpy()
    total = int(row_prefix[-1])
    if total < SORT_BATCH_MIN:
        return None
    starts, r0 = [], 0
    n_rows = a.rows
    while r0 < n_rows:
        starts.append(int(row_prefix[r0]))
        r1 = int(np.searchsorted(row_prefix, row_prefix[r0] + target, "right") - 1)
        r0 = min(max(r1, r0 + 1), n_rows)
    starts = np.asarray(starts, np.int64)
    return starts, np.diff(np.concatenate([starts, [total]]))


# ---------------------------------------------------------------------------
# ESC
# ---------------------------------------------------------------------------


def _chunks(row_prefix: torch.Tensor, budget: int):
    """``[(r0, r1), ...]``: row chunks whose products fit ``budget`` (a
    single row over budget still makes one chunk).  The prefix stays on
    the device; each chunk reads back one scalar."""
    n_rows = row_prefix.shape[0] - 1
    chunks, r0 = [], 0
    while r0 < n_rows:
        target = (row_prefix[r0] + budget).reshape(1)
        r1 = int(torch.searchsorted(row_prefix, target, right=True)[0]) - 1
        r1 = min(max(r1, r0 + 1), n_rows)
        chunks.append((r0, r1))
        r0 = r1
    return chunks


def chunk_bounds(a: CsMat, b: CsMat, budget: int):
    """The A-row chunks :func:`spgemm` expands one at a time when the
    product count exceeds ``budget``."""
    return _chunks(_row_product_prefix(a.to_csr(), b.to_csr()), budget)


def _spgemm_chunked(a: CsMat, b: CsMat, budget: int) -> CsMat:
    """Row-chunked ESC SpGEMM for product counts beyond one pass's
    ``budget``: each chunk of A's rows is a slice on the device, its
    product is one ESC pass, and the results are stitched on the device.
    Read back: the chunk boundaries, and per chunk the slice's entry
    range and the result's nnz."""
    row_prefix = _row_product_prefix(a, b)
    chunks = _chunks(row_prefix, budget)
    bounds = [r0 for r0, _ in chunks] + [a.rows]
    prods = row_prefix[bounds].tolist()
    parts_indptr = [torch.zeros(1, dtype=torch.int64, device=a.device)]
    parts_indices, parts_data = [], []
    base = 0
    for i, (r0, r1) in enumerate(chunks):
        cap = max(prods[i + 1] - prods[i], 1)
        c = _esc(a.slice_outer(r0, r1), b, prod_cap=cap, out_cap=cap)[0]
        c_nnz = c.nnz
        parts_indptr.append(c.indptr[1:].to(torch.int64) + base)
        parts_indices.append(c.indices[:c_nnz])
        parts_data.append(c.data[:c_nnz])
        base += c_nnz
    pad = max(base, 1) - base
    indices = torch.cat(parts_indices + [parts_indices[0].new_zeros(pad)])
    data = torch.cat(parts_data + [parts_data[0].new_zeros(pad)])
    indptr = torch.cat(parts_indptr)
    if base < 2**31:
        indptr = indptr.to(INDEX_DTYPE)
    return CsMat(indptr, indices.to(INDEX_DTYPE), data, (a.rows, b.cols), "csr")


def _esc(a: CsMat, b: CsMat, *, prod_cap: int, out_cap: int, sort_batches=None):
    """One ESC pass of CSR a × CSR b: ``(C, total, required_nnz)``, C of
    capacity ``out_cap``, the counts as 0-d device tensors."""
    rows, cols, vals, total = _expand_products(a, b, prod_cap)
    res = compress_coo(rows, cols, (vals,), prod_cap, a.rows, b.cols, out_cap,
                       sort_batches=sort_batches)
    c = CsMat(res.indptr, res.indices, res.values[0], (a.rows, b.cols), "csr")
    return c, total, res.required_nnz


def spgemm(
    a: CsMat,
    b: CsMat,
    *,
    out_cap: Optional[int] = None,
    prod_cap: Optional[int] = None,
    check_capacity: bool = True,
    sort_batches=None,
    method: str = "esc",
    precision: str = "highest",
    out_format: str = "csr",
):
    """C = A @ B for sparse A and B, on their device.

    Capacities default to exact values and the result is tightly packed
    (the product count and the result's nnz are read back as scalars).
    Given ``prod_cap`` / ``out_cap`` bound the products and the result
    (``out_cap`` defaults to ``prod_cap``); with ``check_capacity`` a
    count over its bound raises :class:`CapacityError`, else the result
    is truncated.  A product count over the device's ESC budget
    (:func:`chunk_product_budget`) is computed in A-row chunks.
    ``sort_batches`` is accepted for the JAX signature; the sort runs in
    one pass.

    ``method``: ``"esc"`` keeps the structural pattern (an entry whose
    products cancel to zero stays stored); ``"dense"`` forces the dense
    route (:func:`spgemm_dense`), whose pattern is the numerical one;
    ``"auto"`` takes the dense route when the product count is at least
    ``AUTO_DENSE_PRODUCTS_PER_MAC`` of m·k·n and the dense operands fit
    :func:`dense_bytes_budget`.

    ``precision`` (dense route only): ``"highest"`` computes the dense
    product in true float32 on the card (TF32 off for the call);
    ``"default"`` (or ``"high"``) lets it use TF32 tensor cores.

    ``out_format``: ``"csr"`` always returns a :class:`CsMat`; ``"auto"``
    lets the dense route return a :class:`~sprs_tpu_torch.formats.bsr.BsrMat`
    (:func:`spgemm_dense_bsr`, no per-element compaction); ``"bsr"``
    returns a BsrMat from every route (ESC through ``bsr_from_csmat``).

    >>> import numpy as np
    >>> import sprs_tpu_torch as st
    >>> a = st.from_dense(np.array([[1.0, 0.0], [2.0, 3.0]]), device="cpu")
    >>> b = st.from_dense(np.array([[0.0, 4.0], [5.0, 0.0]]), device="cpu")
    >>> st.spgemm(a, b).to_dense().tolist()
    [[0.0, 4.0], [15.0, 8.0]]
    """
    if a.cols != b.rows:
        raise ShapeError(f"spgemm: {a.shape} @ {b.shape}")
    if out_format not in ("csr", "auto", "bsr"):
        raise ValueError(f"unknown spgemm out_format {out_format!r}")
    if method == "dense":
        if out_format in ("auto", "bsr"):
            return spgemm_dense_bsr(a, b, precision=precision)
        return spgemm_dense(a, b, out_cap=out_cap, precision=precision)
    if method not in ("esc", "auto"):
        raise ValueError(f"unknown spgemm method {method!r}")
    if out_format == "bsr":
        from ..formats.bsr import bsr_from_csmat

        c = spgemm(a, b, out_cap=out_cap, prod_cap=prod_cap, check_capacity=check_capacity,
                   sort_batches=sort_batches, method=method, precision=precision,
                   out_format="auto")
        return c if not isinstance(c, CsMat) else bsr_from_csmat(c.to_csr())
    if a.is_csc:
        # (A·B) = (Bᵀ·Aᵀ)ᵀ: the CSR pass, a CSC result ("auto" gives CSR
        # here, as in the JAX package)
        return spgemm(b.T.to_csr(), a.T.to_csr(), out_cap=out_cap, prod_cap=prod_cap,
                      check_capacity=check_capacity, method=method, precision=precision).T
    b = b.to_csr()
    if prod_cap is None:
        exact = _exact_prod_count(a, b)
        if method == "auto":
            m, k = a.shape
            n = b.cols
            itemsize = torch.promote_types(a.dtype, b.dtype).itemsize
            fits = (m * k + k * n + m * n) * itemsize <= dense_bytes_budget(a.device)
            if fits and exact >= AUTO_DENSE_PRODUCTS_PER_MAC * (float(m) * k * n):
                if out_format == "auto":
                    return spgemm_dense_bsr(a, b, precision=precision)
                return spgemm_dense(a, b, out_cap=out_cap, precision=precision)
        budget = chunk_product_budget(a.device)
        if exact > budget:
            return _spgemm_chunked(a, b, budget)
        prod_cap = max(exact, 1)
    if prod_cap > MAX_INDEX:
        raise CapacityError.index_limit(
            "prod_cap", prod_cap,
            hint="leave prod_cap unset (the product is then row-chunked), or "
            "partition A's rows with slice_outer and stitch the results",
        )
    if out_cap is not None and out_cap > MAX_INDEX:
        raise CapacityError.index_limit(
            "out_cap", out_cap,
            hint="a single CsMat holds at most 2^31-1 entries; keep row-block "
            "products as separate matrices via slice_outer",
        )
    cap0 = out_cap if out_cap is not None else prod_cap
    c, total, required = _esc(a, b, prod_cap=prod_cap, out_cap=cap0, sort_batches=sort_batches)
    if check_capacity:
        total, required = torch.stack([total.to(torch.int64), required.to(torch.int64)]).tolist()
        if total > prod_cap:
            raise CapacityError(total, prod_cap)
        if required > cap0:
            raise CapacityError(required, cap0)
        if out_cap is None:
            c = c.with_cap(max(required, 1))
    return c


# ---------------------------------------------------------------------------
# dense route
# ---------------------------------------------------------------------------


def _with_cap_truncating(c: CsMat, cap: int) -> CsMat:
    """Re-cap keeping the first ``cap`` entries (indptr clipped, the tail
    zeroed), as ``from_dense`` truncates."""
    ip = c.indptr.clamp(max=cap).to(INDEX_DTYPE)
    if cap > c.cap:
        idx = torch.cat([c.indices, c.indices.new_zeros(cap - c.cap)])
        dat = torch.cat([c.data, c.data.new_zeros(cap - c.cap)])
    else:
        idx, dat = c.indices[:cap], c.data[:cap]
    live = torch.arange(cap, dtype=INDEX_DTYPE, device=c.device) < ip[-1]
    return CsMat(ip, torch.where(live, idx, 0), torch.where(live, dat, torch.zeros_like(dat)),
                 c.shape, c.storage)


_MATMUL_PRECISION = {"highest": "highest", "high": "high", "default": "high"}


@contextlib.contextmanager
def _matmul_precision(precision: str):
    """torch's float32 matmul precision for the block: ``"highest"`` is
    true float32 (no TF32), ``"default"`` / ``"high"`` allow TF32.  The
    process setting is restored afterwards."""
    if precision not in _MATMUL_PRECISION:
        raise ValueError(f"unknown precision {precision!r}")
    saved = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision(_MATMUL_PRECISION[precision])
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(saved)


def _densify(op) -> torch.Tensor:
    from ..formats.bsr import BsrMat

    return op.to_dense() if isinstance(op, BsrMat) else op.to_csr().to_dense()


def _dense_prod(a, b, precision: str) -> torch.Tensor:
    """Dense A @ B of two sparse operands (CsMat or BsrMat): one
    ``torch.matmul``, accumulating half types in float32."""
    ad, bd = _densify(a), _densify(b)
    out = torch.promote_types(ad.dtype, bd.dtype)
    acc = torch.float32 if out.is_floating_point and out.itemsize < 4 else out
    with _matmul_precision(precision):
        c = torch.matmul(ad.to(acc), bd.to(acc))
    return c.to(out)


def spgemm_dense(
    a: CsMat,
    b: CsMat,
    *,
    eps: float = 0.0,
    out_cap: Optional[int] = None,
    precision: str = "highest",
) -> CsMat:
    """C = A @ B through a dense matrix product, then ``from_dense``.

    The pattern is the numerical one (|c_ij| > eps): an entry whose
    products cancel to exactly zero is dropped, where :func:`spgemm`'s
    ESC keeps it.  ``precision`` as in :func:`spgemm`.  The result is
    tightly packed unless ``out_cap`` is given.  Operands whose dense
    form exceeds :func:`dense_bytes_budget` are chunked: over B's columns
    when dense B alone takes half of it, then over A's rows.
    """
    if a.cols != b.rows:
        raise ShapeError(f"spgemm_dense: {a.shape} @ {b.shape}")
    a = a.to_csr()  # the chunks below slice rows
    m, k = a.shape
    n = b.cols
    itemsize = torch.promote_types(a.dtype, b.dtype).itemsize
    budget = dense_bytes_budget(a.device)
    dense_bytes = (m * k + k * n + m * n) * itemsize
    # a chunk is at least 128 wide; each split fires only if it subdivides
    if k * n * itemsize > budget // 2:
        cols_per = max(int((budget // 2) // (k * itemsize)), 128)
        if cols_per < n:
            from .construct import hstack

            bc = b.to_csc()
            parts = [
                spgemm_dense(a, bc.slice_outer(c0, min(c0 + cols_per, n)), eps=eps,
                             precision=precision)
                for c0 in range(0, n, cols_per)
            ]
            out = hstack(parts).to_csr()
            return out if out_cap is None else _with_cap_truncating(out, out_cap)
    if dense_bytes > budget:
        rows_per = max(int((budget - k * n * itemsize) // ((k + n) * itemsize)), 128)
        if rows_per < m:
            from .construct import vstack

            parts = [
                spgemm_dense(a.slice_outer(r0, min(r0 + rows_per, m)), b, eps=eps,
                             precision=precision)
                for r0 in range(0, m, rows_per)
            ]
            out = vstack(parts)
            return out if out_cap is None else _with_cap_truncating(out, out_cap)
    c = _dense_prod(a, b, precision)
    return from_dense(c, eps=eps, cap=out_cap, device=c.device)


def spgemm_dense_bsr(
    a,
    b,
    *,
    block_size: int = 128,
    eps: float = 0.0,
    precision: str = "highest",
):
    """C = A @ B through a dense product, returned as a
    :class:`~sprs_tpu_torch.formats.bsr.BsrMat`: no per-element
    compaction, only a block mask and one gather of the kept blocks
    (:func:`~sprs_tpu_torch.formats.bsr.bsr_from_dense_device`).  A block
    survives iff it holds an |entry| > eps.  Either operand may be a
    BsrMat.  A-row chunks (aligned to ``block_size``) keep the dense
    operands within :func:`dense_bytes_budget`; a dense B over half of
    it raises :class:`CapacityError` (use :func:`spgemm` there).  The
    result stays on the operands' device; ``BsrMat @ X`` then runs K3.
    """
    from ..formats.bsr import BsrMat, bsr_from_dense_device

    if a.cols != b.rows:
        raise ShapeError(f"spgemm_dense_bsr: {a.shape} @ {b.shape}")
    if isinstance(a, CsMat):
        a = a.to_csr()
    m, k = a.shape
    n = b.cols
    itemsize = torch.promote_types(a.dtype, b.dtype).itemsize
    budget = dense_bytes_budget(a.device)
    if k * n * itemsize > budget // 2:
        raise CapacityError(
            int(k * n * itemsize),
            budget // 2,
            "spgemm_dense_bsr: dense B alone exceeds the byte budget; use spgemm "
            "(ESC/chunked) or chunk B's columns by hand",
        )
    if (m * k + k * n + m * n) * itemsize > budget:
        rows_per = max(int((budget - k * n * itemsize) // ((k + n) * itemsize)), block_size)
        align = block_size
        if isinstance(a, BsrMat):
            align = int(np.lcm(block_size, a.block_size))
        rows_per = max(rows_per - rows_per % align, align)
        if rows_per < m:
            parts = [
                spgemm_dense_bsr(
                    a.slice_block_rows(r0, min(r0 + rows_per, m)) if isinstance(a, BsrMat)
                    else a.slice_outer(r0, min(r0 + rows_per, m)),
                    b, block_size=block_size, eps=eps, precision=precision,
                )
                for r0 in range(0, m, rows_per)
            ]
            brows, off = [], 0
            for p in parts:
                brows.append(p.brows[: p.n_blocks] + off)
                off += -(-p.shape[0] // block_size)
            return BsrMat(
                torch.cat(brows).to(INDEX_DTYPE),
                torch.cat([p.bcols[: p.n_blocks] for p in parts]),
                torch.cat([p.blocks[: p.n_blocks] for p in parts]),
                (m, n),
                sum(p.n_blocks for p in parts),
            )
    return bsr_from_dense_device(_dense_prod(a, b, precision), block_size, eps=eps)
