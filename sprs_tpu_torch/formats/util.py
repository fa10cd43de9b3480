"""Shared structural primitives for capacity-padded sparse formats.

The representation discipline of the JAX package (``sprs_tpu/formats/
util.py``): every sparse container carries arrays of capacity
``cap >= nnz``; entries at positions ``>= nnz`` are padding with
``indices == 0`` and ``data == 0``.  Indices are stored as int32 for
parity with the JAX arrays and widened to int64 only where torch's
index ops need it.

Unlike JAX's scatters, torch's ``index_add_`` raises on an out-of-range
index and advanced indexing wraps a negative one, so every consumer of
:func:`row_ids_from_indptr` masks the padding sentinel explicitly.

:func:`csr_spmv_plain` is the plain product of a compressed matrix (the
gather or scatter form of :func:`contributions`, summed by
:func:`index_sum_`), which ``ops/prod.py`` and kernel K7's wrapper share.

:func:`compress_coo` is the shared sort-and-compress primitive: triplet
assembly, ``csmat_from_unsorted`` and the sparse binary ops all run
through it, as in the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from .._span import span
from ..errors import StructureError

INDEX_DTYPE = torch.int32

# Largest value representable by the i32 index type.
MAX_INDEX = 2**31 - 1

# Public constructors place tensors here unless the caller passes
# ``device=``; the default never depends on what hardware is present.
DEFAULT_DEVICE = "cuda"


def index_sum_(out: torch.Tensor, index: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """``out[index[i]] += values[i]`` along dim 0, each slot's values
    added in one fixed order, so two runs give the same bits.  On the CPU
    that order is index order (``index_add_``, which adds serially; the
    CPU's accumulating ``index_put_`` adds float32 on several threads, in
    no fixed order, on large inputs), the JAX package's scatter-add order.
    On a CUDA tensor it is an accumulating ``index_put_``, for which torch
    sorts the slots stably and adds each run of equal slots in an order of
    its own (``index_add_`` adds with atomics there, in no fixed order):
    repeatable, but not the CPU's order, so a slot of several values may
    differ from the CPU's sum in its last bits (on an H100 with 64 values
    a slot, 81 % of the slots did, within 2.6e-7 of the sum in float32,
    5.9e-16 in float64).  The card's CSR products no longer come here:
    they run kernel K7 (``ops/cuda/csr_spmv.py``), which sums each row in
    an order of its own, the same from run to run; the CSC products, the
    SpMMs, the assembly and the backwards still do.  Runs in a
    ``sprs.index_sum`` profiler span.  Returns ``out``."""
    with span("sprs.index_sum"):
        if out.is_cuda:
            return out.index_put_((index,), values, accumulate=True)
        return out.index_add_(0, index, values)


def contributions(mat, x: torch.Tensor):
    """(dst ids, contributions) of every stored slot of the compressed
    matrix ``mat`` times a vector or a (cols, k) matrix ``x``, padding
    masked to row 0 with a zero contribution: the gather form
    ``data * x[indices]`` to the rows for CSR, the scatter form
    ``data * x[col ids]`` to ``indices`` for CSC."""
    outer = mat.outer_ids()
    live = outer < mat.outer_dims
    outer = torch.where(live, outer, torch.zeros_like(outer)).to(torch.int64)
    inner = mat.indices.to(torch.int64)
    src, dst = (inner, outer) if mat.is_csr else (outer, inner)
    xs = x[src] if x.ndim == 1 else x[src, :]
    data = mat.data if x.ndim == 1 else mat.data[:, None]
    live = live if x.ndim == 1 else live[:, None]
    contrib = data * xs
    return dst, torch.where(live, contrib, torch.zeros_like(contrib))


def csr_spmv_plain(mat, x: torch.Tensor) -> torch.Tensor:
    """The plain torch product y = A @ x of a CSR or CSC matrix:
    :func:`contributions` summed by :func:`index_sum_`.  Differentiable by
    torch's autograd.  The CPU's product, and on the card the reference
    of kernel K7 and the product of what K7 does not take; its ``calls``
    attribute counts calls."""
    csr_spmv_plain.calls += 1
    dst, contrib = contributions(mat, x)
    y = torch.zeros(mat.rows, dtype=contrib.dtype, device=contrib.device)
    return index_sum_(y, dst, contrib)


csr_spmv_plain.calls = 0


def is_bf16(dtype) -> bool:
    """Whether ``dtype`` is bfloat16: torch's, or ml_dtypes' as JAX hands
    it out."""
    if isinstance(dtype, torch.dtype):
        return dtype == torch.bfloat16
    return np.dtype(dtype).name == "bfloat16"


def np_dtype(dtype) -> np.dtype:
    """numpy dtype that holds a torch or numpy dtype's values on the host.

    numpy has no bfloat16 of its own: bfloat16 is held as float32, where
    every bfloat16 value is exact, so that the host paths never need
    ml_dtypes."""
    if is_bf16(dtype):
        return np.dtype(np.float32)
    if isinstance(dtype, torch.dtype):
        return torch.empty(0, dtype=dtype).numpy().dtype
    return np.dtype(dtype)


def torch_dtype(dtype) -> torch.dtype:
    """torch dtype for a torch or numpy dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    if is_bf16(dtype):
        return torch.bfloat16
    return torch.from_numpy(np.zeros(0, np.dtype(dtype))).dtype


def host_array(t: torch.Tensor) -> np.ndarray:
    """``t`` as a numpy array on the host (detached).  bfloat16 comes out
    as float32 (:func:`np_dtype`): exact, and ``as_tensor(a,
    dtype=torch.bfloat16)`` gives the tensor back bit for bit."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def as_tensor(arr, *, dtype=None, device=DEFAULT_DEVICE) -> torch.Tensor:
    """Tensor on ``device`` from a numpy array, sequence or tensor."""
    if isinstance(arr, torch.Tensor):
        t = arr
    else:
        a = np.array(arr)  # a copy: the source may be read-only
        if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16, as JAX hands it out
            t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(a)
    return t.to(device=device, dtype=torch_dtype(dtype) if dtype else None)


def round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def check_index_capacity(**named_sizes) -> None:
    """Raise ``StructureError`` when a named size exceeds the i32 index."""
    for name, v in named_sizes.items():
        if v is not None and int(v) > MAX_INDEX:
            raise StructureError.index_overflow(
                f"{name}={int(v)} exceeds the i32 index limit "
                f"{MAX_INDEX}; the i32 index type is not large enough"
            )


def positions(cap: int, device=DEFAULT_DEVICE) -> torch.Tensor:
    """[0, 1, ..., cap-1] as the index dtype."""
    return torch.arange(cap, dtype=INDEX_DTYPE, device=device)


def valid_mask(cap: int, nnz, device=DEFAULT_DEVICE) -> torch.Tensor:
    """Boolean mask of live (non-padding) entry slots."""
    return positions(cap, device) < nnz


def row_ids_from_indptr(indptr: torch.Tensor, cap: int) -> torch.Tensor:
    """Per-entry outer (row) id of a compressed matrix.

    Padding positions (>= indptr[-1]) map to ``n_outer``, one past the
    last row.  Scatter-ones at each row start plus a prefix sum, as in
    the JAX package.  Row starts equal to ``cap`` (trailing empty rows of
    a full matrix) land in one spare slot past the end, which is dropped,
    so no start has to be filtered out on the host.
    """
    device = indptr.device
    starts = indptr[:-1].to(torch.int64)
    seg = torch.zeros(cap + 1, dtype=INDEX_DTYPE, device=device)
    seg.index_add_(0, starts, torch.ones_like(starts, dtype=INDEX_DTYPE))
    ids = torch.cumsum(seg[:cap], 0, dtype=INDEX_DTYPE) - 1
    n_outer = indptr.shape[0] - 1
    return torch.where(
        positions(cap, device) < indptr[-1], ids, torch.full_like(ids, n_outer)
    )


def indptr_from_row_counts(row_counts: torch.Tensor) -> torch.Tensor:
    """Exclusive scan of a per-row count vector: an indptr of length n+1."""
    out = torch.zeros(
        row_counts.shape[0] + 1, dtype=INDEX_DTYPE, device=row_counts.device
    )
    out[1:] = torch.cumsum(row_counts, 0)
    return out


def indptr_from_rows(
    rows: torch.Tensor, unique_valid: torch.Tensor, n_outer: int
) -> torch.Tensor:
    """indptr from the row ids of the live unique entries (``unique_valid``).
    Rows outside [0, n_outer), the padding sentinel ``n_outer`` among them,
    are dropped as JAX's ``mode="drop"`` drops them: they count in one
    spare slot past the end.  The JAX version's ``rows_sorted`` hint has
    no counterpart in torch."""
    rows = rows.to(torch.int64)
    keep = unique_valid & (rows >= 0) & (rows < n_outer)
    counts = torch.zeros(n_outer + 1, dtype=INDEX_DTYPE, device=rows.device)
    counts.index_add_(
        0, torch.where(keep, rows, n_outer), torch.ones_like(rows, dtype=INDEX_DTYPE)
    )
    return indptr_from_row_counts(counts[:n_outer])


class CompressedCoo(NamedTuple):
    """Result of :func:`compress_coo`.

    ``required_nnz`` is the number of unique live entries of the input; if
    it exceeds ``out_cap`` the output holds the first ``out_cap`` of them
    and ``nnz == out_cap``.  Both are 0-d tensors on the input's device.
    """

    indptr: torch.Tensor
    indices: torch.Tensor
    values: Tuple[torch.Tensor, ...]
    nnz: torch.Tensor
    required_nnz: torch.Tensor


def compress_coo(
    rows: torch.Tensor,
    cols: torch.Tensor,
    value_channels: Sequence[torch.Tensor],
    nvalid,
    n_outer: int,
    n_inner: int,
    out_cap: int,
    sort_batches=None,
) -> CompressedCoo:
    """Sort-and-deduplicate COO entries into CSR-ordered arrays.

    Entries at positions >= ``nvalid`` are padding and ignored, as are
    entries whose row is ``n_outer`` or more.  Duplicate (row, col) pairs
    are summed per value channel; the output is sorted by (row, col), so
    each row's column indices ascend.  Several value channels ride one
    sort (the binary ops carry each operand in its own).

    One ``torch.sort`` on an int64 key ``row * n_inner + col``: it holds
    every i32 index space, so the JAX package's i32 / i64 / two-key cases
    are one case here.  The sort is stable, and each group of duplicates
    is summed in input order on the CPU and in one fixed order on the
    card, so a result is the same bits from run to run; the JAX sort is
    unstable, which can change the last bit of a sum of three or more
    duplicates against it.  ``sort_batches`` is accepted
    for the JAX signature and ignored: the JAX package splits its sort
    into segments because one very large ``lax.sort`` crashed the TPU
    worker; the port does one sort.
    """
    del sort_batches
    device = rows.device
    cap = rows.shape[0]
    channels = tuple(value_channels)
    if cap == 0:
        zero = torch.zeros((), dtype=INDEX_DTYPE, device=device)
        return CompressedCoo(
            torch.zeros(n_outer + 1, dtype=INDEX_DTYPE, device=device),
            torch.zeros(out_cap, dtype=INDEX_DTYPE, device=device),
            tuple(torch.zeros(out_cap, dtype=v.dtype, device=device) for v in channels),
            zero,
            zero,
        )
    live = positions(cap, device) < nvalid
    n_inner_c = max(n_inner, 1)
    # Padding packs to the sentinel key n_outer·n_inner, which sorts after
    # every live key; so does a live entry of row n_outer (a padding slot
    # of a CsMat operand, whose outer id is the sentinel row).
    sentinel = n_outer * n_inner_c
    key = torch.where(
        live,
        rows.to(torch.int64) * n_inner_c + cols.to(torch.int64),
        torch.full((cap,), sentinel, dtype=torch.int64, device=device),
    )
    key, order = torch.sort(key, stable=True)
    vals = [torch.where(live, v, torch.zeros((), dtype=v.dtype, device=device))[order]
            for v in channels]
    first = torch.ones(cap, dtype=torch.bool, device=device)
    first[1:] = key[1:] != key[:-1]
    unique = first & (key < sentinel)
    gid = torch.cumsum(unique, 0) - 1
    required = gid[-1] + 1
    # Padding follows the last group (or precedes the first, gid -1 → 0);
    # it adds zeros there and loses every min against a live key.
    gid = gid.clamp(min=0)
    slot = torch.where(gid < out_cap, gid, out_cap)  # out_cap: dropped
    nnz = required.clamp(max=out_cap)
    key_out = torch.full(
        (out_cap + 1,), torch.iinfo(torch.int64).max, dtype=torch.int64, device=device
    ).scatter_reduce_(0, slot, key, "amin")[:out_cap]
    valid = positions(out_cap, device) < nnz
    r_out = key_out // n_inner_c
    indices = torch.where(valid, key_out - r_out * n_inner_c, 0).to(INDEX_DTYPE)
    # each slot's duplicates summed in one fixed order (index_sum_)
    values = tuple(
        index_sum_(torch.zeros(out_cap + 1, dtype=v.dtype, device=device), slot, v)[:out_cap]
        for v in vals
    )
    return CompressedCoo(
        indptr_from_rows(r_out, valid, n_outer),
        indices,
        values,
        nnz.to(INDEX_DTYPE),
        required.to(INDEX_DTYPE),
    )


def prune_channel(values: torch.Tensor, nnz, *, pad_value=0) -> torch.Tensor:
    """Set the padding positions (>= ``nnz``) of a capacity-padded channel
    to ``pad_value``."""
    live = valid_mask(values.shape[0], nnz, values.device)
    return torch.where(live, values, torch.tensor(pad_value, dtype=values.dtype,
                                                  device=values.device))
