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
"""

from __future__ import annotations

import numpy as np
import torch

from ..errors import StructureError

INDEX_DTYPE = torch.int32

# Largest value representable by the i32 index type.
MAX_INDEX = 2**31 - 1

# Public constructors place tensors here unless the caller passes
# ``device=``; the default never depends on what hardware is present.
DEFAULT_DEVICE = "cuda"

def np_dtype(dtype) -> np.dtype:
    """numpy dtype for a torch or numpy dtype."""
    if isinstance(dtype, torch.dtype):
        return torch.empty(0, dtype=dtype).numpy().dtype
    return np.dtype(dtype)


def torch_dtype(dtype) -> torch.dtype:
    """torch dtype for a torch or numpy dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.zeros(0, np.dtype(dtype))).dtype


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
