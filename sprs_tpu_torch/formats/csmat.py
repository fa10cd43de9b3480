"""Compressed sparse matrix (CSR/CSC) as a capacity-padded dataclass.

The PyTorch counterpart of ``sprs_tpu/formats/csmat.py``: the same
``indptr / indices / data`` layout with a static capacity, live entries
in the first ``nnz = indptr[-1]`` slots and padding ``indices == 0,
data == 0``, so that arrays compare one for one with the JAX package.
Transpose is metadata (the storage flag flips).  This module carries
the subset of ``CsMat`` that the ported slices need, with the elementwise
methods and the ``+ - *`` operators (``ops/binop.py``); the rest of the
JAX class is listed in ROADMAP.md.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..errors import ShapeError, StructureError
from .util import (
    DEFAULT_DEVICE,
    INDEX_DTYPE,
    as_tensor,
    check_index_capacity,
    compress_coo,
    positions,
    row_ids_from_indptr,
    torch_dtype,
    valid_mask,
)

CSR = "csr"
CSC = "csc"


@dataclasses.dataclass(frozen=True)
class CsMat:
    """A CSR or CSC matrix.

    ``indptr (n_outer+1,) i32``, ``indices (cap,) i32``, ``data (cap,)``,
    all on one device; ``shape`` and ``storage`` are plain Python values.
    """

    indptr: torch.Tensor
    indices: torch.Tensor
    data: torch.Tensor
    shape: Tuple[int, int]
    storage: str

    # -- basic properties ------------------------------------------------
    @property
    def rows(self) -> int:
        return self.shape[0]

    @property
    def cols(self) -> int:
        return self.shape[1]

    @property
    def is_csr(self) -> bool:
        return self.storage == CSR

    @property
    def is_csc(self) -> bool:
        return self.storage == CSC

    @property
    def outer_dims(self) -> int:
        return self.shape[0] if self.is_csr else self.shape[1]

    @property
    def inner_dims(self) -> int:
        return self.shape[1] if self.is_csr else self.shape[0]

    @property
    def cap(self) -> int:
        return self.indices.shape[0]

    @property
    def nnz(self) -> int:
        """Live entry count (reads ``indptr[-1]`` back to the host)."""
        return int(self.indptr[-1])

    @property
    def dtype(self) -> torch.dtype:
        return self.data.dtype

    @property
    def device(self) -> torch.device:
        return self.data.device

    # -- structural helpers ----------------------------------------------
    def outer_ids(self) -> torch.Tensor:
        """Per-entry outer index (row id for CSR); padding maps to
        ``outer_dims``, one past the last."""
        return row_ids_from_indptr(self.indptr, self.cap)

    def live_mask(self) -> torch.Tensor:
        return valid_mask(self.cap, self.indptr[-1], self.device)

    def outer_nnz(self) -> torch.Tensor:
        return self.indptr[1:] - self.indptr[:-1]

    def max_outer_nnz(self) -> int:
        if self.outer_dims == 0:
            return 0
        return int(self.outer_nnz().max())

    # -- transpose / storage conversion ----------------------------------
    @property
    def T(self) -> "CsMat":
        """O(1) transpose by flipping the storage flag."""
        return CsMat(
            self.indptr,
            self.indices,
            self.data,
            (self.shape[1], self.shape[0]),
            CSC if self.is_csr else CSR,
        )

    def to_other_storage(self) -> "CsMat":
        """Re-sort the live entries into the opposite storage order.

        A valid matrix has no duplicate entries, so one stable sort by
        (new outer, new inner) gives the arrays the JAX package's
        sort-and-compress produces, capacity and padding included.
        """
        nnz = self.nnz
        outer = self.outer_ids()[:nnz].to(torch.int64)
        inner = self.indices[:nnz].to(torch.int64)
        order = torch.argsort(
            inner * max(self.outer_dims, 1) + outer, stable=True
        )
        counts = torch.bincount(inner, minlength=self.inner_dims)
        indptr = torch.zeros(
            self.inner_dims + 1, dtype=INDEX_DTYPE, device=self.device
        )
        indptr[1:] = torch.cumsum(counts, 0)
        indices = torch.zeros_like(self.indices)
        indices[:nnz] = outer[order].to(INDEX_DTYPE)
        data = torch.zeros_like(self.data)
        data[:nnz] = self.data[:nnz][order]
        return CsMat(
            indptr, indices, data, self.shape, CSC if self.is_csr else CSR
        )

    def to_csr(self) -> "CsMat":
        return self if self.is_csr else self.to_other_storage()

    def to_csc(self) -> "CsMat":
        return self if self.is_csc else self.to_other_storage()

    # -- conversions -------------------------------------------------------
    def to_dense(self) -> torch.Tensor:
        nnz = self.nnz
        out = torch.zeros(
            (self.outer_dims, self.inner_dims),
            dtype=self.dtype,
            device=self.device,
        )
        out.index_put_(
            (
                self.outer_ids()[:nnz].to(torch.int64),
                self.indices[:nnz].to(torch.int64),
            ),
            self.data[:nnz],
            accumulate=True,
        )
        return out if self.is_csr else out.T

    def to_ell(self, *, width: Optional[int] = None):
        """Convert to the padded-row ELL layout (formats/ell.py)."""
        from .ell import ell_from_csmat

        return ell_from_csmat(self.to_csr(), width=width)

    def to_dia(self, *, max_diags: Optional[int] = None):
        """Convert to diagonal storage for banded SpMV (formats/dia.py)."""
        from .dia import dia_from_csmat

        return dia_from_csmat(self, max_diags=max_diags)

    def to_bsr(self, block_size: int = 128):
        """Convert to the block-sparse layout (formats/bsr.py)."""
        from .bsr import bsr_from_csmat

        return bsr_from_csmat(self, block_size)

    # -- elementwise -------------------------------------------------------
    def map(self, fn) -> "CsMat":
        """Apply ``fn`` to every live entry; padding stays zero.  Only stored
        entries are touched: ``fn(0) != 0`` does not densify."""
        new = fn(self.data)
        return self.with_data(torch.where(self.live_mask(), new, torch.zeros_like(new)))

    def with_data(self, data: torch.Tensor) -> "CsMat":
        if data.shape != self.data.shape:
            raise ShapeError(
                f"data must keep capacity {tuple(self.data.shape)}, got {tuple(data.shape)}"
            )
        return CsMat(self.indptr, self.indices, data, self.shape, self.storage)

    def astype(self, dtype) -> "CsMat":
        return self.with_data(self.data.to(torch_dtype(dtype)))

    def scale(self, alpha) -> "CsMat":
        return self.map(lambda d: d * alpha)

    def __neg__(self) -> "CsMat":
        return self.map(torch.neg)

    def with_cap(self, new_cap: int) -> "CsMat":
        """Re-pad to a new capacity; shrinking below nnz raises."""
        if new_cap == self.cap:
            return self
        if new_cap < self.nnz:
            raise StructureError.size_mismatch(f"cannot shrink cap below nnz={self.nnz}")
        if new_cap > self.cap:
            indices = _pad_to_cap(self.indices, new_cap)
            data = _pad_to_cap(self.data, new_cap)
        else:
            indices, data = self.indices[:new_cap], self.data[:new_cap]
        return CsMat(self.indptr, indices, data, self.shape, self.storage)

    # -- queries -----------------------------------------------------------
    def diag(self) -> torch.Tensor:
        """Dense main diagonal of length min(rows, cols)."""
        k = min(self.shape)
        outer = self.outer_ids()
        on_diag = (outer == self.indices) & self.live_mask()
        idx = torch.where(on_diag, outer, torch.full_like(outer, k))
        out = torch.zeros(k + 1, dtype=self.dtype, device=self.device)
        out.index_add_(0, idx.to(torch.int64), self.data * on_diag)
        return out[:k]

    def norm(self, ord="fro") -> torch.Tensor:
        """Matrix norm over the stored values (scipy.sparse.linalg.norm
        parity): 'fro', 1 (largest column abs-sum), inf (largest row
        abs-sum) or 'max' (largest |entry|).  Padding is zero.

        >>> import numpy as np
        >>> from sprs_tpu_torch import from_dense
        >>> m = from_dense(np.array([[1.0, -2.0], [0.0, 3.0]]), device="cpu")
        >>> [float(m.norm(o)) for o in (1, np.inf, "max")]
        [5.0, 3.0, 3.0]
        """
        a = self.data.abs()
        if ord == "fro":
            return torch.sqrt((a * a).sum())
        if ord == "max":
            return a.max()
        if ord in (1, np.inf, "inf"):
            outer = self.outer_ids().to(torch.int64)
            # padding slots carry outer id outer_dims and data 0: send
            # them to 0, where they add nothing
            outer = torch.where(outer < self.outer_dims, outer, 0)
            inner = self.indices.to(torch.int64)
            rows_like, cols_like = (outer, inner) if self.is_csr else (inner, outer)
            ids, n = (cols_like, self.cols) if ord == 1 else (rows_like, self.rows)
            sums = torch.zeros(n, dtype=a.dtype, device=a.device)
            return sums.index_add_(0, ids, a).max()
        raise ValueError(f"unsupported norm ord {ord!r}")

    # -- validation --------------------------------------------------------
    def check_structure(self) -> "CsMat":
        """Host-side invariant check; raises StructureError, returns self."""
        indptr = self.indptr.cpu().numpy()
        indices = self.indices.cpu().numpy()
        n_outer, n_inner = self.outer_dims, self.inner_dims
        if indptr.shape != (n_outer + 1,):
            raise StructureError.size_mismatch(
                f"indptr length {indptr.shape[0]} != outer_dims+1 {n_outer + 1}"
            )
        if self.indices.shape != self.data.shape:
            raise StructureError.size_mismatch(
                "indices and data capacity differ"
            )
        if indptr[0] != 0:
            raise StructureError.out_of_range("indptr[0] must be 0")
        if np.any(np.diff(indptr) < 0):
            raise StructureError.unsorted("indptr must be monotone")
        nnz = int(indptr[-1])
        if nnz > self.cap:
            raise StructureError.size_mismatch(
                f"nnz {nnz} exceeds capacity {self.cap}"
            )
        live_idx = indices[:nnz].astype(np.int64)
        if nnz and (live_idx.min() < 0 or live_idx.max() >= max(n_inner, 1)):
            raise StructureError.out_of_range("inner index out of range")
        row = np.repeat(np.arange(n_outer), np.diff(indptr))
        same_row = row[1:] == row[:-1]
        bad = same_row & (np.diff(live_idx) <= 0)
        if np.any(bad):
            o = int(row[1:][bad][0])
            raise StructureError.unsorted(
                f"indices in outer dim {o} not strictly increasing"
            )
        return self

    # -- operators ---------------------------------------------------------
    def __matmul__(self, other):
        from ..ops import matmul

        return matmul(self, other)

    def __rmatmul__(self, other):
        from ..ops import rmatmul

        return rmatmul(other, self)

    def __add__(self, other):
        from ..ops import add

        return add(self, other)

    __radd__ = __add__

    def __sub__(self, other):
        from ..ops import sub

        return sub(self, other)

    def __rsub__(self, other):
        from ..ops import sub

        return sub(other, self)

    def __mul__(self, other):
        from ..ops import elementwise_mul

        return elementwise_mul(self, other)

    __rmul__ = __mul__

    def __repr__(self):
        return (
            f"CsMat(shape={self.shape}, storage={self.storage}, "
            f"nnz={self.nnz}, cap={self.cap}, dtype={self.dtype}, "
            f"device={self.device})"
        )


# ---------------------------------------------------------------------------
# Constructors
# ---------------------------------------------------------------------------


def _pad_to_cap(arr: torch.Tensor, cap: int) -> torch.Tensor:
    n = arr.shape[0]
    if n > cap:
        raise StructureError.size_mismatch(f"nnz {n} exceeds cap {cap}")
    if n == cap:
        return arr
    return torch.cat([arr, arr.new_zeros(cap - n)])


def csmat(
    shape: Tuple[int, int],
    indptr,
    indices,
    data,
    *,
    storage: str = CSR,
    cap: Optional[int] = None,
    validate: bool = True,
    device=DEFAULT_DEVICE,
) -> CsMat:
    """Build a CsMat from raw compressed arrays on ``device``.

    Arrays may be shorter than ``cap``; they are zero-padded.  With
    ``validate=True`` the structural invariants are checked eagerly.
    """
    check_index_capacity(rows=shape[0], cols=shape[1], cap=cap)
    indices = as_tensor(indices, dtype=INDEX_DTYPE, device=device)
    data = as_tensor(data, device=device)
    if cap is None:
        cap = max(int(indices.shape[0]), 1)
    m = CsMat(
        as_tensor(indptr, dtype=INDEX_DTYPE, device=device),
        _pad_to_cap(indices, cap),
        _pad_to_cap(data, cap),
        tuple(int(s) for s in shape),
        storage,
    )
    if validate:
        m.check_structure()
    return m


def from_dense(
    arr,
    *,
    eps: float = 0.0,
    storage: str = CSR,
    cap: Optional[int] = None,
    device=DEFAULT_DEVICE,
) -> CsMat:
    """Threshold conversion: entries with |a_ij| > eps are kept.

    The capacity defaults to the exact nnz; a smaller ``cap`` keeps the
    first ``cap`` entries in storage order, as the JAX package does.

    >>> import numpy as np
    >>> from sprs_tpu_torch import from_dense
    >>> m = from_dense(np.array([[0.0, 2.0], [3.0, 0.0]]), device="cpu")
    >>> m.nnz
    2
    >>> m.to_dense().tolist()
    [[0.0, 2.0], [3.0, 0.0]]
    """
    a = as_tensor(arr, device=device)
    if a.ndim != 2:
        raise ShapeError("from_dense expects a 2-D array")
    r, c = a.shape
    a = a if storage == CSR else a.T
    keep = a.abs() > eps
    counts = keep.sum(1)
    total = int(counts.sum())
    if cap is None:
        cap = max(total, 1)
    n = min(total, cap)
    indices = torch.zeros(cap, dtype=INDEX_DTYPE, device=a.device)
    indices[:n] = keep.nonzero()[:n, 1].to(INDEX_DTYPE)
    data = torch.zeros(cap, dtype=a.dtype, device=a.device)
    data[:n] = a[keep][:n]
    indptr = torch.zeros(a.shape[0] + 1, dtype=torch.int64, device=a.device)
    indptr[1:] = torch.cumsum(counts, 0)
    return CsMat(
        indptr.clamp(max=n).to(INDEX_DTYPE),
        indices,
        data,
        (int(r), int(c)),
        storage,
    )


def csmat_from_unsorted(
    shape: Tuple[int, int],
    indptr,
    indices,
    data,
    *,
    storage: str = CSR,
    cap: Optional[int] = None,
    device=DEFAULT_DEVICE,
) -> CsMat:
    """Build a CsMat from compressed arrays whose indices within an outer
    dimension are in any order; duplicates are summed, as triplets are."""
    raw = csmat(
        shape, indptr, indices, data, storage=storage, cap=cap, validate=False, device=device
    )
    res = compress_coo(
        raw.outer_ids(),
        raw.indices,
        (raw.data,),
        raw.indptr[-1],
        raw.outer_dims,
        raw.inner_dims,
        raw.cap,
    )
    return CsMat(res.indptr, res.indices, res.values[0], raw.shape, storage)


def eye(
    n: int,
    dtype=torch.float32,
    *,
    storage: str = CSR,
    cap: Optional[int] = None,
    device=DEFAULT_DEVICE,
) -> CsMat:
    """The n×n identity; a ``cap`` above n adds padding slots."""
    check_index_capacity(n=n, cap=cap)
    cap = cap or max(n, 1)
    idx = positions(cap, device)
    live = idx < n
    return CsMat(
        positions(n + 1, device),
        torch.where(live, idx, 0),
        live.to(torch_dtype(dtype)),
        (n, n),
        storage,
    )
