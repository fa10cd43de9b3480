"""Compressed sparse matrix (CSR/CSC) as a capacity-padded dataclass.

The PyTorch counterpart of ``sprs_tpu/formats/csmat.py``: the same
``indptr / indices / data`` layout with a static capacity, live entries
in the first ``nnz = indptr[-1]`` slots and padding ``indices == 0,
data == 0``, so that arrays compare one for one with the JAX package.
Transpose is metadata (the storage flag flips).

Methods that the JAX package marks host-only (``insert``,
``append_outer``, ``modify``, ``row``, ``outer_vectors``, ``to_scipy``)
copy arrays to the host here too; every other method stays on the
matrix's device.  Where the JAX package sizes a result from a concrete
count (``slice_outer``, ``compact``), the port reads that count back as
one scalar: every port tensor is concrete.
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
    host_array,
    index_sum_,
    indptr_from_row_counts,
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

    @property
    def density(self) -> float:
        r, c = self.shape
        if r == 0 or c == 0:
            return 0.0
        return float(self.nnz) / (r * c)

    # -- structural helpers ----------------------------------------------
    def outer_ids(self) -> torch.Tensor:
        """Per-entry outer index (row id for CSR); padding maps to
        ``outer_dims``, one past the last."""
        return row_ids_from_indptr(self.indptr, self.cap)

    def live_mask(self) -> torch.Tensor:
        return valid_mask(self.cap, self.indptr[-1], self.device)

    def coo_arrays(self):
        """(row_ids, col_ids, data) in matrix orientation (not storage);
        padding carries the outer sentinel ``outer_dims``."""
        outer = self.outer_ids()
        if self.is_csr:
            return outer, self.indices, self.data
        return self.indices, outer, self.data

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

    def to_scipy(self):
        """Host-side scipy.sparse twin (for tests and interop).

        A bfloat16 matrix gives ml_dtypes' bfloat16 data, as the JAX
        package does: this is the one function of the package that
        imports ml_dtypes, and only for bfloat16."""
        import scipy.sparse as sp

        nnz = self.nnz
        data = self.data[:nnz].detach().cpu()
        if data.dtype == torch.bfloat16:
            import ml_dtypes

            data = data.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        else:
            data = data.numpy()
        klass = sp.csr_matrix if self.is_csr else sp.csc_matrix
        return klass(
            (data, self.indices[:nnz].cpu().numpy(), self.indptr.cpu().numpy()),
            shape=self.shape,
        )

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

    def compact(self, out_cap: Optional[int] = None) -> "CsMat":
        """Drop stored zeros; the capacity defaults to the count kept (one
        scalar read back).  Kept entries keep their order."""
        keep = self.live_mask() & (self.data != 0)
        outer = torch.where(keep, self.outer_ids(), self.outer_dims).to(torch.int64)
        order = torch.argsort((~keep).to(torch.uint8), stable=True)
        new_nnz = keep.sum()
        if out_cap is None:
            out_cap = max(int(new_nnz), 1)
        pos = positions(out_cap, self.device)
        perm = order[pos.clamp(max=self.cap - 1).to(torch.int64)]
        live = pos < new_nnz
        counts = torch.zeros(self.outer_dims + 1, dtype=INDEX_DTYPE, device=self.device)
        counts.index_add_(0, outer, keep.to(INDEX_DTYPE))
        data = self.data[perm]
        return CsMat(
            indptr_from_row_counts(counts[: self.outer_dims]),
            torch.where(live, self.indices[perm], 0),
            torch.where(live, data, torch.zeros_like(data)),
            self.shape,
            self.storage,
        )

    def slice_outer(self, start: int, stop: int) -> "CsMat":
        """Outer-dimension slice ``[start, stop)`` as a new matrix whose
        capacity is the slice's own entry count (two scalars read back)."""
        if not (0 <= start <= stop <= self.outer_dims):
            raise ShapeError(
                f"slice [{start}:{stop}) out of range for {self.outer_dims}"
            )
        lo, hi = (int(v) for v in self.indptr[[start, stop]].tolist())
        out_cap = max(hi - lo, 1)
        shape = (stop - start, self.shape[1]) if self.is_csr else (self.shape[0], stop - start)
        return CsMat(
            self.indptr[start : stop + 1] - lo,
            _pad_to_cap(self.indices[lo:hi], out_cap),
            _pad_to_cap(self.data[lo:hi], out_cap),
            shape,
            self.storage,
        )

    def outer_blocks(self, block_size: int):
        """Iterate ``(start, CsMat)`` outer-dimension chunks."""
        for start in range(0, self.outer_dims, block_size):
            yield start, self.slice_outer(start, min(start + block_size, self.outer_dims))

    # -- host-side editing ---------------------------------------------------
    def _host_arrays(self):
        """(indptr, indices, data) as numpy; bfloat16 data as float32
        (``host_array``)."""
        nnz = self.nnz
        return (
            self.indptr.cpu().numpy().copy(),
            self.indices[:nnz].cpu().numpy(),
            host_array(self.data[:nnz]),
        )

    def insert(self, row: int, col: int, value) -> "CsMat":
        """A new matrix with (row, col) set to ``value``, overwriting a
        stored entry; host-side, capacity grows by one for a new entry."""
        if not (0 <= row < self.shape[0] and 0 <= col < self.shape[1]):
            raise ShapeError(f"insert({row}, {col}) out of {self.shape}")
        o, i = (row, col) if self.is_csr else (col, row)
        indptr, indices, data = self._host_arrays()
        lo, hi = int(indptr[o]), int(indptr[o + 1])
        pos = lo + int(np.searchsorted(indices[lo:hi], i))
        if pos < hi and indices[pos] == i:
            data = data.copy()
            data[pos] = value
        else:
            indices = np.insert(indices, pos, i)
            data = np.insert(data, pos, value)
            indptr[o + 1 :] += 1
        data = as_tensor(data, dtype=self.dtype, device="cpu")
        return csmat(self.shape, indptr, indices, data, storage=self.storage,
                     validate=False, device=self.device)

    def append_outer(self, dense_row) -> "CsMat":
        """Append one outer dimension from a dense vector (host-side)."""
        dense_row = np.asarray(dense_row)
        if dense_row.shape != (self.inner_dims,):
            raise ShapeError(
                f"append_outer expects ({self.inner_dims},), got {dense_row.shape}"
            )
        nz = np.nonzero(dense_row)[0]
        indptr, indices, data = self._host_arrays()
        nnz = int(indptr[-1])
        shape = (
            (self.shape[0] + 1, self.shape[1])
            if self.is_csr
            else (self.shape[0], self.shape[1] + 1)
        )
        return csmat(
            shape,
            np.concatenate([indptr, [nnz + nz.size]]),
            np.concatenate([indices, nz]),
            np.concatenate([data, dense_row[nz]]),
            storage=self.storage,
            validate=False,
            device=self.device,
        )

    def modify(self, fn) -> "CsMat":
        """Rebuild through ``fn(indptr, indices, data) -> (indptr,
        indices, data)`` and check the invariants again (host-side)."""
        new_indptr, new_indices, new_data = fn(self.indptr, self.indices, self.data)
        out = CsMat(
            as_tensor(new_indptr, dtype=INDEX_DTYPE, device=self.device),
            as_tensor(new_indices, dtype=INDEX_DTYPE, device=self.device),
            as_tensor(new_data, device=self.device),
            self.shape,
            self.storage,
        )
        out.check_structure()
        return out

    # -- queries -----------------------------------------------------------
    def degrees(self) -> torch.Tensor:
        """Per-outer-dim entry count, the diagonal excluded."""
        outer = self.outer_ids()
        off_diag = (outer != self.indices) & self.live_mask()
        counts = torch.zeros(self.outer_dims + 1, dtype=INDEX_DTYPE, device=self.device)
        return counts.index_add_(0, outer.to(torch.int64), off_diag.to(INDEX_DTYPE))[:-1]

    def sum(self, axis: Optional[int] = None) -> torch.Tensor:
        """Sum of stored values: total (``axis=None``), per row
        (``axis=1``) or per column (``axis=0``)."""
        if axis is None:
            return self.data.sum()
        if axis not in (0, 1):
            raise ValueError(f"sum axis must be None, 0 or 1; got {axis}")
        rows_like, cols_like, _ = self.coo_arrays()
        ids = rows_like if axis == 1 else cols_like
        n = self.rows if axis == 1 else self.cols
        # padding's outer sentinel lands in the spare slot n; each slot
        # summed in one fixed order (util.index_sum_)
        out = torch.zeros(n + 1, dtype=self.dtype, device=self.device)
        return index_sum_(out, ids.to(torch.int64), self.data)[:n]

    def mean(self, axis: Optional[int] = None) -> torch.Tensor:
        """Mean over the full dense extent (scipy semantics: zeros count)."""
        total = self.sum(axis)
        if axis is None:
            return total / (self.rows * self.cols)
        return total / (self.cols if axis == 1 else self.rows)

    def to_inner_onehot(self) -> "CsMat":
        """One entry of value 1 per populated outer vector, at the inner
        index of its largest stored value compared in float32 (NaNs
        ignored; ties take the first).  Capacity ``outer_dims``."""
        n_outer = self.outer_dims
        outer = self.outer_ids().to(torch.int64)
        ok = self.live_mask() & ~torch.isnan(self.data)
        vals = torch.where(ok, self.data.to(torch.float32), float("-inf"))
        best = torch.full((n_outer + 1,), float("-inf"), device=self.device)
        best.scatter_reduce_(0, outer, vals, "amax")
        pos = positions(self.cap, self.device)
        is_best = ok & (vals == best[outer.clamp(max=max(n_outer - 1, 0))])
        first = torch.full((n_outer + 1,), self.cap, dtype=INDEX_DTYPE, device=self.device)
        first.scatter_reduce_(0, outer, torch.where(is_best, pos, self.cap), "amin")
        first = first[:n_outer]
        has = first < self.cap
        hot_inner = torch.where(has, self.indices[first.clamp(max=self.cap - 1).to(torch.int64)], 0)
        indptr = indptr_from_row_counts(has.to(INDEX_DTYPE))
        dst = torch.where(has, indptr[:-1], n_outer).to(torch.int64)
        cap_out = max(n_outer, 1)
        new_indices = torch.zeros(cap_out + 1, dtype=INDEX_DTYPE, device=self.device)
        new_indices[dst] = hot_inner
        new_data = torch.zeros(cap_out + 1, dtype=self.dtype, device=self.device)
        new_data[dst] = 1
        return CsMat(indptr, new_indices[:cap_out], new_data[:cap_out], self.shape, self.storage)

    def _hit(self, row: int, col: int) -> torch.Tensor:
        """Mask of the storage slot of (row, col) (all false if absent)."""
        i, j = (row, col) if self.is_csr else (col, row)
        pos = positions(self.cap, self.device)
        return (pos >= self.indptr[i]) & (pos < self.indptr[i + 1]) & (self.indices == j)

    def get(self, row: int, col: int) -> torch.Tensor:
        """Value at (row, col), 0 if not stored: a masked reduction over
        the slots, on the device."""
        hit = self._hit(row, col)
        return torch.where(hit, self.data, torch.zeros_like(self.data)).sum().to(self.dtype)

    def __getitem__(self, key):
        if isinstance(key, tuple) and len(key) == 2:
            return self.get(*key)
        raise TypeError("CsMat supports mat[i, j] indexing only")

    def nnz_index(self, row: int, col: int) -> torch.Tensor:
        """Storage slot of entry (row, col) as an int32 scalar, -1 if
        absent."""
        hit = self._hit(row, col)
        return torch.where(
            hit.any(),
            torch.argmax(hit.to(torch.uint8)).to(INDEX_DTYPE),
            torch.tensor(-1, dtype=INDEX_DTYPE, device=self.device),
        )

    def structure_view(self) -> "CsMat":
        """Pattern-only twin with data 1 (int8) on live slots."""
        return CsMat(self.indptr, self.indices, self.live_mask().to(torch.int8),
                     self.shape, self.storage)
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
            return index_sum_(sums, ids, a).max()
        raise ValueError(f"unsupported norm ord {ord!r}")

    def tril(self, k: int = 0) -> "CsMat":
        """Lower triangle at and below diagonal ``k`` (scipy.sparse.tril);
        the capacity stays, the entries above become padding."""
        return self._tri_filter(lower=True, k=k)

    def triu(self, k: int = 0) -> "CsMat":
        """Upper triangle at and above diagonal ``k``."""
        return self._tri_filter(lower=False, k=k)

    def _tri_filter(self, *, lower: bool, k: int) -> "CsMat":
        rows_like, cols_like, _ = self.coo_arrays()
        diagk = cols_like - rows_like
        keep = ((diagk <= k) if lower else (diagk >= k)) & self.live_mask()
        res = compress_coo(
            torch.where(keep, rows_like, self.rows),
            torch.where(keep, cols_like, 0),
            (torch.where(keep, self.data, torch.zeros_like(self.data)),),
            self.cap,
            self.rows,
            self.cols,
            self.cap,
        )
        out = CsMat(res.indptr, res.indices, res.values[0], self.shape, CSR)
        return out if self.is_csr else out.to_csc()

    def multiply(self, other) -> "CsMat":
        """Elementwise (Hadamard) product: the scipy.sparse name of ``*``."""
        from ..ops import elementwise_mul

        return elementwise_mul(self, other)

    def maximum(self, other: "CsMat") -> "CsMat":
        from ..ops import maximum

        return maximum(self, other)

    def minimum(self, other: "CsMat") -> "CsMat":
        from ..ops import minimum

        return minimum(self, other)

    def __truediv__(self, other):
        if isinstance(other, CsMat):
            raise TypeError("sparse / sparse is not defined (densifies)")
        return self.map(lambda d: d / other)

    def allclose(self, other: "CsMat", *, rtol: float = 1e-7, atol: float = 1e-12) -> bool:
        """Same shape and dense values within tolerance, whatever the
        storage or pattern (host-side)."""
        if self.shape != other.shape:
            return False
        return bool(np.allclose(host_array(self.to_dense()), host_array(other.to_dense()),
                                rtol=rtol, atol=atol))

    # -- sparse vectors ------------------------------------------------------
    def row(self, i: int):
        """Row ``i`` as a CsVec (host-side bounds; converts to CSR)."""
        m = self.to_csr()
        if not (0 <= i < m.rows):
            raise ShapeError(f"row {i} out of range for {m.shape}")
        lo, hi = (int(v) for v in m.indptr[[i, i + 1]].tolist())
        return m._outer_vector(lo, hi)

    def col(self, j: int):
        """Column ``j`` as a CsVec."""
        return self.T.row(j)

    def outer_vectors(self):
        """Iterate ``(outer_index, CsVec)`` over the outer dimensions."""
        indptr = self.indptr.cpu().numpy()
        for o in range(self.outer_dims):
            yield o, self._outer_vector(int(indptr[o]), int(indptr[o + 1]))

    def _outer_vector(self, lo: int, hi: int):
        from .csvec import CsVec

        n = hi - lo
        idx = self.indices[lo:hi] if n else self.indices.new_zeros(1)
        dat = self.data[lo:hi] if n else self.data.new_zeros(1)
        return CsVec(idx, dat, torch.tensor(n, dtype=INDEX_DTYPE, device=self.device),
                     self.inner_dims)

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


def csr(shape, indptr, indices, data, **kw) -> CsMat:
    return csmat(shape, indptr, indices, data, storage=CSR, **kw)


def csc(shape, indptr, indices, data, **kw) -> CsMat:
    return csmat(shape, indptr, indices, data, storage=CSC, **kw)


def empty(
    shape: Tuple[int, int],
    dtype=torch.float32,
    *,
    storage: str = CSR,
    cap: int = 1,
    device=DEFAULT_DEVICE,
) -> CsMat:
    """A matrix with no entries and ``cap`` padding slots."""
    check_index_capacity(rows=shape[0], cols=shape[1], cap=cap)
    n_outer = shape[0] if storage == CSR else shape[1]
    return CsMat(
        torch.zeros(n_outer + 1, dtype=INDEX_DTYPE, device=device),
        torch.zeros(cap, dtype=INDEX_DTYPE, device=device),
        torch.zeros(cap, dtype=torch_dtype(dtype), device=device),
        tuple(int(s) for s in shape),
        storage,
    )


def diag_csmat(values, *, storage: str = CSR, device=DEFAULT_DEVICE) -> CsMat:
    """Square diagonal matrix from a dense vector."""
    values = as_tensor(values, device=device)
    return eye(values.shape[0], values.dtype, storage=storage, device=values.device).with_data(values)


def diags(diagonals, offsets, shape=None, *, storage: str = CSR, device=DEFAULT_DEVICE) -> CsMat:
    """A matrix from its diagonals (scipy.sparse.diags): ``diagonals[k]``
    fills diagonal ``offsets[k]``, as a scalar broadcast along it or a 1-D
    array exactly as long as it.  ``shape`` defaults to the square size
    the longest diagonal implies.  Host-side construction."""
    offsets = [int(o) for o in np.atleast_1d(offsets)]
    diagonals = [np.atleast_1d(np.asarray(d)) for d in diagonals]
    if len(diagonals) != len(offsets):
        raise ShapeError(f"diags: {len(diagonals)} diagonals vs {len(offsets)} offsets")
    if shape is None:
        n = max(
            d.shape[0] + abs(o) if d.shape[0] > 1 else abs(o) + 1
            for d, o in zip(diagonals, offsets)
        )
        shape = (n, n)
    rows_n, cols_n = shape
    rs, cs, vs = [], [], []
    for d, o in zip(diagonals, offsets):
        length = min(rows_n + min(o, 0), cols_n - max(o, 0))
        if length <= 0:
            raise ShapeError(f"diags: offset {o} out of range for shape {shape}")
        if d.shape[0] == 1:
            vals = np.broadcast_to(d, (length,))
        elif d.shape[0] == length:
            vals = d
        else:
            raise ShapeError(
                f"diags: diagonal at offset {o} has length {d.shape[0]}, expected {length}"
            )
        r = np.arange(max(0, -o), max(0, -o) + length)
        rs.append(r)
        cs.append(r + o)
        vs.append(vals)
    rr, cc, vv = np.concatenate(rs), np.concatenate(cs), np.concatenate(vs)
    order = np.lexsort((cc, rr))
    rr, cc, vv = rr[order], cc[order], vv[order]
    indptr = np.zeros(rows_n + 1, np.int64)
    np.add.at(indptr, rr + 1, 1)
    out = csmat((rows_n, cols_n), np.cumsum(indptr).astype(np.int32), cc.astype(np.int32), vv,
                validate=False, device=device)
    return out if storage == CSR else out.to_csc()


def from_scipy(m, *, storage: Optional[str] = None, cap=None, device=DEFAULT_DEVICE) -> CsMat:
    """Convert a scipy.sparse matrix (host interop); CSC input stays CSC
    unless ``storage`` says otherwise."""
    import scipy.sparse as sp

    if storage == CSC or (storage is None and sp.issparse(m) and m.format == "csc"):
        m, st = m.tocsc(), CSC
    else:
        m, st = m.tocsr(), CSR
    m.sort_indices()
    return csmat(m.shape, m.indptr.astype(np.int32), m.indices.astype(np.int32), m.data,
                 storage=st, cap=cap, validate=False, device=device)
