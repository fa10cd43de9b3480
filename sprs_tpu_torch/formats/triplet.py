"""COO / triplet format: a host-side builder and the conversion to CsMat,
the PyTorch counterpart of ``sprs_tpu/formats/triplet.py``.

* :class:`TriMat` — a growable builder on the host.  Duplicate entries
  are legal and are summed when the builder is compressed.
* :func:`coo_to_csmat` — padded COO tensors to a :class:`CsMat` on their
  device through the shared sort-and-compress (``util.compress_coo``):
  duplicates summed, empty trailing rows kept.

The builder keeps numpy arrays where the JAX one keeps Python lists, so
that a mesh of millions of triplets goes in with one call to
:meth:`TriMat.from_triplets`; single ``add_triplet`` calls are buffered
and joined to the arrays when the builder is next read.  As in the JAX
package, ``transpose_view`` shares the triplets with its builder.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from .._span import span
from ..errors import ShapeError, StructureError
from .csmat import CSC, CSR, CsMat
from .util import (
    DEFAULT_DEVICE,
    INDEX_DTYPE,
    as_tensor,
    check_index_capacity,
    compress_coo,
    host_array,
    is_bf16,
    np_dtype,
)


def coo_to_csmat(
    rows,
    cols,
    data,
    shape: Tuple[int, int],
    *,
    nnz=None,
    storage: str = CSR,
    cap: Optional[int] = None,
    device=DEFAULT_DEVICE,
) -> CsMat:
    """Compress COO triplets into a CsMat on ``device``, summing duplicates.

    ``rows``/``cols``/``data`` may be capacity-padded; ``nnz`` is the live
    count (default: their full length) and ``cap`` the result's capacity
    (default: that length, at least 1).  Runs in a ``sprs.coo_to_csmat``
    profiler span.
    """
    with span("sprs.coo_to_csmat"):
        check_index_capacity(rows=shape[0], cols=shape[1], cap=cap)
        rows = as_tensor(rows, dtype=INDEX_DTYPE, device=device)
        cols = as_tensor(cols, dtype=INDEX_DTYPE, device=device)
        data = as_tensor(data, device=device)
        n = rows.shape[0]
        if nnz is None:
            nnz = n
        if cap is None:
            cap = max(n, 1)
        outer, inner = (rows, cols) if storage == CSR else (cols, rows)
        n_outer, n_inner = (shape[0], shape[1]) if storage == CSR else (shape[1], shape[0])
        res = compress_coo(outer, inner, (data,), nnz, n_outer, n_inner, cap)
        return CsMat(res.indptr, res.indices, res.values[0], tuple(int(s) for s in shape), storage)


class _Triplets:
    """The triplet arrays that a builder and its transpose views share.
    Single adds are buffered and joined to the arrays when they are next
    read.  ``dtype`` is the builder's type: a numpy dtype, or
    ``torch.bfloat16``, whose values the host holds as float32
    (``util.np_dtype``)."""

    def __init__(self, dtype):
        self.dtype = torch.bfloat16 if is_bf16(dtype) else np_dtype(dtype)
        self.rows = np.zeros(0, np.int64)
        self.cols = np.zeros(0, np.int64)
        self.data = np.zeros(0, np_dtype(self.dtype))
        self.pending: List[tuple] = []

    def cast(self, values) -> np.ndarray:
        """``values`` in the builder's type, held as the host holds it: a
        bfloat16 cast rounds to nearest even in torch, as ml_dtypes' cast
        does."""
        a = np.asarray(values)
        if self.dtype != torch.bfloat16:
            return a.astype(self.dtype)
        return host_array(torch.from_numpy(np.array(a, np.float64)).to(torch.bfloat16))

    def arrays(self):
        if self.pending:
            r, c, v = zip(*self.pending)
            self.rows = np.concatenate([self.rows, np.asarray(r, np.int64)])
            self.cols = np.concatenate([self.cols, np.asarray(c, np.int64)])
            self.data = np.concatenate([self.data, self.cast(v)])
            self.pending = []
        return self.rows, self.cols, self.data

    def __len__(self) -> int:
        return self.rows.shape[0] + len(self.pending)


class TriMat:
    """Host-side triplet builder.

    Duplicates are allowed; ``to_csr`` / ``to_csc`` sum them.  Mutation is
    eager numpy; the compression runs on the target device.  ``dtype`` is
    a numpy or torch dtype; a bfloat16 builder (``dtype`` is then
    ``torch.bfloat16``) rounds each value to bfloat16 as it comes in and
    hands its values out as float32 (:meth:`data`, :meth:`to_dense`),
    where the JAX builder hands out ml_dtypes' bfloat16.
    """

    def __init__(self, shape: Tuple[int, int], dtype=np.float64):
        check_index_capacity(rows=shape[0], cols=shape[1])
        self.shape = tuple(int(s) for s in shape)
        self._store = _Triplets(dtype)
        self._transposed = False

    @classmethod
    def from_triplets(cls, shape, rows, cols, data) -> "TriMat":
        if isinstance(data, torch.Tensor):
            m = cls(shape, dtype=data.dtype)
            data = host_array(data)
        else:
            data = np.asarray(data)
            m = cls(shape, dtype=data.dtype)
        rows = np.asarray(rows)
        cols = np.asarray(cols)
        if not (rows.shape == cols.shape == data.shape):
            raise ShapeError("triplet arrays must have equal length")
        if rows.size:
            if rows.min() < 0 or rows.max() >= m.shape[0]:
                raise StructureError.out_of_range("row index out of range")
            if cols.min() < 0 or cols.max() >= m.shape[1]:
                raise StructureError.out_of_range("col index out of range")
        m._store.rows = rows.reshape(-1).astype(np.int64)
        m._store.cols = cols.reshape(-1).astype(np.int64)
        m._store.data = m._store.cast(data.reshape(-1))
        return m

    @property
    def dtype(self):
        """A numpy dtype, or ``torch.bfloat16``."""
        return self._store.dtype

    def _arrays(self):
        """(rows, cols, data) in this builder's orientation: the shared
        arrays themselves, so writing into them writes the store."""
        r, c, v = self._store.arrays()
        return (c, r, v) if self._transposed else (r, c, v)

    # -- mutation ------------------------------------------------------------
    def add_triplet(self, row: int, col: int, val) -> None:
        if not (0 <= row < self.shape[0]):
            raise StructureError.out_of_range(f"row {row} out of range")
        if not (0 <= col < self.shape[1]):
            raise StructureError.out_of_range(f"col {col} out of range")
        self._store.pending.append((col, row, val) if self._transposed else (row, col, val))

    def set_triplet(self, loc: int, row: int, col: int, val) -> None:
        """Overwrite the triplet at position ``loc``."""
        r, c, v = self._arrays()
        r[loc], c[loc], v[loc] = row, col, self._store.cast(val)

    def find_locations(self, row: int, col: int) -> List[int]:
        """All triplet positions matching (row, col)."""
        r, c, _ = self._arrays()
        return np.flatnonzero((r == row) & (c == col)).tolist()

    def reserve(self, additional: int) -> None:
        pass  # the arrays grow when they are joined; kept for API parity

    # -- properties ----------------------------------------------------------
    @property
    def nnz(self) -> int:
        return len(self._store)

    @property
    def rows(self) -> int:
        return self.shape[0]

    @property
    def cols(self) -> int:
        return self.shape[1]

    def row_inds(self) -> np.ndarray:
        return self._arrays()[0].astype(np.int32)

    def col_inds(self) -> np.ndarray:
        return self._arrays()[1].astype(np.int32)

    def data(self) -> np.ndarray:
        return self._arrays()[2].astype(np_dtype(self.dtype))

    def transpose_view(self) -> "TriMat":
        """O(1) transpose sharing this builder's triplets: a triplet added
        or set through either is seen by both."""
        t = TriMat((self.shape[1], self.shape[0]), dtype=self.dtype)
        t._store, t._transposed = self._store, not self._transposed
        return t

    # -- conversion ----------------------------------------------------------
    def _to_cs(self, storage: str, cap: Optional[int], device) -> CsMat:
        n = self.nnz
        if n == 0:  # one padding slot, as the JAX builder compresses
            rows = cols = np.zeros(1, np.int32)
            vals = np.zeros(1, np_dtype(self.dtype))
        else:
            r, c, vals = self._arrays()
            rows, cols = r.astype(np.int32), c.astype(np.int32)
        vals = as_tensor(vals, dtype=self.dtype, device="cpu")
        return coo_to_csmat(
            rows, cols, vals, self.shape, nnz=n, storage=storage, cap=cap, device=device
        )

    def to_csr(self, cap: Optional[int] = None, *, device=DEFAULT_DEVICE) -> CsMat:
        return self._to_cs(CSR, cap, device)

    def to_csc(self, cap: Optional[int] = None, *, device=DEFAULT_DEVICE) -> CsMat:
        return self._to_cs(CSC, cap, device)

    def to_dense(self) -> np.ndarray:
        r, c, v = self._arrays()
        if is_bf16(self.dtype):  # duplicates summed in bfloat16, one by one
            out = torch.zeros(self.shape, dtype=torch.bfloat16)
            out.index_put_((torch.from_numpy(r), torch.from_numpy(c)),
                           torch.from_numpy(v).to(torch.bfloat16), accumulate=True)
            return host_array(out)
        out = np.zeros(self.shape, dtype=self.dtype)
        np.add.at(out, (r, c), v)
        return out

    def __repr__(self):
        return f"TriMat(shape={self.shape}, nnz={self.nnz}, dtype={self.dtype})"
