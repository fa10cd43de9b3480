"""DIA (diagonal) sparse format — the gather-free SpMV layout for banded
matrices, the PyTorch counterpart of ``sprs_tpu/formats/dia.py``.

Storing the k populated diagonals densely turns SpMV into

    y[i] = Σ_d  data[d, i] * x[i + offset_d]

— k shifted reads of ``x``, k multiplies, k adds.

Layout: ``offsets`` is a tuple of diagonal offsets (col - row);
``data[d, i] = A[i, i + offsets[d]]`` (row-indexed, zero where out of
range).  Rows are padded to a multiple of 8.

Two functions of the same product, which differ only on bfloat16:

* :func:`dia_spmv` and :func:`dia_spmm` here are the counterparts of the
  JAX package's XLA products: they compute in promote(data, x), so a
  bfloat16 operand times a bfloat16 x rounds every product and partial
  sum to bfloat16, as XLA does.  Whoever calls them directly (or
  through ``formats``) gets that;
* the kernels K1 and K2 and their plain versions (``ops/cuda/dia_spmv.py``,
  ``dia_spmm.py``) compute what the Pallas kernels compute: products and
  sums in promote(out, float32), rounded once to the output type.
  ``prepare_spmv``, ``prepare_spmm`` and :class:`DiaTiledMat` get that,
  on the card and on the CPU alike.

For float32 and float64 the two are the same arithmetic.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..errors import ShapeError
from .csmat import CsMat, csmat
from .util import as_tensor, host_array, round_up


@dataclasses.dataclass(frozen=True)
class DiaMat:
    """Diagonal-storage matrix: ``data (n_diags, rows_pad)`` plus the
    ``offsets`` tuple (col - row) and the logical ``shape``."""

    data: torch.Tensor
    offsets: Tuple[int, ...]
    shape: Tuple[int, int]

    @property
    def rows(self) -> int:
        return self.shape[0]

    @property
    def cols(self) -> int:
        return self.shape[1]

    @property
    def rows_pad(self) -> int:
        return self.data.shape[1]

    @property
    def n_diags(self) -> int:
        return len(self.offsets)

    @property
    def dtype(self) -> torch.dtype:
        return self.data.dtype

    @property
    def device(self) -> torch.device:
        return self.data.device

    @property
    def bandwidth(self) -> int:
        return max(abs(o) for o in self.offsets) if self.offsets else 0

    def to_dense(self) -> torch.Tensor:
        out = torch.zeros(self.shape, dtype=self.dtype, device=self.device)
        r = torch.arange(self.rows, device=self.device)
        for d, off in enumerate(self.offsets):
            c = r + off
            ok = (c >= 0) & (c < self.cols)
            out[r[ok], c[ok]] += self.data[d, : self.rows][ok]
        return out

    def __repr__(self):
        return (
            f"{type(self).__name__}(shape={self.shape}, n_diags={self.n_diags}, "
            f"bandwidth={self.bandwidth}, dtype={self.dtype})"
        )


def _entry_offsets(mat: CsMat):
    """(csr, row of each live entry, its offset col - row), as int64
    tensors on ``mat``'s device.  The offsets come from the indices
    alone, so the values' type never reaches the host."""
    m = mat.to_csr()
    nnz = m.nnz
    rows = m.outer_ids()[:nnz].to(torch.int64)
    return m, rows, m.indices[:nnz].to(torch.int64) - rows


def dia_from_csmat(
    mat: CsMat, *, max_diags: Optional[int] = None, row_align: int = 8
) -> DiaMat:
    """CSR → DIA conversion on ``mat``'s device; only the offsets come to
    the host.  The arrays equal the JAX package's host conversion.

    Raises ShapeError when the matrix populates more than ``max_diags``
    distinct diagonals.
    """
    m, rows, off = _entry_offsets(mat)
    offs = torch.unique(off)  # sorted, as np.unique
    k = int(offs.numel())
    if max_diags is not None and k > max_diags:
        raise ShapeError(f"matrix has {k} diagonals > max_diags={max_diags}")
    rows_pad = round_up(max(mat.rows, 1), row_align)
    dia = torch.zeros((max(k, 1), rows_pad), dtype=m.dtype, device=m.device)
    dia[torch.searchsorted(offs, off), rows] = m.data[: rows.numel()].detach()
    return DiaMat(dia, tuple(offs.tolist()) if k else (0,), mat.shape)


def dia_to_csmat(dia: DiaMat) -> CsMat:
    """Host-side DIA → CSR conversion (structural entries = every
    in-bounds diagonal slot, matching ``dia_from_csmat``'s layout)."""
    rows, cols = dia.shape
    data = host_array(dia.data)
    rs, cs, vs = [], [], []
    for d, off in enumerate(dia.offsets):
        r0 = max(0, -off)
        r1 = min(rows, cols - off)
        if r1 <= r0:
            continue
        rr = np.arange(r0, r1)
        rs.append(rr)
        cs.append(rr + off)
        vs.append(data[d, r0:r1])
    if rs:
        rr, cc, vv = np.concatenate(rs), np.concatenate(cs), np.concatenate(vs)
    else:
        rr = cc = np.zeros(0, np.int64)
        vv = np.zeros(0, data.dtype)
    order = np.lexsort((cc, rr))
    rr, cc, vv = rr[order], cc[order], vv[order]
    indptr = np.zeros(rows + 1, np.int64)
    np.add.at(indptr, rr + 1, 1)
    return csmat(
        (rows, cols),
        np.cumsum(indptr).astype(np.int32),
        cc.astype(np.int32),
        as_tensor(vv, dtype=dia.dtype, device="cpu"),
        validate=False,
        device=dia.device,
    )


def n_diags_of(mat: CsMat) -> int:
    """Number of populated diagonals (the dispatch heuristic), counted on
    ``mat``'s device from the indices alone."""
    return int(torch.unique(_entry_offsets(mat)[2]).numel())


def _padded_x(dia: DiaMat, x: torch.Tensor):
    """Zero-pad x along its first dim so every shifted read is in range;
    returns (xp, left_pad)."""
    left = max(0, -min(dia.offsets))
    right = max(0, dia.rows_pad - 1 + max(dia.offsets) - (dia.cols - 1))
    pad = [0, 0] * (x.ndim - 1) + [left, right]
    return torch.nn.functional.pad(x, pad), left


def dia_spmv(dia: DiaMat, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x, plain torch: k shifted slices, multiply-add in
    diagonal order."""
    if x.shape != (dia.cols,):
        raise ShapeError(f"dia_spmv: A is {dia.shape}, x is {tuple(x.shape)}")
    xp, left = _padded_x(dia, x)
    y = torch.zeros(
        dia.rows_pad,
        dtype=torch.promote_types(dia.dtype, x.dtype),
        device=x.device,
    )
    for d, off in enumerate(dia.offsets):
        y = y + dia.data[d] * xp[left + off : left + off + dia.rows_pad]
    return y[: dia.rows]


def dia_spmm(dia: DiaMat, x: torch.Tensor) -> torch.Tensor:
    """Y = A @ X for dense X (cols, k): shifted row-block reads."""
    if x.ndim != 2 or x.shape[0] != dia.cols:
        raise ShapeError(f"dia_spmm: A is {dia.shape}, X is {tuple(x.shape)}")
    xp, left = _padded_x(dia, x)
    y = torch.zeros(
        (dia.rows_pad, x.shape[1]),
        dtype=torch.promote_types(dia.dtype, x.dtype),
        device=x.device,
    )
    for d, off in enumerate(dia.offsets):
        y = y + dia.data[d][:, None] * xp[left + off : left + off + dia.rows_pad]
    return y[: dia.rows]

