"""Carry state across from the JAX package without importing it.

:func:`from_arrays` takes the arrays of a JAX-package object as numpy
arrays (``np.asarray`` of its leaves) and builds the port's object on
``device``, capacity and padding included, so that both packages hold
the same operand array for array: a CsMat, a DiaMat, a BsrMat (a
conversion's or a dense-route SpGEMM's), an EllMat, a CsVec or a
Permutation.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from .formats.bsr import BsrMat
from .formats.csmat import CSR, csmat
from .formats.csvec import CsVec
from .formats.dia import DiaMat
from .formats.ell import EllMat
from .formats.util import DEFAULT_DEVICE, INDEX_DTYPE, as_tensor
from .ops.permutation import Permutation

KINDS = ("csmat", "dia", "bsr", "ell", "csvec", "permutation")


def from_arrays(
    kind: str,
    shape: Tuple[int, int],
    arrays: Sequence,
    *,
    offsets: Optional[Sequence[int]] = None,
    n_blocks: Optional[int] = None,
    storage: str = CSR,
    device=DEFAULT_DEVICE,
):
    """Build a port object from another package's arrays.

    * ``kind="csmat"``: ``arrays = (indptr, indices, data)`` of a CsMat,
      with ``storage`` "csr" or "csc"; the capacity is ``len(indices)``.
    * ``kind="dia"``: ``arrays = (data,)`` of a DiaMat, shape
      ``(n_diags, rows_pad)``, with its ``offsets``.
    * ``kind="bsr"``: ``arrays = (brows, bcols, blocks)`` of a BsrMat,
      padding blocks included, with its live count ``n_blocks``.
    * ``kind="ell"``: ``arrays = (indices, data)`` of an EllMat, both
      ``(rows_pad, width)``.
    * ``kind="csvec"``: ``arrays = (indices, data, nnz)`` of a CsVec
      (``nnz`` its 0-d count), ``shape = (dim,)``.
    * ``kind="permutation"``: ``arrays = (perm, inv)`` of a Permutation,
      ``shape = (n,)``.
    """
    shape = tuple(int(s) for s in shape)
    if kind == "csmat":
        indptr, indices, data = arrays
        return csmat(
            shape,
            indptr,
            indices,
            data,
            storage=storage,
            cap=len(indices),
            validate=False,
            device=device,
        )
    if kind == "dia":
        if offsets is None:
            raise ValueError("from_arrays('dia', ...) needs offsets")
        (data,) = arrays
        return DiaMat(
            as_tensor(data, device=device),
            tuple(int(o) for o in offsets),
            shape,
        )
    if kind == "bsr":
        if n_blocks is None:
            raise ValueError("from_arrays('bsr', ...) needs n_blocks")
        brows, bcols, blocks = arrays
        return BsrMat(
            as_tensor(brows, dtype=INDEX_DTYPE, device=device),
            as_tensor(bcols, dtype=INDEX_DTYPE, device=device),
            as_tensor(blocks, device=device),
            shape,
            int(n_blocks),
        )
    if kind == "ell":
        indices, data = arrays
        return EllMat(
            as_tensor(indices, dtype=INDEX_DTYPE, device=device),
            as_tensor(data, device=device),
            shape,
        )
    if kind == "csvec":
        indices, data, nnz = arrays
        return CsVec(
            as_tensor(indices, dtype=INDEX_DTYPE, device=device),
            as_tensor(data, device=device),
            torch.tensor(int(nnz), dtype=INDEX_DTYPE, device=device),
            shape[0],
        )
    if kind == "permutation":
        perm, inv = arrays
        return Permutation(
            as_tensor(perm, dtype=INDEX_DTYPE, device=device),
            as_tensor(inv, dtype=INDEX_DTYPE, device=device),
        )
    raise ValueError(f"from_arrays: kind must be one of {KINDS}, got {kind!r}")
