"""Halo-exchange distributed SpMV for banded matrices, the counterpart of
``sprs_tpu/parallel/halo.py``.

A row-partitioned SpMV whose shards reach only a bounded window of
columns around their own rows (grid Laplacians, anything RCM-ordered)
needs no all-gather: each slot receives the ``halo`` boundary entries of
x from its left and right neighbours, two ``ppermute`` copies of
O(halo) elements each (see ``dist.py`` for the mesh and its copies).

Shard layout (host-built by :func:`shard_csr_rows_halo`): shard ``s``
owns rows [s·rp, (s+1)·rp); its column ids are rebased to the local
window [s·rp − halo, (s+1)·rp + halo).  Requires a square matrix
partitioned identically on rows and columns.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..errors import ShapeError
from ..formats.csmat import CSR, CsMat
from ..ops.prod import spmv
from .dist import (
    Mesh,
    Tensors,
    _cdiv,
    _csr_host,
    _gather_out,
    _input,
    _on,
    _placement,
    _ppermute,
    _sharded_x,
    _slots,
)


@dataclasses.dataclass(frozen=True)
class HaloCsMat:
    """Row-sharded CSR with window-local column ids and halo width; per
    shard ``indptr (rp+1,)``, ``indices`` / ``data (cap,)`` (local ids in
    [0, rp + 2·halo)), shard ``s``'s on its device."""

    indptr: Tensors
    indices: Tensors
    data: Tensors
    shape: Tuple[int, int]
    halo: int

    @property
    def n_shards(self) -> int:
        return len(self.indptr)

    @property
    def rows_per_shard(self) -> int:
        return self.indptr[0].shape[0] - 1


def _halo_host(mat: CsMat, n_shards: int):
    """The halo partition on the host: ``(ip, ix, dt, halo, shape)`` with
    (S, rp+1) / (S, cap) numpy arrays."""
    csr, indptr, indices, data = _csr_host(mat)
    rows, cols = csr.shape
    if rows != cols:
        raise ShapeError("halo sharding needs a square matrix")
    rp = _cdiv(max(rows, 1), n_shards)
    # halo = max reach of any entry outside its shard's own column range
    entry_rows = np.repeat(np.arange(rows, dtype=np.int64), np.diff(indptr))
    shard_of = entry_rows // rp
    lo = shard_of * rp
    hi = np.minimum(lo + rp, rows)
    nnz = int(indptr[-1])
    reach_left = np.maximum(lo - indices[:nnz], 0)
    reach_right = np.maximum(indices[:nnz] - (hi - 1), 0)
    halo = int(max(reach_left.max(initial=0), reach_right.max(initial=0)))
    if halo > rp:
        raise ShapeError(f"bandwidth {halo} exceeds rows_per_shard {rp}; use dist_spmv")

    cap = 1
    for s in range(n_shards):
        a, b = min(s * rp, rows), min((s + 1) * rp, rows)
        cap = max(cap, int(indptr[b] - indptr[a]))
    ip = np.zeros((n_shards, rp + 1), dtype=np.int32)
    ix = np.zeros((n_shards, cap), dtype=np.int32)
    dt = np.zeros((n_shards, cap), dtype=data.dtype)
    for s in range(n_shards):
        a, b = min(s * rp, rows), min((s + 1) * rp, rows)
        base = indptr[a]
        local_ptr = indptr[a : b + 1] - base
        ip[s, : b - a + 1] = local_ptr
        ip[s, b - a + 1 :] = local_ptr[-1]
        k = int(local_ptr[-1])
        # rebase columns to the local window [s*rp - halo, ...)
        ix[s, :k] = indices[base : base + k] - (s * rp - halo)
        dt[s, :k] = data[base : base + k]
    return ip, ix, dt, halo, (rows, cols)


def shard_csr_rows_halo(mat: CsMat, n_shards: int, *, device=None) -> HaloCsMat:
    """Host-side partition; raises ShapeError when some entry reaches
    beyond one neighbour shard (bandwidth > rows_per_shard).  ``device``
    places the shards as in ``shard_csr_rows``."""
    ip, ix, dt, halo, shape = _halo_host(mat, n_shards)
    devs = _placement(device, n_shards, mat.device)
    return HaloCsMat(_on(ip, devs), _on(ix, devs), _on(dt, devs, mat.dtype), shape, halo)


@dataclasses.dataclass(frozen=True)
class HaloSplitCsMat:
    """Halo-sharded CSR split into interior and boundary parts.

    ``int_*`` columns are shard-local row ids [0, rp); ``bnd_*`` columns
    index the 2·halo-long halo buffer (left halo first).  The split lets
    the interior product be issued before the halo copies, which it does
    not depend on.
    """

    int_indptr: Tensors
    int_indices: Tensors
    int_data: Tensors
    bnd_indptr: Tensors
    bnd_indices: Tensors
    bnd_data: Tensors
    shape: Tuple[int, int]
    halo: int

    @property
    def n_shards(self) -> int:
        return len(self.int_indptr)

    @property
    def rows_per_shard(self) -> int:
        return self.int_indptr[0].shape[0] - 1


def shard_csr_rows_halo_split(mat: CsMat, n_shards: int, *, device=None) -> HaloSplitCsMat:
    """Host-side partition into interior + boundary shard matrices."""
    ip, ix, dt, halo, shape = _halo_host(mat, n_shards)
    S, rp = ip.shape[0], ip.shape[1] - 1

    ii_p = np.zeros((S, rp + 1), np.int32)
    bi_p = np.zeros((S, rp + 1), np.int32)
    ii_x, ii_d, bi_x, bi_d = [], [], [], []
    for s in range(S):
        nnz = int(ip[s, -1])
        idx = ix[s, :nnz]  # window coords
        dat = dt[s, :nnz]
        rows = np.repeat(np.arange(rp), np.diff(ip[s]))
        interior = (idx >= halo) & (idx < halo + rp)
        # interior: rebase to [0, rp); boundary: left halo -> [0, halo),
        # right halo -> [halo, 2*halo)
        b_raw = idx[~interior]
        ii_p[s, 1:] = np.cumsum(np.bincount(rows[interior], minlength=rp))
        bi_p[s, 1:] = np.cumsum(np.bincount(rows[~interior], minlength=rp))
        ii_x.append(idx[interior] - halo)
        ii_d.append(dat[interior])
        bi_x.append(np.where(b_raw < halo, b_raw, b_raw - rp))
        bi_d.append(dat[~interior])
    cap_i = max(max((len(a) for a in ii_x), default=1), 1)
    cap_b = max(max((len(a) for a in bi_x), default=1), 1)

    def pack(lst, cap, dtype):
        out = np.zeros((S, cap), dtype)
        for s, a in enumerate(lst):
            out[s, : len(a)] = a
        return out

    devs = _placement(device, S, mat.device)
    return HaloSplitCsMat(
        _on(ii_p, devs),
        _on(pack(ii_x, cap_i, np.int32), devs),
        _on(pack(ii_d, cap_i, dt.dtype), devs, mat.dtype),
        _on(bi_p, devs),
        _on(pack(bi_x, cap_b, np.int32), devs),
        _on(pack(bi_d, cap_b, dt.dtype), devs, mat.dtype),
        shape,
        halo,
    )


def _halo_pieces(xs, halo: int, devs):
    """(from_left, from_right) on every slot: the left neighbour's last
    ``halo`` entries and the right neighbour's first ones, zeros at the
    ends (ppermute's value where no source sends)."""
    S = len(xs)
    rp = xs[0].shape[0]
    fwd = [(i, i + 1) for i in range(S - 1)]  # send to the right neighbour
    bwd = [(i + 1, i) for i in range(S - 1)]  # send to the left neighbour
    from_left = _ppermute([x[rp - halo :] for x in xs], fwd, devs)
    from_right = _ppermute([x[:halo] for x in xs], bwd, devs)
    return from_left, from_right


def dist_spmv_halo_overlap(
    dmat: HaloSplitCsMat, x, mesh: Mesh, *, axis: str = "shards"
) -> torch.Tensor:
    """y = A @ x with the interior products issued before the halo
    copies, then the boundary products; y (S·rp,) gathered onto the
    mesh's first device."""
    S, rp, halo = dmat.n_shards, dmat.rows_per_shard, dmat.halo
    devs = _slots(mesh, axis, S)
    x = _input(x, devs[0])
    if x.shape[0] != dmat.shape[1]:
        raise ShapeError(f"dist_spmv_halo: A {dmat.shape}, x {tuple(x.shape)}")
    xs = _sharded_x(x, S, devs)
    ys = [spmv(CsMat(dmat.int_indptr[s], dmat.int_indices[s], dmat.int_data[s], (rp, rp), CSR),
               xs[s]) for s in range(S)]
    if halo > 0:
        from_left, from_right = _halo_pieces(xs, halo, devs)
        for s in range(S):
            boundary = CsMat(dmat.bnd_indptr[s], dmat.bnd_indices[s], dmat.bnd_data[s],
                             (rp, 2 * halo), CSR)
            ys[s] = ys[s] + spmv(boundary, torch.cat([from_left[s], from_right[s]]))
    return _gather_out(ys, devs[0])


def dist_spmv_halo(dmat: HaloCsMat, x, mesh: Mesh, *, axis: str = "shards") -> torch.Tensor:
    """y = A @ x with x row-sharded and only O(halo) copies: each slot
    multiplies over the window [from_left | own | from_right]; edge slots
    receive zeros, which is exact because no entry reaches outside the
    matrix.  y (S·rp,) is gathered onto the mesh's first device."""
    S, rp, halo = dmat.n_shards, dmat.rows_per_shard, dmat.halo
    devs = _slots(mesh, axis, S)
    x = _input(x, devs[0])
    if x.shape[0] != dmat.shape[1]:
        raise ShapeError(f"dist_spmv_halo: A {dmat.shape}, x {tuple(x.shape)}")
    xs = _sharded_x(x, S, devs)
    if halo > 0:
        from_left, from_right = _halo_pieces(xs, halo, devs)
        wins = [torch.cat([from_left[s], xs[s], from_right[s]]) for s in range(S)]
    else:
        wins = xs
    ys = [spmv(CsMat(dmat.indptr[s], dmat.indices[s], dmat.data[s], (rp, rp + 2 * halo), CSR),
               wins[s]) for s in range(S)]
    return _gather_out(ys, devs[0])
