"""Distributed sparse kernels over a mesh of devices, the counterpart of
``sprs_tpu/parallel/dist.py``.

The JAX package runs one program over a ``jax.sharding.Mesh`` with
``shard_map``: each device runs the kernel on its shard, and the
collectives (``all_gather``, ``ppermute``, ``psum``) move data between
devices.  Here the mesh is a :class:`Mesh` of ``torch.device`` slots in
one process.  Shard ``s`` keeps its arrays on mesh slot ``s``; the
per-shard kernel runs once per slot in shard order; a collective is an
explicit copy between slot devices:

* ``all_gather`` — the shards' pieces concatenated in shard order into a
  new buffer on each slot's device;
* ``ppermute`` — each (source, target) pair copies the source's piece to
  the target's device; a slot that no source sends to receives zeros;
* ``psum`` over a mesh axis — the partials added in slot order on the
  first slot of the group.

An input the JAX package shards or replicates with ``in_specs`` is
copied to the slots that take it; a row-sharded result is gathered, in
shard order, onto the mesh's first device (the array a JAX caller reads
back).  Slots may share a device — on one card all of them do — and
every copy is still made, so that the code path is the one a mesh over
several cards runs.

* **Row partitioning (1-D)** — each slot owns a contiguous row block of
  the CSR matrix (column indices stay global); ``balance="nnz"`` places
  the block boundaries by cumulative nnz.  SpMV takes x replicated or
  all-gathered; SpGEMM runs ESC per shard against a replicated B, or
  against B's shards all-gathered (``bshard``) or fetched block by block
  in the rounds of a host plan (``bgather``).
* **2-D block partitioning** — mesh axes (rows × cols): slot (i, j) owns
  block (i, j) with local column ids; x is sharded over the column axis
  and the partial products are summed over it.

The host-side plans (shard layouts, caps, routing, the gather schedule)
are the JAX package's, integer for integer.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..errors import ShapeError
from ..formats.csmat import CSR, CsMat
from ..formats.util import INDEX_DTYPE, as_tensor, compress_coo, host_array
from ..ops.prod import spmv
from ..ops.spgemm import _expand_from_rows, spgemm

Tensors = Tuple[torch.Tensor, ...]


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


# ---------------------------------------------------------------------------
# the mesh and its collectives
# ---------------------------------------------------------------------------


class Mesh:
    """An array of ``torch.device`` with one name per axis, built like
    ``jax.sharding.Mesh(devices, axis_names)``: ``devices`` is a nested
    sequence (or numpy array) of devices or device strings whose rank is
    ``len(axis_names)``.

    >>> Mesh(["cpu"] * 4, ("shards",)).shape
    {'shards': 4}
    """

    def __init__(self, devices, axis_names: Sequence[str]):
        given = np.asarray(devices, dtype=object)
        self.devices = np.empty(given.shape, dtype=object)
        for idx in np.ndindex(given.shape):
            self.devices[idx] = torch.device(given[idx])
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ShapeError(
                f"mesh of rank {self.devices.ndim} needs {self.devices.ndim} axis names, "
                f"got {self.axis_names}"
            )

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def axis_devices(self, *axes: str) -> np.ndarray:
        """The devices with ``axes`` leading, in that order; a mesh axis
        not named is replicated over and its first slot taken."""
        order = [self.axis_names.index(a) for a in axes]
        rest = [i for i in range(self.devices.ndim) if i not in order]
        arr = np.transpose(self.devices, order + rest)
        return arr[(Ellipsis,) + (0,) * len(rest)] if rest else arr

    def __repr__(self):
        return f"Mesh({self.shape}, devices={sorted({str(d) for d in self.devices.flat})})"


def _slots(mesh: Mesh, axis: str, n: int) -> list:
    devs = list(mesh.axis_devices(axis))
    if len(devs) != n:
        raise ShapeError(f"{n} shards on a mesh axis {axis!r} of {len(devs)} slots")
    return devs


def _placement(device, n: int, default) -> list:
    """Devices of ``n`` shards: ``None`` puts every shard on ``default``,
    a device puts every shard there, a :class:`Mesh` gives shard ``s``
    its ``s``-th device (flattened in mesh order)."""
    if device is None:
        return [torch.device(default)] * n
    if not isinstance(device, Mesh):
        return [torch.device(device)] * n
    devs = list(device.devices.reshape(-1))
    if len(devs) != n:
        raise ShapeError(f"{n} shards placed on {len(devs)} devices")
    return devs


def _transfer(t: torch.Tensor, device) -> torch.Tensor:
    """One piece moved by a collective: a new tensor on ``device``, a copy
    even when the piece already lies there."""
    return t.to(device, copy=True)


def _all_gather(pieces: Sequence[torch.Tensor], devices, *, tiled: bool = True) -> list:
    """``all_gather`` over the slots: on each device, the pieces in shard
    order, concatenated (``tiled``) or stacked on a new leading axis."""
    p0 = pieces[0]
    n = len(pieces)
    shape = ((n * p0.shape[0],) + tuple(p0.shape[1:])) if tiled else ((n,) + tuple(p0.shape))
    out = []
    for d in devices:
        buf = torch.empty(shape, dtype=p0.dtype, device=d)
        for s, p in enumerate(pieces):
            (buf[s * p0.shape[0] : (s + 1) * p0.shape[0]] if tiled else buf[s]).copy_(p)
        out.append(buf)
    return out


def _ppermute(pieces: Sequence[torch.Tensor], perm, devices) -> list:
    """``ppermute``: for each (source, target) pair the source's piece is
    copied to the target's device; a slot no source sends to gets zeros."""
    out = [torch.zeros(p.shape, dtype=p.dtype, device=d) for p, d in zip(pieces, devices)]
    for src, dst in perm:
        out[dst].copy_(pieces[src])
    return out


def _gather_out(pieces: Sequence[torch.Tensor], device) -> torch.Tensor:
    """A row-sharded result gathered in shard order onto ``device``."""
    return _all_gather(pieces, [device])[0]


def _pad_rows(x: torch.Tensor, rows: int) -> torch.Tensor:
    if x.shape[0] == rows:
        return x
    return torch.cat([x, x.new_zeros((rows - x.shape[0],) + tuple(x.shape[1:]))])


def _input(x, device) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else as_tensor(x, device=device)


def _csmat_to(m: CsMat, device) -> CsMat:
    """A replicated operand: ``m`` copied to ``device``."""
    return CsMat(_transfer(m.indptr, device), _transfer(m.indices, device),
                 _transfer(m.data, device), m.shape, m.storage)


def _csr_host(mat: CsMat):
    """(CSR, indptr, indices, data) with the arrays on the host; bfloat16
    data as float32 (``host_array``), which ``_on(..., dtype)`` casts
    back."""
    csr = mat.to_csr()
    return (csr, csr.indptr.cpu().numpy(), csr.indices.cpu().numpy(), host_array(csr.data))


def _on(arrays: Sequence[np.ndarray], devices, dtype=None) -> Tensors:
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(d, dtype) for a, d in zip(arrays, devices))


def _host_stack(tensors: Tensors) -> np.ndarray:
    return np.stack([t.cpu().numpy() for t in tensors])


# ---------------------------------------------------------------------------
# 1-D row partitioning
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DistCsMat:
    """Row-sharded CSR: per shard ``indptr (rows_per+1,)``, ``indices`` and
    ``data (cap_per,)`` and ``row_ids (rows_per,)``, shard ``s``'s on its
    device.  Stacked, they are the JAX package's ``(S, ...)`` leaves.

    Rows are padded to ``S * rows_per`` (padding rows are empty and their
    ``row_ids`` carry the sentinel ``shape[0]``; nnz-balanced shards have
    ragged true row counts, which :meth:`assemble` undoes).  Column
    indices are global.
    """

    indptr: Tensors
    indices: Tensors
    data: Tensors
    row_ids: Tensors
    shape: Tuple[int, int]  # true (unpadded) global shape

    def assemble(self, y: torch.Tensor) -> torch.Tensor:
        """Map a flat row-sharded result (S*rows_per[, k]) back to global
        row order (shape[0][, k]) on ``y``'s device."""
        rows = self.shape[0]
        ids = torch.cat([r.to(y.device) for r in self.row_ids]).to(torch.int64)
        live = ids < rows
        idx = torch.where(live, ids, 0)
        zero = torch.zeros((), dtype=y.dtype, device=y.device)
        contrib = torch.where(live if y.ndim == 1 else live[:, None], y, zero)
        out = torch.zeros((rows,) + tuple(y.shape[1:]), dtype=y.dtype, device=y.device)
        return out.index_add_(0, idx, contrib)

    @property
    def n_shards(self) -> int:
        return len(self.indptr)

    @property
    def rows_per_shard(self) -> int:
        return self.indptr[0].shape[0] - 1

    @property
    def cap_per_shard(self) -> int:
        return self.indices[0].shape[0]

    @property
    def padded_rows(self) -> int:
        return self.n_shards * self.rows_per_shard

    @property
    def devices(self) -> list:
        return [t.device for t in self.data]

    def local_mat(self, s) -> CsMat:
        """The CsMat of one shard (shard-local row numbering)."""
        return CsMat(self.indptr[s], self.indices[s], self.data[s],
                     (self.rows_per_shard, self.shape[1]), CSR)

    def to_csmat(self) -> CsMat:
        """Gather back to one CsMat on the first shard's device."""
        from ..ops.construct import vstack

        dev = self.devices[0]
        blocks = []
        for s in range(self.n_shards):
            true_rows = int((self.row_ids[s] < self.shape[0]).sum())
            blocks.append(_csmat_to(self.local_mat(s).slice_outer(0, true_rows), dev))
        return vstack(blocks)


def shard_csr_rows(
    mat: CsMat,
    n_shards: int,
    *,
    balance: str = "rows",
    device=None,
) -> DistCsMat:
    """Partition a CSR matrix into ``n_shards`` row blocks (host-side).

    ``balance="rows"``: equal row counts.  ``balance="nnz"``: boundaries
    by cumulative nnz, still materialized as equal-size padded blocks.
    ``device``: where the shards go (see :func:`_placement`; a
    :class:`Mesh` puts shard ``s`` on slot ``s``); default the matrix's
    device.
    """
    csr, indptr, indices, data = _csr_host(mat)
    rows, cols = csr.shape
    nnz = int(indptr[-1])

    rows_per = _cdiv(max(rows, 1), n_shards)
    if balance == "rows":
        bounds = [min(s * rows_per, rows) for s in range(n_shards + 1)]
    elif balance == "nnz":
        target = np.linspace(0, nnz, n_shards + 1)
        bounds = [int(np.searchsorted(indptr, t, side="left")) for t in target]
        bounds[0], bounds[-1] = 0, rows
        for s in range(1, n_shards + 1):  # keep monotone
            bounds[s] = max(bounds[s], bounds[s - 1])
        rows_per = max(max(bounds[s + 1] - bounds[s] for s in range(n_shards)), 1)
    else:
        raise ValueError(f"unknown balance {balance!r}")

    cap_per = max(
        max((int(indptr[bounds[s + 1]] - indptr[bounds[s]]) for s in range(n_shards)), default=1),
        1,
    )
    ip = np.zeros((n_shards, rows_per + 1), dtype=np.int32)
    ix = np.zeros((n_shards, cap_per), dtype=np.int32)
    dt = np.zeros((n_shards, cap_per), dtype=data.dtype)
    rid = np.full((n_shards, rows_per), rows, dtype=np.int32)
    for s in range(n_shards):
        lo, hi = bounds[s], bounds[s + 1]
        nr = hi - lo
        base = indptr[lo]
        local_ptr = indptr[lo : hi + 1] - base
        ip[s, : nr + 1] = local_ptr
        ip[s, nr + 1 :] = local_ptr[-1]  # padding rows are empty
        rid[s, :nr] = np.arange(lo, hi, dtype=np.int32)
        k = int(local_ptr[-1])
        ix[s, :k] = indices[base : base + k]
        dt[s, :k] = data[base : base + k]
    devs = _placement(device, n_shards, mat.device)
    return DistCsMat(_on(ip, devs), _on(ix, devs), _on(dt, devs, csr.dtype), _on(rid, devs),
                     (rows, cols))


@dataclasses.dataclass(frozen=True)
class PreparedDistSpmv:
    """Routing decision + prepared shards for distributed SpMV.

    ``kind='halo'`` wraps a :class:`~sprs_tpu_torch.parallel.halo.HaloSplitCsMat`
    and runs :func:`~sprs_tpu_torch.parallel.halo.dist_spmv_halo_overlap`
    (O(halo) copies per slot); ``kind='allgather'`` wraps a
    :class:`DistCsMat` and all-gathers the sharded x (O(n) per slot).
    Built by :func:`prepare_dist_spmv`.
    """

    kind: str
    dmat: object

    @property
    def n_shards(self) -> int:
        return self.dmat.n_shards

    @property
    def shape(self):
        return self.dmat.shape

    def __call__(self, x, mesh: Mesh, *, axis: str = "shards"):
        if self.kind == "halo":
            from .halo import dist_spmv_halo_overlap

            return dist_spmv_halo_overlap(self.dmat, x, mesh, axis=axis)
        return dist_spmv(self.dmat, x, mesh, axis=axis, x_sharded=True)


def prepare_dist_spmv(
    mat: CsMat,
    n_shards: int,
    *,
    halo_frac: float = 0.25,
    device=None,
) -> PreparedDistSpmv:
    """Host-side routing for distributed SpMV over a 1-D mesh axis: the
    halo path whenever the partition's true halo width (the largest
    column reach outside a shard's own row window) is feasible (halo <=
    rows_per_shard, square matrix) and local (2·halo <= halo_frac·n),
    else the all-gather path.  The JAX package's rule."""
    csr, indptr, indices, _ = _csr_host(mat)
    rows, cols = csr.shape
    if rows == cols:
        rp = _cdiv(max(rows, 1), n_shards)
        nnz = int(indptr[-1])
        indices = indices[:nnz]
        entry_rows = np.repeat(np.arange(rows, dtype=np.int64), np.diff(indptr))
        shard_of = entry_rows // rp
        lo = shard_of * rp
        hi = np.minimum(lo + rp, rows)
        reach_l = np.maximum(lo - indices, 0)
        reach_r = np.maximum(indices - (hi - 1), 0)
        halo = int(max(reach_l.max(initial=0), reach_r.max(initial=0)))
        if halo <= rp and 2 * halo <= halo_frac * cols:
            from .halo import shard_csr_rows_halo_split

            return PreparedDistSpmv("halo", shard_csr_rows_halo_split(csr, n_shards, device=device))
    return PreparedDistSpmv("allgather", shard_csr_rows(csr, n_shards, device=device))


def _sharded_x(x: torch.Tensor, n: int, devs) -> list:
    """x padded to ``n`` equal row pieces, piece ``s`` on slot ``s``."""
    per = _cdiv(x.shape[0], n)
    xp = _pad_rows(x, n * per)
    return [_transfer(xp[s * per : (s + 1) * per], d) for s, d in enumerate(devs)]


def _x_per_slot(dmat: DistCsMat, x: torch.Tensor, devs, x_sharded: bool) -> list:
    cols = dmat.shape[1]
    if x_sharded:
        return [g[:cols] for g in _all_gather(_sharded_x(x, dmat.n_shards, devs), devs)]
    return [_transfer(x, d) for d in devs]


def dist_spmv(
    dmat: DistCsMat,
    x,
    mesh: Mesh,
    *,
    axis: str = "shards",
    x_sharded: bool = False,
) -> torch.Tensor:
    """y = A @ x with A row-sharded over ``mesh[axis]``.

    With ``x_sharded=True`` x is sharded over the same axis and
    all-gathered on every slot; otherwise x is replicated.  The output is
    row-sharded (padded length), gathered onto the mesh's first device.
    """
    devs = _slots(mesh, axis, dmat.n_shards)
    x = _input(x, devs[0])
    if x.shape[0] != dmat.shape[1]:
        raise ShapeError(f"dist_spmv: A {dmat.shape}, x {tuple(x.shape)}")
    xs = _x_per_slot(dmat, x, devs, x_sharded)
    ys = [spmv(dmat.local_mat(s), xs[s]) for s in range(dmat.n_shards)]
    return _gather_out(ys, devs[0])


def dist_spmm(
    dmat: DistCsMat,
    x,
    mesh: Mesh,
    *,
    axis: str = "shards",
    x_sharded: bool = False,
) -> torch.Tensor:
    """Y = A @ X for a dense RHS ``X (cols, k)`` with A row-sharded; the
    multi-RHS twin of :func:`dist_spmv`."""
    from ..ops.prod import spmm

    devs = _slots(mesh, axis, dmat.n_shards)
    x = _input(x, devs[0])
    if x.ndim != 2 or x.shape[0] != dmat.shape[1]:
        raise ShapeError(f"dist_spmm: A {dmat.shape}, X {tuple(x.shape)}")
    xs = _x_per_slot(dmat, x, devs, x_sharded)
    ys = [spmm(dmat.local_mat(s), xs[s]) for s in range(dmat.n_shards)]
    return _gather_out(ys, devs[0])


def _b_row_lens(db: DistCsMat) -> np.ndarray:
    """Global row lengths of a rows-balanced B (host)."""
    S, rp_b = db.n_shards, db.rows_per_shard
    b_lens = np.zeros(db.shape[0] + 1, dtype=np.int64)
    for s in range(S):
        lens = np.diff(db.indptr[s].cpu().numpy())
        r0 = s * rp_b
        take = min(rp_b, db.shape[0] - r0)
        if take > 0:
            b_lens[r0 : r0 + take] = lens[:take]
    return b_lens


def _prod_cap(da: DistCsMat, b_lens: np.ndarray) -> int:
    """The exact per-shard product count, maxed across shards (host)."""
    caps = []
    for s in range(da.n_shards):
        nnz_s = int(da.indptr[s][-1])
        idx = da.indices[s][:nnz_s].cpu().numpy()
        caps.append(int(b_lens[idx].sum()) if nnz_s else 0)
    return max(max(caps), 1)


def _check_rows_balanced(db: DistCsMat, name: str) -> None:
    ids = _host_stack(db.row_ids)
    expect = np.arange(db.n_shards * db.rows_per_shard).reshape(ids.shape)
    live_b = ids < db.shape[0]
    if not np.array_equal(ids[live_b], expect[live_b]):
        raise ShapeError(
            f"{name} needs rows-balanced B shards "
            '(shard_csr_rows(..., balance="rows"))'
        )


def _local_esc(local: CsMat, b_starts, b_lens, g_ix, g_dt, prod_cap, n_inner, out_cap):
    rows, cols, vals, total = _expand_from_rows(local, b_starts, b_lens, g_ix, g_dt, prod_cap)
    res = compress_coo(rows, cols, (vals,), total, local.rows, n_inner, out_cap)
    return res.indptr, res.indices, res.values[0]


def _dist_result(parts, row_ids, shape) -> DistCsMat:
    ip, ix, dt = zip(*parts)
    return DistCsMat(tuple(ip), tuple(ix), tuple(dt), row_ids, shape)


def dist_spgemm(
    dmat: DistCsMat,
    b: CsMat,
    mesh: Mesh,
    *,
    axis: str = "shards",
    prod_cap: Optional[int] = None,
    out_cap: Optional[int] = None,
) -> DistCsMat:
    """C = A @ B with A row-sharded and B replicated: each slot runs ESC
    SpGEMM on its row block with one shared ``prod_cap`` / ``out_cap``
    (default: the largest shard's exact product count)."""
    b = b.to_csr()
    if dmat.shape[1] != b.shape[0]:
        raise ShapeError(f"dist_spgemm: {dmat.shape} @ {b.shape}")
    devs = _slots(mesh, axis, dmat.n_shards)
    if prod_cap is None:
        prod_cap = _prod_cap(dmat, np.diff(b.indptr.cpu().numpy()))
    if out_cap is None:
        out_cap = prod_cap
    parts = []
    for s, d in enumerate(devs):
        c = spgemm(dmat.local_mat(s), _csmat_to(b, d), prod_cap=prod_cap, out_cap=out_cap,
                   check_capacity=False)
        parts.append((c.indptr, c.indices, c.data))
    return _dist_result(parts, dmat.row_ids, (dmat.shape[0], b.shape[1]))


def dist_spgemm_bshard(
    da: DistCsMat,
    db: DistCsMat,
    mesh: Mesh,
    *,
    axis: str = "shards",
    prod_cap: Optional[int] = None,
    out_cap: Optional[int] = None,
) -> DistCsMat:
    """C = A @ B with both operands row-sharded: every slot all-gathers
    B's shard arrays and expands against their gap-padded concatenation
    (shard s's entries at flat offsets [s·cap_B, s·cap_B + nnz_s)).
    Requires ``db`` rows-balanced, so that B row r is global row r."""
    if da.shape[1] != db.shape[0]:
        raise ShapeError(f"dist_spgemm_bshard: {da.shape} @ {db.shape}")
    _check_rows_balanced(db, "dist_spgemm_bshard")
    S, rp_b, cap_b = db.n_shards, db.rows_per_shard, db.cap_per_shard
    devs = _slots(mesh, axis, da.n_shards)
    if prod_cap is None:
        prod_cap = _prod_cap(da, _b_row_lens(db))
    if out_cap is None:
        out_cap = prod_cap
    g_ips = _all_gather(db.indptr, devs, tiled=False)  # (S, rp_b+1) each
    g_ixs = _all_gather(db.indices, devs)
    g_dts = _all_gather(db.data, devs)
    parts = []
    for s, d in enumerate(devs):
        g_ip = g_ips[s]
        offs = torch.arange(S, dtype=INDEX_DTYPE, device=d)[:, None] * cap_b
        b_starts = (g_ip[:, :-1] + offs).reshape(-1)
        b_lens = (g_ip[:, 1:] - g_ip[:, :-1]).reshape(-1)
        local = CsMat(da.indptr[s], da.indices[s], da.data[s], (da.rows_per_shard, S * rp_b), CSR)
        parts.append(_local_esc(local, b_starts, b_lens, g_ixs[s], g_dts[s], prod_cap,
                                db.shape[1], out_cap))
    return _dist_result(parts, da.row_ids, (da.shape[0], db.shape[1]))


@dataclasses.dataclass(frozen=True)
class BGatherPlan:
    """Host-built schedule for :func:`dist_spgemm_bgather`.

    ``rounds`` ppermute rounds fetch, per slot, only the B row blocks its
    local A columns reference; every slot runs all rounds (a slot with
    fewer references receives zeros in the others).  ``perms[k]`` is the
    (src, dst) pair list of round k (targets unique, sources may repeat).
    ``slot_of_block[i, g]`` is the slot at which device i holds block g
    (0 = its own, 1 + k = round k), or ``rounds + 1`` if unreferenced.
    ``comm_blocks`` / ``full_blocks`` quantify the saving against a full
    all-gather.
    """

    rounds: int
    perms: Tuple[Tuple[Tuple[int, int], ...], ...]
    slot_of_block: np.ndarray  # (S, S) int32
    comm_blocks: int  # max remote blocks fetched by any slot
    mean_blocks: float  # mean remote blocks per slot
    full_blocks: int  # what all-gather would move (S - 1 remote)

    @property
    def comm_fraction(self) -> float:
        """Per-slot remote B traffic relative to a full all-gather."""
        return self.comm_blocks / max(self.full_blocks, 1)


def plan_b_gather(da: DistCsMat, db: DistCsMat) -> BGatherPlan:
    """Build the referenced-block gather schedule (host-side).

    For each A shard i, the B row blocks {col // rp_b} its column
    indices touch; the remote (owner, requester) demands are greedily
    edge-coloured into partial permutations (unique sources and targets
    per round), in the JAX package's iteration order, so the rounds,
    slots and perms are the same.
    """
    S = da.n_shards
    if db.n_shards != S:
        raise ShapeError(f"plan_b_gather: {S} A shards vs {db.n_shards} B shards")
    rp_b = db.rows_per_shard
    refs = []
    ip = _host_stack(da.indptr)
    ix = _host_stack(da.indices)
    for i in range(S):
        nnz_i = int(ip[i, -1])
        blocks = np.unique(ix[i, :nnz_i] // rp_b) if nnz_i else np.zeros((0,), np.int64)
        refs.append([int(g) for g in blocks if g < S and g != i])
    mean_blocks = float(np.mean([len(r) for r in refs])) if S else 0.0
    max_blocks = max((len(r) for r in refs), default=0)

    # greedy proper edge colouring of the (owner, requester) edges
    src_used = [set() for _ in range(S)]
    dst_used = [set() for _ in range(S)]
    color_of = {}
    for i in range(S):
        for g in refs[i]:
            c = 0
            while c in src_used[g] or c in dst_used[i]:
                c += 1
            color_of[(g, i)] = c
            src_used[g].add(c)
            dst_used[i].add(c)
    K = 1 + max(color_of.values()) if color_of else 0

    nslots = K + 1  # slot 0 = own block
    slot = np.full((S, S), nslots, dtype=np.int32)
    for i in range(S):
        slot[i, i] = 0
    perms = [[] for _ in range(K)]
    for (g, i), c in color_of.items():
        perms[c].append((g, i))
        slot[i, g] = 1 + c
    return BGatherPlan(
        rounds=K,
        perms=tuple(tuple(p) for p in perms),
        slot_of_block=slot,
        comm_blocks=max_blocks,
        mean_blocks=mean_blocks,
        full_blocks=max(S - 1, 1),
    )


def dist_spgemm_bgather(
    da: DistCsMat,
    db: DistCsMat,
    mesh: Mesh,
    *,
    axis: str = "shards",
    plan: Optional[BGatherPlan] = None,
    prod_cap: Optional[int] = None,
    out_cap: Optional[int] = None,
) -> DistCsMat:
    """C = A @ B, both row-sharded, fetching only the referenced B blocks
    in ``plan.rounds`` ppermute rounds (:func:`plan_b_gather`).  Requires
    ``db`` rows-balanced, so that block g owns rows [g·rp_b, (g+1)·rp_b)."""
    if da.shape[1] != db.shape[0]:
        raise ShapeError(f"dist_spgemm_bgather: {da.shape} @ {db.shape}")
    _check_rows_balanced(db, "dist_spgemm_bgather")
    if plan is None:
        plan = plan_b_gather(da, db)
    S, rp_b, cap_b = db.n_shards, db.rows_per_shard, db.cap_per_shard
    K = plan.rounds
    nslots = K + 1
    devs = _slots(mesh, axis, da.n_shards)
    if prod_cap is None:
        prod_cap = _prod_cap(da, _b_row_lens(db))
    if out_cap is None:
        out_cap = prod_cap
    # round k: the colour-k partial permutation of B's shards
    got = [tuple(_ppermute(arrs, plan.perms[k], devs) for arrs in (db.indptr, db.indices, db.data))
           for k in range(K)]
    padded_b_rows = S * rp_b
    parts = []
    for i, d in enumerate(devs):
        g_ip = torch.stack([db.indptr[i]] + [got[k][0][i] for k in range(K)])  # (nslots, rp_b+1)
        g_ix = torch.cat([db.indices[i]] + [got[k][1][i] for k in range(K)])
        g_dt = torch.cat([db.data[i]] + [got[k][2][i] for k in range(K)])
        slot_row = _transfer(torch.from_numpy(plan.slot_of_block[i]), d).to(torch.int64)
        # global (padded) B row -> its span in the gathered arrays
        r = torch.arange(padded_b_rows, dtype=torch.int64, device=d)
        g = r // rp_b
        lr = r - g * rp_b
        sl = slot_row[g]
        safe = torch.clamp(sl, max=nslots - 1)
        start = safe * cap_b + g_ip[safe, lr]
        lens = torch.where(sl < nslots, g_ip[safe, lr + 1] - g_ip[safe, lr], 0)
        local = CsMat(da.indptr[i], da.indices[i], da.data[i], (da.rows_per_shard, padded_b_rows),
                      CSR)
        parts.append(_local_esc(local, start, lens, g_ix, g_dt, prod_cap, db.shape[1], out_cap))
    return _dist_result(parts, da.row_ids, (da.shape[0], db.shape[1]))


# ---------------------------------------------------------------------------
# 2-D block partitioning
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Dist2DCsMat:
    """Block-partitioned CSR over an (R, C) mesh: ``indptr[i][j]``,
    ``indices[i][j]``, ``data[i][j]`` store rows [i·rp, (i+1)·rp) × cols
    [j·cp, (j+1)·cp) with local column ids, on slot (i, j)'s device."""

    indptr: Tuple[Tensors, ...]
    indices: Tuple[Tensors, ...]
    data: Tuple[Tensors, ...]
    shape: Tuple[int, int]

    @property
    def grid(self) -> Tuple[int, int]:
        return len(self.indptr), len(self.indptr[0])

    @property
    def rows_per(self) -> int:
        return self.indptr[0][0].shape[0] - 1


def shard_csr_2d(mat: CsMat, grid: Tuple[int, int], *, device=None) -> Tuple[Dist2DCsMat, int]:
    """Partition into an R×C block grid (host-side).  Returns the
    distributed matrix and ``cols_per`` (the local column width of each
    block).  ``device`` as for :func:`shard_csr_rows`, block (i, j) taking
    the (i·C + j)-th device."""
    csr, indptr, indices, data = _csr_host(mat)
    rows, cols = csr.shape
    R, C = grid
    rp = _cdiv(max(rows, 1), R)
    cp = _cdiv(max(cols, 1), C)

    nnz = int(indptr[-1])
    rows_of = np.repeat(np.arange(rows, dtype=np.int64), np.diff(indptr).astype(np.int64))
    cols_of = indices[:nnz].astype(np.int64)
    bi = rows_of // rp
    bj = cols_of // cp
    block = bi * C + bj
    # a stable sort by block keeps the CSR (row, col) order in each block
    order = np.argsort(block, kind="stable")
    sblock = block[order]
    bcount = np.bincount(sblock, minlength=R * C).astype(np.int64)
    cap = max(int(bcount.max()) if nnz else 1, 1)
    boffs = np.zeros(R * C + 1, dtype=np.int64)
    np.cumsum(bcount, out=boffs[1:])
    rank = np.arange(nnz, dtype=np.int64) - np.repeat(boffs[:-1], bcount)
    local_col = cols_of[order] - (sblock % C) * cp
    ix = np.zeros((R * C, cap), dtype=np.int32)
    dt = np.zeros((R * C, cap), dtype=data.dtype)
    ix[sblock, rank] = local_col
    dt[sblock, rank] = data[:nnz][order]
    lr_counts = np.bincount(block * rp + rows_of - bi * rp, minlength=R * C * rp).reshape(R * C, rp)
    ip = np.zeros((R * C, rp + 1), dtype=np.int32)
    np.cumsum(lr_counts, axis=1, out=ip[:, 1:])
    devs = _placement(device, R * C, mat.device)

    def grid_of(arr, dtype=None):
        flat = _on(arr, devs, dtype)
        return tuple(tuple(flat[i * C : (i + 1) * C]) for i in range(R))

    return Dist2DCsMat(grid_of(ip), grid_of(ix), grid_of(dt, csr.dtype), (rows, cols)), cp


def dist_spmv_2d(
    dmat: Dist2DCsMat,
    cols_per: int,
    x,
    mesh: Mesh,
    *,
    row_axis: str = "r",
    col_axis: str = "c",
) -> torch.Tensor:
    """2-D SpMV: x sharded over the column axis, a local block SpMV per
    slot, the partials summed over the column axis in column order onto
    each row's first slot; y (R·rp,) gathered onto the mesh's first
    device.  The sum order differs from XLA's ``psum``."""
    R, C = dmat.grid
    devs = mesh.axis_devices(row_axis, col_axis)
    if devs.shape != (R, C):
        raise ShapeError(f"a {R}x{C} block grid on a mesh of {devs.shape}")
    x = _input(x, devs[0, 0])
    if x.shape[0] != dmat.shape[1]:
        raise ShapeError(f"dist_spmv_2d: A {dmat.shape}, x {tuple(x.shape)}")
    rp = dmat.rows_per
    xp = _pad_rows(x, C * cols_per)
    ys = []
    for i in range(R):
        partials = []
        for j in range(C):
            local = CsMat(dmat.indptr[i][j], dmat.indices[i][j], dmat.data[i][j], (rp, cols_per),
                          CSR)
            xs = _transfer(xp[j * cols_per : (j + 1) * cols_per], devs[i, j])
            partials.append(spmv(local, xs))
        acc = partials[0]
        for p in partials[1:]:
            acc = acc + _transfer(p, devs[i, 0])
        ys.append(acc)
    return _gather_out(ys, devs[0, 0])
