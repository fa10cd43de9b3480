"""BSR (block compressed sparse row), the PyTorch counterpart of
``sprs_tpu/formats/bsr.py``.

Nonzero (bs, bs) tiles are stored as a dense ``(cap, bs, bs)`` stack plus
per-block coordinate vectors ``brows`` and ``bcols``, so that a product
with a dense right-hand side is a stream of dense ``block @ X-block``
products (kernels K3 and K4, ``ops/cuda/bsr_spmm.py``).

Layout, kept array for array with the JAX package: the constructors sort
blocks by (block row, block column), and two invariants hold:

* every block row stores **at least one** block (conversion inserts an
  explicit zero block into empty rows);
* padding blocks (slots >= ``n_blocks``) carry the last real block's row,
  a column of 0 and zero data.

The JAX kernel needs both invariants and the row order.  The port's
kernel needs neither: it walks each block row through a row pointer built
once per matrix (:attr:`BsrMat.row_order`), over the live blocks only.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple, Union

import numpy as np
import torch

from ..errors import ShapeError
from .csmat import CsMat
from .util import DEFAULT_DEVICE, INDEX_DTYPE, index_sum_, round_up, torch_dtype


@dataclasses.dataclass(frozen=True)
class BsrMat:
    """Block-sparse matrix with square ``block_size`` tiles.

    ``brows (cap,) i32``, ``bcols (cap,) i32``, ``blocks (cap, bs, bs)``,
    all on one device; ``shape`` (logical) and ``n_blocks`` (live count)
    are plain Python values.
    """

    brows: torch.Tensor
    bcols: torch.Tensor
    blocks: torch.Tensor
    shape: Tuple[int, int]
    n_blocks: int

    @property
    def block_size(self) -> int:
        return self.blocks.shape[1]

    @property
    def rows(self) -> int:
        return self.shape[0]

    @property
    def cols(self) -> int:
        return self.shape[1]

    @property
    def n_block_rows(self) -> int:
        return round_up(self.shape[0], self.block_size) // self.block_size

    @property
    def n_block_cols(self) -> int:
        return round_up(self.shape[1], self.block_size) // self.block_size

    @property
    def cap(self) -> int:
        return self.blocks.shape[0]

    @property
    def dtype(self) -> torch.dtype:
        return self.blocks.dtype

    @property
    def device(self) -> torch.device:
        return self.blocks.device

    @property
    def block_density(self) -> float:
        return self.n_blocks / max(self.n_block_rows * self.n_block_cols, 1)

    @functools.cached_property
    def row_order(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(row_ptr, order)``, both int32 on the matrix's device: the
        live blocks of block row r are ``order[row_ptr[r]:row_ptr[r+1]]``.
        Built once per matrix (bincount and prefix sum for the pointer,
        a stable sort by block row for the order), so the kernels do not
        depend on the blocks being sorted by row."""
        live = self.brows[: self.n_blocks].to(torch.int64)
        counts = torch.bincount(live, minlength=self.n_block_rows)
        row_ptr = torch.zeros(
            self.n_block_rows + 1, dtype=INDEX_DTYPE, device=self.device
        )
        row_ptr[1:] = torch.cumsum(counts, 0)
        order = torch.argsort(live, stable=True).to(INDEX_DTYPE)
        return row_ptr, order

    def to_dense(self) -> torch.Tensor:
        bs = self.block_size
        out = torch.zeros(
            (self.n_block_rows, self.n_block_cols, bs, bs),
            dtype=self.dtype,
            device=self.device,
        )
        # a slice with no block row keeps one block whose row lies past
        # the end: drop it, as the JAX scatter does
        keep = self.brows < self.n_block_rows
        out.index_put_(
            (self.brows[keep].to(torch.int64), self.bcols[keep].to(torch.int64)),
            self.blocks[keep],
            accumulate=True,
        )
        dense = out.permute(0, 2, 1, 3).reshape(
            self.n_block_rows * bs, self.n_block_cols * bs
        )
        return dense[: self.rows, : self.cols]

    def slice_block_rows(self, r0: int, r1: int) -> "BsrMat":
        """Rows ``[r0, r1)`` as a new BsrMat (bounds must be
        ``block_size``-aligned except ``r1 == rows``); the surviving
        blocks keep their order and padding is dropped."""
        bs = self.block_size
        if r0 % bs or (r1 % bs and r1 != self.rows):
            raise ShapeError(
                f"slice_block_rows bounds ({r0}, {r1}) must align to "
                f"block_size {bs}"
            )
        br = self.brows[: self.n_blocks].cpu().numpy()
        keep = np.nonzero((br >= r0 // bs) & (br < -(-r1 // bs)))[0]
        dev = self.device
        if keep.size == 0:
            return BsrMat(
                torch.zeros(1, dtype=INDEX_DTYPE, device=dev),
                torch.zeros(1, dtype=INDEX_DTYPE, device=dev),
                torch.zeros((1, bs, bs), dtype=self.dtype, device=dev),
                (r1 - r0, self.cols),
                1,
            )
        ids = torch.from_numpy(keep).to(dev)
        return BsrMat(
            torch.from_numpy((br[keep] - r0 // bs).astype(np.int32)).to(dev),
            self.bcols[ids],
            self.blocks[ids],
            (r1 - r0, self.cols),
            int(keep.size),
        )

    def to_csmat(self, *, eps: float = 0.0, cap: Optional[int] = None) -> CsMat:
        """CSR view of this block matrix (``from_dense`` on the densified
        blocks)."""
        from .csmat import from_dense

        return from_dense(self.to_dense(), eps=eps, cap=cap, device=self.device)

    def __matmul__(self, other):
        from ..ops import matmul

        return matmul(self, other)

    def __repr__(self):
        return (
            f"BsrMat(shape={self.shape}, bs={self.block_size}, "
            f"n_blocks={self.n_blocks}/{self.cap}, "
            f"block_density={self.block_density:.4f}, dtype={self.dtype})"
        )


def _host(arr) -> np.ndarray:
    """numpy copy of an array or tensor; bfloat16 goes through float32,
    which holds it exactly."""
    if isinstance(arr, torch.Tensor):
        arr = arr.detach().cpu()
        if arr.dtype == torch.bfloat16:
            arr = arr.float()
        return arr.numpy()
    return np.asarray(arr)


def _pad_and_build(brows, bcols, blocks, shape, cap, dtype, device) -> BsrMat:
    """Append padding blocks up to ``cap`` (last row, column 0, zero
    data) and move the arrays to ``device``."""
    n_blocks = brows.shape[0]
    bs = blocks.shape[1]
    if cap is None:
        cap = n_blocks
    if cap < n_blocks:
        raise ShapeError(f"cap {cap} < n_blocks {n_blocks}")
    if cap > n_blocks:
        pad = cap - n_blocks
        brows = np.concatenate([brows, np.full((pad,), brows[-1], np.int32)])
        bcols = np.concatenate([bcols, np.zeros((pad,), np.int32)])
        blocks = np.concatenate([blocks, np.zeros((pad, bs, bs), blocks.dtype)])
    return BsrMat(
        torch.from_numpy(brows.astype(np.int32)).to(device),
        torch.from_numpy(bcols.astype(np.int32)).to(device),
        torch.from_numpy(blocks).to(device=device, dtype=dtype),
        tuple(int(s) for s in shape),
        int(n_blocks),
    )


def bsr_from_dense(
    arr,
    block_size: int = 128,
    *,
    eps: float = 0.0,
    cap: Optional[int] = None,
    dtype=None,
    device=DEFAULT_DEVICE,
) -> BsrMat:
    """Host-side conversion: keep blocks with any |entry| > eps.

    Empty block rows get one explicit zero block.  ``dtype`` defaults to
    the input's."""
    if dtype is None:
        dtype = arr.dtype if isinstance(arr, torch.Tensor) else np.asarray(arr).dtype
    a = _host(arr)
    if a.ndim != 2:
        raise ShapeError("bsr_from_dense expects a 2-D array")
    r, c = a.shape
    bs = block_size
    nbr, nbc = round_up(r, bs) // bs, round_up(c, bs) // bs
    padded = np.zeros((nbr * bs, nbc * bs), dtype=a.dtype)
    padded[:r, :c] = a
    tiles = padded.reshape(nbr, bs, nbc, bs).transpose(0, 2, 1, 3)
    keep = np.abs(tiles).max(axis=(2, 3)) > eps

    brows, bcols, blocks = [], [], []
    for i in range(nbr):
        cols_i = np.nonzero(keep[i])[0]
        if cols_i.size == 0:
            cols_i = np.array([0])  # explicit zero block
            tiles_i = np.zeros((1, bs, bs), dtype=a.dtype)
        else:
            tiles_i = tiles[i, cols_i]
        brows.append(np.full(cols_i.shape, i, dtype=np.int32))
        bcols.append(cols_i.astype(np.int32))
        blocks.append(tiles_i)
    return _pad_and_build(
        np.concatenate(brows),
        np.concatenate(bcols),
        np.concatenate(blocks),
        (r, c),
        cap,
        torch_dtype(dtype),
        device,
    )


def bsr_from_csmat(
    mat: CsMat, block_size: int = 128, *, cap: Optional[int] = None
) -> BsrMat:
    """Host-side CSR → BSR conversion from the entry coordinates alone
    (never densifying); the result lies on ``mat``'s device.  A block
    exists iff it holds at least one structural entry; empty block rows
    get one explicit zero block, as in :func:`bsr_from_dense`."""
    a = mat.to_csr()
    indptr = a.indptr.cpu().numpy()
    nnz = int(indptr[-1])
    cols = a.indices[:nnz].cpu().numpy()
    vals = _host(a.data[:nnz])
    rows = np.repeat(np.arange(a.rows, dtype=np.int64), np.diff(indptr))
    r, c = a.shape
    bs = block_size
    nbr, nbc = round_up(r, bs) // bs, round_up(c, bs) // bs

    br = rows // bs
    bc = cols.astype(np.int64) // bs
    key = br * nbc + bc
    uniq = np.unique(key)  # sorted == (brow, bcol) lexicographic
    blk_of = np.searchsorted(uniq, key)
    u_br = (uniq // nbc).astype(np.int32)
    u_bc = (uniq % nbc).astype(np.int32)

    present = np.zeros(nbr, dtype=bool)
    present[u_br] = True
    missing = np.nonzero(~present)[0].astype(np.int32)
    all_br = np.concatenate([u_br, missing])
    all_bc = np.concatenate([u_bc, np.zeros(missing.size, np.int32)])
    order = np.lexsort((all_bc, all_br))
    pos = np.empty(all_br.size, np.int64)
    pos[order] = np.arange(all_br.size)
    blk_new = pos[blk_of]

    blocks = np.zeros((all_br.size, bs, bs), dtype=vals.dtype)
    blocks[blk_new, rows % bs, cols % bs] = vals
    return _pad_and_build(
        all_br[order], all_bc[order], blocks, (r, c), cap, mat.dtype, mat.device
    )


def bsr_from_dense_device(arr: torch.Tensor, block_size: int = 128, *, eps: float = 0.0) -> BsrMat:
    """Dense → BSR on the array's device, with no per-element placement:
    the block mask is a reduction, the kept blocks one gather of whole
    tiles.  Only the (block rows × block columns) mask is read back, to
    fix the block list; the dense array never leaves the device.  Rows
    and columns are zero-padded to a block multiple; an empty block row
    gets an explicit zero block, as :func:`bsr_from_dense` gives it."""
    if arr.ndim != 2:
        raise ShapeError("bsr_from_dense_device expects a 2-D array")
    r, c = arr.shape
    bs = block_size
    nbr, nbc = round_up(r, bs) // bs, round_up(c, bs) // bs
    pad = arr
    if (nbr * bs, nbc * bs) != (r, c):
        pad = arr.new_zeros((nbr * bs, nbc * bs))
        pad[:r, :c] = arr
    tiles = pad.reshape(nbr, bs, nbc, bs).transpose(1, 2)  # (nbr, nbc, bs, bs), a view
    keep = (tiles.abs().amax(dim=(2, 3)) > eps).cpu().numpy()
    bi, bj = np.nonzero(keep)  # row-major: sorted by (block row, block column)
    empty = np.nonzero(~keep.any(1))[0]
    brows = np.concatenate([bi, empty])
    bcols = np.concatenate([bj, np.zeros(empty.size, np.int64)])
    live = np.concatenate([np.ones(bi.size, bool), np.zeros(empty.size, bool)])
    order = np.lexsort((bcols, brows))
    brows, bcols, live = brows[order], bcols[order], live[order]
    dev = arr.device
    br = torch.from_numpy(brows.astype(np.int32)).to(dev)
    bc = torch.from_numpy(bcols.astype(np.int32)).to(dev)
    blocks = tiles[br.to(torch.int64), bc.to(torch.int64)]
    blocks *= torch.from_numpy(live).to(dev)[:, None, None]
    return BsrMat(br, bc, blocks, (int(r), int(c)), int(brows.size))


def bsr_spmm_plain(bsr: BsrMat, x: torch.Tensor) -> torch.Tensor:
    """Y = A @ X, plain torch: batched block products and an indexed sum
    over block rows, in float32 for every operand type (the counterpart
    of the JAX package's ``bsr_spmm_xla``, whose ``preferred_element_type``
    is float32: an f64 product is f32-accurate there and here).  The
    result has X's type when A and X share it, else float32.  Its
    ``calls`` attribute counts calls."""
    bsr_spmm_plain.calls += 1
    if x.ndim != 2 or x.shape[0] != bsr.cols:
        raise ShapeError(f"bsr_spmm: A is {bsr.shape}, X is {tuple(x.shape)}")
    bs = bsr.block_size
    k = x.shape[1]
    xp = x.new_zeros((bsr.n_block_cols * bs, k))
    xp[: bsr.cols] = x
    xb = xp.reshape(bsr.n_block_cols, bs, k)
    prods = torch.einsum(
        "nij,njk->nik",
        bsr.blocks.float(),
        xb[bsr.bcols.to(torch.int64)].float(),
    )
    out = index_sum_(prods.new_zeros((bsr.n_block_rows, bs, k)), bsr.brows.to(torch.int64), prods)
    out = out.reshape(bsr.n_block_rows * bs, k)[: bsr.rows]
    return out.to(x.dtype) if x.dtype == bsr.dtype else out


bsr_spmm_plain.calls = 0


def bsr_random(
    seed: Union[int, torch.Generator],
    shape: Tuple[int, int],
    block_size: int = 128,
    block_density: float = 0.1,
    dtype=torch.float32,
    *,
    device=DEFAULT_DEVICE,
) -> BsrMat:
    """Random block-sparse matrix for benches and tests (host-side),
    seeded by an int or a ``torch.Generator``: each block slot is kept
    with probability ``block_density`` and filled with standard normals
    (drawn in float64 and stored in float32 first, in row-major block
    order, as the JAX package's ``bsr_random`` fills its dense array).
    The blocks are built directly, never through a dense matrix."""
    if isinstance(seed, torch.Generator):
        seed = int(torch.randint(0, 2**31 - 1, (), generator=seed))
    rng = np.random.default_rng(seed)
    bs = block_size
    nbr = round_up(shape[0], bs) // bs
    nbc = round_up(shape[1], bs) // bs
    keep = rng.random((nbr, nbc)) < block_density
    bi, bj = np.nonzero(keep)
    blocks = rng.standard_normal((bi.size, bs, bs)).astype(np.float32)
    # entries past the logical shape are zero, as after the JAX slice
    lane = np.arange(bs)
    blocks *= (lane[None, :] < shape[0] - bi[:, None] * bs)[:, :, None]
    blocks *= (lane[None, :] < shape[1] - bj[:, None] * bs)[:, None, :]
    empty = np.setdiff1d(np.arange(nbr), bi)
    brows = np.concatenate([bi, empty]).astype(np.int32)
    bcols = np.concatenate([bj, np.zeros(empty.size, np.int64)]).astype(np.int32)
    blocks = np.concatenate([blocks, np.zeros((empty.size, bs, bs), np.float32)])
    order = np.lexsort((bcols, brows))
    return _pad_and_build(
        brows[order], bcols[order], blocks[order], shape, None,
        torch_dtype(dtype), device,
    )
