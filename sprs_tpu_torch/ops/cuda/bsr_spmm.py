"""Block-sparse SpMM kernels K3 and K4: Y = A @ X for a BSR matrix A.

The CUDA C++ kernel is ``sprs_tpu_torch/csrc/bsr_spmm.cu``; its note says
which TPU functions it replaces, what bounds it and how its design goes
about it.  This module holds what surrounds it:

* :func:`bsr_spmm_kernel` (K3) and :func:`bsr_spmv_kernel`, the
  counterparts of ``bsr_spmm_pallas`` and ``bsr_spmv_pallas``;
* :func:`bsr_group`, the host repack of the JAX package, and
  :func:`bsr_spmm_grouped_kernel` (K4), the counterpart of
  ``bsr_spmm_pallas_grouped``: on a group-aligned matrix
  (``cap % group == 0``) it launches the same kernel on the repacked
  operand, under its own ``launches`` count; else it takes the per-block
  path, K3, as the JAX function does;
* a ``torch.autograd.Function`` whose backward (:func:`bsr_vjp`) is the
  plain torch form of the JAX package's ``_spmm_bwd``.

Every (blocks, X) pair of float16, bfloat16, float32 and float64 is a
form (``forms.FORMS``).  As in the Pallas kernels, products and sums are
taken in float32 and Y has the type promote(blocks, X), rounded once.
The plain version is ``formats/bsr.py::bsr_spmm_plain`` (the counterpart
of the JAX ``bsr_spmm_xla``, whose output type is X's where blocks and X
share it, else float32); each wrapper takes it for tensors on the CPU and
casts its float32 sums to promote(blocks, X), exactly.  Tensors on a CUDA
device launch a kernel or raise — never both.  The source has two
kernels, both on the tensor cores, and :func:`variant` picks one by an
explicit rule: the wgmma kernel ("tc": float16 or bfloat16 blocks and X
of one type, block size 64 or 128, k a multiple of 8, X and the blocks
16-byte aligned, as TMA needs) or the TF32 kernel ("tf32x3": every other
case, in the number of TF32 passes that :func:`tf32_passes` gives the
form).  Each wrapper's ``launches`` counts its launches,
``launches_<form>`` those of each form, and ``launches_tc`` and
``launches_tf32x3`` those of each variant.  The kernels read the
block-row pointer that :attr:`BsrMat.row_order` builds once per matrix,
so they take the blocks in any order.  The launch configuration is
computed here in Python (:func:`launch_config`) so the CPU tests reach
it.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import numpy as np
import torch

from ...errors import ShapeError
from ...formats.bsr import BsrMat, bsr_spmm_plain
from ...formats.util import INDEX_DTYPE, index_sum_
from . import build
from .forms import FORMS, HALVES, count_launch, form_of, zero_counts

THREADS = 512  # 16 warps in the 3xTF32 kernel (csrc/bsr_spmm.cu: kTf32Threads)
TILE_N = 128  # output columns per CTA of both kernels (kTf32TileN, kTcTileN)
BLOCK_MULTIPLE = 8  # block sizes are multiples of an MMA's depth
MAX_BLOCK = 128
TC_BLOCK_SIZES = (64, 128)  # one or two 64-row wgmma tiles

# (blocks dtype, X dtype) -> the TF32 kernel's entry point of that form
_ENTRY = {pair: f"sprs_bsr_spmm_tf32x3_{form}" for pair, form in FORMS.items()}
_TC_ENTRY = {torch.bfloat16: "sprs_bsr_spmm_tc_bf16", torch.float16: "sprs_bsr_spmm_tc_f16"}


def tf32_passes(blocks_dtype: torch.dtype, x_dtype: torch.dtype) -> int:
    """The TF32 passes the "tf32x3" kernel takes for a form: one, plus one
    for each operand wider than 16 bits.  A 16-bit value is exact in TF32
    (its 8- or 11-bit significand fits TF32's 11 bits, float16's
    subnormals included), so its low part is 0 and only a wider operand
    adds a pass (hi·hi, then lo·hi for each split side); float64 operands
    are rounded to float32 first, as the Pallas kernel's float32 products
    take them.  The C entry table of ``csrc/bsr_spmm.cu`` mirrors this."""
    return 1 + sum(t not in HALVES for t in (blocks_dtype, x_dtype))


def variant(
    dtype: torch.dtype, bs: int, k: int, x_ptr: int, blocks_ptr: int, x_dtype: torch.dtype = None
) -> str:
    """"tc" (the wgmma kernel) for float16 or bfloat16 blocks (``dtype``)
    and X (``x_dtype``, the blocks' type where not given) of one type, at
    block size 64 or 128, when TMA can read X and the blocks: rows of X
    of whole 16 bytes (k a multiple of 8) and both starting on 16-byte
    boundaries; else "tf32x3"."""
    if (
        dtype in HALVES
        and (x_dtype is None or x_dtype == dtype)
        and bs in TC_BLOCK_SIZES
        and k % 8 == 0
        and x_ptr % 16 == 0
        and blocks_ptr % 16 == 0
    ):
        return "tc"
    return "tf32x3"


def launch_config(n_block_rows: int, k: int, kind: str, bs: int) -> Tuple[Tuple[int, int], int]:
    """((grid_x, grid_y), block): one CTA per (block row, column tile of
    X): 128 columns in both; 16 warps in the 3xTF32 kernel, bs / 64
    consumer warpgroups plus one producer warp in the wgmma kernel."""
    grid = (max(n_block_rows, 1), max(-(-k // TILE_N), 1))
    return grid, 128 * (bs // 64) + 32 if kind == "tc" else THREADS


@functools.lru_cache(maxsize=None)
def _entry(name: str):
    fn = getattr(build.load("bsr_spmm"), name)
    ll, vp, i = ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int
    if name in _TC_ENTRY.values():
        fn.argtypes = [vp, vp, vp, vp, vp, vp, ll, ll, ll, i, ll, i, i, vp]
    else:
        fn.argtypes = [vp, vp, vp, vp, vp, vp, ll, ll, ll, i, i, i, vp]
    fn.restype = ctypes.c_int
    return fn


def _launch(bsr: BsrMat, blocks: torch.Tensor, x: torch.Tensor, counter) -> torch.Tensor:
    if bsr.bcols.dtype != INDEX_DTYPE:
        raise TypeError(
            f"bsr_spmm kernel reads bcols as {INDEX_DTYPE}, got {bsr.bcols.dtype}"
        )
    if blocks.device.type != "cuda" or x.device != blocks.device:
        raise ValueError(
            f"bsr_spmm kernel needs blocks and X on one CUDA device, got "
            f"{blocks.device} and {x.device}"
        )
    form = form_of("bsr_spmm", blocks, x)
    bs = bsr.block_size
    if bs % BLOCK_MULTIPLE or not BLOCK_MULTIPLE <= bs <= MAX_BLOCK:
        raise ShapeError(
            f"bsr_spmm kernel takes block sizes that are multiples of {BLOCK_MULTIPLE} "
            f"up to {MAX_BLOCK}, got {bs}"
        )
    if not (blocks.is_contiguous() and x.is_contiguous() and bsr.bcols.is_contiguous()):
        raise ValueError("bsr_spmm kernel needs contiguous blocks, bcols and X")
    k = x.shape[1]
    y = torch.empty((bsr.rows, k), dtype=torch.promote_types(blocks.dtype, x.dtype), device=x.device)
    if bsr.rows == 0 or k == 0:
        return y
    row_ptr, order = bsr.row_order
    kind = variant(blocks.dtype, bs, k, x.data_ptr(), blocks.data_ptr(), x.dtype)
    (gx, gy), _ = launch_config(bsr.n_block_rows, k, kind, bs)
    args = [
        blocks.data_ptr(),
        bsr.bcols.data_ptr(),
        row_ptr.data_ptr(),
        order.data_ptr(),
        x.data_ptr(),
        y.data_ptr(),
        bsr.rows,
        bsr.cols,
        k,
        bs,
    ]
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if kind == "tc":
        err = _entry(_TC_ENTRY[x.dtype])(*args, bsr.cap, gx, gy, stream)
    else:
        err = _entry(_ENTRY[(blocks.dtype, x.dtype)])(*args, gx, gy, stream)
    if err != 0:
        raise RuntimeError(f"bsr_spmm kernel ({kind}, {form}) launch failed: CUDA error {err}")
    count_launch(counter, form)
    if kind == "tc":
        counter.launches_tc += 1
    else:
        counter.launches_tf32x3 += 1
    return y


def bsr_vjp(bsr: BsrMat, blocks: torch.Tensor, x: torch.Tensor, g: torch.Tensor):
    """(dblocks, dX) for Y = A @ X, in float32 as the JAX ``_spmm_bwd``:
    dblocks[n] = G[brows[n]] @ X[bcols[n]]ᵀ and
    dX[bcols[n]] += blocks[n]ᵀ @ G[brows[n]], over every slot."""
    bs, k = bsr.block_size, x.shape[1]
    nbr, nbc = bsr.n_block_rows, bsr.n_block_cols
    gb = g.new_zeros((nbr * bs, k))
    gb[: bsr.rows] = g
    gb = gb.reshape(nbr, bs, k)[bsr.brows.to(torch.int64)].float()
    xb = x.new_zeros((nbc * bs, k))
    xb[: bsr.cols] = x
    bcols = bsr.bcols.to(torch.int64)
    xb = xb.reshape(nbc, bs, k)[bcols].float()
    dblocks = torch.einsum("nik,njk->nij", gb, xb).to(blocks.dtype)
    contrib = torch.einsum("nji,njk->nik", blocks.float(), gb)
    dxb = index_sum_(contrib.new_zeros((nbc, bs, k)), bcols, contrib)
    return dblocks, dxb.reshape(nbc * bs, k)[: bsr.cols].to(x.dtype)


class _BsrSpmm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, blocks, x, bsr, counter):
        ctx.save_for_backward(blocks, x)
        ctx.bsr = bsr
        if blocks.device.type == "cpu" and x.device.type == "cpu":
            return bsr_spmm_plain(bsr, x).to(torch.promote_types(blocks.dtype, x.dtype))
        return _launch(bsr, blocks, x, counter)

    @staticmethod
    def backward(ctx, g):
        blocks, x = ctx.saved_tensors
        dblocks, dx = bsr_vjp(ctx.bsr, blocks, x, g)
        return dblocks, dx, None, None


def _apply(bsr: BsrMat, x: torch.Tensor, counter) -> torch.Tensor:
    if x.ndim != 2 or x.shape[0] != bsr.cols:
        raise ShapeError(f"bsr_spmm: A is {bsr.shape}, X is {tuple(x.shape)}")
    return _BsrSpmm.apply(bsr.blocks, x.contiguous(), bsr, counter)


def bsr_spmm_kernel(bsr: BsrMat, x: torch.Tensor) -> torch.Tensor:
    """Y = A @ X through K3; X is dense, (cols, k); Y has the type
    promote(blocks, X).  Differentiable in ``bsr.blocks`` and ``X``."""
    return _apply(bsr, x, bsr_spmm_kernel)


zero_counts(bsr_spmm_kernel)
bsr_spmm_kernel.launches_tc = 0
bsr_spmm_kernel.launches_tf32x3 = 0


def bsr_spmv_kernel(bsr: BsrMat, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x through K3 with one RHS column."""
    return bsr_spmm_kernel(bsr, x[:, None])[:, 0]


def bsr_group(bsr: BsrMat, group: int) -> BsrMat:
    """Host repack: pad each block row's block count to a multiple of
    ``group`` with zero blocks, so every run of ``group`` slots holds
    blocks of one row (arrays equal to the JAX package's ``bsr_group``).
    All slots of the result are live."""
    nb = bsr.n_blocks
    brows = bsr.brows[:nb].cpu().numpy()
    bcols = bsr.bcols[:nb].cpu().numpy()
    blocks = bsr.blocks[:nb].cpu()
    bs = bsr.block_size
    out_r, out_c, out_b = [], [], []
    for r in range(bsr.n_block_rows):
        sel = np.nonzero(brows == r)[0]
        pad = (-sel.size) % group
        out_r.append(np.full(sel.size + pad, r, np.int32))
        out_c.append(np.concatenate([bcols[sel], np.zeros(pad, np.int32)]))
        out_b.append(blocks[torch.from_numpy(sel)])
        out_b.append(blocks.new_zeros((pad, bs, bs)))
    brows2 = np.concatenate(out_r)
    dev = bsr.device
    return BsrMat(
        torch.from_numpy(brows2).to(dev),
        torch.from_numpy(np.concatenate(out_c).astype(np.int32)).to(dev),
        torch.cat(out_b).to(dev),
        bsr.shape,
        int(brows2.shape[0]),
    )


def bsr_spmm_grouped_kernel(bsr: BsrMat, x: torch.Tensor, group: int = 8) -> torch.Tensor:
    """Y = A @ X through K4, ``group`` blocks of one row at a time.

    ``bsr`` must be row-group-aligned (use :func:`bsr_group`); when
    ``bsr.cap % group != 0`` this takes the per-block path, K3, as
    ``bsr_spmm_pallas_grouped`` does.  (The JAX function's other escape,
    an X too large for the TPU's VMEM, has no counterpart here.)"""
    if bsr.cap % group != 0:
        return bsr_spmm_kernel(bsr, x)
    return _apply(bsr, x, bsr_spmm_grouped_kernel)


zero_counts(bsr_spmm_grouped_kernel)
bsr_spmm_grouped_kernel.launches_tc = 0
bsr_spmm_grouped_kernel.launches_tf32x3 = 0
