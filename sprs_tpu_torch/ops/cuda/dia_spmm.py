"""Banded SpMM kernel K2: Y[i, c] = Σ_d data[d, i] · X[i + off_d, c].

The CUDA C++ kernel is ``sprs_tpu_torch/csrc/dia_spmm.cu``; its note says
which TPU functions it replaces, what bounds it (bytes: the diagonals, X
and Y each cross device memory once) and how its design meets that bound.
This module holds what surrounds it, as ``dia_spmv.py`` does for K1:

* :func:`dia_spmm_plain`, the plain torch version (``formats/dia.py::
  dia_spmm``, widened for 16-bit operands as ``forms.widened`` says), used for
  tensors on the CPU and as the kernel's reference on the card.  Its
  ``calls`` attribute counts calls;
* :func:`dia_spmm_kernel`, the wrapper: it runs as ``launch.run`` says
  (CPU tensors take the plain version, CUDA tensors launch the kernel or
  raise — never both).  It takes the type forms of ``forms.FORMS``.  Its
  ``launches`` attribute counts kernel launches, ``launches_tma`` and
  ``launches_scalar`` those of each variant, and ``launches_<form>``
  those of each form.  Every RHS width takes
  the kernel: the JAX package's ``k >= 256`` cut (``ops/prod.py``) is a
  TPU measurement and has no counterpart here;
* :func:`variant`, the rule that picks the kernel's variant: "tma" (X and
  the coefficients staged in shared memory by TMA, 16-byte stores of Y)
  when a row of X is whole 16-byte vectors and X starts on a 16-byte
  boundary, else "scalar".  X's element size decides, whatever the
  diagonals' type: Y's type, ``promote(data, X)``, is at least as wide as
  X's, so its rows are then whole 16-byte vectors too, and Y is allocated
  here, aligned.  :func:`variant_for` applies it to an operand, and sends
  operands past TMA's 32-bit coordinates (2^30 rows, columns or offset)
  to the scalar variant;
* the tma variant's shapes, which the C entry mirrors: :func:`tile_shape`
  (T rows by kc columns), :func:`slab_plan` (which diagonals share one
  load of X) and :func:`ring` (the stages of shared memory);
* a ``torch.autograd.Function``, for products that need a gradient,
  whose backward is :func:`~.dia_spmv.dia_vjp`, the plain torch form of
  the JAX package's ``_bwd``.

The prepared operand is K1's :class:`~.dia_spmv.DiaTiledMat`, whose
``spmm`` method calls this wrapper.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from ...errors import ShapeError
from ...formats.dia import DiaMat, dia_spmm
from ...formats.util import round_up
from . import launch
from .dia_spmv import MAX_DIAGS, dia_vjp, widened_sum
from .forms import FORMS, form_of, widened
from .launch import I32, I64, PTR

VECTOR_BYTES = 16
# the scalar variant (csrc/dia_spmm.cu)
THREADS = 256  # kThreads
RUN = 4  # consecutive rows per thread (kRun)
BLOCKS_PER_SM = 3  # resident CTAs per SM (kMinBlocks)
# the tma variant
TMA_THREADS = 544  # kTmaThreads: 16 consumer warps and the producer warp
TMA_CTAS_PER_SM = 1  # kTmaCtasPerSm
TMA_CONSUMERS = 512  # kTmaConsumers
# kPairs: (row, vector) pairs per consumer thread by the sums' element
# size; a tile is PAIRS * TMA_CONSUMERS 16-byte vectors of X (32 or 16 KB)
PAIRS = {4: 4, 8: 2}
MAX_TILE_COLS = 128  # kMaxTileCols
MAX_TILE_ROWS = 128  # kMaxTileRows
MAX_SPAN = 2  # kMaxSpan: rows between a slab's lowest and highest offset
SLAB_DIAGS = MAX_SPAN + 1  # kSlabDiags
MAX_STAGES = 16  # kMaxStages
SMEM_ALIGN = 128  # kSmemAlign
SM_SMEM = 233_472  # shared memory per SM, bytes (228 KB); 1 KB of it reserved per CTA
SMEM_PER_CTA = SM_SMEM // TMA_CTAS_PER_SM - 1024  # kSmemPerCta
COORD_LIMIT = 1 << 30  # kCoordLimit


def variant(k: int, itemsize: int, x_ptr: int) -> str:
    """"tma" when every row of X is whole 16-byte vectors and X starts
    on a 16-byte boundary (Y, at least as wide, is allocated here,
    aligned), else "scalar"."""
    if (k * itemsize) % VECTOR_BYTES == 0 and x_ptr % VECTOR_BYTES == 0:
        return "tma"
    return "scalar"


def variant_for(dia: DiaMat, x: torch.Tensor) -> str:
    """The variant the wrapper launches for ``dia @ x``: :func:`variant`,
    except that an operand whose rows, columns or an offset reach 2^30
    (past TMA's 32-bit coordinates), or an X of no rows (no tensor map),
    takes the scalar variant."""
    extent = max(dia.rows, dia.cols, dia.rows_pad, dia.bandwidth)
    if extent >= COORD_LIMIT or dia.cols == 0:
        return "scalar"
    return variant(x.shape[1], x.element_size(), x.data_ptr())


def tile_vectors(acc_itemsize: int) -> int:
    """16-byte vectors of X in a tma tile: 2048 (32 KB) where the sums
    are float32, 1024 (16 KB) where they are float64."""
    return PAIRS[acc_itemsize] * TMA_CONSUMERS


def tile_shape(k: int, itemsize: int, acc_itemsize: int) -> Tuple[int, int, int]:
    """(T, kc, chunks) of the tma variant for X of ``itemsize`` bytes and
    sums of ``acc_itemsize``: a tile of T rows by kc columns, k cut into
    ``chunks`` even shares of at most MAX_TILE_COLS columns, each a whole
    number of 16-byte vectors; at most :func:`tile_vectors` vectors of X,
    T a multiple of 8 up to MAX_TILE_ROWS."""
    per_vec = VECTOR_BYTES // itemsize
    chunks = -(-k // MAX_TILE_COLS)
    kc = round_up(-(-k // chunks), per_vec)
    rows = min(MAX_TILE_ROWS, tile_vectors(acc_itemsize) * per_vec // kc) // 8 * 8
    return rows, kc, -(-k // kc)


def slab_plan(offsets) -> List[Tuple[int, int, int, int]]:
    """The tma variant's loads of X for one tile, as (first diagonal,
    count, lowest offset, span): diagonals consecutive in storage order
    share one slab (one load of T + span rows) while their offsets span at
    most MAX_SPAN rows and it holds at most SLAB_DIAGS of them; every
    other diagonal is a slab of its own.  ``csrc/dia_spmm.cu``'s
    ``plan_slabs`` mirrors it."""
    out = []
    d, n = 0, len(offsets)
    while d < n:
        lo = hi = offsets[d]
        nd = 1
        while d + nd < n and nd < SLAB_DIAGS:
            o = offsets[d + nd]
            if max(hi, o) - min(lo, o) > MAX_SPAN:
                break
            lo, hi, nd = min(lo, o), max(hi, o), nd + 1
        out.append((d, nd, lo, hi - lo))
        d += nd
    return out


def ring(tile_rows: int, tile_cols: int, x_itemsize: int, data_itemsize: int) -> Tuple[int, int, int]:
    """(stages, stage bytes, dynamic shared memory bytes) of the tma
    variant's ring: a stage holds a slab of up to T + MAX_SPAN rows of X
    and SLAB_DIAGS coefficient strips of T, each 128-byte aligned; as many
    stages as fit in SMEM_PER_CTA, at most MAX_STAGES (the C entry
    refuses fewer than 2)."""
    x_bytes = round_up((tile_rows + MAX_SPAN) * tile_cols * x_itemsize, SMEM_ALIGN)
    stage = x_bytes + SLAB_DIAGS * round_up(tile_rows * data_itemsize, SMEM_ALIGN)
    barriers = 2 * MAX_STAGES * 8
    stages = min(MAX_STAGES, (SMEM_PER_CTA - SMEM_ALIGN - barriers) // stage)
    return stages, stage, SMEM_ALIGN + stages * stage + barriers


def acc_itemsize(data_dtype: torch.dtype, x_dtype: torch.dtype) -> int:
    """The element size of the sums, promote(promote(data, x), float32)."""
    return torch.promote_types(torch.promote_types(data_dtype, x_dtype), torch.float32).itemsize


def launch_config(
    rows: int, k: int, n_sm: int, itemsize: int, kind: str, acc_size: int
) -> Tuple[int, int, int, int]:
    """(grid, block, tile_rows, tile_cols) for a (rows, k) output on a
    card with ``n_sm`` SMs, X of ``itemsize`` bytes, sums of ``acc_size``.
    "tma": tiles of :func:`tile_shape`, at most TMA_CTAS_PER_SM persistent
    CTAs per SM walking the (tile, chunk) items.  "scalar": a thread owns
    a run of RUN rows by one column, a CTA's tile is as many runs
    (``tile_rows``) as its threads cover across the k columns, and the
    grid is at most one wave of BLOCKS_PER_SM CTAs per SM; ``tile_cols``
    is 1."""
    if kind == "tma":
        tile_rows, tile_cols, chunks = tile_shape(k, itemsize, acc_size)
        items = -(-rows // tile_rows) * chunks
        return max(1, min(items, n_sm * TMA_CTAS_PER_SM)), TMA_THREADS, tile_rows, tile_cols
    runs = max(THREADS // k, 1)
    tiles = -(-rows // (runs * RUN))
    return max(1, min(tiles, n_sm * BLOCKS_PER_SM)), THREADS, runs, 1


def dia_spmm_plain(dia: DiaMat, x: torch.Tensor) -> torch.Tensor:
    """The plain torch K2: shifted row blocks, multiply-add in diagonal
    order (``formats/dia.py::dia_spmm``); where an operand is 16-bit, in
    ``promote(out, float32)`` with one rounding (``dia_spmv.widened_sum``)."""
    dia_spmm_plain.calls += 1
    wide = widened(dia.data, x)
    if wide is None:
        return dia_spmm(dia, x)
    if x.ndim != 2 or x.shape[0] != dia.cols:
        raise ShapeError(f"dia_spmm: A is {dia.shape}, X is {tuple(x.shape)}")
    return widened_sum(dia, x, wide)


dia_spmm_plain.calls = 0


_ARGS = (PTR, PTR, PTR, I64, I64, I64, I64, PTR, I32, I32, I32, I32, I32, PTR)


def _tma_data(dia: DiaMat) -> Tuple[torch.Tensor, int]:
    """(data, rows_pad) as the tma variant reads them: TMA needs a 16-byte
    aligned base and rows of whole 16 bytes, so a DiaMat built otherwise
    (by hand) is copied into rows padded to a multiple of 8."""
    data = dia.data
    if data.data_ptr() % VECTOR_BYTES == 0 and (dia.rows_pad * data.element_size()) % VECTOR_BYTES == 0:
        return data, dia.rows_pad
    pad = round_up(dia.rows_pad, 8)
    staged = data.new_zeros((data.shape[0], pad))
    staged[:, : dia.rows_pad] = data
    return staged, pad


def _launch(dia: DiaMat, x: torch.Tensor) -> torch.Tensor:
    data = dia.data
    launch.one_card("dia_spmm", "data and X", data, x)
    form = form_of("dia_spmm", data, x)
    n = dia.n_diags
    if n > MAX_DIAGS:
        raise ShapeError(f"dia_spmm kernel takes at most {MAX_DIAGS} diagonals, got {n}")
    if data.shape != (n, dia.rows_pad) or dia.rows_pad < dia.rows:
        raise ShapeError(f"dia_spmm: data {tuple(data.shape)} for {n} diagonals of {dia.shape}")
    if not (data.is_contiguous() and x.is_contiguous()):
        raise ValueError("dia_spmm kernel needs contiguous data and X")
    k = x.shape[1]
    y = torch.empty((dia.rows, k), dtype=torch.promote_types(data.dtype, x.dtype), device=data.device)
    if dia.rows == 0 or k == 0:
        return y
    kind = variant_for(dia, x)
    rows_pad = dia.rows_pad
    if kind == "tma":
        data, rows_pad = _tma_data(dia)
    index = data.get_device()
    grid, _, tile_rows, tile_cols = launch_config(
        dia.rows, k, launch.sm_count(index), x.element_size(), kind, acc_itemsize(data.dtype, x.dtype)
    )
    err = launch.entry("dia_spmm", f"sprs_dia_spmm_{form}", _ARGS)(
        data.data_ptr(),
        x.data_ptr(),
        y.data_ptr(),
        dia.rows,
        dia.cols,
        rows_pad,
        k,
        (I32 * n)(*dia.offsets),
        n,
        int(kind == "tma"),
        tile_rows,
        tile_cols,
        grid,
        launch.stream(index),
    )
    launch.check(err, f"dia_spmm kernel ({kind})")
    launch.count(dia_spmm_kernel, form, kind)
    return y


class _DiaSpmm(torch.autograd.Function):
    @staticmethod
    def of(dia: DiaMat, x: torch.Tensor) -> torch.Tensor:
        return _DiaSpmm.apply(dia.data, x, tuple(dia.offsets), tuple(dia.shape))

    @staticmethod
    def forward(ctx, data, x, offsets, shape):
        dia = DiaMat(data, offsets, shape)
        ctx.save_for_backward(data, x)
        ctx.offsets, ctx.shape = offsets, shape
        if launch.on_cpu(data, x):
            return dia_spmm_plain(dia, x)
        return _launch(dia, x)

    @staticmethod
    def backward(ctx, g):
        data, x = ctx.saved_tensors
        ddata, dx = dia_vjp(DiaMat(data, ctx.offsets, ctx.shape), x, g)
        return ddata, dx, None, None


def dia_spmm_kernel(dia: DiaMat, x: torch.Tensor) -> torch.Tensor:
    """Y = A @ X through K2; the counterpart of ``dia_spmm_pallas``.

    ``X`` is dense, (cols, k), at any width k.  Runs as ``launch.run``
    says: tensors on the CPU take :func:`dia_spmm_plain`; tensors on a
    CUDA device launch the kernel, which raises on what it cannot take (a
    complex operand among them).  Differentiable in ``dia.data`` and
    ``X``.
    """
    if x.ndim != 2 or x.shape[0] != dia.cols:
        raise ShapeError(f"dia_spmm: A is {dia.shape}, X is {tuple(x.shape)}")
    # The kernel reads X row-major; the solvers' blocks often come out of
    # torch.linalg in column-major order.
    x = x.contiguous()
    return launch.run((dia.data, x), dia_spmm_plain, _DiaSpmm.of, _launch, dia, x)


launch.zero(dia_spmm_kernel, (*FORMS.values(), "tma", "scalar"))
