"""Banded SpMM kernel K2: Y[i, c] = Σ_d data[d, i] · X[i + off_d, c].

The CUDA C++ kernel is ``sprs_tpu_torch/csrc/dia_spmm.cu``; its note says
which TPU functions it replaces, what bounds it (bytes: the diagonals, X
and Y each cross device memory once) and how its design meets that bound.
This module holds what surrounds it, as ``dia_spmv.py`` does for K1:

* :func:`dia_spmm_plain`, the plain torch version (``formats/dia.py::
  dia_spmm``, widened for 16-bit operands as ``forms.widened`` says), used for
  tensors on the CPU and as the kernel's reference on the card.  Its
  ``calls`` attribute counts calls;
* :func:`dia_spmm_kernel`, the wrapper: CPU tensors take the plain
  version, CUDA tensors launch the kernel or raise — never both.  It
  takes the type forms of ``forms.FORMS``.  Its ``launches`` attribute
  counts kernel launches, ``launches_vector`` and ``launches_scalar``
  those of each variant, and ``launches_<form>`` those of each form.  Every RHS width takes
  the kernel: the JAX package's ``k >= 256`` cut (``ops/prod.py``) is a
  TPU measurement and has no counterpart here;
* :func:`variant`, the rule that picks the kernel's variant: "vector"
  (16-byte loads of X, and 16-byte stores of Y) when a row of X is whole
  16-byte vectors and X starts on a 16-byte boundary, else "scalar".  X's
  element size decides, whatever the diagonals' type: Y's type,
  ``promote(data, X)``, is at least as wide as X's, so its rows are then
  whole 16-byte vectors too, and Y is allocated here, aligned;
* a ``torch.autograd.Function`` whose forward is the kernel and whose
  backward is :func:`~.dia_spmv.dia_vjp`, the plain torch form of the JAX
  package's ``_bwd``.

The prepared operand is K1's :class:`~.dia_spmv.DiaTiledMat`, whose
``spmm`` method calls this wrapper.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from ...errors import ShapeError
from ...formats.dia import DiaMat, dia_spmm
from . import build
from .dia_spmv import MAX_DIAGS, dia_vjp, widened_sum
from .forms import count_launch, form_of, widened, zero_counts

THREADS = 256  # csrc/dia_spmm.cu: kThreads
RUN = 4  # consecutive rows per thread (kRun); 2 for a vector of 8 columns (R)
BLOCKS_PER_SM = 3  # resident CTAs per SM (kMinBlocks)
VECTOR_BYTES = 16


def variant(k: int, itemsize: int, x_ptr: int) -> str:
    """"vector" when every row of X is whole 16-byte vectors and X starts
    on a 16-byte boundary (Y, at least as wide, is allocated here,
    aligned), else "scalar"."""
    if (k * itemsize) % VECTOR_BYTES == 0 and x_ptr % VECTOR_BYTES == 0:
        return "vector"
    return "scalar"


def launch_config(rows: int, k: int, n_sm: int, itemsize: int, vector: bool) -> Tuple[int, int, int]:
    """(grid, block, runs_per_tile) for a (rows, k) output on a card with
    ``n_sm`` SMs.  A thread owns a run of RUN rows (half as many for a
    vector of 8 bfloat16 columns, ``R`` in the kernel) by one column
    vector (16 bytes, or one element for the scalar variant); a CTA's tile
    is as many runs as its threads cover across the k columns, all k
    columns wide; the grid is at most one wave of resident CTAs, which
    walk the tiles in grid-stride order."""
    per_vec = VECTOR_BYTES // itemsize if vector else 1
    kv = k // per_vec
    runs = max(THREADS // kv, 1)
    tiles = -(-rows // (runs * (RUN // 2 if per_vec > 4 else RUN)))
    return max(1, min(tiles, n_sm * BLOCKS_PER_SM)), THREADS, runs


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


@functools.lru_cache(maxsize=None)
def _entry(form: str):
    fn = getattr(build.load("dia_spmm"), f"sprs_dia_spmm_{form}")
    ll, vp, i = ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp, vp, vp, ll, ll, ll, ll, vp, i, i, i, i, vp]
    fn.restype = ctypes.c_int
    return fn


def _launch(dia: DiaMat, x: torch.Tensor) -> torch.Tensor:
    data = dia.data
    if data.device.type != "cuda" or x.device != data.device:
        raise ValueError(
            f"dia_spmm kernel needs data and X on one CUDA device, got "
            f"{data.device} and {x.device}"
        )
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
    kind = variant(k, x.element_size(), x.data_ptr())
    n_sm = torch.cuda.get_device_properties(data.device).multi_processor_count
    grid, _, runs = launch_config(dia.rows, k, n_sm, x.element_size(), kind == "vector")
    err = _entry(form)(
        data.data_ptr(),
        x.data_ptr(),
        y.data_ptr(),
        dia.rows,
        dia.cols,
        dia.rows_pad,
        k,
        (ctypes.c_int * n)(*dia.offsets),
        n,
        int(kind == "vector"),
        runs,
        grid,
        torch.cuda.current_stream(data.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"dia_spmm kernel ({kind}) launch failed: CUDA error {err}")
    count_launch(dia_spmm_kernel, form)
    if kind == "vector":
        dia_spmm_kernel.launches_vector += 1
    else:
        dia_spmm_kernel.launches_scalar += 1
    return y


class _DiaSpmm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, x, offsets, shape):
        dia = DiaMat(data, offsets, shape)
        ctx.save_for_backward(data, x)
        ctx.offsets, ctx.shape = offsets, shape
        if data.device.type == "cpu" and x.device.type == "cpu":
            return dia_spmm_plain(dia, x)
        return _launch(dia, x)

    @staticmethod
    def backward(ctx, g):
        data, x = ctx.saved_tensors
        ddata, dx = dia_vjp(DiaMat(data, ctx.offsets, ctx.shape), x, g)
        return ddata, dx, None, None


def dia_spmm_kernel(dia: DiaMat, x: torch.Tensor) -> torch.Tensor:
    """Y = A @ X through K2; the counterpart of ``dia_spmm_pallas``.

    ``X`` is dense, (cols, k), at any width k.  Tensors on the CPU take
    :func:`dia_spmm_plain`; tensors on a CUDA device launch the kernel,
    which raises on what it cannot take (a complex operand among them).
    Differentiable in ``dia.data`` and ``X``.
    """
    if x.ndim != 2 or x.shape[0] != dia.cols:
        raise ShapeError(f"dia_spmm: A is {dia.shape}, X is {tuple(x.shape)}")
    # The kernel reads X row-major; the solvers' blocks often come out of
    # torch.linalg in column-major order.
    x = x.contiguous()
    return _DiaSpmm.apply(dia.data, x, tuple(dia.offsets), tuple(dia.shape))


zero_counts(dia_spmm_kernel)
dia_spmm_kernel.launches_vector = 0
dia_spmm_kernel.launches_scalar = 0
