"""Banded SpMV kernel K1: y[i] = Σ_d data[d, i] · x[i + off_d].

The CUDA C++ kernel is ``sprs_tpu_torch/csrc/dia_spmv.cu``; its note
says which TPU functions it replaces, what bounds it (bytes: the k
diagonals, x and y each cross device memory once) and how its design
meets that bound.  This module holds what surrounds it:

* :func:`dia_spmv_plain`, the plain torch version (the same arithmetic
  as ``formats/dia.py::dia_spmv``), used for tensors on the CPU and as
  the kernel's reference on the card;
* :func:`dia_spmv_kernel`, the wrapper: CPU tensors take the plain
  version, CUDA tensors launch the kernel or raise — never both.  Its
  ``launches`` attribute counts kernel launches;
* :class:`DiaTiledMat` and :func:`dia_tile`, the prepare-once operand of
  the solver loops.  The GPU kernel reads ``DiaMat``'s own (k, rows_pad)
  layout, so preparing only checks the operand and makes it contiguous;
* a ``torch.autograd.Function`` whose forward is the kernel and whose
  backward (:func:`dia_vjp`, shared with K2) is the plain torch form of
  the JAX package's ``_bwd``.

The launch configuration is computed here in Python (:func:`launch_config`)
so the CPU tests reach it.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from ...errors import ShapeError
from ...formats.dia import DiaMat, _padded_x, dia_spmv
from . import build

# Offsets travel to the kernel by value in a fixed struct of this many
# ints (csrc/dia_spmv.cu: kMaxDiags), prepare_spmv's ceiling.
MAX_DIAGS = 64
BLOCK = 256
# Resident 256-thread blocks per SM at full occupancy (2048 threads).
BLOCKS_PER_SM = 8

_ENTRY = {torch.float32: "sprs_dia_spmv_f32", torch.float64: "sprs_dia_spmv_f64"}


def launch_config(rows: int, n_sm: int) -> Tuple[int, int]:
    """(grid, block) for ``rows`` output rows on a card with ``n_sm``
    SMs: one thread per row, at most one full wave of resident blocks;
    the kernel's grid-stride loop covers the rest."""
    blocks = -(-rows // BLOCK)
    return max(1, min(blocks, n_sm * BLOCKS_PER_SM)), BLOCK


def dia_spmv_plain(dia: DiaMat, x: torch.Tensor) -> torch.Tensor:
    """The plain torch K1: shifted slices, multiply-add in diagonal order
    (``formats/dia.py::dia_spmv``).  Its ``calls`` attribute counts calls."""
    dia_spmv_plain.calls += 1
    return dia_spmv(dia, x)


dia_spmv_plain.calls = 0


@functools.lru_cache(maxsize=None)
def _entry(dtype: torch.dtype):
    fn = getattr(build.load("dia_spmv"), _ENTRY[dtype])
    ll, vp, i = ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp, vp, vp, ll, ll, ll, vp, i, i, i, vp]
    fn.restype = ctypes.c_int
    return fn


def _launch(dia: DiaMat, x: torch.Tensor) -> torch.Tensor:
    data = dia.data
    if data.device.type != "cuda" or x.device != data.device:
        raise ValueError(
            f"dia_spmv kernel needs data and x on one CUDA device, got "
            f"{data.device} and {x.device}"
        )
    if data.dtype not in _ENTRY or x.dtype != data.dtype:
        raise TypeError(
            f"dia_spmv kernel takes float32 or float64 data and x of the "
            f"same type, got {data.dtype} and {x.dtype}"
        )
    k = dia.n_diags
    if k > MAX_DIAGS:
        raise ShapeError(f"dia_spmv kernel takes at most {MAX_DIAGS} diagonals, got {k}")
    if data.shape != (k, dia.rows_pad) or dia.rows_pad < dia.rows:
        raise ShapeError(f"dia_spmv: data {tuple(data.shape)} for {k} diagonals of {dia.shape}")
    if not (data.is_contiguous() and x.is_contiguous()):
        raise ValueError("dia_spmv kernel needs contiguous data and x")
    y = torch.empty(dia.rows, dtype=data.dtype, device=data.device)
    if dia.rows == 0:
        return y
    n_sm = torch.cuda.get_device_properties(data.device).multi_processor_count
    grid, block = launch_config(dia.rows, n_sm)
    err = _entry(data.dtype)(
        data.data_ptr(),
        x.data_ptr(),
        y.data_ptr(),
        dia.rows,
        dia.cols,
        dia.rows_pad,
        (ctypes.c_int * k)(*dia.offsets),
        k,
        grid,
        block,
        torch.cuda.current_stream(data.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"dia_spmv kernel launch failed: CUDA error {err}")
    dia_spmv_kernel.launches += 1
    return y


def dia_vjp(dia: DiaMat, x: torch.Tensor, g: torch.Tensor):
    """(ddata, dx) for y = A @ x (x of shape (cols,) or (cols, k)):
    ddata[d, i] = Σ_c g[i, c]·x[i+off_d, c] and dx[i+off_d] += data[d, i]·g[i],
    over the zero-padded x.  The plain torch form of the JAX package's
    ``_bwd`` for both K1 and K2."""
    gp = g.new_zeros((dia.rows_pad,) + tuple(g.shape[1:]))
    gp[: dia.rows] = g
    xp, left = _padded_x(dia, x)
    n = dia.rows_pad
    prods = [gp * xp[left + off : left + off + n] for off in dia.offsets]
    if x.ndim == 2:
        prods = [p.sum(1) for p in prods]
    ddata = torch.stack(prods).to(dia.dtype)
    data = dia.data if x.ndim == 1 else dia.data[:, :, None]
    dxp = torch.zeros_like(xp, dtype=torch.promote_types(dia.dtype, g.dtype))
    for d, off in enumerate(dia.offsets):
        dxp[left + off : left + off + n] += data[d] * gp
    return ddata, dxp[left : left + dia.cols].to(x.dtype)


class _DiaSpmv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, x, offsets, shape):
        dia = DiaMat(data, offsets, shape)
        ctx.save_for_backward(data, x)
        ctx.offsets, ctx.shape = offsets, shape
        if data.device.type == "cpu" and x.device.type == "cpu":
            return dia_spmv_plain(dia, x)
        return _launch(dia, x)

    @staticmethod
    def backward(ctx, g):
        data, x = ctx.saved_tensors
        ddata, dx = dia_vjp(DiaMat(data, ctx.offsets, ctx.shape), x, g)
        return ddata, dx, None, None


def dia_spmv_kernel(dia: DiaMat, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x through K1; the counterpart of ``dia_spmv_pallas``.

    Tensors on the CPU take :func:`dia_spmv_plain`; tensors on a CUDA
    device launch the kernel, which raises on what it cannot take.
    Differentiable in ``dia.data`` and ``x``.
    """
    if x.shape != (dia.cols,):
        raise ShapeError(f"dia_spmv: A is {dia.shape}, x is {tuple(x.shape)}")
    return _DiaSpmv.apply(dia.data, x, tuple(dia.offsets), tuple(dia.shape))


dia_spmv_kernel.launches = 0


class DiaTiledMat(DiaMat):
    """Prepared DIA operand for repeated products (solver loops): the
    contiguous (k, rows_pad) diagonals and their offsets, multiplied
    through K1 (a vector) or K2 (a block of columns).  Build it once with
    :func:`dia_tile`."""

    def spmv(self, x: torch.Tensor) -> torch.Tensor:
        return dia_spmv_kernel(self, x)

    def spmm(self, x: torch.Tensor) -> torch.Tensor:
        from .dia_spmm import dia_spmm_kernel

        return dia_spmm_kernel(self, x)

    def __matmul__(self, x):
        return self.spmv(x) if x.ndim == 1 else self.spmm(x)


def dia_tile(dia: DiaMat) -> DiaTiledMat:
    """Prepare a :class:`DiaTiledMat` from a :class:`DiaMat`; raises
    ShapeError above the kernel's ``MAX_DIAGS`` diagonals."""
    if dia.n_diags > MAX_DIAGS:
        raise ShapeError(
            f"dia_tile: {dia.n_diags} diagonals exceed the kernel's {MAX_DIAGS}"
        )
    return DiaTiledMat(dia.data.contiguous(), tuple(dia.offsets), tuple(dia.shape))
