"""Banded SpMV kernel K1: y[i] = Σ_d data[d, i] · x[i + off_d].

The CUDA C++ kernel is ``sprs_tpu_torch/csrc/dia_spmv.cu``; its note
says which TPU functions it replaces, what bounds it (bytes: the k
diagonals, x and y each cross device memory once) and how its design
meets that bound.  This module holds what surrounds it:

* :func:`dia_spmv_plain`, the plain torch version (the same arithmetic
  as ``formats/dia.py::dia_spmv``, but widened for 16-bit operands as
  ``forms.widened`` says), used for tensors on the CPU and as the
  kernel's reference on the card;
* :class:`K1Plan`, the launch plan of one operand, prepared once: the
  operand's checks, the offsets, the grid (:func:`launch_config`) and,
  per x type used, the C side's plan.  Calling it is the direct launch:
  it checks only what may differ per call (x's device, type, shape and
  contiguity), allocates y and launches on the current stream, with no
  host sync;
* :func:`dia_spmv_kernel`, the wrapper, which takes the type forms of
  ``forms.FORMS`` and runs, as every product wrapper does, as
  ``launch.run`` says: the plain version on CPU tensors, the direct
  launch on the card (the operand's plan, or one built for the call on
  a bare ``DiaMat``), and a ``torch.autograd.Function`` where a gradient
  is needed, whose backward (:func:`dia_vjp`, shared with K2) is the
  plain torch form of the JAX package's ``_bwd``.  Its ``launches``
  attribute counts kernel launches, and ``launches_<form>`` those of
  each form;
* :class:`DiaTiledMat` and :func:`dia_tile`, the prepare-once operand of
  the solver loops: the contiguous (k, rows_pad) diagonals, whose plan is
  built when the operand is.
"""

from __future__ import annotations

import ctypes
import dataclasses
import weakref
from typing import Tuple

import torch

from ..._span import span
from ...errors import ShapeError
from ...formats.dia import DiaMat, _padded_x, dia_spmv
from . import launch
from .forms import FORMS, form_of, widened
from .launch import I32, I64, PTR

# Offsets travel to the kernel by value in a fixed struct of this many
# ints (csrc/dia_spmv.cu: kMaxDiags), prepare_spmv's ceiling.
MAX_DIAGS = 64
BLOCK = 256  # kBlock
# Resident 256-thread blocks per SM at full occupancy (2048 threads).
BLOCKS_PER_SM = 8


def launch_config(rows: int, n_sm: int) -> Tuple[int, int]:
    """(grid, block) for ``rows`` output rows on a card with ``n_sm``
    SMs: one thread per row, at most one full wave of resident blocks;
    the kernel's grid-stride loop covers the rest."""
    blocks = -(-rows // BLOCK)
    return max(1, min(blocks, n_sm * BLOCKS_PER_SM)), BLOCK


def widened_sum(dia: DiaMat, x: torch.Tensor, wide) -> torch.Tensor:
    """Σ_d data[d, i]·x[i + off_d] for x of shape (cols,) or (cols, k),
    as ``forms.widened``'s (out, acc, prod) say: each product taken in
    ``prod``, added in ``acc`` in diagonal order, rounded once to ``out``.
    The arithmetic of K1's and K2's plain versions on 16-bit operands."""
    out, acc, prod = wide
    xp, left = _padded_x(dia, x.to(prod))
    data = dia.data.to(prod)
    if x.ndim == 2:
        data = data[:, :, None]
    n = dia.rows_pad
    y = torch.zeros((n,) + tuple(x.shape[1:]), dtype=acc, device=x.device)
    for d, off in enumerate(dia.offsets):
        y = y + (data[d] * xp[left + off : left + off + n]).to(acc)
    return y[: dia.rows].to(out)


def dia_spmv_plain(dia: DiaMat, x: torch.Tensor) -> torch.Tensor:
    """The plain torch K1: shifted slices, multiply-add in diagonal order
    (``formats/dia.py::dia_spmv``); where an operand is 16-bit, in
    ``promote(out, float32)`` with one rounding (:func:`widened_sum`).
    Its ``calls`` attribute counts calls."""
    dia_spmv_plain.calls += 1
    wide = widened(dia.data, x)
    if wide is None:
        return dia_spmv(dia, x)
    if x.shape != (dia.cols,):
        raise ShapeError(f"dia_spmv: A is {dia.shape}, x is {tuple(x.shape)}")
    return widened_sum(dia, x, wide)


dia_spmv_plain.calls = 0


class K1Plan:
    """K1's launch plan for one operand on the card: the checks the
    operand must pass (raising as the kernel would), its offsets in a
    persistent host array, its grid (:func:`launch_config`), and per x
    type used the C plan (built at the first product in that type,
    released with this object).  Calling it with x launches K1 directly
    (no autograd).
    """

    def __init__(self, dia: DiaMat):
        data = dia.data
        if data.device.type != "cuda":
            raise ValueError(
                f"dia_spmv kernel needs data and x on one CUDA device, got {data.device}"
            )
        k = dia.n_diags
        if k > MAX_DIAGS:
            raise ShapeError(f"dia_spmv kernel takes at most {MAX_DIAGS} diagonals, got {k}")
        if data.shape != (k, dia.rows_pad) or dia.rows_pad < dia.rows:
            raise ShapeError(f"dia_spmv: data {tuple(data.shape)} for {k} diagonals of {dia.shape}")
        if not data.is_contiguous():
            raise ValueError("dia_spmv kernel needs contiguous data and x")
        self.data = data
        self.offsets = tuple(dia.offsets)
        self.rows, self.cols, self.rows_pad = dia.rows, dia.cols, dia.rows_pad
        self.device = data.device
        self.index = data.get_device()
        self.x_shape = (dia.cols,)
        self.grid = launch_config(dia.rows, launch.sm_count(self.index))[0]
        self.c_offsets = (I32 * k)(*self.offsets)
        self.forms = {}

    def form_plan(self, x_dtype: torch.dtype) -> Tuple[int, torch.dtype, str]:
        """(handle, y's type, form) of the C plan for x of ``x_dtype``
        (TypeError for a pair that is no form), built on first use."""
        plan = self.forms.get(x_dtype)
        if plan is not None:
            return plan
        data = self.data
        form = form_of("dia_spmv", data, torch.empty(0, dtype=x_dtype))
        err = I32(0)
        create = launch.entry("dia_spmv", f"sprs_dia_spmv_plan_{form}",
                              (PTR, I64, I64, I64, PTR, I32, I32, ctypes.POINTER(I32)), PTR)
        handle = create(
            data.data_ptr(), self.rows, self.cols, self.rows_pad, self.c_offsets, len(self.offsets),
            self.grid, ctypes.byref(err),
        )
        if not handle:
            raise RuntimeError(f"dia_spmv kernel plan failed: CUDA error {err.value}")
        free = launch.entry("dia_spmv", "sprs_dia_spmv_plan_free", (PTR,), None)
        weakref.finalize(self, free, handle)
        self.run = launch.entry("dia_spmv", "sprs_dia_spmv_run", (PTR, PTR, PTR, PTR))
        plan = self.forms[x_dtype] = (handle, torch.promote_types(data.dtype, x_dtype), form)
        return plan

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """y = A @ x, launched on the current stream, in a ``sprs.k1``
        profiler span."""
        with span("sprs.k1"):
            if x.shape != self.x_shape:
                raise ShapeError(f"dia_spmv: A is {(self.rows, self.cols)}, x is {tuple(x.shape)}")
            if x.get_device() != self.index:
                launch.one_card("dia_spmv", "data and x", self.data, x)
            if not x.is_contiguous():
                raise ValueError("dia_spmv kernel needs contiguous data and x")
            if self.rows == 0:
                form_of("dia_spmv", self.data, x)
                return torch.empty(0, dtype=torch.promote_types(self.data.dtype, x.dtype), device=self.device)
            handle, out, form = self.forms.get(x.dtype) or self.form_plan(x.dtype)
            y = x.new_empty(self.rows, dtype=out)
            launch.check(self.run(handle, x.data_ptr(), y.data_ptr(), launch.stream(self.index)),
                         "dia_spmv kernel")
            launch.count(dia_spmv_kernel, form)
            return y


def _launch(dia: DiaMat, x: torch.Tensor) -> torch.Tensor:
    """K1's direct launch: the operand's plan, or on a bare DiaMat one
    built for this call alone."""
    plan = getattr(dia, "plan", None)
    return (K1Plan(dia) if plan is None else plan)(x)


def dia_vjp(dia: DiaMat, x: torch.Tensor, g: torch.Tensor):
    """(ddata, dx) for y = A @ x (x of shape (cols,) or (cols, k)):
    ddata[d, i] = Σ_c g[i, c]·x[i+off_d, c] and dx[i+off_d] += data[d, i]·g[i],
    over the zero-padded x, each in its input's type.  The plain torch
    form of the JAX package's ``_bwd`` for both K1 and K2; where an
    operand is 16-bit it takes products and sums as the forward does
    (``forms.widened``) and rounds once."""
    wide = widened(dia.data, x)
    if wide is None:
        acc = prod = torch.promote_types(dia.dtype, g.dtype)
    else:
        _, acc, prod = wide
    gp = g.new_zeros((dia.rows_pad,) + tuple(g.shape[1:]), dtype=prod)
    gp[: dia.rows] = g
    xp, left = _padded_x(dia, x.to(prod))
    n = dia.rows_pad
    prods = [(gp * xp[left + off : left + off + n]).to(acc) for off in dia.offsets]
    if x.ndim == 2:
        prods = [p.sum(1) for p in prods]
    ddata = torch.stack(prods).to(dia.dtype)
    data = dia.data.to(prod) if x.ndim == 1 else dia.data.to(prod)[:, :, None]
    dxp = torch.zeros(xp.shape, dtype=acc, device=xp.device)
    for d, off in enumerate(dia.offsets):
        dxp[left + off : left + off + n] += (data[d] * gp).to(acc)
    return ddata, dxp[left : left + dia.cols].to(x.dtype)


class _DiaSpmv(torch.autograd.Function):
    @staticmethod
    def of(dia: DiaMat, x: torch.Tensor) -> torch.Tensor:
        plan = getattr(dia, "plan", None)
        return _DiaSpmv.apply(dia.data, x, tuple(dia.offsets), tuple(dia.shape), plan)

    @staticmethod
    def forward(ctx, data, x, offsets, shape, plan):
        dia = DiaMat(data, offsets, shape)
        ctx.save_for_backward(data, x)
        ctx.offsets, ctx.shape = offsets, shape
        if launch.on_cpu(data, x):
            return dia_spmv_plain(dia, x)
        return plan(x) if plan is not None else _launch(dia, x)

    @staticmethod
    def backward(ctx, g):
        data, x = ctx.saved_tensors
        ddata, dx = dia_vjp(DiaMat(data, ctx.offsets, ctx.shape), x, g)
        return ddata, dx, None, None, None


def dia_spmv_kernel(dia: DiaMat, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x through K1; the counterpart of ``dia_spmv_pallas``.

    Runs as ``launch.run`` says: tensors on the CPU take
    :func:`dia_spmv_plain`; tensors on a CUDA device launch the kernel,
    which raises on what it cannot take.  Differentiable in ``dia.data``
    and ``x``.  An operand that carries a plan (a :class:`DiaTiledMat` on
    the card) launches its plan wherever no gradient is needed.
    """
    plan = getattr(dia, "plan", None)
    if plan is None and x.shape != (dia.cols,):  # a plan checks x itself
        raise ShapeError(f"dia_spmv: A is {dia.shape}, x is {tuple(x.shape)}")
    plain = dia_spmv_plain if plan is None else _launch  # a plan launches wherever no gradient is needed
    return launch.run((dia.data, x), plain, _DiaSpmv.of, _launch, dia, x)


launch.zero(dia_spmv_kernel, FORMS.values())


@dataclasses.dataclass(frozen=True, repr=False)
class DiaTiledMat(DiaMat):
    """Prepared DIA operand for repeated products (solver loops): the
    contiguous (k, rows_pad) diagonals and their offsets, multiplied
    through K1 (a vector) or K2 (a block of columns).  Its ``plan`` is
    K1's :class:`K1Plan` on the card (None on the CPU), built with the
    operand.  Build it once with :func:`dia_tile`."""

    def __post_init__(self):
        plan = K1Plan(self) if self.data.device.type == "cuda" else None
        object.__setattr__(self, "plan", plan)

    def spmv(self, x: torch.Tensor) -> torch.Tensor:
        return dia_spmv_kernel(self, x)

    def spmm(self, x: torch.Tensor) -> torch.Tensor:
        from .dia_spmm import dia_spmm_kernel

        return dia_spmm_kernel(self, x)

    def __matmul__(self, x):
        return self.spmv(x) if x.ndim == 1 else self.spmm(x)


def dia_tile(dia: DiaMat) -> DiaTiledMat:
    """Prepare a :class:`DiaTiledMat` from a :class:`DiaMat` (on the card,
    with K1's plan); raises ShapeError above the kernel's ``MAX_DIAGS``
    diagonals."""
    if dia.n_diags > MAX_DIAGS:
        raise ShapeError(
            f"dia_tile: {dia.n_diags} diagonals exceed the kernel's {MAX_DIAGS}"
        )
    return DiaTiledMat(dia.data.contiguous(), tuple(dia.offsets), tuple(dia.shape))
