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
* :func:`dia_spmv_kernel`, the wrapper: CPU tensors take the plain
  version, CUDA tensors launch the kernel or raise — never both.  It
  takes the type forms of ``forms.FORMS``.  A prepared operand whose
  product needs no gradient takes its plan's direct launch; otherwise
  the product goes through a ``torch.autograd.Function`` whose forward
  is the kernel and whose backward (:func:`dia_vjp`, shared with K2) is
  the plain torch form of the JAX package's ``_bwd``.  Its ``launches``
  attribute counts kernel launches, and ``launches_<form>`` those of
  each form;
* :class:`DiaTiledMat` and :func:`dia_tile`, the prepare-once operand of
  the solver loops: the contiguous (k, rows_pad) diagonals, whose plan is
  built when the operand is.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import weakref
from typing import Tuple

import torch

from ..._span import span
from ...errors import ShapeError
from ...formats.dia import DiaMat, _padded_x, dia_spmv
from . import build
from .forms import FORMS, form_of, widened, zero_counts

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


@functools.lru_cache(maxsize=None)
def _lib():
    """(library, run): the plan entries, and ``sprs_dia_spmv_run`` bound
    through ``ctypes.PyDLL``, whose calls keep the interpreter lock (a
    launch takes microseconds; releasing and taking the lock again would
    add to them)."""
    lib = build.load("dia_spmv")
    ll, vp, i = ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int
    for form in FORMS.values():
        fn = getattr(lib, f"sprs_dia_spmv_plan_{form}")
        fn.argtypes = [vp, ll, ll, ll, vp, i, i, ctypes.POINTER(i)]
        fn.restype = vp
    lib.sprs_dia_spmv_plan_free.argtypes = [vp]
    lib.sprs_dia_spmv_plan_free.restype = None
    run = ctypes.PyDLL(lib._name).sprs_dia_spmv_run
    run.argtypes = [vp, vp, vp, vp]
    run.restype = i
    return lib, run


def _raw_stream():
    """index -> the current stream's handle on that device, as an int."""
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    return raw if raw is not None else (lambda index: torch.cuda.current_stream(index).cuda_stream)


class _FormPlan:
    """The C plan of one operand for one form, released with this object."""

    def __init__(self, handle: int, out: torch.dtype, form: str):
        self.handle, self.out, self.form = handle, out, form
        self.form_count = f"launches_{form}"
        lib, self.run = _lib()
        weakref.finalize(self, lib.sprs_dia_spmv_plan_free, handle)


class K1Plan:
    """K1's launch plan for one operand on the card: the checks the
    operand must pass (raising as the kernel would), its offsets in a
    persistent host array, its grid (:func:`launch_config`), and per x
    type used the C plan (:class:`_FormPlan`, built at the first product
    in that type).  Calling it with x launches K1 directly (no autograd).
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
        self.index = data.device.index if data.device.index is not None else torch.cuda.current_device()
        self.x_shape = (dia.cols,)
        n_sm = torch.cuda.get_device_properties(self.device).multi_processor_count
        self.grid = launch_config(dia.rows, n_sm)[0]
        self.c_offsets = (ctypes.c_int * k)(*self.offsets)
        self.forms = {}
        self.stream = _raw_stream()

    def form_plan(self, x_dtype: torch.dtype) -> _FormPlan:
        """The C plan for x of ``x_dtype`` (TypeError for a pair that is
        no form), built on first use."""
        plan = self.forms.get(x_dtype)
        if plan is not None:
            return plan
        data = self.data
        form = form_of("dia_spmv", data, torch.empty(0, dtype=x_dtype))
        err = ctypes.c_int(0)
        handle = getattr(_lib()[0], f"sprs_dia_spmv_plan_{form}")(
            data.data_ptr(), self.rows, self.cols, self.rows_pad, self.c_offsets, len(self.offsets),
            self.grid, ctypes.byref(err),
        )
        if not handle:
            raise RuntimeError(f"dia_spmv kernel plan failed: CUDA error {err.value}")
        plan = _FormPlan(handle, torch.promote_types(data.dtype, x_dtype), form)
        self.forms[x_dtype] = plan
        return plan

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """y = A @ x, launched on the current stream, in a ``sprs.k1``
        profiler span."""
        with span("sprs.k1"):
            if x.shape != self.x_shape:
                raise ShapeError(f"dia_spmv: A is {(self.rows, self.cols)}, x is {tuple(x.shape)}")
            if x.get_device() != self.index:
                raise ValueError(
                    f"dia_spmv kernel needs data and x on one CUDA device, got {self.device} and {x.device}"
                )
            if not x.is_contiguous():
                raise ValueError("dia_spmv kernel needs contiguous data and x")
            if self.rows == 0:
                form_of("dia_spmv", self.data, x)
                return torch.empty(0, dtype=torch.promote_types(self.data.dtype, x.dtype), device=self.device)
            plan = self.forms.get(x.dtype) or self.form_plan(x.dtype)
            y = x.new_empty(self.rows, dtype=plan.out)
            err = plan.run(plan.handle, x.data_ptr(), y.data_ptr(), self.stream(self.index))
            if err != 0:
                raise RuntimeError(f"dia_spmv kernel launch failed: CUDA error {err}")
            wrapper = dia_spmv_kernel
            wrapper.launches += 1
            setattr(wrapper, plan.form_count, getattr(wrapper, plan.form_count) + 1)
            return y


def _launch(dia: DiaMat, x: torch.Tensor) -> torch.Tensor:
    """K1 on an operand prepared for this call alone (a bare DiaMat)."""
    return K1Plan(dia)(x)


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
    def forward(ctx, data, x, offsets, shape, plan):
        dia = DiaMat(data, offsets, shape)
        ctx.save_for_backward(data, x)
        ctx.offsets, ctx.shape = offsets, shape
        if data.device.type == "cpu" and x.device.type == "cpu":
            return dia_spmv_plain(dia, x)
        return plan(x) if plan is not None else _launch(dia, x)

    @staticmethod
    def backward(ctx, g):
        data, x = ctx.saved_tensors
        ddata, dx = dia_vjp(DiaMat(data, ctx.offsets, ctx.shape), x, g)
        return ddata, dx, None, None, None


def dia_spmv_kernel(dia: DiaMat, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x through K1; the counterpart of ``dia_spmv_pallas``.

    Tensors on the CPU take :func:`dia_spmv_plain`; tensors on a CUDA
    device launch the kernel, which raises on what it cannot take.
    Differentiable in ``dia.data`` and ``x``: a product that needs a
    gradient goes through ``torch.autograd.Function``; one that needs none
    on a prepared operand (:class:`DiaTiledMat`) takes its plan's direct
    launch.
    """
    plan = getattr(dia, "plan", None)
    if plan is not None and not (torch.is_grad_enabled() and (x.requires_grad or dia.data.requires_grad)):
        return plan(x)
    if x.shape != (dia.cols,):
        raise ShapeError(f"dia_spmv: A is {dia.shape}, x is {tuple(x.shape)}")
    return _DiaSpmv.apply(dia.data, x, tuple(dia.offsets), tuple(dia.shape), plan)


zero_counts(dia_spmv_kernel)


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
