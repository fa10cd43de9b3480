"""Unstructured SpMV kernel K5 over the ELL format:
y[r] = Σ_j data[r, j] · x[indices[r, j]].

The CUDA C++ kernel is ``sprs_tpu_torch/csrc/ell_spmv.cu``; its note says
which TPU function it replaces, what bounds it (bytes: indices, data, x
and y each cross device memory once) and how its design meets that bound.
This module holds what surrounds it, as ``dia_spmv.py`` does for K1:

* :func:`ell_spmv_plain`, the plain torch version (``formats/ell.py::
  ell_spmv``; where an operand is 16-bit, a sum over the slots in slot
  order in ``promote(out, float32)`` with one rounding, as
  ``forms.widened`` says), used for tensors on the CPU and as the
  kernel's reference on the card.  Its ``calls`` attribute counts calls;
* :func:`ell_spmv_kernel`, the wrapper: CPU tensors take the plain
  version, CUDA tensors launch the kernel or raise — never both.  It
  takes the type forms of ``forms.FORMS``.  Its ``launches`` attribute
  counts kernel launches, and ``launches_<form>`` those of each form.
  Every x takes the kernel: the JAX package's escapes to XLA (x above
  48 MB of VMEM, a backend that cannot lower the gather) are TPU limits
  with no counterpart here;
* a ``torch.autograd.Function`` whose forward is the kernel and whose
  backward (:func:`ell_vjp`) is the plain torch form of the JAX package's
  ``_bwd``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from ...errors import ShapeError
from ...formats.ell import EllMat, ell_spmv
from ...formats.util import index_sum_
from . import build
from .forms import count_launch, form_of, widened, zero_counts

BLOCK = 256  # csrc/ell_spmv.cu: kThreads
# Resident 256-thread blocks per SM at full occupancy (2048 threads).
BLOCKS_PER_SM = 8


def group_lanes(width: int) -> int:
    """Lanes that share a row: the smallest power of two >= ``width``, at
    most 32.  The kernel takes it as an argument and the grid is sized by
    it, so the rule lives only here."""
    g = 1
    while g < width and g < 32:
        g *= 2
    return g


def launch_config(rows: int, width: int, n_sm: int) -> Tuple[int, int]:
    """(grid, block) for ``rows`` output rows of ``width`` slots on a card
    with ``n_sm`` SMs: a group of :func:`group_lanes` lanes per row, at
    most one full wave of resident blocks; the kernel's grid-stride loop
    covers the rest."""
    blocks = -(-rows // (BLOCK // group_lanes(width)))
    return max(1, min(blocks, n_sm * BLOCKS_PER_SM)), BLOCK


def ell_spmv_plain(ell: EllMat, x: torch.Tensor) -> torch.Tensor:
    """The plain torch K5: one gather and a row sum, pad slots included
    (``formats/ell.py::ell_spmv``); where an operand is 16-bit, each
    product taken in ``prod`` and the slots added in slot order in
    ``promote(out, float32)``, rounded once (``forms.widened``)."""
    ell_spmv_plain.calls += 1
    wide = widened(ell.data, x)
    if wide is None:
        return ell_spmv(ell, x)
    if x.shape != (ell.cols,):
        raise ShapeError(f"ell_spmv: A is {ell.shape}, x is {tuple(x.shape)}")
    out, acc, prod = wide
    data, xs, idx = ell.data.to(prod), x.to(prod), ell.indices.to(torch.int64)
    y = torch.zeros(ell.rows_pad, dtype=acc, device=x.device)
    for s in range(ell.width):
        y = y + (data[:, s] * xs[idx[:, s]]).to(acc)
    return y[: ell.rows].to(out)


ell_spmv_plain.calls = 0


@functools.lru_cache(maxsize=None)
def _entry(form: str):
    fn = getattr(build.load("ell_spmv"), f"sprs_ell_spmv_{form}")
    ll, vp, i = ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp, vp, vp, vp, ll, ll, i, i, i, i, vp]
    fn.restype = ctypes.c_int
    return fn


def _check(ell: EllMat, x: torch.Tensor) -> str:
    """Refuse, before any launch, the types, shapes and layouts that the
    kernel does not take (the device is checked by :func:`_launch`);
    return the type form."""
    idx, data = ell.indices, ell.data
    form = form_of("ell_spmv", data, x)
    if idx.dtype != torch.int32:
        raise TypeError(f"ell_spmv kernel takes int32 indices, got {idx.dtype}")
    if idx.ndim != 2 or data.shape != idx.shape or ell.rows_pad < ell.rows:
        raise ShapeError(
            f"ell_spmv: indices {tuple(idx.shape)} and data {tuple(data.shape)} for {ell.shape}"
        )
    if not (idx.is_contiguous() and data.is_contiguous() and x.is_contiguous()):
        raise ValueError("ell_spmv kernel needs contiguous indices, data and x")
    return form


def _launch(ell: EllMat, x: torch.Tensor) -> torch.Tensor:
    idx, data = ell.indices, ell.data
    if data.device.type != "cuda" or idx.device != data.device or x.device != data.device:
        raise ValueError(
            f"ell_spmv kernel needs indices, data and x on one CUDA device, got "
            f"{idx.device}, {data.device} and {x.device}"
        )
    form = _check(ell, x)
    y = torch.empty(ell.rows, dtype=torch.promote_types(data.dtype, x.dtype), device=data.device)
    if ell.rows == 0:
        return y
    if ell.cols == 0:
        return y.zero_()
    n_sm = torch.cuda.get_device_properties(data.device).multi_processor_count
    grid, block = launch_config(ell.rows, ell.width, n_sm)
    err = _entry(form)(
        idx.data_ptr(),
        data.data_ptr(),
        x.data_ptr(),
        y.data_ptr(),
        ell.rows,
        ell.cols,
        ell.width,
        group_lanes(ell.width),
        grid,
        block,
        torch.cuda.current_stream(data.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"ell_spmv kernel launch failed: CUDA error {err}")
    count_launch(ell_spmv_kernel, form)
    return y


def ell_vjp(ell: EllMat, x: torch.Tensor, g: torch.Tensor):
    """(ddata, dx) for y = A @ x: ddata[r, j] = g[r]·x[indices[r, j]] (the
    forward gather against the cotangent) and dx[indices[r, j]] +=
    data[r, j]·g[r] (the transpose product in scatter form), pad rows
    taking g = 0, each in its input's type.  The plain torch form of the
    JAX package's ``_bwd``; where an operand is 16-bit it takes products
    and sums as the forward does (``forms.widened``) and rounds once."""
    wide = widened(ell.data, x)
    if wide is None:
        acc = prod = torch.promote_types(ell.dtype, g.dtype)
    else:
        _, acc, prod = wide
    gp = g.new_zeros(ell.rows_pad, dtype=prod)
    gp[: ell.rows] = g
    idx = ell.indices.to(torch.int64)
    ddata = (x.to(prod)[idx] * gp[:, None]).to(ell.dtype)
    contrib = (ell.data.to(prod) * gp[:, None]).to(acc)
    dx = index_sum_(torch.zeros(x.shape, dtype=acc, device=x.device), idx.reshape(-1),
                    contrib.reshape(-1))
    return ddata, dx.to(x.dtype)


class _EllSpmv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, indices, data, x, shape):
        ell = EllMat(indices, data, shape)
        ctx.save_for_backward(indices, data, x)
        ctx.shape = shape
        if all(t.device.type == "cpu" for t in (indices, data, x)):
            return ell_spmv_plain(ell, x)
        return _launch(ell, x)

    @staticmethod
    def backward(ctx, g):
        indices, data, x = ctx.saved_tensors
        ddata, dx = ell_vjp(EllMat(indices, data, ctx.shape), x, g)
        return None, ddata, dx, None


def ell_spmv_kernel(ell: EllMat, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x through K5; the counterpart of ``ell_spmv_pallas``.

    Tensors on the CPU take :func:`ell_spmv_plain`; tensors on a CUDA
    device launch the kernel, which raises on what it cannot take.
    Differentiable in ``ell.data`` and ``x``.
    """
    if x.shape != (ell.cols,):
        raise ShapeError(f"ell_spmv: A is {ell.shape}, x is {tuple(x.shape)}")
    return _EllSpmv.apply(ell.indices, ell.data, x, tuple(ell.shape))


zero_counts(ell_spmv_kernel)
