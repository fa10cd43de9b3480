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
* :func:`ell_spmv_kernel`, the wrapper, which takes the type forms of
  ``forms.FORMS`` and runs as ``launch.run`` says: the plain version on
  CPU tensors, the kernel's direct launch on the card, and a
  ``torch.autograd.Function`` where a gradient is needed, whose backward
  (:func:`ell_vjp`) is the plain torch form of the JAX package's
  ``_bwd``.  Its ``launches`` attribute counts kernel launches, and
  ``launches_<form>`` those of each form.  Every x takes the kernel: the
  JAX package's escapes to XLA (x above 48 MB of VMEM, a backend that
  cannot lower the gather) are TPU limits with no counterpart here.

A renumbered operand (``EllMat.order``: ``ops/renumber.py``) runs two
hand-written passes inside one product: the gather x' = x[order] into
scratch, then K5 over the stored rows and x', whose store writes
y[order[r]].  Each row sums as it does unrenumbered, so y is bit-equal
to K5's on the operator as given.  ``launches`` still counts one per
product; ``launches_renumbered`` counts the products that took this path.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..._span import span
from ...errors import ShapeError
from ...formats.ell import EllMat, ell_spmv, in_stored_order
from ...formats.util import index_sum_
from . import launch
from .forms import FORMS, form_of, widened
from .launch import I32, I64, PTR

BLOCK = 256  # csrc/ell_spmv.cu: kThreads
GATHER_UNROLL = 4  # csrc/ell_spmv.cu: kGatherUnroll
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
    ``promote(out, float32)``, rounded once (``forms.widened``).  On a
    renumbered operand y[order] = plain(A', x[order]), as K5 computes it."""
    ell_spmv_plain.calls += 1
    wide = widened(ell.data, x)
    if wide is None:
        return ell_spmv(ell, x)
    if x.shape != (ell.cols,):
        raise ShapeError(f"ell_spmv: A is {ell.shape}, x is {tuple(x.shape)}")
    out, acc, prod = wide
    data, idx = ell.data.to(prod), ell.indices.to(torch.int64)

    def rows(v):
        v = v.to(prod)
        y = torch.zeros(ell.rows_pad, dtype=acc, device=x.device)
        for s in range(ell.width):
            y = y + (data[:, s] * v[idx[:, s]]).to(acc)
        return y[: ell.rows].to(out)

    return in_stored_order(ell, x, rows)


ell_spmv_plain.calls = 0


def gather_config(n: int, n_sm: int) -> Tuple[int, int]:
    """(grid, block) of the gather pass over ``n`` entries: GATHER_UNROLL
    entries a thread in flight, at most one full wave of resident
    blocks; its grid-stride loop covers the rest."""
    blocks = -(-n // (BLOCK * GATHER_UNROLL))
    return max(1, min(blocks, n_sm * BLOCKS_PER_SM)), BLOCK


_ARGS = (PTR, PTR, PTR, PTR, PTR, I64, I64, I32, I32, I32, I32, PTR)
_GATHER_ARGS = (PTR, PTR, PTR, I64, I32, I32, PTR)


def _check(ell: EllMat, x: torch.Tensor) -> str:
    """Refuse, before any launch, the types, shapes and layouts that the
    kernel does not take (the device is checked by :func:`_launch`);
    return the type form."""
    idx, data, order = ell.indices, ell.data, ell.order
    form = form_of("ell_spmv", data, x)
    if idx.dtype != torch.int32:
        raise TypeError(f"ell_spmv kernel takes int32 indices, got {idx.dtype}")
    if idx.ndim != 2 or data.shape != idx.shape or ell.rows_pad < ell.rows:
        raise ShapeError(
            f"ell_spmv: indices {tuple(idx.shape)} and data {tuple(data.shape)} for {ell.shape}"
        )
    if not (idx.is_contiguous() and data.is_contiguous() and x.is_contiguous()):
        raise ValueError("ell_spmv kernel needs contiguous indices, data and x")
    if order is not None:
        if order.dtype != torch.int32 or not order.is_contiguous():
            raise TypeError(f"ell_spmv kernel takes a contiguous int32 order, got {order.dtype}")
        if ell.rows != ell.cols or tuple(order.shape) != (ell.rows,):
            raise ShapeError(f"ell_spmv: order of {tuple(order.shape)} for {ell.shape}")
    return form


def _launch(ell: EllMat, x: torch.Tensor) -> torch.Tensor:
    idx, data, order = ell.indices, ell.data, ell.order
    launch.one_card("ell_spmv", "indices, data and x", idx, data, x)
    if order is not None:
        launch.one_card("ell_spmv", "the order and x", order, x)
    form = _check(ell, x)
    y = torch.empty(ell.rows, dtype=torch.promote_types(data.dtype, x.dtype), device=data.device)
    if ell.rows == 0:
        return y
    if ell.cols == 0:
        return y.zero_()
    index = data.get_device()
    n_sm, stream = launch.sm_count(index), launch.stream(index)
    if order is not None:
        xs = torch.empty_like(x)
        err = launch.entry("ell_spmv", f"sprs_ell_gather_b{x.element_size()}", _GATHER_ARGS)(
            order.data_ptr(), x.data_ptr(), xs.data_ptr(), ell.cols,
            *gather_config(ell.cols, n_sm), stream,
        )
        launch.check(err, "ell_spmv gather")
        x = xs
    grid, block = launch_config(ell.rows, ell.width, n_sm)
    err = launch.entry("ell_spmv", f"sprs_ell_spmv_{form}", _ARGS)(
        idx.data_ptr(),
        data.data_ptr(),
        x.data_ptr(),
        y.data_ptr(),
        None if order is None else order.data_ptr(),
        ell.rows,
        ell.cols,
        ell.width,
        group_lanes(ell.width),
        grid,
        block,
        stream,
    )
    launch.check(err, "ell_spmv kernel")
    if order is None:
        launch.count(ell_spmv_kernel, form)
    else:
        launch.count(ell_spmv_kernel, form, "renumbered")
    return y


def ell_vjp(ell: EllMat, x: torch.Tensor, g: torch.Tensor):
    """(ddata, dx) for y = A @ x: ddata[r, j] = g[r]·x[indices[r, j]] (the
    forward gather against the cotangent) and dx[indices[r, j]] +=
    data[r, j]·g[r] (the transpose product in scatter form), pad rows
    taking g = 0, each in its input's type.  The plain torch form of the
    JAX package's ``_bwd``; where an operand is 16-bit it takes products
    and sums as the forward does (``forms.widened``) and rounds once.  On
    a renumbered operand ddata is in the stored layout, dx in the
    caller's order."""
    if ell.renumbered:
        order = ell.order.long()
        ddata, dxs = ell_vjp(EllMat(ell.indices, ell.data, ell.shape), x[order], g[order])
        dx = torch.empty_like(dxs)
        dx[order] = dxs
        return ddata, dx
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
    def of(ell: EllMat, x: torch.Tensor) -> torch.Tensor:
        return _EllSpmv.apply(ell.indices, ell.data, x, tuple(ell.shape), ell.order)

    @staticmethod
    def forward(ctx, indices, data, x, shape, order):
        ell = EllMat(indices, data, shape, order)
        ctx.save_for_backward(indices, data, x, order)
        ctx.shape = shape
        if launch.on_cpu(indices, data, x):
            return ell_spmv_plain(ell, x)
        return _launch(ell, x)

    @staticmethod
    def backward(ctx, g):
        indices, data, x, order = ctx.saved_tensors
        ddata, dx = ell_vjp(EllMat(indices, data, ctx.shape, order), x, g)
        return None, ddata, dx, None, None


def ell_spmv_kernel(ell: EllMat, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x through K5; the counterpart of ``ell_spmv_pallas``.

    Runs as ``launch.run`` says: tensors on the CPU take
    :func:`ell_spmv_plain`; tensors on a CUDA device launch the kernel,
    which raises on what it cannot take.  Differentiable in ``ell.data``
    and ``x``.  Runs in a ``sprs.k5`` profiler span.
    """
    with span("sprs.k5"):
        if x.shape != (ell.cols,):
            raise ShapeError(f"ell_spmv: A is {ell.shape}, x is {tuple(x.shape)}")
        return launch.run((ell.indices, ell.data, x), ell_spmv_plain, _EllSpmv.of, _launch, ell, x)


launch.zero(ell_spmv_kernel, [*FORMS.values(), "renumbered"])
