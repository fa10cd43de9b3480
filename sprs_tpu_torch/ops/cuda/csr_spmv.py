"""Unstructured SpMV kernel K7 over the CSR format:
y[r] = Σ_{k in indptr[r]..indptr[r+1]} data[k] · x[indices[k]].

The CUDA C++ kernel is ``sprs_tpu_torch/csrc/csr_spmv.cu``.  It replaces
no Pallas kernel: the JAX package's CSR product is XLA's
``segment_sum``.  Its note says what bounds it (bytes: values and
indices once, the row pointers, x and y once) and how its merge-path
design meets that bound.  This module holds what surrounds it, as
``ell_spmv.py`` does for K5:

* ``csr_spmv_plain``, the plain torch product of a compressed matrix in
  either storage (``formats/util.py``: the gather or scatter form summed
  by ``index_sum_``), imported from there: the CPU's product and K7's
  reference on the card;
* :func:`takes`, the one rule of which products K7 computes, which
  ``ops/prod.py::spmv`` asks and :func:`_check` enforces;
* :func:`csr_spmv_kernel`, the wrapper: CPU tensors take the plain
  version, CUDA tensors launch the kernel or raise — never both.  It
  takes the type forms of ``forms.FORMS`` with int32 indices.  Where
  neither ``data`` nor ``x`` needs a gradient it launches directly (one
  ctypes call, y from ``new_empty``, the tiles' carries from
  ``torch.empty``); otherwise through a ``torch.autograd.Function`` whose
  backward (:func:`csr_vjp`) is the plain product's gradient.  Its
  ``launches`` attribute counts kernel launches, and ``launches_<form>``
  those of each form.  The grid comes from sizes the host knows
  (:func:`tiles`): no launch reads a device value back.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..._span import span
from ...errors import ShapeError
from ...formats.csmat import CsMat
from ...formats.util import INDEX_DTYPE, csr_spmv_plain, index_sum_, row_ids_from_indptr
from . import build
from .forms import FORMS, count_launch, form_of, widened, zero_counts

TILE = 256 * 11  # csrc/csr_spmv.cu: kTile = kThreads * kItems, merge-path items a CTA
# scratch a tile: its trailing and head partial sums (up to 8 bytes
# each) and its trailing row id
CARRY_BYTES = 8 + 8 + 4


def tiles(rows: int, cap: int) -> int:
    """The tile kernel's grid for ``rows`` rows and ``cap`` stored slots:
    enough tiles of :data:`TILE` path items for rows + cap, the most the
    path can hold (rows + nnz, nnz <= cap), from sizes the host knows.
    Tiles past rows + nnz return at once."""
    return -(-(rows + cap) // TILE)


def _refusal(mat: CsMat, x: torch.Tensor):
    """The error K7 raises on the storage and types of ``mat @ x``, or
    None where it takes them: CSR storage, a (data, x) form of ``FORMS``
    and int32 indptr and indices."""
    if not mat.is_csr:
        return ValueError("csr_spmv kernel takes CSR storage, got CSC")
    try:
        form_of("csr_spmv", mat.data, x)
    except TypeError as err:
        return err
    if mat.indices.dtype != INDEX_DTYPE or mat.indptr.dtype != INDEX_DTYPE:
        return TypeError(f"csr_spmv kernel takes int32 indptr and indices, got "
                         f"{mat.indptr.dtype} and {mat.indices.dtype}")
    return None


def takes(mat: CsMat, x: torch.Tensor) -> bool:
    """Whether K7 computes ``mat @ x``: a matrix on a CUDA device whose
    storage and types :func:`_check` accepts.  Its layout does not enter:
    ``ops/prod.py::spmv`` hands the kernel contiguous operands."""
    return mat.data.is_cuda and _refusal(mat, x) is None


@functools.lru_cache(maxsize=None)
def _entry(form: str):
    fn = getattr(build.load("csr_spmv"), f"sprs_csr_spmv_{form}")
    ll, vp = ctypes.c_longlong, ctypes.c_void_p
    fn.argtypes = [vp, vp, vp, vp, vp, vp, ll, ll, ll, ll, vp]
    fn.restype = ctypes.c_int
    return fn


def _check(mat: CsMat, x: torch.Tensor) -> str:
    """Refuse, before any launch, the storages, types, shapes and layouts
    that the kernel does not take (the device is checked by
    :func:`_launch`); return the type form."""
    indptr, idx, data = mat.indptr, mat.indices, mat.data
    err = _refusal(mat, x)
    if err is not None:
        raise err
    if (indptr.shape != (mat.rows + 1,) or idx.ndim != 1 or data.shape != idx.shape
            or x.shape != (mat.cols,)):
        raise ShapeError(
            f"csr_spmv: indptr {tuple(indptr.shape)}, indices {tuple(idx.shape)}, data "
            f"{tuple(data.shape)} and x {tuple(x.shape)} for {mat.shape}")
    if not (indptr.is_contiguous() and idx.is_contiguous() and data.is_contiguous()
            and x.is_contiguous()):
        raise ValueError("csr_spmv kernel needs contiguous indptr, indices, data and x")
    return FORMS[(data.dtype, x.dtype)]


def _launch(mat: CsMat, x: torch.Tensor) -> torch.Tensor:
    indptr, idx, data = mat.indptr, mat.indices, mat.data
    dev = data.device
    if dev.type != "cuda" or indptr.device != dev or idx.device != dev or x.device != dev:
        raise ValueError(
            f"csr_spmv kernel needs indptr, indices, data and x on one CUDA device, got "
            f"{indptr.device}, {idx.device}, {dev} and {x.device}")
    form = _check(mat, x)
    y = data.new_empty(mat.rows, dtype=torch.promote_types(data.dtype, x.dtype))
    if mat.rows == 0:
        return y
    if mat.cols == 0:
        return y.zero_()
    n = tiles(mat.rows, idx.shape[0])
    work = torch.empty(n * CARRY_BYTES, dtype=torch.uint8, device=dev)
    err = _entry(form)(
        indptr.data_ptr(), idx.data_ptr(), data.data_ptr(), x.data_ptr(), y.data_ptr(),
        work.data_ptr(), mat.rows, mat.cols, idx.shape[0], n,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"csr_spmv kernel launch failed: CUDA error {err}")
    count_launch(csr_spmv_kernel, form)
    return y


def csr_vjp(mat: CsMat, x: torch.Tensor, g: torch.Tensor):
    """(ddata, dx) for y = A @ x, A in CSR: ddata[k] = g[row k]·x[indices[k]]
    (the forward gather against the cotangent) and dx[indices[k]] +=
    data[k]·g[row k] (the transpose product in scatter form, summed by
    ``index_sum_``), padding slots taking 0, each in its input's type.
    The plain product's gradient; where an operand is 16-bit it takes
    products and sums as the kernel does (``forms.widened``) and rounds
    once."""
    wide = widened(mat.data, x)
    if wide is None:
        acc = prod = torch.promote_types(mat.dtype, g.dtype)
    else:
        _, acc, prod = wide
    rows = row_ids_from_indptr(mat.indptr, mat.cap).to(torch.int64)
    live = rows < mat.rows
    rows = torch.where(live, rows, torch.zeros_like(rows))
    cols = mat.indices.to(torch.int64)
    zero = torch.zeros((), dtype=prod, device=g.device)
    gr = torch.where(live, g.to(prod)[rows], zero)
    ddata = torch.where(live, x.to(prod)[cols] * gr, zero).to(mat.dtype)
    contrib = (mat.data.to(prod) * gr).to(acc)
    dx = index_sum_(torch.zeros(x.shape, dtype=acc, device=x.device), cols, contrib)
    return ddata, dx.to(x.dtype)


class _CsrSpmv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, indptr, indices, data, x, shape):
        mat = CsMat(indptr, indices, data, shape, "csr")
        ctx.save_for_backward(indptr, indices, data, x)
        ctx.shape = shape
        return _launch(mat, x)

    @staticmethod
    def backward(ctx, g):
        indptr, indices, data, x = ctx.saved_tensors
        ddata, dx = csr_vjp(CsMat(indptr, indices, data, ctx.shape, "csr"), x, g)
        return None, None, ddata, dx, None


def csr_spmv_kernel(mat: CsMat, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x through K7 for a CSR matrix.

    Tensors on the CPU take :func:`csr_spmv_plain`; tensors on a CUDA
    device launch the kernel, which raises on what it cannot take.
    Differentiable in ``mat.data`` and ``x``.  Runs in a ``sprs.k7``
    profiler span.
    """
    with span("sprs.k7"):
        if x.shape != (mat.cols,):
            raise ShapeError(f"csr_spmv: A is {mat.shape}, x is {tuple(x.shape)}")
        if all(t.device.type == "cpu" for t in (mat.indptr, mat.indices, mat.data, x)):
            return csr_spmv_plain(mat, x)
        if torch.is_grad_enabled() and (mat.data.requires_grad or x.requires_grad):
            return _CsrSpmv.apply(mat.indptr, mat.indices, mat.data, x, tuple(mat.shape))
        return _launch(mat, x)


zero_counts(csr_spmv_kernel)
