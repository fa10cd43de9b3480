"""Kernel K8: BiCGSTAB's vector updates, reductions and scalar logic in
six passes an iteration (``csrc/krylov.cu``), around the caller's three
products; ``linalg/bicgstab.py::_fused`` runs them in order.

Each pass is one launch of its kernel:

1. :func:`rhat_dot_v`: r̂·v, then ``safe`` and α;
2. :func:`s_update`: s = r − α v;
3. :func:`t_sums`: t·t and t·s, then ω;
4. :func:`xr_update`: x += α p̂ + ω ŝ and r = s − ω t, with r̂·r, r·r and
   r̂·r̂, then the soft restart, ρ_next, β and whether ‖r‖ passed;
5. :func:`true_residual`: ‖b − A·x‖², then ``done``, ``lied`` and ρ;
6. :func:`p_update`: p = r + β (p − ω v), or r̂ = p = r where the soft
   restart fired, or r = r̂ = p = b − A·x where the recursive residual
   lied.

The scalars and flags live in ``Work.sc``, a small tensor of the
vectors' type on their device (slot names in :data:`SLOTS`); the passes
update the vectors in place.  The passes take the pointers as they are:
every vector is the solve's own buffer or has passed :func:`vector`.

:func:`takes` is the one rule of which solves take K8: a real float32 or
float64 right-hand side, one-dimensional and contiguous, on a CUDA
device, and under grad mode no tensor of the solve that needs a
gradient.  :data:`COUNTS` keeps the engagement counters: K8's
``launches`` and ``launches_<f32|f64>``, and the iterations that ran
fused or in the plain loop.
"""

from __future__ import annotations

import dataclasses

import torch

from ...errors import ShapeError
from . import forms, launch
from .launch import I32, I64, PTR

THREADS = 256  # csrc/krylov.cu: kThreads
UNROLL = 4  # csrc/krylov.cu: kUnroll
MAX_GRID = 1024  # csrc/krylov.cu: kMaxGrid
SLOTS = ("rho", "alpha", "omega", "beta", "threshold", "eps", "tiny", "safe", "soft",
         "rec_small", "rho_next", "lied", "done")
(RHO, ALPHA, OMEGA, BETA, THRESH, EPS, TINY, SAFE, SOFT, REC, RHO_NEXT, LIED,
 DONE) = range(len(SLOTS))
WORK_BYTES = 3 * MAX_GRID * 8 + 8  # partial sums, then the last block's counter
SHORT = {t: forms.SHORT[t] for t in (torch.float32, torch.float64)}
# a pass's argument types by its pointer count: vectors, sc and the scratch
_ARGS = {n: (PTR,) * n + (I64, I32, PTR) for n in range(4, 10)}


@dataclasses.dataclass
class Counts:
    launches: int = 0
    launches_f32: int = 0
    launches_f64: int = 0
    fused_iterations: int = 0
    plain_iterations: int = 0

    def zero(self) -> None:
        for field in dataclasses.fields(self):
            setattr(self, field.name, 0)


COUNTS = Counts()


def _refusal(b: torch.Tensor, grads=()):
    """The reason K8 does not take a solve for ``b``, or None: b must be
    float32 or float64, one-dimensional and contiguous, and under grad
    mode neither b nor any tensor of ``grads`` (the other tensors the
    solution depends on, read lazily) may need a gradient, since the
    passes write their vectors in place, out of autograd's sight.  The
    device is :func:`takes`' test."""
    if b.dtype not in SHORT:
        return TypeError(f"K8 takes float32 or float64 vectors, got {b.dtype}")
    if b.ndim != 1:
        return ShapeError(f"K8 takes one right-hand side, got shape {tuple(b.shape)}")
    if not b.is_contiguous():
        return ValueError("K8 takes a contiguous right-hand side")
    if torch.is_grad_enabled() and (b.requires_grad or any(t.requires_grad for t in grads)):
        return ValueError("K8 does not differentiate: a solve that needs a gradient takes the plain loop")
    return None


def takes(b: torch.Tensor, grads=()) -> bool:
    """Whether ``linalg.bicgstab`` runs the solve for ``b`` through K8:
    a CUDA tensor that :func:`_refusal` accepts with ``grads``."""
    return b.is_cuda and _refusal(b, grads) is None


def grid(n: int) -> int:
    """The passes' grid for vectors of ``n``: fixed by n alone, so each
    thread sums the same elements in the same order on every run."""
    return max(1, min(MAX_GRID, -(-n // (THREADS * UNROLL))))


@dataclasses.dataclass
class Work:
    """One solve's scalars (``sc``), the reductions' scratch (``part``:
    partial sums and a counter, zeroed), and the launch geometry."""

    sc: torch.Tensor
    part: torch.Tensor
    n: int
    grid: int
    form: str


def workspace(b: torch.Tensor, rho, threshold, done, restart_eps: float, tiny) -> Work:
    """The solve's :class:`Work`: ``sc`` holds ρ, the threshold, ``done``
    (0-d tensors of the loop's set-up), ``restart_eps`` and ``tiny`` in
    b's type, every other slot 0."""
    zero = b.new_zeros(())
    vals = [zero] * len(SLOTS)
    vals[RHO], vals[THRESH], vals[TINY] = rho, threshold, tiny
    vals[EPS] = b.new_tensor(restart_eps)
    vals[DONE] = done
    sc = torch.stack([v.to(b.dtype) for v in vals])
    part = torch.zeros(WORK_BYTES, dtype=torch.uint8, device=b.device)
    return Work(sc, part, b.shape[0], grid(b.shape[0]), SHORT[b.dtype])


def vector(y, like: torch.Tensor, what: str) -> torch.Tensor:
    """``y`` (x0, the first residual, or a matvec's or preconditioner's
    result) as the passes take it: of ``like``'s shape, type and device
    (else raises), contiguous."""
    if not isinstance(y, torch.Tensor):
        raise TypeError(f"bicgstab: {what} is a {type(y).__name__}, not a tensor")
    if y.shape != like.shape:
        raise ShapeError(f"bicgstab: {what} has shape {tuple(y.shape)}, b {tuple(like.shape)}")
    if y.dtype != like.dtype:
        raise TypeError(f"bicgstab: {what} is {y.dtype}, b {like.dtype}")
    if y.device != like.device:
        raise ValueError(f"bicgstab: {what} is on {y.device}, b on {like.device}")
    return y.contiguous()


def _launch(name: str, w: Work, vectors, reduces: bool) -> None:
    """One pass on ``vectors`` (then ``sc``, and the scratch where the
    pass reduces)."""
    ptrs = [v.data_ptr() for v in vectors] + [w.sc.data_ptr()] + ([w.part.data_ptr()] if reduces else [])
    fn = launch.entry("krylov", f"sprs_k8_{name}_{w.form}", _ARGS[len(ptrs)])
    launch.check(fn(*ptrs, w.n, w.grid, launch.stream(w.sc.get_device())), "K8 " + name)
    launch.count(COUNTS, w.form)


def rhat_dot_v(rhat, v, w: Work) -> None:
    _launch("rv", w, (rhat, v), True)


def s_update(r, v, s, w: Work) -> None:
    _launch("s", w, (r, v, s), False)


def t_sums(t, s, w: Work) -> None:
    _launch("tt", w, (t, s), True)


def xr_update(x, phat, shat, s, t, r, rhat, w: Work) -> None:
    _launch("xr", w, (x, phat, shat, s, t, r, rhat), True)


def true_residual(b, ax, w: Work) -> None:
    _launch("true", w, (b, ax), True)


def p_update(b, ax, r, rhat, p, v, w: Work) -> None:
    _launch("p", w, (b, ax, r, rhat, p, v), False)
