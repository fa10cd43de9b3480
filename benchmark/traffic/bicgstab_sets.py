"""Requests that are sets of BiCGSTAB iterations over the heat example's
operator, as a time-stepper's implicit solves run them: one operator,
built and prepared once at set-up (``prepare_spmv``), and each request
``sprs_tpu_torch.linalg.bicgstab(matvec, b, tol=0, max_iter=iters)``.

The mix's parameter: ``iterations`` (per set).  Every request, the
warm-up's too, solves for a right-hand side of its own, uniform in
[−1, 1) in float64 and drawn from the seed and the request's number
outside the ``bicgstab`` span, then cast to the configuration's type:
no answer can be cached, and a solve handed a stale b fails the check.
The answer of a request is its x, the iterations it ran and the
residual norm the solver reports.  The warm-up also solves one short
set of ``PROBE_ITERS`` iterations, whose x the check compares with the
reference's (``check`` says why).
"""

from __future__ import annotations

import dataclasses
import statistics
from typing import Callable, Optional

import torch

from sprs_tpu_torch import linalg
from sprs_tpu_torch.ops import prod

from harness.program import DTYPES, route_of, worst
from reference.bicgstab import bicgstab as reference_bicgstab
from reference.stencil5 import Stencil5

# the warm-up's short set: short enough that a sound float64 solve still
# agrees with the reference in x to round-off (see ``check``)
PROBE_ITERS = 10


@dataclasses.dataclass
class State:
    n: int
    nnz: int
    dtype: torch.dtype
    iters: int
    grid: tuple
    base: int  # request i's b comes from the seed base + i + 1
    draws: torch.Generator
    device: torch.device
    route: str
    matvec: Optional[Callable]
    program: Optional[tuple]
    probe: Optional[tuple] = None  # (iterations, x) of the warm-up's short set


def setup(cell, device, probe, gen: torch.Generator) -> State:
    cfg = cell.config
    dtype = DTYPES[cfg["dtype"]]
    mat = cell.generator().operator(cfg, device)
    fn, prepared = prod.prepare_spmv(mat)
    if probe.tracing:
        def matvec(v):
            with probe.span("spmv"):
                return fn(prepared, v)
    else:
        def matvec(v):
            return fn(prepared, v)
    base = int(torch.randint(0, 1 << 62, (1,), generator=gen, device=device))
    return State(mat.rows, mat.nnz, dtype, int(cell.traffic["iterations"]),
                 (int(cfg["nx"]), int(cfg["ny"])), base, torch.Generator(device=device),
                 torch.device(device), route_of(prepared), matvec, (mat, fn, prepared))


def rhs(state: State, i: int) -> torch.Tensor:
    """Request ``i``'s b in float64, the same on every call."""
    state.draws.manual_seed(state.base + i + 1)
    return torch.rand(state.n, generator=state.draws, device=state.device,
                      dtype=torch.float64) * 2.0 - 1.0


def request(state: State, i: int, probe):
    b = rhs(state, i).to(state.dtype)
    with probe.span("bicgstab"):
        res = linalg.bicgstab(state.matvec, b, tol=0.0, max_iter=state.iters)
    probe.count("bicgstab_iterations", res.iterations)
    return i, res.x, res.residual_norm, res.iterations


def warmup(state: State, probe) -> None:
    request(state, -1, probe)
    k = min(PROBE_ITERS, state.iters)
    res = linalg.bicgstab(state.matvec, rhs(state, -2).to(state.dtype), tol=0.0, max_iter=k)
    state.probe = (k, res.x)


def describe(state: State) -> dict:
    return {"n": state.n, "nnz": state.nnz, "value_bytes": state.dtype.itemsize,
            "route": state.route, "iterations": state.iters}


def release(state: State) -> None:
    state.matvec = state.program = None


def check(state: State, kept) -> dict:
    """Over the sampled requests, with b drawn again and the reference's
    operator applied in float64 on the grid itself:

    * resid_err: the largest |reported residual − ‖b − A·x‖| / ‖b − A·x‖,
      whether the residual the solver reports is that of the x it
      returns, for the request's own b and the true operator;
    * x_unchanged: the answers whose x is still the start (0 everywhere);
    * iterations_off: the answers that ran other than ``iters``
      iterations;
    * resid_ratio: the median of ‖b − A·x‖ / ‖b − A·x_ref‖, x_ref the
      reference's solve of the same b in as many iterations: the
      progress of the set.  A median, because a sound set may end on a
      passing spike of its residual (7.1·‖b‖ in one request of 600 on an
      H100, against 0.013·‖b‖ at the median);
    * probe_x_err: max|x − x_ref| / max|x_ref| of the warm-up's short set
      of ``PROBE_ITERS`` iterations against the reference's.

    The sets' x is not compared: BiCGSTAB on this operator amplifies the
    last bit of one product about 10^4.5 times every 10 iterations, so
    after 50 two sound float64 solves differ by percents in x, as a
    float32 one does, and their residuals alike.  After 10 they still
    agree to round-off, so the short set is what holds the arithmetic of
    the iterations (their precision, α, ω and β) to the reference."""
    ref = Stencil5(*state.grid)
    norm = torch.linalg.vector_norm
    resid_err, unchanged, off, ratios = 0.0, 0, 0, []
    for _, (i, x, resid, iters) in kept:
        b = rhs(state, i)
        x = x.to(torch.float64)
        true = float(norm(b - ref.matvec(x)))
        resid_err = worst(resid_err, abs(resid - true) / max(true, 1e-300))
        unchanged += int(not bool(x.any()))
        off += int(iters != state.iters)
        _, _, ref_resid = reference_bicgstab(ref.matvec, b, 0.0, state.iters)
        ratios.append(worst(true / max(ref_resid, 1e-300)))
    k, xp = state.probe
    xr, _, _ = reference_bicgstab(ref.matvec, rhs(state, -2), 0.0, k)
    probe_err = float((xp.to(torch.float64) - xr).abs().max() / xr.abs().max())
    return {"resid_err": resid_err, "x_unchanged": unchanged, "iterations_off": off,
            "resid_ratio": statistics.median(ratios), "probe_x_err": worst(probe_err)}
