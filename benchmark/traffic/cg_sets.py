"""Requests that are sets of CG iterations, as a PDE code's time steps
solve: one operator, assembled and prepared once at set-up, and each
request ``sprs_tpu_torch.linalg.cg(matvec, b, tol=0, max_iter=iters)``
for a right-hand side b = A·x_true from the seed.

The mix's parameters: ``iterations`` (per set), ``numbering``
(``natural``, or ``random``: the unknowns in a seeded order, as an
unstructured-mesh code numbers them), ``rhs_pool`` (distinct right-hand
sides, cycled).  The answer of a request is its x and the residual norm
the solver reports; the reference runs the same sets in float64.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

import sprs_tpu_torch as st
from sprs_tpu_torch import linalg
from sprs_tpu_torch.ops import prod

from harness.program import DTYPES, route_of, worst
from reference.cg import cg as reference_cg
from reference.stencil27 import Stencil27


@dataclasses.dataclass
class State:
    n: int
    nnz: int
    dtype: torch.dtype
    iters: int
    b64: torch.Tensor  # (pool, n) float64: the inputs, for the reference
    b: torch.Tensor  # the same in the program's type
    grid: tuple
    perm: Optional[torch.Tensor]
    route: str
    matvec: Optional[Callable]
    program: Optional[tuple]


def setup(cell, device, probe, gen: torch.Generator) -> State:
    cfg, mix = cell.config, cell.traffic
    dtype = DTYPES[cfg["dtype"]]
    op = cell.generator().operator(cfg, device)
    n = op["n"]
    rows, cols = op["rows"], op["cols"]
    perm = None
    if mix["numbering"] == "random":
        perm = torch.randperm(n, generator=gen, device=device)
        pos = torch.empty_like(perm)
        pos[perm] = torch.arange(n, dtype=perm.dtype, device=device)
        rows, cols = pos[rows.long()].to(torch.int32), pos[cols.long()].to(torch.int32)
    grid = (int(cfg["nx"]), int(cfg["ny"]), int(cfg["nz"]))
    ref = Stencil27(*grid, perm=perm)
    x_true = torch.rand((int(mix["rhs_pool"]), n), generator=gen, device=device,
                        dtype=torch.float64) * 2.0 - 1.0
    b64 = torch.stack([ref.matvec(x) for x in x_true])
    del x_true
    mat = st.coo_to_csmat(rows, cols, op["vals"].to(dtype), (n, n), device=device)
    nnz = mat.nnz
    del rows, cols, op
    fn, prepared = prod.prepare_spmv(mat)
    if probe.tracing:
        def matvec(v):
            with probe.span("spmv"):
                return fn(prepared, v)
    else:
        def matvec(v):
            return fn(prepared, v)
    return State(n, nnz, dtype, int(mix["iterations"]), b64, b64.to(dtype), grid, perm,
                 route_of(prepared), matvec, (mat, fn, prepared))


def request(state: State, i: int, probe):
    j = i % state.b.shape[0]
    with probe.span("cg"):
        res = linalg.cg(state.matvec, state.b[j], tol=0.0, max_iter=state.iters)
    probe.count("cg_iterations", res.iterations)
    return j, res.x, res.residual_norm


def warmup(state: State, probe) -> None:
    request(state, 0, probe)


def describe(state: State) -> dict:
    return {"n": state.n, "nnz": state.nnz, "value_bytes": state.dtype.itemsize,
            "route": state.route, "iterations": state.iters}


def release(state: State) -> None:
    state.matvec = state.program = None
    state.b = None


def check(state: State, kept) -> dict:
    """x_err: max over the sample of max|x - x_ref| / max|x_ref|;
    resid_err: of |reported residual - reference residual| / the
    reference's."""
    ref = Stencil27(*state.grid, perm=state.perm)
    x_err = resid_err = 0.0
    for _, (j, x, resid) in kept:
        xr, rr = reference_cg(ref.matvec, state.b64[j], state.iters)
        x_err = worst(x_err, float((x.to(torch.float64) - xr).abs().max() / xr.abs().max()))
        resid_err = worst(resid_err, abs(resid - rr) / rr)
    return {"x_err": x_err, "resid_err": resid_err}
