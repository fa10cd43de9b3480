"""Requests that are personalized PageRanks over one graph, as a
graph-diffusion service answers them: the operator P = A·D⁻¹ is built
once at set-up through the program (``coo_to_csmat``, then
``prepare_spmv``), and each request runs GAP's power iteration in the
caller's own loop, one product by the program per step.

The mix's parameters: ``damping``, ``tolerance`` (on the L1 change of
the scores, read back every step as GAP's loop does; 0 runs every
request to ``max_iterations``), ``max_iterations``,
``teleport_vertices`` (the size of each request's seeded teleport set; a
power of two, so that the teleport vector's sums are exact) and
``teleport_pool`` (distinct teleport sets, cycled).  Scores are in the
configuration's type.  The answer is the scores and the step count; the
reference runs the same number of steps in float64.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

import sprs_tpu_torch as st
from sprs_tpu_torch.ops import prod

from harness.program import DTYPES, route_of, worst
from reference.pagerank import pagerank as reference_pagerank


@dataclasses.dataclass
class State:
    n: int
    nnz: int
    dtype: torch.dtype
    rows: torch.Tensor  # the deduplicated graph: the inputs, for the reference
    cols: torch.Tensor
    sources: torch.Tensor  # (pool, teleport_vertices) int64
    damping: float
    tolerance: float
    max_iterations: int
    route: str
    program: Optional[tuple]


def setup(cell, device, probe, gen: torch.Generator) -> State:
    cfg, mix = cell.config, cell.traffic
    dtype = DTYPES[cfg["dtype"]]
    g = cell.generator()
    e = g.edges(cfg, device)
    n = e["n"]
    rows, cols = g.dedup(e["rows"], e["cols"], n)
    del e
    deg = torch.bincount(rows.to(torch.int64), minlength=n)
    vals = (1.0 / deg[cols.to(torch.int64)].to(torch.float64)).to(dtype)
    del deg
    mat = st.coo_to_csmat(rows, cols, vals, (n, n), device=device)
    del vals
    fn, prepared = prod.prepare_spmv(mat)
    sources = torch.randint(0, n, (int(mix["teleport_pool"]), int(mix["teleport_vertices"])),
                            generator=gen, device=device)
    return State(n, int(rows.numel()), dtype, rows, cols, sources, float(mix["damping"]),
                 float(mix["tolerance"]), int(mix["max_iterations"]), route_of(prepared),
                 (mat, fn, prepared))


def teleport(n: int, sources: torch.Tensor, dtype) -> torch.Tensor:
    v = torch.zeros(n, dtype=dtype, device=sources.device)
    return v.index_add_(0, sources, torch.full(sources.shape, 1.0 / sources.numel(),
                                               dtype=dtype, device=sources.device))


def request(state: State, i: int, probe):
    _, fn, prepared = state.program
    j = i % state.sources.shape[0]
    d = state.damping
    with probe.span("pagerank"):
        v = teleport(state.n, state.sources[j], state.dtype)
        x = v.clone()
        steps = 0
        while steps < state.max_iterations:
            with probe.span("spmv"):
                y = fn(prepared, x)
            x_new = (1.0 - d) * v + d * y
            err = (x_new - x).abs().sum()
            x = x_new
            steps += 1
            if float(err) < state.tolerance:
                break
    probe.count("pagerank_steps", steps)
    return j, x, steps


def warmup(state: State, probe) -> None:
    request(state, 0, probe)


def describe(state: State) -> dict:
    return {"n": state.n, "nnz": state.nnz, "value_bytes": state.dtype.itemsize,
            "route": state.route}


def release(state: State) -> None:
    state.program = None


def check(state: State, kept) -> dict:
    """score_err: max over the sample of max|x - x_ref| / max|x_ref|, the
    reference run for as many steps as the request took."""
    score_err = 0.0
    for _, (j, x, steps) in kept:
        v = teleport(state.n, state.sources[j], torch.float64)
        xr = reference_pagerank(state.rows, state.cols, state.n, v, state.damping, steps)
        score_err = worst(score_err, float((x.to(torch.float64) - xr).abs().max() / xr.abs().max()))
    return {"score_err": score_err}
