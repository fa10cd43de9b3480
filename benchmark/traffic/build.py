"""Requests that build an operator from raw triplets, as a code does on
every new graph snapshot or re-assembly: ``coo_to_csmat`` (sort and
duplicate sum) and then ``prepare_spmv`` (the routing rule's structure
counts and the chosen format's preparation).  The triplets' structure,
the configuration's symmetrized edge list with its duplicates, is made
once at set-up.  Every request, the warm-up's too, builds with weights
of its own, drawn from the seed and the request's number: uniform in
(0, 1], equal on an edge's two directions, in the configuration's type.
So no two builds agree, and a build handed back stale fails the check
on every sampled request.  Drawing them takes about a millisecond of the
request, outside its ``build`` span.

The answer is the built matrix and the route; the reference draws the
request's weights again and assembles the triplets in float64, working
the routing rule out itself.
"""

from __future__ import annotations

import dataclasses

import torch

import sprs_tpu_torch as st
from sprs_tpu_torch.ops import prod

from harness.program import DTYPES, route_of, worst
from reference.compress import compress, route as reference_route


@dataclasses.dataclass
class State:
    n: int
    nnz: int
    dtype: torch.dtype
    rows: torch.Tensor
    cols: torch.Tensor
    base: int  # request i's weights come from the seed base + i + 1
    draws: torch.Generator
    route: str
    device: torch.device


def setup(cell, device, probe, gen: torch.Generator) -> State:
    dtype = DTYPES[cell.config["dtype"]]
    e = cell.generator().edges(cell.config, device)
    base = int(torch.randint(0, 1 << 62, (1,), generator=gen, device=device))
    return State(e["n"], int(e["rows"].numel()), dtype, e["rows"], e["cols"], base,
                 torch.Generator(device=device), "", device)


def weights(state: State, i: int) -> torch.Tensor:
    """Request ``i``'s weights in float32, the same on every call."""
    state.draws.manual_seed(state.base + i + 1)
    w = 1.0 - torch.rand(state.nnz // 2, generator=state.draws, device=state.device,
                         dtype=torch.float32)
    return torch.cat([w, w])  # the two directions of each edge


def _build(state: State, w: torch.Tensor, probe):
    with probe.timed("compress"):
        mat = st.coo_to_csmat(state.rows, state.cols, w, (state.n, state.n), device=state.device)
    with probe.timed("route"):
        _, prepared = prod.prepare_spmv(mat)
    return mat, route_of(prepared)


def request(state: State, i: int, probe):
    w = weights(state, i).to(state.dtype)
    with probe.span("build"):
        mat, route = _build(state, w, probe)
        if state.device.type == "cuda":
            torch.cuda.synchronize(state.device)
    state.route = route
    return i, mat, route


def warmup(state: State, probe) -> None:
    request(state, -1, probe)


def describe(state: State) -> dict:
    return {"n": state.n, "nnz": state.nnz, "value_bytes": state.dtype.itemsize,
            "route": state.route}


def release(state: State) -> None:
    """Nothing of the program's is held between requests."""


def check(state: State, kept) -> dict:
    """structure_mismatch: live count, indptr, indices and padding slots
    that differ from the reference's (exact); data_err: max over the live
    entries of |data - ref| / |ref|; route_mismatch: 1 where the route
    differs from the rule's on the reference structure."""
    structure = route_bad = 0
    data_err = 0.0
    for _, (i, mat, route) in kept:
        indptr, indices, data = compress(state.rows, state.cols, weights(state, i), state.n, state.n)
        nnz = int(indptr[-1])
        got = int(mat.indptr[-1])
        structure += int(got != nnz)
        structure += int((mat.indptr.to(torch.int64) != indptr).sum())
        if got == nnz:
            structure += int((mat.indices[:nnz].to(torch.int64) != indices).sum())
            d = mat.data[:nnz].to(torch.float64)
            data_err = worst(data_err, float(((d - data).abs() / data.abs()).max()))
        else:
            data_err = float("inf")
        structure += int((mat.indices[got:] != 0).sum()) + int((mat.data[got:] != 0).sum())
        route_bad += int(route != reference_route(indptr, indices, state.n))
    return {"structure_mismatch": structure, "data_err": data_err, "route_mismatch": route_bad}
