"""Repeatability of the float sums by index on the card: each site run six
times on one input, the entries that differ from the first run counted,
once as summed by ``index_add_`` (CUDA atomics, no fixed order) and once
by the port's code (an accumulating ``index_put_``, one fixed order).

Sites: ``CsMat.sum(axis=0/1)`` and ``CsMat.norm(1 / inf)`` on the 1024²
mesh step's pattern with standard-normal values (float64 and float32: the
mesh step's own entries are integers, whose sums are exact in any order),
K5's backward dx (``ell_vjp``) on the 1024² mesh step with a normal
cotangent, and K3's backward dX (``bsr_vjp``) and ``bsr_spmm_plain`` on
the float32 K3 cell (n 4096, k 512, bs 128, density 0.125).  The
``index_add_`` forms are those the port used before it took
``index_put_``; they are kept here only as the comparison.

Run from the repository root on a machine with one GPU:
``python3 benches/torch_index_sum_repeats.py`` (``--device cpu`` runs
it on the CPU, where both forms add in index order).  Prints one JSON
line: {site: {"index_add_": [differing entries in runs 2-6], "port":
[...], "of": entries, "rel_gap": max |difference| of the two forms over
max |port's|}}, with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402
from sprs_tpu_torch.formats.bsr import bsr_random, bsr_spmm_plain  # noqa: E402
from sprs_tpu_torch.formats.csmat import eye  # noqa: E402
from sprs_tpu_torch.formats.ell import ell_from_csmat  # noqa: E402
from sprs_tpu_torch.ops.cuda.bsr_spmm import bsr_vjp  # noqa: E402
from sprs_tpu_torch.ops.cuda.ell_spmv import ell_vjp  # noqa: E402
from sprs_tpu_torch.utils import tri_mesh_graph_laplacian  # noqa: E402
from sprs_tpu_torch.utils.profile import bench_device, card  # noqa: E402

REPEATS = 5


def add_sum(m, axis):
    rows, cols, _ = m.coo_arrays()
    ids, n = (rows, m.rows) if axis == 1 else (cols, m.cols)
    return torch.zeros(n + 1, dtype=m.dtype, device=m.device).index_add_(0, ids.to(torch.int64), m.data)[:n]


def add_norm(m, ord):
    a = m.data.abs()
    outer = m.outer_ids().to(torch.int64)
    outer = torch.where(outer < m.outer_dims, outer, 0)
    inner = m.indices.to(torch.int64)
    rows, cols = (outer, inner) if m.is_csr else (inner, outer)
    ids, n = (cols, m.cols) if ord == 1 else (rows, m.rows)
    return torch.zeros(n, dtype=a.dtype, device=a.device).index_add_(0, ids, a).max()


def add_ell_dx(ell, x, g):
    gp = g.new_zeros(ell.rows_pad)
    gp[: ell.rows] = g
    contrib = ell.data * gp[:, None]
    return torch.zeros_like(x).index_add_(0, ell.indices.to(torch.int64).reshape(-1), contrib.reshape(-1))


def _blocks_of(v, n_blocks, bs):
    """The (n_blocks, bs, k) row blocks of ``v`` zero-padded to n_blocks·bs rows."""
    vp = v.new_zeros((n_blocks * bs, v.shape[1]))
    vp[: v.shape[0]] = v
    return vp.reshape(n_blocks, bs, v.shape[1])


def add_bsr_dx(bsr, x, g):
    gb = _blocks_of(g, bsr.n_block_rows, bsr.block_size)[bsr.brows.to(torch.int64)]
    contrib = torch.einsum("nji,njk->nik", bsr.blocks.float(), gb.float())
    dxb = contrib.new_zeros((bsr.n_block_cols, bsr.block_size, x.shape[1]))
    return dxb.index_add_(0, bsr.bcols.to(torch.int64), contrib).reshape(-1, x.shape[1])[: bsr.cols]


def add_bsr_plain(bsr, x):
    xb = _blocks_of(x, bsr.n_block_cols, bsr.block_size)[bsr.bcols.to(torch.int64)]
    prods = torch.einsum("nij,njk->nik", bsr.blocks.float(), xb.float())
    out = prods.new_zeros((bsr.n_block_rows, bsr.block_size, x.shape[1]))
    return out.index_add_(0, bsr.brows.to(torch.int64), prods).reshape(-1, x.shape[1])[: bsr.rows]


def differing(fn):
    """(entries of each of REPEATS further runs that differ in bits from
    the first run, the first run)."""
    first = fn()
    bits = {8: torch.int64, 4: torch.int32}[first.element_size()]
    out = []
    for _ in range(REPEATS):
        again = fn()
        if again.is_cuda:
            torch.cuda.synchronize()
        out.append(int((first.view(bits) != again.view(bits)).sum()))
    return out, first


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    device = bench_device(ap.parse_args(argv).device)
    # chip_smoke.py's mesh step I + τL
    n, tri, _ = cs.permuted_mesh(cs.MESH_SIDE)
    a = eye(n, dtype=torch.float64, device=device) + tri_mesh_graph_laplacian(n, tri, device=device) * cs.MESH_TAU
    rng = np.random.default_rng(140)
    vals = torch.from_numpy(rng.standard_normal(a.cap)).to(device)
    ar = dataclasses.replace(a, data=torch.where(a.live_mask(), vals, torch.zeros_like(vals)))
    ell = ell_from_csmat(a)
    x = torch.from_numpy(rng.standard_normal(n)).to(device)
    g = torch.from_numpy(rng.standard_normal(n)).to(device)
    bsr = bsr_random(62, (cs.BSR_N, cs.BSR_N), cs.BSR_BS, cs.BSR_DENSITIES[0], torch.float32, device=device)
    xk = torch.from_numpy(np.random.default_rng(63).standard_normal((cs.BSR_N, cs.BSR_K))).to(device, torch.float32)
    gk = torch.from_numpy(np.random.default_rng(64).standard_normal((cs.BSR_N, cs.BSR_K))).to(device, torch.float32)
    sites = {}
    for m, tag in ((ar, "f64"), (dataclasses.replace(ar, data=ar.data.float()), "f32")):
        for axis in (0, 1):
            sites[f"CsMat.sum(axis={axis}) {tag}"] = (lambda m=m, axis=axis: add_sum(m, axis),
                                                      lambda m=m, axis=axis: m.sum(axis))
        for ord, name in ((1, "1"), (np.inf, "inf")):
            sites[f"CsMat.norm({name}) {tag}"] = (lambda m=m, ord=ord: add_norm(m, ord),
                                                  lambda m=m, ord=ord: m.norm(ord))
    sites["ell_vjp dx f64"] = (lambda: add_ell_dx(ell, x, g), lambda: ell_vjp(ell, x, g)[1])
    sites["bsr_vjp dX f32"] = (lambda: add_bsr_dx(bsr, xk, gk), lambda: bsr_vjp(bsr, bsr.blocks, xk, gk)[1])
    sites["bsr_spmm_plain f32"] = (lambda: add_bsr_plain(bsr, xk), lambda: bsr_spmm_plain(bsr, xk))
    out = {"card": card() if device.type == "cuda" else None}
    for site, (by_add, by_port) in sites.items():
        added, y_add = differing(by_add)
        ported, y_port = differing(by_port)
        # the two forms compute the same sums, in other orders
        gap = float((y_add.double() - y_port.double()).abs().max() / y_port.double().abs().max())
        out[site] = {"index_add_": added, "port": ported, "of": y_port.numel(), "rel_gap": gap}
        print(f"# {site}: index_add_ {added}, port {ported} of {y_port.numel()}, forms {gap!r} apart",
              file=sys.stderr, flush=True)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
