"""GAP's ``kron`` graph (Beamer, Asanović, Patterson, arXiv:1508.03619):
the Graph500 Kronecker (R-MAT) generator as GAP's ``generator.h`` runs
it, made on the device from the seed.

Each of ``edge_factor · 2^scale`` directed edges takes ``scale`` steps;
at each step one uniform draw u picks a quadrant: u < A the top left,
A ≤ u < A + B the top right (destination bit), A + B ≤ u < A + B + C the
bottom left (source bit), otherwise both bits.  Vertex ids are then
scrambled by one random permutation, as GAP's ``PermuteIDs`` does.  Both
the draws and the permutation come from the configuration's
``graph_seed``, as GAP's generator seeds both from its fixed
``kRandSeed``: every run holds the same graph, and the run's seed draws
only what the requests carry.  (The CSR route's product time follows the
labelling: two scrambles of one graph differed by 26 % a step.)  The
builder's part for an undirected graph follows: every edge is stored
both ways and self-loops are dropped.  Duplicates are kept here; each
traffic kind says what it does with them.
"""

from __future__ import annotations

import torch


def edges(config: dict, device) -> dict:
    """{'n', 'rows', 'cols'}: the symmetrized edge list without
    self-loops, duplicates kept, int32 on ``device``."""
    scale, factor = int(config["scale"]), int(config["edge_factor"])
    a, b, c = (float(config[k]) for k in ("a", "b", "c"))
    n, m = 1 << scale, factor << scale
    draws = torch.Generator(device=device)
    draws.manual_seed(int(config["graph_seed"]))
    src = torch.zeros(m, dtype=torch.int64, device=device)
    dst = torch.zeros(m, dtype=torch.int64, device=device)
    for _ in range(scale):
        u = torch.rand(m, generator=draws, device=device, dtype=torch.float32)
        right = u >= a + b
        src = src * 2 + right.to(torch.int64)
        dst = dst * 2 + (torch.where(right, u >= a + b + c, u >= a)).to(torch.int64)
    del u, right
    perm = torch.randperm(n, generator=draws, device=device)
    src, dst = perm[src], perm[dst]
    keep = src != dst
    rows = torch.cat([src[keep], dst[keep]]).to(torch.int32)
    cols = torch.cat([dst[keep], src[keep]]).to(torch.int32)
    return {"n": n, "rows": rows, "cols": cols}


def dedup(rows: torch.Tensor, cols: torch.Tensor, n: int):
    """The unique (row, col) pairs in row-major order, as GAP's builder
    squishes its adjacency lists: int32 rows and cols."""
    key = torch.unique(rows.to(torch.int64) * n + cols.to(torch.int64))
    return (key // n).to(torch.int32), (key % n).to(torch.int32)
