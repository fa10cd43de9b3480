"""Plain personalized PageRank, GAP's update: scores = (1 - d)·v +
d·P·scores with P = A·D⁻¹, started from v, for a given number of
iterations; the product by a gather and ``index_add_`` in float64."""

from __future__ import annotations

import torch


def pagerank(rows, cols, n: int, v: torch.Tensor, damping: float, iters: int,
             dtype=torch.float64) -> torch.Tensor:
    rows, cols = rows.to(torch.int64), cols.to(torch.int64)
    deg = torch.bincount(rows, minlength=n).to(dtype)
    vals = 1.0 / deg[cols]
    v = v.to(dtype)
    x = v.clone()
    for _ in range(iters):
        y = torch.zeros(n, dtype=dtype, device=v.device).index_add_(0, rows, vals * x[cols])
        x = (1.0 - damping) * v + damping * y
    return x
