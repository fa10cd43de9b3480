"""The heat example's 5-point operator applied from the grid itself, by
shifted slices of an (nx, ny) view: y = u on the border, y = 4·u minus
the four neighbours inside (sprs ``examples/heat.rs``, ``grid_laplacian``:
the border rows are identity rows)."""

from __future__ import annotations

import torch


class Stencil5:
    def __init__(self, nx: int, ny: int):
        self.shape = (nx, ny)
        self.n = nx * ny

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        nx, ny = self.shape
        u = x.view(nx, ny)
        y = u.clone()
        if nx > 2 and ny > 2:
            y[1:-1, 1:-1] = (4.0 * u[1:-1, 1:-1] - u[:-2, 1:-1] - u[1:-1, :-2]
                             - u[1:-1, 2:] - u[2:, 1:-1])
        return y.reshape(-1)
