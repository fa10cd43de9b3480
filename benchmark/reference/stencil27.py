"""HPCG's 27-point operator applied from the grid itself: y = 26·u minus
the sum of u over the in-grid neighbours, where a box sum of the
zero-padded grid gives the neighbours.  Under a numbering ``perm``
(new unknown i is grid point perm[i]), y = (S z)[perm] with z the
vector put back in grid order."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


class Stencil27:
    def __init__(self, nx: int, ny: int, nz: int, perm: Optional[torch.Tensor] = None):
        self.shape = (nz, ny, nx)
        self.n = nx * ny * nz
        self.perm = perm
        if perm is not None:
            self.inv = torch.empty_like(perm)
            self.inv[perm] = torch.arange(perm.numel(), dtype=perm.dtype, device=perm.device)

    def _grid(self, u: torch.Tensor) -> torch.Tensor:
        nz, ny, nx = self.shape
        up = F.pad(u.view(1, nz, ny, nx), (1, 1, 1, 1, 1, 1))[0]
        s = up[:, :, :-2] + up[:, :, 1:-1] + up[:, :, 2:]
        s = s[:, :-2] + s[:, 1:-1] + s[:, 2:]
        s = s[:-2] + s[1:-1] + s[2:]
        return (26.0 * u.view(nz, ny, nx) - (s - u.view(nz, ny, nx))).reshape(-1)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        if self.perm is None:
            return self._grid(x)
        return self._grid(x[self.inv])[self.perm]
