"""Entry point: the flagship forward step of the port.

The counterpart of the JAX package's ``__graft_entry__.entry``: SpMV on
the 5-point grid Laplacian of a 128×128 grid in float32, here through
the prepared DIA operand and the CUDA kernel K1 on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from .formats.util import DEFAULT_DEVICE
from .ops.cuda.dia_spmv import dia_tile
from .utils.special import grid_laplacian


def _spmv(mat, x):
    return mat.spmv(x)


def entry(device=DEFAULT_DEVICE):
    """``(fn, example_args)`` with ``fn(*example_args)`` the SpMV."""
    mat = dia_tile(grid_laplacian((128, 128), torch.float32, device=device).to_dia())
    x = torch.from_numpy(np.linspace(0.0, 1.0, mat.cols).astype(np.float32))
    return _spmv, (mat, x.to(device))
