"""What the traffic kinds share about the program's types and routes,
and how a compared number is taken."""

from __future__ import annotations

import math

import torch

DTYPES = {
    "float64": torch.float64,
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
}

# the nearest precision below each stated one: the control's
LOWER = {"float64": "float32", "float32": "bfloat16"}

ROUTES = {"DiaTiledMat": "dia", "EllMat": "ell", "CsMat": "csr"}


def route_of(prepared) -> str:
    """'dia', 'ell' or 'csr': the format ``prepare_spmv`` chose, by the
    type of the operand it prepared."""
    return ROUTES.get(type(prepared).__name__, type(prepared).__name__)


def worst(*values: float) -> float:
    """The largest of ``values``, where NaN counts as infinite: a number
    compared against a limit must never pass by being NaN."""
    return max(math.inf if math.isnan(v) else v for v in values)
