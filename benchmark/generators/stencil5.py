"""The heat example's operator (sprs ``examples/heat.rs``,
``grid_laplacian``): the 5-point Laplacian on an nx × ny grid, row
``i·ny + j``, with the border rows identity rows.  Built by the program's
own constructor, ``sprs_tpu_torch.utils.grid_laplacian``, on the card, as a
user of the library builds it; its time counts in ``setup_s``.  The
operator has no random part; the seed goes to the right-hand sides."""

from __future__ import annotations

from sprs_tpu_torch.utils import grid_laplacian

from harness.program import DTYPES


def operator(config: dict, device):
    """The CsMat of the operator, in the configuration's type."""
    return grid_laplacian((int(config["nx"]), int(config["ny"])), DTYPES[config["dtype"]],
                          device=device)
