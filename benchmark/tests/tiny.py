"""Cells cut to a size that a CPU test holds: the same files, the same
kinds and references, smaller grids and graphs, and 5 CG iterations so
that a set's residual stays far above round-off."""

from harness.spec import load_cell

TINY = {"hpcg256": {"nx": 6, "ny": 5, "nz": 7}, "kron23": {"scale": 9}}


def tiny_cell(name: str, **config):
    cell = load_cell(name)
    cell.config = dict(cell.config, **TINY[cell.config_name], **config)
    if cell.traffic["kind"] == "cg_sets":
        cell.traffic = dict(cell.traffic, iterations=5)
    return cell
