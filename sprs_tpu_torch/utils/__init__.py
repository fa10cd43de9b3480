"""Utilities: fixtures, special matrices, random generation, timing and
roofline audit, pattern visualization."""

from . import fixtures, profile
from .profile import audit_spmv, chain_time, measure_peak_bandwidth, roofline_report
from .rand import rand_csr
from .special import dirichlet_laplacian, grid_laplacian, tri_mesh_graph_laplacian
from .visu import nnz_image, nnz_pattern, nnz_pattern_str

__all__ = [
    "fixtures",
    "profile",
    "audit_spmv",
    "chain_time",
    "measure_peak_bandwidth",
    "roofline_report",
    "rand_csr",
    "dirichlet_laplacian",
    "grid_laplacian",
    "tri_mesh_graph_laplacian",
    "nnz_image",
    "nnz_pattern",
    "nnz_pattern_str",
]
