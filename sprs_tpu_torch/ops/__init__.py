"""Sparse×dense products and their structure dispatch."""

from .cuda import DiaTiledMat, dia_spmv_kernel, dia_spmv_plain, dia_tile
from .prod import dense_matmul_sparse, prepare_spmm, prepare_spmv, spmm, spmv
