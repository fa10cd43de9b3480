"""Kernels written by hand for Hopper (CUDA C++ in ``csrc/``), each beside
its plain torch version.  Sources are compiled on first use, never at
import time."""

from .bsr_spmm import (
    bsr_group,
    bsr_spmm_grouped_kernel,
    bsr_spmm_kernel,
    bsr_spmv_kernel,
)
from .dia_spmm import dia_spmm_kernel, dia_spmm_plain
from .dia_spmv import DiaTiledMat, dia_spmv_kernel, dia_spmv_plain, dia_tile
from .ell_spmv import ell_spmv_kernel, ell_spmv_plain
from .sort import sort_rows_kernel, sort_rows_plain
