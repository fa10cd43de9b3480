"""Kernels written by hand for Hopper (CUDA C++ in ``csrc/``), each beside
its plain torch version.  Sources are compiled on first use, never at
import time."""

from .dia_spmv import DiaTiledMat, dia_spmv_kernel, dia_spmv_plain, dia_tile
