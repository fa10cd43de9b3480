"""Sparse storage formats: CSR/CSC, COO triplets, DIA, ELL and BSR."""

from .bsr import BsrMat, bsr_from_csmat, bsr_from_dense, bsr_random, bsr_spmm_plain
from .csmat import CSC, CSR, CsMat, csmat, csmat_from_unsorted, eye, from_dense
from .dia import DiaMat, dia_from_csmat, dia_spmm, dia_spmv, dia_to_csmat, n_diags_of
from .ell import EllMat, ell_from_csmat, ell_overhead, ell_spmm, ell_spmv
from .triplet import TriMat, coo_to_csmat
from .util import INDEX_DTYPE, MAX_INDEX
