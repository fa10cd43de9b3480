"""Sparse storage formats: CSR/CSC, sparse vectors, COO triplets, DIA,
ELL and BSR."""

from .bsr import (
    BsrMat,
    bsr_from_csmat,
    bsr_from_dense,
    bsr_from_dense_device,
    bsr_random,
    bsr_spmm_plain,
)
from .csmat import (
    CSC,
    CSR,
    CsMat,
    csc,
    csmat,
    csmat_from_unsorted,
    csr,
    diag_csmat,
    diags,
    empty,
    eye,
    from_dense,
    from_scipy,
)
from .csvec import CsVec, csvec, csvec_from_dense, csvec_from_unsorted, empty_csvec
from .dia import DiaMat, dia_from_csmat, dia_spmm, dia_spmv, dia_to_csmat, n_diags_of
from .ell import EllMat, ell_from_csmat, ell_overhead, ell_spmm, ell_spmv, ell_to_csmat
from .triplet import TriMat, coo_to_csmat
from .util import INDEX_DTYPE, MAX_INDEX, compress_coo
