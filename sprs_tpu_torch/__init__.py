"""sprs_tpu_torch — the PyTorch and CUDA port of ``sprs_tpu``.

A package of its own beside the JAX package: it imports ``torch`` and
numpy, never JAX, and nothing of ``sprs_tpu``.  It mirrors the JAX
package's module paths.  Ported so far: the banded-solve path (formats,
the structure-dispatched SpMV with its hand-written CUDA kernel for the
DIA format, BiCGSTAB, CG, Jacobi and Gauss–Seidel), the multi-RHS
path (the DIA SpMM and BSR SpMM kernels, ``@`` on CsMat and BsrMat,
LOBPCG, svds and expm_multiply) and the unstructured path (triplet
assembly, the mesh Laplacian, sparse ``+ - *``, and the ELL SpMV kernel
under CG; the row-sort kernel beside it) and the sparse-ops slice (the
rest of ``CsMat``, ``CsVec``, stacking, Kronecker products,
permutations, symmetry, SpGEMM with its dense and block-sparse routes,
GMRES, LSQR and the sparse-iterate BiCGSTAB).
Public constructors place tensors on ``"cuda"`` unless the caller
passes ``device=``.

>>> import numpy as np
>>> import torch
>>> import sprs_tpu_torch as st
>>> a = st.from_dense(np.array([[1.0, 0.0, 2.0],
...                             [0.0, 0.0, 3.0],
...                             [4.0, 5.0, 6.0]]), device="cpu")
>>> a.nnz
6
>>> st.spmv(a, torch.ones(3, dtype=torch.float64)).tolist()
[3.0, 3.0, 15.0]
"""

from . import formats, linalg, ops, utils
from .errors import (
    CapacityError,
    LinalgError,
    NonSquareMatrixError,
    ShapeError,
    SprsError,
    StructureError,
)
from .formats import (
    CSC,
    CSR,
    INDEX_DTYPE,
    BsrMat,
    CsMat,
    CsVec,
    TriMat,
    coo_to_csmat,
    csc,
    csmat,
    csmat_from_unsorted,
    csr,
    csvec,
    csvec_from_dense,
    csvec_from_unsorted,
    diag_csmat,
    diags,
    empty,
    empty_csvec,
    eye,
    from_dense,
    from_scipy,
)
from .interop import from_arrays
from .ops import (
    Permutation,
    add,
    assign_to_dense,
    block_diag,
    bmat,
    dense_matmul_sparse,
    elementwise_mul,
    hstack,
    is_symmetric,
    kronecker_product,
    matmul,
    permute_cols,
    permute_rows,
    prepare_spmm,
    prepare_spmv,
    rmatmul,
    spgemm,
    spgemm_caps,
    spgemm_dense,
    spgemm_dense_bsr,
    spmm,
    spmv,
    sub,
    transform_mat_papt,
    transform_mat_paq,
    vstack,
)

__version__ = "0.1.0"
