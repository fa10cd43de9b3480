"""sprs_tpu_torch — the PyTorch and CUDA port of ``sprs_tpu``.

A package of its own beside the JAX package: it imports ``torch`` and
numpy, never JAX, and nothing of ``sprs_tpu``.  It mirrors the JAX
package's module paths; the banded-solve path is ported so far
(formats, the structure-dispatched SpMV with its hand-written CUDA
kernel for the DIA format, BiCGSTAB, CG, Jacobi and Gauss–Seidel).
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
from .formats import CSC, CSR, INDEX_DTYPE, CsMat, csmat, from_dense
from .interop import from_arrays
from .ops import dense_matmul_sparse, prepare_spmm, prepare_spmv, spmm, spmv

__version__ = "0.1.0"
