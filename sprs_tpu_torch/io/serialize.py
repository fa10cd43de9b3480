"""Binary persistence with validation on load, the counterpart of
``sprs_tpu/io/serialize.py``.

The same ``.npz`` container, keys and storage strings as the JAX
package, so that a file written by either package loads in the other.
The loader reads with ``allow_pickle=False`` and rebuilds through the
checked constructors: a corrupted or adversarial payload raises
:class:`StructureError`.

bfloat16 data: the JAX package writes ml_dtypes' bfloat16 values, which
``.npz`` keeps only as 2-byte voids (``|V2``) that its own loader then
refuses.  This module writes them as float32 (exact) with an extra
``dtype`` key, which the JAX loader ignores (it loads a float32 matrix
of the same values) and this loader reads back as bfloat16; it also
reads the JAX package's ``|V2`` data as the bfloat16 bits it holds.
"""

from __future__ import annotations

from typing import Union

import numpy as np
import torch

from ..errors import StructureError
from ..formats.csmat import CsMat, csmat
from ..formats.csvec import CsVec, csvec
from ..formats.util import DEFAULT_DEVICE, host_array


def _data_fields(data: torch.Tensor) -> dict:
    if data.dtype == torch.bfloat16:
        return {"data": host_array(data), "dtype": "bfloat16"}
    return {"data": host_array(data)}


def _data(z):
    """The stored values: a bfloat16 CPU tensor when the file says so
    (this package's files) or holds 2-byte voids (the JAX package's),
    else the numpy array as stored."""
    data = z["data"]
    if data.dtype.kind == "V" and data.dtype.itemsize == 2:
        return torch.from_numpy(data.view(np.int16).copy()).view(torch.bfloat16)
    if "dtype" in z.files and str(z["dtype"]) == "bfloat16":
        return torch.from_numpy(data).to(torch.bfloat16)
    return data


def save_npz(path: str, mat: Union[CsMat, CsVec]) -> None:
    if isinstance(mat, CsMat):
        np.savez(
            path,
            format="csmat",
            indptr=host_array(mat.indptr),
            indices=host_array(mat.indices),
            shape=np.asarray(mat.shape),
            storage=mat.storage,
            cap=mat.cap,
            **_data_fields(mat.data),
        )
    elif isinstance(mat, CsVec):
        np.savez(
            path,
            format="csvec",
            indices=host_array(mat.indices),
            nnz=mat.nnz,
            dim=mat.dim,
            cap=mat.cap,
            **_data_fields(mat.data),
        )
    else:
        raise TypeError(f"cannot serialize {type(mat)}")


def load_npz(path: str, *, device=DEFAULT_DEVICE) -> Union[CsMat, CsVec]:
    """Load onto ``device`` and re-validate (invalid payloads raise
    StructureError)."""
    with np.load(path, allow_pickle=False) as z:
        fmt = str(z["format"])
        if fmt == "csmat":
            shape = tuple(int(s) for s in z["shape"])
            cap = int(z["cap"])
            indptr = z["indptr"]
            indices = z["indices"]
            data = _data(z)
            if indices.shape[0] != cap or data.shape[0] != cap:
                raise StructureError.size_mismatch(
                    "stored capacity does not match arrays"
                )
            nnz = int(indptr[-1]) if indptr.size else 0
            return csmat(
                shape,
                indptr,
                indices[:nnz],
                data[:nnz],
                storage=str(z["storage"]),
                cap=cap,
                validate=True,
                device=device,
            )
        if fmt == "csvec":
            nnz = int(z["nnz"])
            cap = int(z["cap"])
            if nnz > cap:
                raise StructureError.size_mismatch("nnz exceeds capacity")
            return csvec(
                int(z["dim"]),
                z["indices"][:nnz],
                _data(z)[:nnz],
                cap=cap,
                validate=True,
                device=device,
            )
        raise StructureError.size_mismatch(f"unknown format {fmt!r}")
