"""Binary persistence with validation on load, the counterpart of
``sprs_tpu/io/serialize.py``.

The same ``.npz`` container, keys and storage strings as the JAX
package, so that a file written by either package loads in the other.
The loader reads with ``allow_pickle=False`` and rebuilds through the
checked constructors: a corrupted or adversarial payload raises
:class:`StructureError`.
"""

from __future__ import annotations

from typing import Union

import numpy as np

from ..errors import StructureError
from ..formats.csmat import CsMat, csmat
from ..formats.csvec import CsVec, csvec
from ..formats.util import DEFAULT_DEVICE


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def save_npz(path: str, mat: Union[CsMat, CsVec]) -> None:
    if isinstance(mat, CsMat):
        np.savez(
            path,
            format="csmat",
            indptr=_host(mat.indptr),
            indices=_host(mat.indices),
            data=_host(mat.data),
            shape=np.asarray(mat.shape),
            storage=mat.storage,
            cap=mat.cap,
        )
    elif isinstance(mat, CsVec):
        np.savez(
            path,
            format="csvec",
            indices=_host(mat.indices),
            data=_host(mat.data),
            nnz=mat.nnz,
            dim=mat.dim,
            cap=mat.cap,
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
            data = z["data"]
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
                z["data"][:nnz],
                cap=cap,
                validate=True,
                device=device,
            )
        raise StructureError.size_mismatch(f"unknown format {fmt!r}")
