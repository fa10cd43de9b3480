"""Matrix Market IO, the counterpart of ``sprs_tpu/io/matrix_market.py``.

Coordinate files of the four data kinds (real, integer, complex,
pattern) and four symmetry modes (general, symmetric, skew-symmetric,
hermitian), expanded to the full triplet set on read.  Reading gives a
host :class:`TriMat`; ``read_matrix_market_csr`` compresses it on a
device.  A pattern file loads with unit values, and ``kind="pattern"``
writes the structure only.

The reader is the JAX package's loop over lines, so that every
malformed file raises the same :class:`MatrixMarketError` (or
``ValueError`` from the number parse) with the same message.  The
writer's text equals the JAX package's byte for byte: indices 1-based,
real values as ``repr(float(v))`` (a float32 value prints as the repr
of its float64 widening).
"""

from __future__ import annotations

import io as _io
from dataclasses import dataclass
from typing import Optional, TextIO, Union

import numpy as np

from ..errors import StructureError
from ..formats.csmat import CsMat
from ..formats.triplet import TriMat
from ..formats.util import DEFAULT_DEVICE, host_array

SYMMETRY_MODES = ("general", "symmetric", "skew-symmetric", "hermitian")
DATA_KINDS = ("real", "integer", "complex", "pattern")


@dataclass
class MmHeader:
    kind: str  # real | integer | complex | pattern
    symmetry: str  # general | symmetric | skew-symmetric | hermitian
    rows: int
    cols: int
    entries: int


class MatrixMarketError(StructureError):
    def __init__(self, msg: str):
        super().__init__("matrix_market", msg)


def _parse_header_line(line: str) -> tuple:
    parts = line.strip().split()
    if len(parts) != 5 or parts[0] != "%%MatrixMarket":
        raise MatrixMarketError(f"bad banner: {line.strip()!r}")
    _, obj, fmt, kind, symmetry = (p.lower() for p in parts)
    if obj != "matrix":
        raise MatrixMarketError(f"unsupported object {obj!r}")
    if fmt != "coordinate":
        raise MatrixMarketError(f"only coordinate format supported, got {fmt!r}")
    if kind not in DATA_KINDS:
        raise MatrixMarketError(f"unknown data kind {kind!r}")
    if symmetry not in SYMMETRY_MODES:
        raise MatrixMarketError(f"unknown symmetry {symmetry!r}")
    return kind, symmetry


def _dtype_for(kind: str):
    return {
        "real": np.float64,
        "integer": np.int64,
        "complex": np.complex128,
        "pattern": np.float64,
    }[kind]


def _read_header(source: TextIO) -> MmHeader:
    kind, symmetry = _parse_header_line(source.readline())
    size_line = None
    while True:  # skip comments / blank lines to the size line
        line = source.readline()
        if not line:
            break
        s = line.strip()
        if s and not s.startswith("%"):
            size_line = s
            break
    if size_line is None:
        raise MatrixMarketError("missing size line")
    parts = size_line.split()
    if len(parts) != 3:
        raise MatrixMarketError(f"bad size line: {size_line!r}")
    rows, cols, entries = (int(p) for p in parts)
    if symmetry != "general" and rows != cols:
        raise MatrixMarketError("symmetric matrix must be square")
    return MmHeader(kind, symmetry, rows, cols, entries)


def _read_lines(h: MmHeader, lines):
    """The JAX package's line loop: (rows, cols, values) arrays, the
    mirrored entry of a symmetric mode right after its stored one."""
    dtype = _dtype_for(h.kind)
    want_vals = h.kind != "pattern"
    ri, ci, vs = [], [], []
    count = 0
    for line in lines:
        s = line.strip()
        if not s or s.startswith("%"):
            continue
        toks = s.split()
        if h.kind == "complex":
            if len(toks) != 4:
                raise MatrixMarketError(f"complex entry needs 4 fields: {s!r}")
            val = complex(float(toks[2]), float(toks[3]))
        elif want_vals:
            if len(toks) != 3:
                raise MatrixMarketError(f"entry needs 3 fields: {s!r}")
            val = dtype(toks[2]) if h.kind == "integer" else float(toks[2])
        else:
            if len(toks) != 2:
                raise MatrixMarketError(f"pattern entry needs 2 fields: {s!r}")
            val = 1.0
        r, c = int(toks[0]) - 1, int(toks[1]) - 1  # 1-based in the format
        if not (0 <= r < h.rows and 0 <= c < h.cols):
            raise MatrixMarketError(f"index out of range: {s!r}")
        ri.append(r)
        ci.append(c)
        vs.append(val)
        if h.symmetry != "general" and r != c:
            ri.append(c)
            ci.append(r)
            if h.symmetry == "symmetric":
                vs.append(val)
            elif h.symmetry == "skew-symmetric":
                vs.append(-val)
            else:  # hermitian
                vs.append(np.conj(val))
        if h.symmetry == "skew-symmetric" and r == c:
            raise MatrixMarketError("skew-symmetric file stores a diagonal entry")
        count += 1
    if count != h.entries:
        raise MatrixMarketError(f"expected {h.entries} entries, found {count}")
    return np.asarray(ri), np.asarray(ci), np.asarray(vs, dtype=dtype)


def read_matrix_market(source: Union[str, TextIO]) -> TriMat:
    """Read a coordinate Matrix Market file into a host TriMat.

    Symmetric, skew-symmetric and Hermitian entries are expanded to the
    full pattern on read; diagonal entries are not duplicated, and a skew
    diagonal is rejected.
    """
    if isinstance(source, str):
        with open(source, "r") as f:
            return read_matrix_market(f)
    h = _read_header(source)
    ri, ci, vs = _read_lines(h, source)
    if ri.size:
        return TriMat.from_triplets((h.rows, h.cols), ri, ci, vs)
    return TriMat((h.rows, h.cols), dtype=_dtype_for(h.kind))


def read_matrix_market_csr(source, *, device=DEFAULT_DEVICE) -> CsMat:
    """Read a file and compress it into a CSR matrix on ``device``."""
    return read_matrix_market(source).to_csr(device=device)


def _infer_kind(dtype) -> str:
    if np.issubdtype(dtype, np.complexfloating):
        return "complex"
    if np.issubdtype(dtype, np.integer):
        return "integer"
    return "real"


def _entry_lines(rows, cols, vals, kind: str) -> str:
    r1 = (rows.astype(np.int64) + 1).tolist()
    c1 = (cols.astype(np.int64) + 1).tolist()
    if kind == "pattern":
        return "".join(f"{r} {c}\n" for r, c in zip(r1, c1))
    v = vals.tolist()
    if kind == "complex":
        return "".join(f"{r} {c} {float(x.real)!r} {float(x.imag)!r}\n" for r, c, x in zip(r1, c1, v))
    if kind == "integer":
        return "".join(f"{r} {c} {int(x)}\n" for r, c, x in zip(r1, c1, v))
    return "".join(f"{r} {c} {float(x)!r}\n" for r, c, x in zip(r1, c1, v))


def write_matrix_market(
    dest: Union[str, TextIO],
    mat: Union[CsMat, TriMat],
    *,
    kind: Optional[str] = None,
    symmetry: str = "general",
) -> None:
    """Write in coordinate format.

    ``symmetry="symmetric"`` (and ``"hermitian"``) stores only the lower
    triangle, ``"skew-symmetric"`` the strict lower triangle; callers
    are responsible for the matrix actually having that symmetry.
    """
    if isinstance(dest, str):
        with open(dest, "w") as f:
            write_matrix_market(f, mat, kind=kind, symmetry=symmetry)
        return
    if symmetry not in SYMMETRY_MODES:
        raise MatrixMarketError(f"unknown symmetry {symmetry!r}")

    if isinstance(mat, TriMat):
        rows = mat.row_inds()
        cols = mat.col_inds()
        vals = mat.data()
        shape = mat.shape
    else:
        csr = mat.to_csr()
        nnz = csr.nnz
        rows = csr.outer_ids()[:nnz].cpu().numpy()
        cols = csr.indices[:nnz].cpu().numpy()
        vals = host_array(csr.data[:nnz])  # bfloat16 as float32: the same text
        shape = csr.shape

    if symmetry != "general":
        if shape[0] != shape[1]:
            raise MatrixMarketError("symmetric write requires square matrix")
        keep = rows >= cols if symmetry != "skew-symmetric" else rows > cols
        rows, cols, vals = rows[keep], cols[keep], vals[keep]

    k = kind or _infer_kind(vals.dtype)
    dest.write(f"%%MatrixMarket matrix coordinate {k} {symmetry}\n")
    dest.write("% written by sprs_tpu\n")
    dest.write(f"{shape[0]} {shape[1]} {len(rows)}\n")
    dest.write(_entry_lines(rows, cols, vals, k))


def write_matrix_market_sym(dest, mat, **kw) -> None:
    write_matrix_market(dest, mat, symmetry="symmetric", **kw)


def dumps(mat, **kw) -> str:
    buf = _io.StringIO()
    write_matrix_market(buf, mat, **kw)
    return buf.getvalue()


def loads(text: str) -> TriMat:
    return read_matrix_market(_io.StringIO(text))
