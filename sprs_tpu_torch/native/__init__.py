"""The port's native host library: build, load and ctypes bindings.

``csrc/sprs_host.cpp`` holds the sequential graph algorithms of the host
symbolic layer (elimination trees, LDLᵀ symbolic analysis, the RCM, AMD
and nested-dissection orderings, level schedules, supernode
amalgamation) and the host numerics of LU, ILU(0), IC(0) and a
Gauss–Seidel sweep.  It is compiled on first use with the system g++
into ``sprs_tpu_torch/_build/`` and bound with ctypes.  Every entry point
has a numpy fallback in the Python layer, so :func:`available` gates a
fast path, never a capability: each typed wrapper returns None when the
library is not there.

The build is safe against other processes doing the same at once (the
test runner's workers import and use this module together): it runs
under an exclusive ``fcntl.flock`` on a lock file in the build
directory, compiles to a temporary name there and renames it onto the
final name with ``os.replace``, so no process ever loads a half-written
library.  A library older than its source is rebuilt.  Nothing here runs
at import time.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

import numpy as np

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "sprs_host.cpp"
BUILD_DIR = _PKG / "_build"
LIB_PATH = BUILD_DIR / "libsprs_host.so"
_LOCK_PATH = BUILD_DIR / "sprs_host.lock"

# -ffp-contract=off: no FMA contraction, so the numeric entry points (lu,
# ilu0, ic0) stay bit-identical to their numpy fallbacks.
GXX_FLAGS = ("-O3", "-march=native", "-ffp-contract=off", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False

_I32P = np.ctypeslib.ndpointer(dtype=np.int32, flags="C_CONTIGUOUS")
_I64P = np.ctypeslib.ndpointer(dtype=np.int64, flags="C_CONTIGUOUS")
_F64P = np.ctypeslib.ndpointer(dtype=np.float64, flags="C_CONTIGUOUS")
_I64 = ctypes.c_int64
_F64 = ctypes.c_double

# entry point -> (argtypes, restype)
_SIGNATURES = {
    "sprs_etree": ([_I32P, _I32P, _I64, _I32P], None),
    "sprs_ldl_symbolic": ([_I32P, _I32P, _I64, _I32P, _I32P, _I32P], _I64),
    "sprs_ldl_pattern": ([_I32P, _I32P, _I64, _I32P, _I64P, _I64, _I32P, _I64P, _I32P], None),
    "sprs_ldl_pattern_flat": ([_I32P, _I32P, _I64, _I32P, _I64P, _I64P, _I32P, _I64P, _I32P], None),
    "sprs_etree_postorder": ([_I32P, _I64, _I32P], None),
    "sprs_super_rmap": ([_I64P, _I64P, _I64, _I64P, _I64P, _I64P, _I64P, _I64, _I32P], None),
    "sprs_amalgamate_union": (
        [_I64P, _I64P, _I64, _I64P, _I64, _I64, _I64, _F64, _I64P, _I64P, _I64P], _I64),
    "sprs_rcm": ([_I32P, _I32P, _I64, _I32P, _I64P, ctypes.c_int32], _I64),
    "sprs_tri_levels": ([_I32P, _I32P, _I64, ctypes.c_int32, _I64P], _I64),
    "sprs_gauss_seidel": (
        [_I32P, _I32P, _F64P, _F64P, _F64P, _I64, _F64, _I64, ctypes.POINTER(_F64)], _I64),
    "sprs_min_degree": ([_I32P, _I32P, _I64, _I32P], None),
    "sprs_amd": ([_I32P, _I32P, _I64, _I32P], None),
    "sprs_nd_order": ([_I32P, _I32P, _I64, _I64, _F64, _I32P], _I64),
    "sprs_lu": (
        [_I32P, _I32P, _F64P, _I64, _F64, _I64, _I64P, _I32P, _F64P, _I64P, _I32P, _F64P,
         _I32P, ctypes.POINTER(_I64)], _I64),
    "sprs_ilu0": ([_I32P, _I32P, _F64P, _I64, ctypes.POINTER(_I64)], ctypes.c_int32),
    "sprs_ic0": ([_I32P, _I32P, _F64P, _I64, ctypes.POINTER(_I64)], ctypes.c_int32),
    "sprs_spgemm_count": ([_I32P, _I32P, _I64, _I32P, _I32P, _I64, _I32P], _I64),
    "sprs_spgemm": ([_I32P, _I32P, _F64P, _I64, _I32P, _I32P, _F64P, _I64, _I32P, _I32P, _F64P],
                    None),
}


def _stale() -> bool:
    return not LIB_PATH.exists() or LIB_PATH.stat().st_mtime < SOURCE.stat().st_mtime


def build() -> float:
    """Compile the library if it is missing or older than its source, and
    return the seconds the compiler took (0.0 when it was up to date).
    Raises RuntimeError with g++'s output when the build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(_LOCK_PATH, "a") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if not _stale():
            return 0.0
        tmp = BUILD_DIR / f"libsprs_host.{os.getpid()}.tmp"
        t0 = time.perf_counter()
        try:
            proc = subprocess.run(
                ["g++", *GXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                capture_output=True,
                text=True,
                timeout=240,
            )
            if proc.returncode != 0:
                raise RuntimeError(f"g++ failed for {SOURCE.name}:\n{proc.stdout}{proc.stderr}")
            os.replace(tmp, LIB_PATH)
        finally:
            if tmp.exists():
                tmp.unlink()
        return time.perf_counter() - t0


def load() -> ctypes.CDLL:
    """Build (if needed), load and bind the library; raises on failure."""
    build()
    lib = ctypes.CDLL(str(LIB_PATH))
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def get_lib() -> Optional[ctypes.CDLL]:
    """The bound library, or None when it cannot be built or loaded (the
    callers then take their numpy fallbacks).  A failure is remembered
    for the life of the process."""
    global _lib, _build_failed
    if _lib is not None or _build_failed:
        return _lib
    with _lock:
        if _lib is None and not _build_failed:
            try:
                _lib = load()
            except (OSError, RuntimeError, subprocess.SubprocessError):
                _build_failed = True
    return _lib


def available() -> bool:
    return get_lib() is not None


# ---------------------------------------------------------------------------
# typed wrappers (numpy in, numpy out; None without the library)
# ---------------------------------------------------------------------------


def _i32(a) -> np.ndarray:
    return np.ascontiguousarray(a, np.int32)


def _i64(a) -> np.ndarray:
    return np.ascontiguousarray(a, np.int64)


def etree(indptr, indices, n) -> Optional[np.ndarray]:
    lib = get_lib()
    if lib is None:
        return None
    parent = np.empty(n, dtype=np.int32)
    lib.sprs_etree(_i32(indptr), _i32(indices), n, parent)
    return parent


def ldl_symbolic(row_ptr, row_cols, n):
    """(parent, col_count, row_count, lnz below the diagonal)."""
    lib = get_lib()
    if lib is None:
        return None
    parent = np.empty(n, dtype=np.int32)
    col_count = np.empty(n, dtype=np.int32)
    row_count = np.empty(n, dtype=np.int32)
    total = lib.sprs_ldl_symbolic(_i32(row_ptr), _i32(row_cols), n, parent, col_count, row_count)
    return parent, col_count, row_count, int(total)


def ldl_pattern(row_ptr, row_cols, n, parent, l_indptr, wl, lnz):
    """The padded (n, wl) row patterns and insert slots, and L's indices."""
    lib = get_lib()
    if lib is None:
        return None
    row_pattern = np.empty((n, wl), dtype=np.int32)
    insert_pos = np.empty((n, wl), dtype=np.int64)
    l_indices = np.empty(lnz, dtype=np.int32)
    lib.sprs_ldl_pattern(_i32(row_ptr), _i32(row_cols), n, _i32(parent), _i64(l_indptr), wl,
                         row_pattern, insert_pos, l_indices)
    return row_pattern, insert_pos, l_indices


def ldl_pattern_flat(row_ptr, row_cols, n, parent, l_indptr, rp_indptr, lnz):
    """Compact O(lnz) pattern: per-row update lists at ``rp_indptr[k]``."""
    lib = get_lib()
    if lib is None:
        return None
    total = int(rp_indptr[-1])
    rp_cols = np.empty(max(total, 1), dtype=np.int32)
    rp_slots = np.empty(max(total, 1), dtype=np.int64)
    l_indices = np.empty(max(lnz, 1), dtype=np.int32)
    lib.sprs_ldl_pattern_flat(_i32(row_ptr), _i32(row_cols), n, _i32(parent), _i64(l_indptr),
                              _i64(rp_indptr), rp_cols, rp_slots, l_indices)
    return rp_cols[:total], rp_slots[:total], l_indices[:lnz]


def etree_postorder(parent, n):
    """Postorder permutation (new -> old) of an elimination tree."""
    lib = get_lib()
    if lib is None:
        return None
    post = np.empty(max(n, 1), dtype=np.int32)
    lib.sprs_etree_postorder(_i32(parent), n, post)
    return post[:n]


def amalgamate_union_native(l_indptr, l_indices, n, ptr0, max_width, max_zeros, rel_zeros):
    """(ptr, below_ptr, below_flat) of the greedy union merger."""
    lib = get_lib()
    if lib is None:
        return None
    s0 = ptr0.shape[0] - 1
    lp = _i64(l_indptr)
    # the strips' first-column below counts bound every union (merging
    # only shrinks or keeps row sets)
    c0s = ptr0[:-1]
    cap = int(np.sum(lp[c0s + 1] - lp[c0s] - 1)) if s0 else 0
    out_ptr = np.empty(s0 + 1, dtype=np.int64)
    out_bptr = np.empty(s0 + 1, dtype=np.int64)
    out_flat = np.empty(max(cap, 1), dtype=np.int64)
    s = int(lib.sprs_amalgamate_union(lp, _i64(l_indices), n, _i64(ptr0), s0, max_width,
                                      max_zeros, float(rel_zeros), out_ptr, out_bptr, out_flat))
    return out_ptr[: s + 1].copy(), out_bptr[: s + 1].copy(), out_flat[: int(out_bptr[s])].copy()


def super_rmap(pair_d, pair_t, c0, w, below_ptr, below_flat, mr):
    """(npairs, mr) supernodal update row maps by two-pointer merges."""
    lib = get_lib()
    if lib is None:
        return None
    npairs = pair_d.shape[0]
    rmap = np.empty((max(npairs, 1), mr), dtype=np.int32)
    lib.sprs_super_rmap(_i64(pair_d), _i64(pair_t), npairs, _i64(c0), _i64(w), _i64(below_ptr),
                        _i64(below_flat), mr, rmap)
    return rmap[:npairs]


def rcm(indptr, indices, n, reversed_order=True):
    """(perm, connected_parts) of Cuthill–McKee from pseudo-peripheral
    starts."""
    lib = get_lib()
    if lib is None:
        return None
    perm = np.empty(n, dtype=np.int32)
    parts = np.empty(n + 1, dtype=np.int64)
    ncomp = lib.sprs_rcm(_i32(indptr), _i32(indices), n, perm, parts, 1 if reversed_order else 0)
    return perm, parts[: ncomp + 1].tolist()


def tri_levels(indptr, indices, n, lower=True):
    """(level per row, level count) of a triangle's dependency DAG."""
    lib = get_lib()
    if lib is None:
        return None
    level = np.zeros(n, dtype=np.int64)
    n_levels = lib.sprs_tri_levels(_i32(indptr), _i32(indices), n, 1 if lower else 0, level)
    return level, int(n_levels)


def gauss_seidel(indptr, indices, data, b, x, tol, max_iter):
    """(x, sweeps, residual norm) of Gauss–Seidel sweeps from ``x``."""
    lib = get_lib()
    if lib is None:
        return None
    x = np.array(x, dtype=np.float64)
    res = _F64(0.0)
    it = lib.sprs_gauss_seidel(_i32(indptr), _i32(indices), np.ascontiguousarray(data, np.float64),
                               np.ascontiguousarray(b, np.float64), x, x.shape[0], tol, max_iter,
                               ctypes.byref(res))
    return x, int(it), float(res.value)


def min_degree(indptr, indices, n):
    """Greedy exact minimum-degree order of a symmetric pattern."""
    lib = get_lib()
    if lib is None:
        return None
    perm = np.empty(n, dtype=np.int32)
    lib.sprs_min_degree(_i32(indptr), _i32(indices), n, perm)
    return perm


def nd_order_native(indptr, indices, n, leaf_size, balance_window):
    """Nested-dissection order, bit-identical to ``linalg.nd``'s numpy
    version; the pattern must be symmetric."""
    lib = get_lib()
    if lib is None:
        return None
    order = np.empty(max(n, 1), dtype=np.int32)
    done = lib.sprs_nd_order(_i32(indptr), _i32(indices), n, int(leaf_size),
                             float(balance_window), order)
    if done != n:
        return None
    return order[:n]


def amd(indptr, indices, n):
    """Approximate-minimum-degree order of a symmetric pattern."""
    lib = get_lib()
    if lib is None:
        return None
    perm = np.empty(n, dtype=np.int32)
    lib.sprs_amd(_i32(indptr), _i32(indices), n, perm)
    return perm


def lu(indptr, indices, data, n, pivot_threshold):
    """Gilbert–Peierls LU with threshold partial pivoting.

    Returns (l_indptr, l_indices, l_data, u_indptr, u_indices, u_data,
    perm_r), or None without the library.  A singular column raises
    ``ValueError("singular:<col>")``; the capacity doubles until the
    factors fit."""
    lib = get_lib()
    if lib is None:
        return None
    indptr, indices = _i32(indptr), _i32(indices)
    data = np.ascontiguousarray(data, np.float64)
    cap = max(4 * len(indices) + 4 * n + 16, 64)
    for _ in range(20):
        l_indptr = np.zeros(n + 1, dtype=np.int64)
        u_indptr = np.zeros(n + 1, dtype=np.int64)
        l_indices = np.empty(cap, dtype=np.int32)
        l_data = np.empty(cap, dtype=np.float64)
        u_indices = np.empty(cap, dtype=np.int32)
        u_data = np.empty(cap, dtype=np.float64)
        perm_r = np.empty(n, dtype=np.int32)
        err = _I64(-1)
        ret = lib.sprs_lu(indptr, indices, data, n, float(pivot_threshold), cap, l_indptr,
                          l_indices, l_data, u_indptr, u_indices, u_data, perm_r,
                          ctypes.byref(err))
        if ret == 0:
            lnnz, unnz = int(l_indptr[-1]), int(u_indptr[-1])
            return (l_indptr, l_indices[:lnnz], l_data[:lnnz], u_indptr, u_indices[:unnz],
                    u_data[:unnz], perm_r)
        if ret == -2:
            raise ValueError(f"singular:{int(err.value)}")
        cap *= 2
    raise MemoryError("sprs_lu: capacity growth did not converge")


def _incomplete(fn_name, what, indptr, indices, vals):
    lib = get_lib()
    if lib is None:
        return None
    out = np.array(vals, dtype=np.float64)
    bad = _I64(-1)
    rc = getattr(lib, fn_name)(_i32(indptr), _i32(indices), out, indptr.shape[0] - 1,
                               ctypes.byref(bad))
    if rc != 0:
        raise ValueError(f"{what} pivot failure at row {bad.value}")
    return out


def ilu0_numeric(indptr, indices, vals):
    """ILU(0) factor values on CSR arrays; a structural or zero pivot
    raises ValueError naming the row."""
    return _incomplete("sprs_ilu0", "ilu0", indptr, indices, vals)


def ic0_numeric(indptr, indices, vals):
    """IC(0) values on the CSR lower triangle; a missing diagonal or a
    non-positive pivot raises ValueError naming the row."""
    return _incomplete("sprs_ic0", "ic0", indptr, indices, vals)


def spgemm_host(a_indptr, a_indices, a_data, b_indptr, b_indices, b_data, n_cols):
    """Gustavson two-phase CSR SpGEMM on the host: (indptr, indices,
    data) with sorted columns."""
    lib = get_lib()
    if lib is None:
        return None
    ap, ai = _i32(a_indptr), _i32(a_indices)
    av = np.ascontiguousarray(a_data, np.float64)
    bp, bi = _i32(b_indptr), _i32(b_indices)
    bv = np.ascontiguousarray(b_data, np.float64)
    n_rows = ap.shape[0] - 1
    cp = np.zeros(n_rows + 1, np.int32)
    nnz = int(lib.sprs_spgemm_count(ap, ai, n_rows, bp, bi, n_cols, cp))
    ci = np.zeros(max(nnz, 1), np.int32)
    cv = np.zeros(max(nnz, 1), np.float64)
    lib.sprs_spgemm(ap, ai, av, n_rows, bp, bi, bv, n_cols, cp, ci, cv)
    return cp, ci[:nnz], cv[:nnz]
