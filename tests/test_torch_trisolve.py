"""Triangular solves of the PyTorch port against the JAX package's
``sprs_tpu.linalg.trisolve``: ``diag_solve``, the scan, levels and flat
methods in both directions on a vector and an (n, 3) block, the auto
rule, the level and flat schedules (exactly equal arrays, native and
numpy), and the sparse-RHS ``lsolve_csc_sparse_rhs``.

Inputs are the triangles of a 12² grid Laplacian's LDLᵀ factor and of a
40-row random SPD matrix, f64, from seeds with numpy.  Solutions agree
to rtol 1e-12: each level or block sums in the port's own order.
"""

import numpy as np
import pytest
import torch

import sprs_tpu as st
from sprs_tpu.linalg import Ldl as JLdl
from sprs_tpu.linalg import trisolve as jt
from sprs_tpu_torch import native
from sprs_tpu_torch.errors import SingularMatrixError
from sprs_tpu_torch.formats.csvec import csvec
from sprs_tpu_torch.interop import from_arrays
from sprs_tpu_torch.linalg import trisolve as tt

RTOL = 1e-12


def port_of(m):
    return from_arrays("csmat", m.shape, (np.asarray(m.indptr), np.asarray(m.indices),
                                          np.asarray(m.data)), storage=m.storage, device="cpu")


def random_spd(n=40, density=0.1, seed=0):
    rng = np.random.default_rng(seed)
    d = rng.standard_normal((n, n))
    d[rng.random((n, n)) > density] = 0.0
    d = (d + d.T) / 2
    d += np.eye(n) * (np.abs(d).sum(axis=1).max() + 1.0)
    return d


def triangles(name):
    """(lower, upper) CsMats with nontrivial level structure: L of an
    LDLᵀ factor (CSC, unit diagonal scaled by 2) and Lᵀ as CSR; or the
    tril/triu of a random SPD matrix."""
    if name == "ldl12":
        num = JLdl().fill_in_reduction("nd").check_symmetry(False).numeric(
            st.utils.dirichlet_laplacian((12, 12)))
        lo = num.l()
        lo = lo.with_data(lo.data * 2.0)
        return lo, st.CsMat(lo.indptr, lo.indices, lo.data, lo.shape, "csr")
    d = random_spd()
    return st.from_dense(np.tril(d)), st.from_dense(np.triu(d), storage="csc")


def rhs(n, k, seed=1):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(n) if k == 0 else rng.standard_normal((n, k))


def assert_close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=RTOL * np.abs(want).max())


@pytest.mark.parametrize("k", [0, 3])
def test_diag_solve(k):
    m = st.from_dense(random_spd())
    b = rhs(40, k)
    assert_close(tt.diag_solve(port_of(m), b), jt.diag_solve(m, b))


@pytest.mark.parametrize("k", [0, 3], ids=["vector", "block"])
@pytest.mark.parametrize("lower", [True, False], ids=["lower", "upper"])
@pytest.mark.parametrize("method", ["scan", "levels", "flat"])
@pytest.mark.parametrize("name", ["ldl12", "random40"])
def test_solve_matches_jax(name, method, lower, k):
    tri = triangles(name)[0 if lower else 1]
    b = rhs(tri.shape[0], k)
    fn, j_fn = (tt.lsolve, jt.lsolve) if lower else (tt.usolve, jt.usolve)
    got = fn(port_of(tri), torch.from_numpy(b), method=method)
    assert got.dtype == torch.float64 and got.shape == b.shape
    assert_close(got, j_fn(tri, b, method=method))


@pytest.mark.parametrize("lower", [True, False])
def test_scan_window_poisons(lower):
    """A row wider than ``window`` NaN-poisons its component."""
    tri = triangles("random40")[0 if lower else 1]
    b = rhs(40, 0)
    fn, j_fn = (tt.lsolve, jt.lsolve) if lower else (tt.usolve, jt.usolve)
    got = fn(port_of(tri), b, method="scan", window=3).numpy()
    want = np.asarray(j_fn(tri, b, method="scan", window=3))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got).any()


@pytest.mark.parametrize("path", ["native", "numpy"])
@pytest.mark.parametrize("lower", [True, False])
@pytest.mark.parametrize("name", ["ldl12", "random40"])
def test_schedules_equal(name, lower, path, monkeypatch):
    if path == "numpy":
        monkeypatch.setattr(native, "get_lib", lambda: None)
    tri = triangles(name)[0 if lower else 1]
    got, want = tt.build_schedule(port_of(tri), lower=lower), jt.build_schedule(tri, lower=lower)
    np.testing.assert_array_equal(got.order, want.order)
    np.testing.assert_array_equal(got.offsets, want.offsets)
    assert (got.width, got.n, got.lower, got.n_levels) == (want.width, want.n, want.lower,
                                                            want.n_levels)
    for e in (16, 2048):
        got = tt.build_flat_schedule(port_of(tri), lower=lower, block_entries=e)
        want = jt.build_flat_schedule(tri, lower=lower, block_entries=e)
        assert (got.n, got.lower, got.E, got.nblocks) == (want.n, want.lower, want.E,
                                                          want.nblocks)
        for f in ("e_slot", "e_col", "e_row", "f_row", "f_dslot"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f))


@pytest.mark.parametrize("k", [0, 3])
def test_given_schedules(k):
    """A schedule passed in selects its method, as does "auto" without
    one; a small flat block size splits rows across blocks."""
    lo, _ = triangles("ldl12")
    b = rhs(lo.shape[0], k)
    sched = tt.build_schedule(port_of(lo), lower=True)
    flat = tt.build_flat_schedule(port_of(lo), lower=True, block_entries=5)
    want = jt.lsolve(lo, b, method="levels")
    assert_close(tt.lsolve(port_of(lo), b, schedule=sched), want)
    assert_close(tt.lsolve(port_of(lo), b, schedule=flat), want)
    assert_close(tt.lsolve(port_of(lo), b), want)
    with pytest.raises(ValueError, match="direction"):
        tt.usolve(port_of(lo), b, method="levels", schedule=sched)


def test_singular_raises():
    d = np.tril(random_spd())
    d[5, 5] = 0.0
    m = st.from_dense(d)
    for method in ("levels", "flat", "scan"):
        with pytest.raises(SingularMatrixError):
            tt.lsolve(port_of(m), rhs(40, 0), method=method)


@pytest.mark.parametrize("pattern", [[3], [0, 17], [5, 20, 39]])
def test_sparse_rhs(pattern):
    lo, _ = triangles("ldl12")
    rng = np.random.default_rng(2)
    vals = rng.standard_normal(len(pattern))
    want = jt.lsolve_csc_sparse_rhs(lo, st.csvec(lo.shape[0], np.array(pattern, np.int32), vals))
    got = tt.lsolve_csc_sparse_rhs(port_of(lo), csvec(lo.shape[0], np.array(pattern, np.int32),
                                                      vals, device="cpu"))
    assert got.nnz == int(want.nnz)
    np.testing.assert_array_equal(got.indices[: got.nnz].numpy(),
                                  np.asarray(want.indices)[: int(want.nnz)])
    assert_close(got.data[: got.nnz], np.asarray(want.data)[: int(want.nnz)])


@pytest.mark.gpu
@pytest.mark.parametrize("method", ["levels", "flat"])
def test_solve_on_card(method):
    """The level and flat solves on a CUDA tensor against the CPU run."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    lo, up = triangles("ldl12")
    b = torch.from_numpy(rhs(lo.shape[0], 3))
    for tri, fn in ((lo, tt.lsolve), (up, tt.usolve)):
        cpu = fn(port_of(tri), b, method=method)
        card = from_arrays("csmat", tri.shape, (np.asarray(tri.indptr), np.asarray(tri.indices),
                                                np.asarray(tri.data)), storage=tri.storage,
                           device="cuda")
        got = fn(card, b.cuda(), method=method)
        assert got.device.type == "cuda"
        assert_close(got.cpu(), cpu.numpy())
