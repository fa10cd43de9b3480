"""GMRES, LSQR and the sparse-iterate BiCGSTAB of the PyTorch port against
the JAX package's ``sprs_tpu.linalg``, on 8²–12² operators in float64.

Tolerances: iteration counts equal; x within 1e-10 (the solves stop at a
residual of 1e-10·‖b‖ on operators with condition numbers below 1e2; the
two packages round their reductions in other orders).
"""

import numpy as np
import pytest
import torch

import sprs_tpu as st
import sprs_tpu_torch as ts
from sprs_tpu.linalg import bicgstab_sparse as j_bicgstab_sparse
from sprs_tpu.linalg import gmres as j_gmres
from sprs_tpu.linalg import lsqr as j_lsqr
from sprs_tpu_torch.interop import from_arrays
from sprs_tpu_torch.linalg import bicgstab_sparse, gmres, lsqr

TOL = 1e-10


def port_of(m):
    return from_arrays(
        "csmat", m.shape, (np.asarray(m.indptr), np.asarray(m.indices), np.asarray(m.data)),
        storage=m.storage, device="cpu",
    )


def convection_diffusion(side, c=0.4):
    """The Dirichlet Laplacian plus a first-difference (upwind
    convection) term along both axes: nonsymmetric, built with
    ``kronecker_product``."""
    i = st.eye(side, np.float64)
    d = st.diags([1.0, -1.0], [0, -1], (side, side))
    return st.utils.dirichlet_laplacian((side, side)) + (
        st.kronecker_product(i, d) + st.kronecker_product(d, i)) * c


def assert_same_solve(got, want):
    assert got.iterations == int(want.iterations)
    assert got.converged == bool(want.converged)
    x = got.x.to_dense() if isinstance(got.x, ts.CsVec) else got.x
    w = want.x.to_dense() if isinstance(want.x, st.CsVec) else want.x
    np.testing.assert_allclose(x.numpy(), np.asarray(w), rtol=0, atol=TOL)


@pytest.mark.parametrize("with_precond", [False, True])
def test_gmres_matches_jax(with_precond):
    a = convection_diffusion(8)
    b = np.random.default_rng(0).standard_normal(64)
    kw = dict(tol=TOL, restart=6, max_iter=600)  # restart far below the steps taken
    if with_precond:
        dinv = 1.0 / np.asarray(a.diag())
        got = gmres(port_of(a), b, precond=lambda v: v * torch.from_numpy(dinv), **kw)
        want = j_gmres(a, b, precond=lambda v: v * dinv, **kw)
    else:
        got, want = gmres(port_of(a), b, **kw), j_gmres(a, b, **kw)
    assert got.iterations > 6
    assert_same_solve(got, want)


def test_gmres_counts_matvecs():
    """1 + cycles·(restart + 1) products, through a callable."""
    a = port_of(convection_diffusion(8))
    calls = [0]

    def op(v):
        calls[0] += 1
        return ts.spmv(a, v)

    res = gmres(op, torch.ones(64, dtype=torch.float64), tol=TOL, restart=5)
    assert res.converged and calls[0] == 1 + (res.iterations // 5) * 6


@pytest.mark.parametrize("shape", ["tall", "wide"])
def test_lsqr_matches_jax(shape):
    """The Tikhonov system [L; sqrt(λ)·I] (tall) and its transpose, whose
    minimum-norm solution LSQR finds (wide)."""
    side, lam = 8, 0.5
    n = side * side
    a = st.vstack([st.utils.dirichlet_laplacian((side, side)), st.eye(n, np.float64) * np.sqrt(lam)])
    if shape == "wide":
        a = a.T.to_csr()
    b = np.random.default_rng(1).standard_normal(a.shape[0])
    assert_same_solve(lsqr(port_of(a), b, tol=TOL), j_lsqr(a, b, tol=TOL))


def test_lsqr_operator_pair_and_complex():
    rng = np.random.default_rng(2)
    d = rng.standard_normal((20, 12)) + 1j * rng.standard_normal((20, 12))
    d[rng.random((20, 12)) > 0.4] = 0.0
    a = st.from_dense(d)
    b = rng.standard_normal(20) + 1j * rng.standard_normal(20)
    assert_same_solve(lsqr(port_of(a), b, tol=TOL), j_lsqr(a, b, tol=TOL))
    real = st.from_dense(d.real)
    t, tt = port_of(real), port_of(real).T.to_csr()
    pair = (lambda v: ts.spmv(t, v), lambda u: ts.spmv(tt, u))
    got = lsqr(pair, torch.from_numpy(b.real), tol=TOL)
    assert_same_solve(got, j_lsqr(real, b.real, tol=TOL))


def test_bicgstab_sparse_matches_jax():
    """A point source under a short implicit convection–diffusion step
    I + 0.1·K on 8², iterates of capacity 80 (above n = 64: padded
    vectors).  The short step and a tolerance of 1e-6 keep the solve to
    a few iterations: each JAX matvec compiles anew while the support
    grows."""
    a = st.eye(64, np.float64) + convection_diffusion(8, c=0.2) * 0.1
    got = bicgstab_sparse(port_of(a), ts.csvec(64, [27], [1.0], device="cpu"), cap=80, tol=1e-6)
    want = j_bicgstab_sparse(a, st.csvec(64, [27], [1.0]), cap=80, tol=1e-6)
    assert got.x.cap == 80
    assert_same_solve(got, want)


# Complex CG and BiCGSTAB: tests/test_precond.py::TestComplexKrylov's
# fixtures, complex128 at tol 1e-10.  x against the JAX solvers' within
# rtol 1e-8 (CG) and 1e-7 (BiCGSTAB), the reference tests' own limits
# against np.linalg.solve; iteration counts equal.
def complex_fixture(kind):
    rng = np.random.default_rng({"hermitian": 7, "general": 8}[kind])
    a = rng.standard_normal((20, 20)) + 1j * rng.standard_normal((20, 20))
    m = a @ a.conj().T + 20 * np.eye(20) if kind == "hermitian" else a + 20 * np.eye(20)
    b = rng.standard_normal(20) + 1j * rng.standard_normal(20)
    return m, b


@pytest.mark.parametrize("solver, kind, rtol", [
    ("cg", "hermitian", 1e-8),
    ("bicgstab", "general", 1e-7),
])
def test_complex_krylov_matches_jax_and_dense_solve(solver, kind, rtol):
    from sprs_tpu import linalg as jl
    from sprs_tpu_torch import linalg as tl

    m, b = complex_fixture(kind)
    want = getattr(jl, solver)(st.from_dense(m), b, tol=TOL)
    got = getattr(tl, solver)(ts.from_dense(m, device="cpu"), b, tol=TOL)
    assert got.converged and bool(want.converged)
    assert got.x.dtype == torch.complex128
    assert got.iterations == int(want.iterations)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), rtol=rtol)
    np.testing.assert_allclose(got.x.numpy(), np.linalg.solve(m, b), rtol=rtol)


@pytest.mark.parametrize("solver", ["cg", "bicgstab"])
@pytest.mark.parametrize("route", ["direct", "solve"])
def test_real_laplacian_stored_complex(solver, route):
    """The 6² Dirichlet Laplacian stored as complex128 with a complex b,
    through the solver and through ``solve(method=...)``: x against the
    JAX solver's and the dense solve."""
    from sprs_tpu import linalg as jl
    from sprs_tpu_torch import linalg as tl

    lap = st.utils.dirichlet_laplacian((6, 6)).to_dense()
    m = np.asarray(lap).astype(np.complex128)
    rng = np.random.default_rng(9)
    b = rng.standard_normal(36) + 1j * rng.standard_normal(36)
    tm = ts.from_dense(m, device="cpu")
    if route == "direct":
        got = getattr(tl, solver)(tm, b, tol=TOL)
        want = getattr(jl, solver)(st.from_dense(m), b, tol=TOL)
        assert got.converged and got.iterations == int(want.iterations)
        x = got.x
        np.testing.assert_allclose(x.numpy(), np.asarray(want.x), rtol=1e-8)
    else:
        x = tl.solve(tm, torch.from_numpy(b), method=solver, tol=TOL)
    assert x.dtype == torch.complex128
    np.testing.assert_allclose(x.numpy(), np.linalg.solve(m, b), rtol=1e-8)


@pytest.mark.parametrize("solver", ["cg", "bicgstab"])
@pytest.mark.parametrize("dtype, tol", [(np.float64, 1e-10), (np.float32, 1e-5)])
def test_real_solves_keep_their_iteration_counts(solver, dtype, tol):
    """The floor's new type leaves real solves as they were: the 8²
    Dirichlet Laplacian in float64 and float32, iteration counts equal to
    the JAX solvers'."""
    from sprs_tpu import linalg as jl
    from sprs_tpu_torch import linalg as tl

    m = np.asarray(st.utils.dirichlet_laplacian((8, 8)).to_dense()).astype(dtype)
    b = np.random.default_rng(10).standard_normal(64).astype(dtype)
    got = getattr(tl, solver)(ts.from_dense(m, device="cpu"), b, tol=tol)
    want = getattr(jl, solver)(st.from_dense(m), b, tol=tol)
    assert got.converged and bool(want.converged)
    assert got.x.dtype == torch.from_numpy(m).dtype
    assert got.iterations == int(want.iterations)
