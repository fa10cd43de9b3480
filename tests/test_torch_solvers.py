"""Solvers of the PyTorch port against the JAX package, float64: the
same iteration counts, and solutions within 1e-10."""

import numpy as np
import pytest
import torch

import sprs_tpu as st
import sprs_tpu_torch as stt
from sprs_tpu.linalg import bicgstab, cg, gauss_seidel, jacobi
from sprs_tpu_torch.interop import from_arrays
from sprs_tpu_torch.linalg import bicgstab as t_bicgstab
from sprs_tpu_torch.linalg import cg as t_cg
from sprs_tpu_torch.linalg import gauss_seidel as t_gauss_seidel
from sprs_tpu_torch.linalg import jacobi as t_jacobi


def port_of(m):
    return from_arrays(
        "csmat",
        m.shape,
        (np.asarray(m.indptr), np.asarray(m.indices), np.asarray(m.data)),
        storage=m.storage,
        device="cpu",
    )


def heat_rhs(side):
    rhs = np.zeros(side * side)
    rhs[(side // 2) * side + side // 2] = 1.0
    return rhs


def assert_same_solve(got, want, *, atol=1e-10):
    assert got.iterations == int(want.iterations)
    assert got.converged == bool(want.converged)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), rtol=0, atol=atol)


def test_bicgstab_grid_laplacian():
    m = st.utils.grid_laplacian((12, 12), dtype=np.float64)
    rhs = heat_rhs(12)
    want = bicgstab(m, rhs, tol=1e-8, max_iter=500)
    got = t_bicgstab(port_of(m), rhs, tol=1e-8, max_iter=500)
    assert_same_solve(got, want)
    np.testing.assert_allclose(got.residual_norm, want.residual_norm, rtol=1e-3, atol=1e-16)


def test_cg_dirichlet_laplacian():
    m = st.utils.dirichlet_laplacian((10, 10), dtype=np.float64)
    b = np.asarray(m.to_dense()) @ np.linspace(0.5, 1.5, 100)
    want = cg(m, b, tol=1e-8, max_iter=500)
    got = t_cg(port_of(m), b, tol=1e-8, max_iter=500)
    assert_same_solve(got, want)


def test_cg_jacobi_preconditioned():
    m = st.utils.dirichlet_laplacian((10, 10), dtype=np.float64)
    b = np.asarray(m.to_dense()) @ np.ones(100)
    d = np.array(m.diag())
    want = cg(m, b, tol=1e-10, max_iter=500, precond=lambda r: r / d)
    td = torch.from_numpy(d)
    got = t_cg(port_of(m), b, tol=1e-10, max_iter=500, precond=lambda r: r / td)
    assert_same_solve(got, want)


def test_jacobi_grid_laplacian():
    m = st.utils.grid_laplacian((12, 12), dtype=np.float64)
    rhs = heat_rhs(12)
    want = jacobi(m, rhs, tol=1e-7, max_iter=8000, omega=0.9)
    got = t_jacobi(port_of(m), rhs, tol=1e-7, max_iter=8000, omega=0.9)
    assert_same_solve(got, want)


def test_gauss_seidel_grid_laplacian():
    m = st.utils.grid_laplacian((8, 8), dtype=np.float64)
    rhs = heat_rhs(8)
    want = gauss_seidel(m, rhs, tol=1e-8, max_iter=300)
    got = t_gauss_seidel(port_of(m), rhs, tol=1e-8, max_iter=300)
    assert got.iterations == want.iterations
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), atol=1e-12)


@pytest.mark.parametrize("solver", ["bicgstab", "cg"])
def test_two_by_two_doctest_system(solver):
    """The reference's executable example: [[4, 1], [1, 3]] x = [1, 2]."""
    a = np.array([[4.0, 1.0], [1.0, 3.0]])
    b = np.array([1.0, 2.0])
    ref_fn, port_fn = {"bicgstab": (bicgstab, t_bicgstab), "cg": (cg, t_cg)}[solver]
    want = ref_fn(st.from_dense(a), b, tol=1e-6)
    got = port_fn(stt.from_dense(a, device="cpu"), b, tol=1e-6)
    assert_same_solve(got, want)
    np.testing.assert_allclose(got.x.numpy(), [1.0 / 11.0, 7.0 / 11.0], atol=1e-5)


def test_bicgstab_float32_thresholds():
    """float32: 1e-300 is 0 in the working type, as in the JAX solver;
    the iteration count must not drift."""
    m = st.utils.grid_laplacian((8, 8), dtype=np.float32)
    rhs = heat_rhs(8).astype(np.float32)
    want = bicgstab(m, rhs, tol=1e-5, max_iter=200)
    got = t_bicgstab(port_of(m), rhs, tol=1e-5, max_iter=200)
    assert got.x.dtype == torch.float32
    assert got.iterations == int(want.iterations)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), atol=1e-5)


@pytest.mark.parametrize("solver,per_iter", [("bicgstab", 3), ("cg", 1)])
def test_matvec_count(solver, per_iter):
    """3·iters + 2 (BiCGSTAB) and iters + 2 (CG) matvecs: the count the
    chip smoke test holds the kernel's launch counter to."""
    m = port_of(st.utils.dirichlet_laplacian((6, 6), dtype=np.float64))
    calls = []

    def matvec(v):
        calls.append(1)
        return stt.spmv(m, v)

    b = torch.ones(36, dtype=torch.float64)
    res = {"bicgstab": t_bicgstab, "cg": t_cg}[solver](matvec, b, tol=1e-10)
    assert res.converged
    assert len(calls) == per_iter * res.iterations + 2


def test_errors():
    wide = stt.from_dense(np.ones((2, 3)), device="cpu")
    with pytest.raises(stt.NonSquareMatrixError):
        t_bicgstab(wide, np.ones(2))
    with pytest.raises(stt.NonSquareMatrixError):
        t_jacobi(wide, np.ones(2))
    sq = stt.from_dense(np.eye(3), device="cpu")
    with pytest.raises(stt.ShapeError):
        t_cg(sq, np.ones(4))


def test_grad_matrix_stays_on_generic_product():
    """A matrix whose values require a gradient is not prepared (the
    prepared formats copy the values): autograd reaches ``mat.data``."""
    from sprs_tpu_torch.linalg._dispatch import as_matvec

    m = stt.utils.grid_laplacian((4, 4), device="cpu")
    m = type(m)(m.indptr, m.indices, m.data.clone().requires_grad_(True), m.shape, m.storage)
    op, n = as_matvec(m)
    op(torch.ones(n, dtype=torch.float64)).sum().backward()
    assert m.data.grad is not None and float(m.data.grad.abs().sum()) > 0
