"""The multi-RHS slice as a whole: LOBPCG, svds and expm_multiply of the
PyTorch port against the JAX package on the fixtures of
tests/test_precond.py, in float64 (complex128 for the Hermitian case).

Tolerances: eigen- and singular values to 1e-8 relative; eigenvectors as
subspaces (the projectors V·Vᴴ to 1e-6: signs and the basis of a repeated
eigenvalue are free); iteration counts within ITER_SLACK of the JAX
solver's, since ``torch.linalg`` and ``jnp.linalg`` round the small dense
problems differently; ``expm_multiply`` to 1e-10 relative to max|y|.  On
a banded matrix the products go through the K2 wrapper, whose plain
version counts its calls: the launch counts the card must show are
checked here on those calls.
"""

import numpy as np
import pytest
import scipy.linalg as sla
import torch

import jax.numpy as jnp

import sprs_tpu as st
import sprs_tpu_torch as stt
from sprs_tpu.linalg import expm_multiply, lobpcg, svds
from sprs_tpu_torch.errors import NonSquareMatrixError
from sprs_tpu_torch.interop import from_arrays
from sprs_tpu_torch.linalg import expm_multiply as t_expm_multiply
from sprs_tpu_torch.linalg import lobpcg as t_lobpcg
from sprs_tpu_torch.linalg import svds as t_svds
from sprs_tpu_torch.linalg._dispatch import as_matvec
from sprs_tpu_torch.ops.cuda.dia_spmm import dia_spmm_plain

ITER_SLACK = 3


def port_of(m):
    return from_arrays(
        "csmat",
        m.shape,
        (np.asarray(m.indptr), np.asarray(m.indices), np.asarray(m.data)),
        storage=m.storage,
        device="cpu",
    )


def assert_same_subspace(v, w):
    v, w = np.asarray(v), np.asarray(w)
    np.testing.assert_allclose(v @ v.conj().T, w @ w.conj().T, atol=1e-6)


def assert_same_eigs(got, want):
    assert abs(got.iterations - int(want.iterations)) <= ITER_SLACK
    assert got.converged == bool(want.converged)
    np.testing.assert_allclose(got.eigenvalues.numpy(), np.asarray(want.eigenvalues), rtol=1e-8)
    assert_same_subspace(got.eigenvectors.numpy(), want.eigenvectors)


def hermitian(n, rng):
    d = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    d = (d + d.conj().T) / 2 + n * np.eye(n)
    d[np.abs(d) < 0.8] = 0.0
    return (d + d.conj().T) / 2


def test_lobpcg_dirichlet_laplacian():
    lap = st.utils.dirichlet_laplacian((10, 10), dtype=np.float64)
    x0 = np.random.default_rng(0).standard_normal((100, 3))
    want = lobpcg(lap, x0, tol=1e-8, max_iter=300)
    got = t_lobpcg(port_of(lap), x0, tol=1e-8, max_iter=300)
    assert got.converged
    assert_same_eigs(got, want)
    true = np.linalg.eigvalsh(np.asarray(lap.to_dense()))[:3]
    np.testing.assert_allclose(got.eigenvalues.numpy(), true, rtol=1e-6)


def test_lobpcg_spmm_count_on_the_banded_route():
    """A banded CsMat runs every SpMM through the K2 wrapper: 2·iters + 2."""
    lap = stt.utils.dirichlet_laplacian((12, 12), device="cpu")
    x0 = np.random.default_rng(1).standard_normal((144, 4))
    before = dia_spmm_plain.calls
    res = t_lobpcg(lap, x0, tol=1e-8, max_iter=300)
    assert res.converged
    assert dia_spmm_plain.calls - before == 2 * res.iterations + 2


def test_lobpcg_matvec_callable():
    d = np.diag(np.arange(1.0, 21.0))
    x0 = np.random.default_rng(2).standard_normal((20, 2))
    want = lobpcg(lambda v: jnp.asarray(d) @ v, x0, tol=1e-9)
    dt = torch.from_numpy(d)
    got = t_lobpcg(lambda v: dt @ v, torch.from_numpy(x0), tol=1e-9)
    assert_same_eigs(got, want)
    np.testing.assert_allclose(got.eigenvalues.numpy(), [1.0, 2.0], rtol=1e-7)


def test_lobpcg_complex_hermitian():
    rng = np.random.default_rng(70)
    d = hermitian(24, rng)
    x0 = rng.standard_normal((24, 2)) + 1j * rng.standard_normal((24, 2))
    want = lobpcg(st.from_dense(d), x0, tol=1e-9, max_iter=400)
    got = t_lobpcg(stt.from_dense(d, device="cpu"), x0, tol=1e-9, max_iter=400)
    assert got.converged
    assert not got.eigenvalues.is_complex() and got.eigenvectors.is_complex()
    assert_same_eigs(got, want)
    np.testing.assert_allclose(got.eigenvalues.numpy(), np.linalg.eigvalsh(d)[:2], rtol=1e-6)


@pytest.mark.parametrize("shape,density,k,seed", [((30, 20), 0.5, 3, 50), ((25, 25), 0.4, 2, 51)])
def test_svds_matches_jax(shape, density, k, seed):
    rng = np.random.default_rng(seed)
    d = rng.standard_normal(shape) * (rng.random(shape) < density)
    want = svds(st.from_dense(d), k=k, tol=1e-10, max_iter=500)
    got = t_svds(stt.from_dense(d, device="cpu"), k=k, tol=1e-10, max_iter=500)
    assert abs(got.iterations - int(want.iterations)) <= ITER_SLACK
    assert got.converged and bool(want.converged)
    np.testing.assert_allclose(got.s.numpy(), np.asarray(want.s), rtol=1e-8)
    np.testing.assert_allclose(got.s.numpy(), np.linalg.svd(d, compute_uv=False)[:k], rtol=1e-6)
    assert_same_subspace(got.vt.numpy().T, np.asarray(want.vt).T)
    assert_same_subspace(got.u.numpy(), want.u)
    for i in range(k):  # the triplet property A v = s u
        np.testing.assert_allclose(
            d @ got.vt[i].numpy(), float(got.s[i]) * got.u[:, i].numpy(), rtol=1e-4, atol=1e-7
        )


def test_svds_spmm_count_on_the_banded_route():
    """A rectangular band runs A and Aᵀ through the K2 wrapper: 4·iters + 5."""
    rng = np.random.default_rng(3)
    d = np.zeros((90, 70))
    for off in (-9, -1, 0, 2, 7):
        i = np.arange(max(0, -off), min(90, 70 - off))
        d[i, i + off] = rng.standard_normal(i.size)
    before = dia_spmm_plain.calls
    res = t_svds(stt.from_dense(d, device="cpu"), k=2, tol=1e-8, max_iter=500)
    assert res.converged
    assert dia_spmm_plain.calls - before == 4 * res.iterations + 5
    np.testing.assert_allclose(res.s.numpy(), np.linalg.svd(d, compute_uv=False)[:2], rtol=1e-6)


def assert_close_expm(got, want):
    got, want = got.numpy(), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-10 * np.abs(want).max())


@pytest.mark.parametrize("t", [0.5, 1.0, -2.0])
def test_expm_multiply_vector(t):
    rng = np.random.default_rng(60)
    d = rng.standard_normal((20, 20)) * (rng.random((20, 20)) < 0.3)
    b = rng.standard_normal(20)
    want = expm_multiply(st.from_dense(d), b, t=t, tol=1e-12)
    got = t_expm_multiply(stt.from_dense(d, device="cpu"), b, t=t, tol=1e-12)
    assert got.shape == (20,)
    assert_close_expm(got, want)
    np.testing.assert_allclose(got.numpy(), sla.expm(t * d) @ b, rtol=1e-8, atol=1e-10)


def test_expm_multiply_block():
    rng = np.random.default_rng(61)
    d = rng.standard_normal((12, 12)) * (rng.random((12, 12)) < 0.4)
    b = rng.standard_normal((12, 3))
    want = expm_multiply(st.from_dense(d), b, t=0.7, tol=1e-12)
    got = t_expm_multiply(stt.from_dense(d, device="cpu"), b, t=0.7, tol=1e-12)
    assert_close_expm(got, want)
    np.testing.assert_allclose(got.numpy(), sla.expm(0.7 * d) @ b, rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize("block", [False, True])
def test_expm_multiply_banded_heat(block):
    """Heat diffusion on the grid Laplacian (the DIA route): a vector takes
    the K1 wrapper, a block of point sources the K2 wrapper."""
    lap = st.utils.grid_laplacian((8, 8), dtype=np.float64)
    b = np.zeros((64, 4))
    b[[9, 27, 36, 54], range(4)] = 1.0
    b = b if block else b[:, 1]
    want = expm_multiply(lap, b, t=-1.0)
    before = dia_spmm_plain.calls
    got = t_expm_multiply(port_of(lap), b, t=-1.0)
    assert_close_expm(got, want)
    assert (dia_spmm_plain.calls > before) == block


def test_as_matvec_square_and_multi_rhs():
    rect = stt.from_dense(np.arange(12.0).reshape(4, 3), device="cpu")
    with pytest.raises(NonSquareMatrixError):
        as_matvec(rect, multi_rhs=True)
    op, n = as_matvec(rect, square=False, multi_rhs=True)
    x = torch.ones((3, 2), dtype=torch.float64)
    assert n == 4
    np.testing.assert_allclose(op(x).numpy(), np.arange(12.0).reshape(4, 3) @ np.ones((3, 2)))
    # a matrix whose values need a gradient stays on the generic SpMM
    m = stt.utils.grid_laplacian((4, 4), device="cpu")
    m = type(m)(m.indptr, m.indices, m.data.clone().requires_grad_(True), m.shape, m.storage)
    op, _ = as_matvec(m, multi_rhs=True)
    op(torch.ones((16, 2), dtype=torch.float64)).sum().backward()
    assert m.data.grad is not None and float(m.data.grad.abs().sum()) > 0
