"""LU, ILU(0) and IC(0) of the PyTorch port against the JAX package's
``sprs_tpu.linalg.lu`` and ``sprs_tpu.linalg.ilu``.

The host numerics are the same arithmetic in the same order on every
path (native C++ built with ``-ffp-contract=off``, and numpy), so L, U,
the permutations and the incomplete factors' values are exactly equal to
the JAX package's, native and numpy alike.  Solves and preconditioner
applications agree to rtol 1e-12.  Inputs: a 10² convection–diffusion
operator, a 12² grid Laplacian and 40-row random matrices, f64.
"""

import numpy as np
import pytest
import torch

import sprs_tpu as st
from sprs_tpu.linalg import ic0 as j_ic0
from sprs_tpu.linalg import ilu0 as j_ilu0
from sprs_tpu.linalg import splu as j_splu
from sprs_tpu_torch import native
from sprs_tpu_torch.errors import SingularMatrixError
from sprs_tpu_torch.interop import from_arrays
from sprs_tpu_torch.linalg import ic0, ilu0, splu

RTOL = 1e-12


@pytest.fixture(params=["native", "numpy"])
def path(request, monkeypatch):
    if request.param == "numpy":
        monkeypatch.setattr(native, "get_lib", lambda: None)
    return request.param


def port_of(m):
    return from_arrays("csmat", m.shape, (np.asarray(m.indptr), np.asarray(m.indices),
                                          np.asarray(m.data)), storage=m.storage, device="cpu")


def convection_diffusion(side=10, c=0.4):
    i = st.eye(side, np.float64)
    d = st.diags([1.0, -1.0], [0, -1], (side, side))
    return st.utils.dirichlet_laplacian((side, side)) + (
        st.kronecker_product(i, d) + st.kronecker_product(d, i)) * c


def random_general(n=40, density=0.1, seed=0):
    rng = np.random.default_rng(seed)
    d = rng.standard_normal((n, n))
    d[rng.random((n, n)) > density] = 0.0
    return st.from_dense(d + np.eye(n) * 0.5)


def random_spd(n=40, density=0.1, seed=1):
    rng = np.random.default_rng(seed)
    d = rng.standard_normal((n, n))
    d[rng.random((n, n)) > density] = 0.0
    d = (d + d.T) / 2
    return st.from_dense(d + np.eye(n) * (np.abs(d).sum(axis=1).max() + 1.0))


GENERAL = {"convdiff10": convection_diffusion, "random40": random_general}
SPD = {"grid12": lambda: st.utils.dirichlet_laplacian((12, 12)), "spd40": random_spd}


def same_csmat(got, want):
    assert got.storage == want.storage
    for f in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                      err_msg=f)


def assert_close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=RTOL * np.abs(want).max())


def rhs(n, k, seed=3):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(n) if k == 0 else rng.standard_normal((n, k))


def splu_pair(name, path, **kw):
    m = GENERAL[name]()
    if kw.get("col_perm") == "min_degree" and path == "numpy":
        # the JAX package's camd_order takes its native AMD here, the
        # port's numpy fallback the greedy minimum degree
        kw["col_perm"] = None
    return m, j_splu(m, **kw), splu(port_of(m), **kw)


@pytest.mark.parametrize("col_perm", [None, "min_degree"])
@pytest.mark.parametrize("pivot_threshold", [0.1, 1.0])
@pytest.mark.parametrize("name", list(GENERAL))
def test_splu_factors_match_jax(name, pivot_threshold, col_perm, path):
    _, want, got = splu_pair(name, path, col_perm=col_perm, pivot_threshold=pivot_threshold)
    same_csmat(got.l(), want.l())
    same_csmat(got.u(), want.u())
    np.testing.assert_array_equal(got.row_perm.perm.numpy(), np.asarray(want.row_perm.perm))
    np.testing.assert_array_equal(got.col_perm.perm.numpy(), np.asarray(want.col_perm.perm))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    assert got.lu_nnz() == want.lu_nnz()
    np.testing.assert_allclose(float(got.det()), float(want.det()), rtol=RTOL)


@pytest.mark.parametrize("k", [0, 3], ids=["vector", "block"])
@pytest.mark.parametrize("name", list(GENERAL))
def test_splu_solves_match_jax(name, k):
    m, want, got = splu_pair(name, "native", col_perm="min_degree")
    b = rhs(m.shape[0], k)
    assert_close(got.solve(b), want.solve(b))
    assert_close(got.solve_transposed(torch.from_numpy(b)), want.solve_transposed(b))


def test_splu_det_and_singular():
    d = np.random.default_rng(4).standard_normal((12, 12))
    lu = splu(from_arrays("csmat", (12, 12), _csr(d), device="cpu"))
    sign, logdet = np.linalg.slogdet(d)
    np.testing.assert_allclose(float(lu.det()), sign * np.exp(logdet), rtol=1e-12)
    d[:, 4] = 0.0
    d[4, 4] = 0.0
    with pytest.raises(SingularMatrixError):
        splu(from_arrays("csmat", (12, 12), _csr(d), device="cpu"), scale=False)


def _csr(d):
    import scipy.sparse as sp

    a = sp.csr_matrix(d)
    return a.indptr, a.indices, a.data


@pytest.mark.parametrize("name", list(GENERAL) + list(SPD))
def test_ilu0_matches_jax(name, path):
    m = {**GENERAL, **SPD}[name]()
    want, got = j_ilu0(m), ilu0(port_of(m))
    same_csmat(got.l, want.l)
    same_csmat(got.u, want.u)
    for k in (0, 3):
        b = rhs(m.shape[0], k)
        assert_close(got(torch.from_numpy(b)), want(b))


@pytest.mark.parametrize("name", list(SPD))
def test_ic0_matches_jax(name, path):
    m = SPD[name]()
    want, got = j_ic0(m), ic0(port_of(m))
    same_csmat(got.l, want.l)
    same_csmat(got.lt, want.lt)
    for k in (0, 3):
        b = rhs(m.shape[0], k)
        assert_close(got(b), want(b))


def test_incomplete_native_equals_numpy(monkeypatch):
    """The port's native ILU(0) / IC(0) values are bit-equal to its numpy
    sweeps."""
    m = port_of(SPD["grid12"]())
    fast = (ilu0(m).u.data.clone(), ic0(m).l.data.clone())
    monkeypatch.setattr(native, "get_lib", lambda: None)
    slow = (ilu0(m).u.data, ic0(m).l.data)
    for a, b in zip(fast, slow):
        assert torch.equal(a, b)


def test_incomplete_pivot_failures(path):
    d = np.eye(4) * 2.0
    d[1, 1] = 0.0
    d[1, 0] = d[0, 1] = 1.0
    with pytest.raises(SingularMatrixError):
        ic0(from_arrays("csmat", (4, 4), _csr(-d), device="cpu"))
    e = np.eye(4)
    e[2, 2] = 0.0
    e[2, 3] = 1.0
    with pytest.raises(SingularMatrixError):
        ilu0(from_arrays("csmat", (4, 4), _csr(e), device="cpu"))


@pytest.mark.gpu
def test_factors_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    m = GENERAL["convdiff10"]()
    card = from_arrays("csmat", m.shape, (np.asarray(m.indptr), np.asarray(m.indices),
                                          np.asarray(m.data)), device="cuda")
    b = rhs(100, 3)
    for fac_fn in (splu, ilu0):
        got = fac_fn(card)
        want = fac_fn(port_of(m))
        solve = got.solve
        assert_close(solve(torch.from_numpy(b).cuda()).cpu(), want.solve(b).numpy())
