"""Refinement, the differentiable ``solve``, IC(0)-preconditioned
LOBPCG and the three ported examples of the PyTorch port, against the
JAX package.

* ``refine_solve``: x to rtol 1e-12 and ``info["backward_errors"]`` of
  the same length (``rtol``'s early stop on the same step) to rtol 1e-6;
  once refinement has converged a backward error is f64 rounding of the
  residual (a few 1e-17 to 1e-16, summed in another order by scipy), so
  those entries agree to an absolute 1e-15 (about 4.5 ulp of 1.0).
* ``solve`` for every method: x to rtol 1e-10 and the gradients in b and
  in the matrix values to rtol 1e-10 against ``jax.grad`` of the JAX
  ``solve`` (for LU, whose JAX version cannot take traced values, the
  value gradient is held against the dense formula −λ[row]·x[col] with
  λ = A⁻ᵀ·g).  The factorization is not differentiated: the output's
  autograd node leads to the leaves and nothing else.
* IC(0)-LOBPCG: the case of ``tests/test_precond.py`` (12² Laplacian,
  four pairs), fewer iterations than plain LOBPCG, equal eigenvalues.

Inputs: a 10² convection–diffusion operator and 10²–16² Laplacians,
f64, from seeds with numpy.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sprs_tpu as st
from sprs_tpu.linalg import Ldl as JLdl
from sprs_tpu.linalg import cg as j_cg
from sprs_tpu.linalg import ic0 as j_ic0
from sprs_tpu.linalg import refine_solve as j_refine_solve
from sprs_tpu.linalg import solve as j_solve
from sprs_tpu_torch.interop import from_arrays
from sprs_tpu_torch.linalg import Ldl, ic0, lobpcg, refine_solve, solve, splu
from sprs_tpu_torch.linalg.solve import resolve_method
from sprs_tpu_torch.ops import prod

jax.config.update("jax_enable_x64", True)

BE_FLOOR = 1e-15


def port_of(m):
    return from_arrays("csmat", m.shape, (np.asarray(m.indptr), np.asarray(m.indices),
                                          np.asarray(m.data)), storage=m.storage, device="cpu")


def convection_diffusion(side=10, c=0.4):
    i = st.eye(side, np.float64)
    d = st.diags([1.0, -1.0], [0, -1], (side, side))
    return st.utils.dirichlet_laplacian((side, side)) + (
        st.kronecker_product(i, d) + st.kronecker_product(d, i)) * c


def f32(m):
    return st.csmat(m.shape, m.indptr, m.indices, np.asarray(m.data, np.float32),
                    storage="csr", validate=False)


@pytest.mark.parametrize("steps,rtol", [(3, 0.0), (4, 1e-14), (0, 0.0)])
@pytest.mark.parametrize("fill", ["nd", "rcm"])
def test_refine_solve_matches_jax(fill, steps, rtol):
    a = st.utils.dirichlet_laplacian((12, 12))
    b = np.linspace(1.0, 2.0, 144)
    j_num = JLdl().fill_in_reduction(fill).check_symmetry(False).numeric(f32(a))
    num = Ldl().fill_in_reduction(fill).check_symmetry(False).numeric(port_of(f32(a)))
    xj, ij = j_refine_solve(a, j_num, b, steps=steps, rtol=rtol)
    xp, ip = refine_solve(port_of(a), num, b, steps=steps, rtol=rtol)
    assert xp.dtype == torch.float64 and xp.device.type == "cpu"
    np.testing.assert_allclose(xp.numpy(), xj, rtol=1e-12)
    assert len(ip["backward_errors"]) == len(ij["backward_errors"])
    np.testing.assert_allclose(ip["backward_errors"], ij["backward_errors"], rtol=1e-6,
                               atol=BE_FLOOR)


def test_refine_solve_callable_counts_products(monkeypatch):
    """A callable solve; one f64 product per backward error."""
    a = port_of(convection_diffusion())
    lu = splu(a)
    calls = [0]
    real = prod.prepare_spmv

    def counting(mat):
        fn, prepared = real(mat)
        assert mat.dtype == torch.float64

        def run(p, x):
            calls[0] += 1
            return fn(p, x)

        return run, prepared

    monkeypatch.setattr(prod, "prepare_spmv", counting)
    x, info = refine_solve(a, lu.solve, np.ones(100), steps=2)
    assert calls[0] == len(info["backward_errors"]) == 3
    assert info["backward_errors"][-1] < 1e-14


METHODS = {
    "ldl": (lambda: st.utils.dirichlet_laplacian((10, 10)), {}),
    "lu": (convection_diffusion, {}),
    "cg": (lambda: st.utils.dirichlet_laplacian((10, 10)), {"tol": 1e-13}),
    "bicgstab": (convection_diffusion, {"tol": 1e-13}),
    "gmres": (convection_diffusion, {"tol": 1e-13, "restart": 20}),
}


@pytest.mark.parametrize("method", list(METHODS) + ["auto"])
def test_solve_and_gradients_match_jax(method):
    make, kw = METHODS.get(method, METHODS["lu"])
    m = make()
    b = np.random.default_rng(6).standard_normal(m.shape[0])

    def j_loss(data, bb):
        mm = st.CsMat(m.indptr, m.indices, data, m.shape, m.storage)
        return jnp.sum(jnp.sin(j_solve(mm, bb, method=method, **kw)))

    if method in ("lu", "auto"):
        # the JAX solve takes no traced matrix values on its LU path
        g_b = jax.grad(lambda bb: j_loss(m.data, bb))(jnp.asarray(b))
        d = np.asarray(m.to_dense())
        xd = np.linalg.solve(d, b)
        lam = np.linalg.solve(d.T, np.cos(xd))
        nnz = int(m.nnz)
        rows = np.repeat(np.arange(m.shape[0]), np.diff(np.asarray(m.indptr)))
        g_data = np.zeros(m.cap)
        g_data[:nnz] = -lam[rows] * xd[np.asarray(m.indices)[:nnz]]
    else:
        g_data, g_b = jax.grad(j_loss, argnums=(0, 1))(m.data, jnp.asarray(b))
    want_x = np.asarray(j_solve(m, b, method=method, **kw))

    pm = port_of(m)
    data = pm.data.clone().requires_grad_(True)
    bt = torch.from_numpy(b).requires_grad_(True)
    x = solve(pm.with_data(data), bt, method=method, **kw)
    np.testing.assert_allclose(x.detach().numpy(), want_x, rtol=1e-10,
                               atol=1e-10 * np.abs(want_x).max())
    # the graph holds the solve's own node and the two leaves only
    assert type(x.grad_fn).__name__ == "_SolveBackward"
    assert {type(f).__name__ for f, _ in x.grad_fn.next_functions} == {"AccumulateGrad"}
    torch.sin(x).sum().backward()
    for got, want in ((data.grad, g_data), (bt.grad, g_b)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-10, atol=1e-10 * np.abs(want).max())


def test_solve_picks_method_and_block_rhs():
    lap = port_of(st.utils.dirichlet_laplacian((10, 10)))
    assert resolve_method(lap) == "ldl"
    assert resolve_method(port_of(convection_diffusion())) == "lu"
    assert resolve_method(lap, "cg") == "cg"
    b = np.random.default_rng(7).standard_normal((100, 3))
    x = solve(lap, torch.from_numpy(b))
    d = lap.to_dense().numpy()
    np.testing.assert_allclose(x.numpy(), np.linalg.solve(d, b), rtol=1e-10)
    xc = solve(lap, torch.from_numpy(b), method="cg", tol=1e-13)
    np.testing.assert_allclose(xc.numpy(), x.numpy(), rtol=1e-9, atol=1e-11)
    with pytest.raises(ValueError, match="unknown solve method"):
        solve(lap, b, method="qr")
    with pytest.raises(TypeError, match="unknown solve options"):
        solve(lap, b, method="cg", bogus=1)


def test_ic0_lobpcg():
    """tests/test_precond.py's IC(0)-preconditioned LOBPCG case."""
    from sprs_tpu.linalg import lobpcg as j_lobpcg

    lap = st.utils.dirichlet_laplacian((12, 12), dtype=np.float64)
    x0 = np.random.default_rng(1).standard_normal((144, 4))
    plain = lobpcg(port_of(lap), x0, tol=1e-8, max_iter=300)
    pre = lobpcg(port_of(lap), x0, tol=1e-8, max_iter=300, precond=ic0(port_of(lap)))
    j_pre = j_lobpcg(lap, x0, tol=1e-8, max_iter=300, precond=j_ic0(lap))
    assert plain.converged and pre.converged
    assert pre.iterations < plain.iterations
    assert pre.iterations == j_pre.iterations
    np.testing.assert_allclose(pre.eigenvalues.numpy(), plain.eigenvalues.numpy(), rtol=1e-6)
    np.testing.assert_allclose(pre.eigenvalues.numpy(), np.asarray(j_pre.eigenvalues),
                               rtol=1e-10)


def test_example_preconditioned_solve(capsys):
    from sprs_tpu_torch.examples import preconditioned_solve

    out = preconditioned_solve.main(["12", "--device", "cpu"])
    lap = st.utils.dirichlet_laplacian((12, 12), dtype=np.float64)
    b = np.ones(144)
    for key, pre in (("cg", None), ("ic0_cg", j_ic0(lap))):
        want = j_cg(lap, b, tol=1e-8, max_iter=4 * 144, precond=pre)
        assert out[key].iterations == int(want.iterations)
    for plain, pre in (("cg", "ic0_cg"), ("bicgstab", "ilu0_bicgstab"),
                       ("lobpcg", "ic0_lobpcg")):
        assert out[pre].converged and out[pre].iterations < out[plain].iterations
    assert "ic0-pcg" in capsys.readouterr().out


def test_example_mixed_precision_refinement():
    from sprs_tpu_torch.examples import mixed_precision_refinement

    errs = mixed_precision_refinement.main(["12", "--device", "cpu"])
    assert errs[0] > 1e-10 and errs[-1] < 1e-12


def test_example_fill_in_reduction():
    from sprs_tpu_torch.examples import fill_in_reduction

    out = fill_in_reduction.main(["40", "--device", "cpu"])
    assert out["rcm_bandwidth"] < out["bandwidth"]
    assert out["min-degree"][0] < out["none"][0]
    for name in ("none", "rcm", "min-degree"):
        assert out[name][1] < 1e-12
    num = JLdl().fill_in_reduction("camd").numeric(
        st.from_dense(fill_in_reduction.random_spd(40)))
    assert out["min-degree"][0] == int(num.l().nnz)


@pytest.mark.gpu
def test_refine_and_solve_on_card():
    """refine_solve's f64 residual and solve on a CUDA matrix."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    a = st.utils.dirichlet_laplacian((16, 16))
    card = from_arrays("csmat", a.shape, (np.asarray(a.indptr), np.asarray(a.indices),
                                          np.asarray(a.data)), device="cuda")
    num = Ldl().fill_in_reduction("nd").check_symmetry(False).numeric(card.astype(torch.float32))
    b = np.linspace(1.0, 2.0, 256)
    x, info = refine_solve(card, num, b, steps=3)
    assert x.device.type == "cuda" and info["backward_errors"][-1] < 1e-14
    xs = solve(card, torch.from_numpy(b).cuda())
    np.testing.assert_allclose(xs.cpu().numpy(), x.cpu().numpy(), rtol=1e-10)
