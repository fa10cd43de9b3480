"""The paths that every (data, x) type pair of float16, bfloat16, float32
and float64 opens in the port, against the JAX package on the CPU: the
routes of ``prepare_spmv`` / ``prepare_spmm`` and their output types, the
backwards of K1, K2 and K5, float64 solvers over float32-stored and
float32 solvers over float16-stored operators, and the bfloat16 host
paths (factorizations, sharding, the sparse right-hand-side solve).

Tolerances, relative to the largest entry: one 16-bit step where two
computations of a 16-bit result may round apart (the JAX XLA products
round each partial sum, the port's kernels once), 1e-6 for float32 and
1e-13 for float64 (sums in other orders).  The JAX VJPs of the Pallas
kernels raise where a cotangent's type is not its primal's (K1 and K2
where promote(data, x) is wider than x, K5 wherever data and x differ);
there the port's backward is held to torch's autograd of the plain
version.  The JAX host paths compute bfloat16 factors in bfloat16 steps,
the port's in float32 or float64 rounded once: the factors agree within
one bfloat16 step of the largest entry, the solves within the 5e-2 of
the bfloat16 tolerance table (tests/test_torch_dtypes.py).
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import sprs_tpu as st
import sprs_tpu_torch as pt
from sprs_tpu.formats.csvec import csvec as jax_csvec
from sprs_tpu.linalg import cg as jax_cg
from sprs_tpu.linalg import expm_multiply as jax_expm
from sprs_tpu.linalg import ic0 as jax_ic0
from sprs_tpu.linalg import ilu0 as jax_ilu0
from sprs_tpu.linalg import splu as jax_splu
from sprs_tpu.linalg.trisolve import lsolve_csc_sparse_rhs as jax_lsolve_sparse
from sprs_tpu.ops.pallas import dia_spmm_pallas, dia_spmv_pallas, ell_spmv_pallas
from sprs_tpu.ops.prod import prepare_spmm as jax_prepare_spmm
from sprs_tpu.ops.prod import prepare_spmv as jax_prepare_spmv
from sprs_tpu.parallel import dist as jax_dist
from sprs_tpu.parallel import halo as jax_halo
from sprs_tpu.parallel import precond as jax_precond
from sprs_tpu.utils.special import dirichlet_laplacian as jax_dirichlet
from sprs_tpu.utils.special import grid_laplacian as jax_grid
from sprs_tpu_torch.formats.csvec import csvec
from sprs_tpu_torch.formats.dia import DiaMat
from sprs_tpu_torch.formats.ell import EllMat
from sprs_tpu_torch.linalg import cg, expm_multiply, ic0, ilu0, splu
from sprs_tpu_torch.linalg.trisolve import lsolve_csc_sparse_rhs
from sprs_tpu_torch.ops.cuda import dia_spmm as k2
from sprs_tpu_torch.ops.cuda import dia_spmv as k1
from sprs_tpu_torch.ops.cuda import ell_spmv as k5
from sprs_tpu_torch.ops.cuda.forms import FORMS
from sprs_tpu_torch.parallel import dist, halo, precond
from sprs_tpu_torch.utils import dirichlet_laplacian, grid_laplacian
from tests.test_torch_forms import NP, as_f64, band, draw, random_dense, t_of

F16, BF, F32, F64 = torch.float16, torch.bfloat16, torch.float32, torch.float64
PAIRS = list(FORMS)
IDS = list(FORMS.values())
# one 16-bit step at the largest entry where two roundings may part
LIMIT = {BF: 2.0**-7, F16: 2.0**-10, F32: 1e-6, F64: 1e-13}
BF16_RTOL = 5e-2
ROUTE = {"DiaTiledMat": "dia", "DiaMat": "dia", "EllMat": "ell", "CsMat": "csr"}


def close(got, want, dtype, mask=None):
    g, w = as_f64(got), as_f64(want)
    assert g.shape == w.shape
    if mask is not None:
        g, w = g[mask], w[mask]
    np.testing.assert_allclose(g, w, rtol=0, atol=LIMIT[dtype] * max(np.abs(w).max(), 1e-300))


# -- routes and output types -----------------------------------------------------


@pytest.mark.parametrize("data, x", PAIRS, ids=IDS)
def test_routes_and_output_types_equal_jax(data, x):
    """A band (DIA) and a random matrix (ELL) in ``data`` through both
    packages' ``prepare_spmv`` and ``prepare_spmm`` with ``x``: the same
    route, the output type promote(data, x), values within one output
    rounding (the JAX DIA arm on the CPU is its XLA product)."""
    out = torch.promote_types(data, x)
    for dense in (band(64, 31), random_dense(48, 40, 0.1, 32)):
        dense = dense.astype(NP[data]).astype(np.float64)  # exact in ``data``
        jm = st.from_dense(dense).astype(NP[data])
        tm = pt.from_dense(dense, device="cpu").astype(data)
        for k, (jprep, tprep) in enumerate(((jax_prepare_spmv, pt.prepare_spmv),
                                            (jax_prepare_spmm, pt.prepare_spmm))):
            v = draw((dense.shape[1],) + ((4,) if k else ()), x, 33 + k)
            jfn, jp = jprep(jm)
            tfn, tp = tprep(tm)
            assert ROUTE[type(jp).__name__] == ROUTE[type(tp).__name__]
            want = jfn(jp, jnp.asarray(v))
            got = tfn(tp, t_of(v))
            assert got.dtype == out and np.dtype(want.dtype) == np.dtype(NP[out])
            # the JAX XLA product may round k partial sums where the
            # kernel rounds once
            close(got, want, out) if out.itemsize > 2 else np.testing.assert_allclose(
                as_f64(got), as_f64(want), rtol=0, atol=8 * LIMIT[out] * np.abs(as_f64(want)).max())


# -- the backwards ------------------------------------------------------------------


def grads_of(fn, make, data, v, g):
    d = data.clone().requires_grad_(True)
    xv = v.clone().requires_grad_(True)
    return torch.autograd.grad(fn(make(d), xv), (d, xv), g)


@pytest.mark.parametrize("kernel", ["K1", "K2", "K5"])
@pytest.mark.parametrize("data, x", PAIRS, ids=IDS)
def test_backward_types_and_values(kernel, data, x):
    """ddata in the data's type and dx in x's; against jax.grad through
    the Pallas kernel where the JAX VJP runs for the pair, else against
    torch's autograd of the plain version."""
    out = torch.promote_types(data, x)
    if kernel == "K5":
        je = st.from_dense(random_dense(30, 24, 0.2, 41)).to_ell()
        je = type(je)(je.indices, je.data.astype(NP[data]), je.shape)
        t_idx = torch.from_numpy(np.array(je.indices))
        tdata = t_of(np.asarray(je.data))
        v = draw(24, x, 42)
        make = lambda d: EllMat(t_idx, d, je.shape)  # noqa: E731
        jmake = lambda d: type(je)(je.indices, d, je.shape)  # noqa: E731
        fn, plain, jfn = k5.ell_spmv_kernel, k5.ell_spmv_plain, ell_spmv_pallas
        rows, runs, jdata = 30, data == x, je.data
    else:
        jd = st.from_dense(band(40, 43)).to_dia()
        jd = type(jd)(jd.data.astype(NP[data]), jd.offsets, jd.shape)
        tdata = t_of(np.asarray(jd.data))
        v = draw(40 if kernel == "K1" else (40, 3), x, 44)
        make = lambda d: DiaMat(d, tuple(jd.offsets), tuple(jd.shape))  # noqa: E731
        jmake = lambda d: type(jd)(d, jd.offsets, jd.shape)  # noqa: E731
        if kernel == "K1":
            fn, plain = k1.dia_spmv_kernel, k1.dia_spmv_plain
            jfn = lambda m, w, interpret: dia_spmv_pallas(m, w, variant="flat", interpret=interpret)  # noqa: E731
        else:
            fn, plain, jfn = k2.dia_spmm_kernel, k2.dia_spmm_plain, dia_spmm_pallas
        rows, runs, jdata = 40, out == x, jd.data
    gcot = np.random.default_rng(45).standard_normal((rows,) + v.shape[1:])
    g = t_of(gcot.astype(NP[out]))
    dd, dx = grads_of(fn, make, tdata, t_of(v), g)
    assert dd.dtype == data and dx.dtype == x
    live = as_f64(tdata) != 0

    def loss(d, w):
        return jnp.sum(jfn(jmake(d), w, interpret=True).astype(jnp.float64) * gcot)

    try:
        want = jax.grad(loss, argnums=(0, 1))(jdata, jnp.asarray(v))
    except (TypeError, ValueError, FutureWarning):
        assert not runs, "the JAX VJP raised where it should run"
        want = grads_of(plain, make, tdata, t_of(v), g)
    else:
        assert runs, "the JAX VJP ran where a cotangent's type is not its primal's"
        assert np.dtype(want[0].dtype) == np.dtype(NP[data]) and np.dtype(want[1].dtype) == np.dtype(NP[x])
    close(dd, want[0], data, live)
    close(dx, want[1], x)


# -- float64 solvers over float32 storage, float32 over float16 ---------------------


@pytest.mark.parametrize("stored, vec", [(F32, F64), (F16, F32)], ids=["f32_f64", "f16_f32"])
def test_cg_over_a_narrower_operator_matches_jax(stored, vec):
    """CG over the 32² Dirichlet Laplacian stored in ``stored`` (its
    entries, 4 and -1, are exact) with b in ``vec``: x in ``vec``, the
    JAX package's iteration count, x bit-equal to the port's CG over the
    operator stored in ``vec`` and within a few roundings of the JAX x.
    The float32 solve stops at 1e-5, as on the card (phase 5k): below
    about 1e-6 its recursive residual is rounding, and the two packages'
    dot products, summed in other orders, stop it on other iterations."""
    tol = 1e-8 if vec == F64 else 1e-5
    b = np.random.default_rng(46).standard_normal(32 * 32).astype(NP[vec])
    want = jax_cg(jax_dirichlet((32, 32)).astype(NP[stored]), jnp.asarray(b), tol=tol)
    got = cg(dirichlet_laplacian((32, 32), stored, device="cpu"), torch.from_numpy(b), tol=tol)
    same = cg(dirichlet_laplacian((32, 32), vec, device="cpu"), torch.from_numpy(b), tol=tol)
    assert got.converged and got.x.dtype == vec and np.dtype(want.x.dtype) == np.dtype(NP[vec])
    assert got.iterations == int(want.iterations) == same.iterations
    assert torch.equal(got.x, same.x)
    w = as_f64(want.x)
    np.testing.assert_allclose(as_f64(got.x), w, rtol=0, atol=(1e-10 if vec == F64 else 1e-6) * np.abs(w).max())


@pytest.mark.parametrize("stored, vec", [(F32, F64), (F16, F32)], ids=["f32_f64", "f16_f32"])
def test_expm_over_a_narrower_operator(stored, vec):
    """Block ``expm_multiply`` over the 16² grid Laplacian stored in
    ``stored`` with sources in ``vec``: bit-equal to the same call over
    the operator stored in ``vec``, and within a few roundings of the JAX
    package's."""
    n = 16 * 16
    B = np.zeros((n, 3), NP[vec])
    B[[5, 100, 200], [0, 1, 2]] = 1.0
    got = expm_multiply(grid_laplacian((16, 16), stored, device="cpu"), torch.from_numpy(B), t=-1.0)
    same = expm_multiply(grid_laplacian((16, 16), vec, device="cpu"), torch.from_numpy(B), t=-1.0)
    assert got.dtype == vec and torch.equal(got, same)
    want = np.asarray(jax_expm(jax_grid((16, 16)).astype(NP[stored]), jnp.asarray(B), t=-1.0))
    assert want.dtype == NP[vec]
    np.testing.assert_allclose(as_f64(got), want, rtol=0, atol=1e-12 if vec == F64 else 1e-6)


# -- the bfloat16 host paths ---------------------------------------------------------


@pytest.fixture(scope="module")
def bf16_laplacians():
    """The 8² Dirichlet Laplacian in bfloat16 (exact) in both packages."""
    return (jax_dirichlet((8, 8)).astype(jnp.bfloat16),
            dirichlet_laplacian((8, 8), BF, device="cpu"))


def factors_close(got, want):
    assert got.dtype == BF and np.dtype(want.dtype) == np.dtype(ml_dtypes.bfloat16)
    close(got.to_dense(), want.to_dense(), BF)


def rhs():
    return np.random.default_rng(47).standard_normal(64).astype(np.float32)


def solves_close(got, want):
    assert got.dtype == F32 and np.dtype(want.dtype) == np.float32
    w = as_f64(want)
    np.testing.assert_allclose(as_f64(got), w, rtol=0, atol=BF16_RTOL * np.abs(w).max())


def test_splu_bf16_equals_jax(bf16_laplacians):
    jm, tm = bf16_laplacians
    j, t = jax_splu(jm), splu(tm)
    factors_close(t._l, j._l)
    factors_close(t._u, j._u)
    assert t.scale.dtype == BF
    close(t.scale, j.scale, BF)
    np.testing.assert_array_equal(t.row_perm.perm.numpy(), np.asarray(j.row_perm.perm))
    solves_close(t.solve(torch.from_numpy(rhs())), j.solve(jnp.asarray(rhs())))


@pytest.mark.parametrize("factor, jax_factor, parts", [(ilu0, jax_ilu0, ("l", "u")), (ic0, jax_ic0, ("l", "lt"))],
                         ids=["ilu0", "ic0"])
def test_incomplete_factors_bf16_equal_jax(bf16_laplacians, factor, jax_factor, parts):
    jm, tm = bf16_laplacians
    j, t = jax_factor(jm), factor(tm)
    for part in parts:
        factors_close(getattr(t, part), getattr(j, part))
    solves_close(t.solve(torch.from_numpy(rhs())), j.solve(jnp.asarray(rhs())))


def test_block_jacobi_ldl_bf16_equals_jax(bf16_laplacians):
    jm, tm = bf16_laplacians
    j, t = jax_precond.block_jacobi_ldl(jm, 4), precond.block_jacobi_ldl(tm, 4)
    for got, want in ((t.panels, j.panels), (t.d, j.d)):
        assert got.dtype == BF and np.dtype(want.dtype) == np.dtype(ml_dtypes.bfloat16)
        close(got, want, BF)
    solves_close(t(torch.from_numpy(rhs())), j(jnp.asarray(rhs())))


def test_shards_bf16_equal_jax(bf16_laplacians):
    """The row, 2-D and halo shards keep the bfloat16 values, bit for
    bit."""
    jm, tm = bf16_laplacians
    rows = dist.shard_csr_rows(tm, 4)
    (grid, cols), (jgrid, jcols) = dist.shard_csr_2d(tm, (2, 2)), jax_dist.shard_csr_2d(jm, (2, 2))
    halos = halo.shard_csr_rows_halo(tm, 4)
    for got, want in ((torch.stack(list(rows.data)), jax_dist.shard_csr_rows(jm, 4).data),
                      (torch.stack([torch.stack(list(r)) for r in grid.data]), jgrid.data),
                      (torch.stack(list(halos.data)), jax_halo.shard_csr_rows_halo(jm, 4).data)):
        assert got.dtype == BF and np.dtype(want.dtype) == np.dtype(ml_dtypes.bfloat16)
        np.testing.assert_array_equal(as_f64(got), as_f64(want))
    assert cols == jcols
    split = halo.shard_csr_rows_halo_split(tm, 4)
    assert split.int_data[0].dtype == split.bnd_data[0].dtype == BF


def test_sparse_rhs_lower_solve_bf16_equals_jax(bf16_laplacians):
    """The result takes b's type, as the JAX package's does."""
    lower = np.tril(np.asarray(bf16_laplacians[0].to_dense(), np.float32))
    jl = st.from_dense(lower).astype(jnp.bfloat16)
    tl = pt.from_dense(lower, device="cpu").astype(BF)
    idx, val = np.array([3, 10]), np.array([1.0, -2.0], np.float32)
    want = jax_lsolve_sparse(jl, jax_csvec(64, idx, val.astype(ml_dtypes.bfloat16)))
    got = lsolve_csc_sparse_rhs(tl, csvec(64, idx, torch.from_numpy(val).to(BF), device="cpu"))
    assert got.data.dtype == BF and np.dtype(want.data.dtype) == np.dtype(ml_dtypes.bfloat16)
    assert got.nnz == int(want.nnz)
    np.testing.assert_array_equal(got.indices[: got.nnz].numpy(), np.asarray(want.indices)[: int(want.nnz)])
    close(got.data[: got.nnz], np.asarray(want.data)[: int(want.nnz)], BF)
