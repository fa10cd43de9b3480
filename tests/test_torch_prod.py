"""Products and structure dispatch of the PyTorch port against the JAX
package: CSR/CSC SpMV and SpMM with capacity padding, X @ A, and the
format ``prepare_spmv`` / ``prepare_spmm`` pick for each matrix."""

import numpy as np
import pytest
import torch

import sprs_tpu as st
import sprs_tpu_torch as stt
from sprs_tpu.ops.prod import dense_matmul_sparse, prepare_spmm, prepare_spmv
from sprs_tpu_torch.interop import from_arrays


def random_sparse(r, c, density, seed):
    rng = np.random.default_rng(seed)
    d = rng.standard_normal((r, c))
    d[rng.random((r, c)) > density] = 0.0
    return d


def port_of(m):
    return from_arrays(
        "csmat",
        m.shape,
        (np.asarray(m.indptr), np.asarray(m.indices), np.asarray(m.data)),
        storage=m.storage,
        device="cpu",
    )


def matrices():
    d = random_sparse(11, 8, 0.35, 1)
    m = st.from_dense(d).with_cap(st.from_dense(d).cap + 5)  # padded
    return {"csr": m, "csc": m.to_csc(), "T": m.T, "empty_rows": st.from_dense(
        np.vstack([np.zeros((2, 8)), d[:4], np.zeros((3, 8))])
    )}


@pytest.mark.parametrize("name", ["csr", "csc", "T", "empty_rows"])
def test_spmv_spmm(name):
    m = matrices()[name]
    t = port_of(m)
    rng = np.random.default_rng(2)
    x = rng.standard_normal(m.cols)
    xm = rng.standard_normal((m.cols, 3))
    np.testing.assert_allclose(
        stt.spmv(t, torch.from_numpy(x)).numpy(), np.asarray(st.spmv(m, x)), rtol=1e-12
    )
    np.testing.assert_allclose(
        stt.spmm(t, torch.from_numpy(xm)).numpy(), np.asarray(st.spmm(m, xm)), rtol=1e-12
    )
    np.testing.assert_allclose(
        (t @ torch.from_numpy(x)).numpy(), np.asarray(m.to_dense()) @ x, rtol=1e-12
    )


@pytest.mark.parametrize("storage", ["csr", "csc"])
def test_index_sums_bit_equal_to_jax(storage):
    """The CSR and CSC products and the batched product sum by an
    accumulating ``index_put_`` (a fixed order on the card, where
    ``index_add_``'s atomics gave other bits from run to run): on the CPU
    the sums stay the JAX package's ``segment_sum``, bit for bit."""
    from sprs_tpu.ops.batch import batch_spmm as jax_batch_spmm
    from sprs_tpu.ops.batch import batch_spmv as jax_batch_spmv

    d = random_sparse(300, 250, 0.1, 7)
    m = st.from_dense(d) if storage == "csr" else st.from_dense(d).to_csc()
    t = port_of(m)
    rng = np.random.default_rng(8)
    x, xm = rng.standard_normal(250), rng.standard_normal((250, 6))
    vals = np.stack([np.asarray(m.data), 2.0 * np.asarray(m.data)])
    xb, xmb = rng.standard_normal((2, 250)), rng.standard_normal((2, 250, 3))
    for got, want in (
        (stt.spmv(t, torch.from_numpy(x)), st.spmv(m, x)),
        (stt.spmm(t, torch.from_numpy(xm)), st.spmm(m, xm)),
        (stt.ops.batch_spmv(t, vals, xb), jax_batch_spmv(m, vals, xb)),
        (stt.ops.batch_spmm(t, vals, xmb), jax_batch_spmm(m, vals, xmb)),
    ):
        np.testing.assert_array_equal(got.numpy().view(np.int64), np.asarray(want).view(np.int64))


@pytest.mark.parametrize("ndim", [1, 2])
def test_dense_matmul_sparse(ndim):
    m = matrices()["csr"]
    rng = np.random.default_rng(3)
    x = rng.standard_normal(m.rows if ndim == 1 else (4, m.rows))
    got = stt.dense_matmul_sparse(torch.from_numpy(x), port_of(m)).numpy()
    np.testing.assert_allclose(got, np.asarray(dense_matmul_sparse(x, m)), rtol=1e-12)


def routing_cases():
    rng = np.random.default_rng(4)
    n = 200
    band40 = np.zeros((n, n))
    for off in range(-20, 20):
        i = np.arange(max(0, -off), min(n, n - off))
        band40[i, i + off] = rng.standard_normal(i.size)
    # every row holds 6 entries at random columns: little ELL padding,
    # hundreds of diagonals
    ell_friendly = np.zeros((n, n))
    for r in range(n):
        ell_friendly[r, rng.choice(n, 6, replace=False)] = rng.standard_normal(6)
    # one dense row: ELL padding explodes, CSR it is
    skewed = ell_friendly.copy()
    skewed[0, :] = rng.standard_normal(n)
    return {
        "laplacian": st.utils.grid_laplacian((12, 12), dtype=np.float64),
        "band40": st.from_dense(band40),
        "ell_friendly": st.from_dense(ell_friendly),
        "skewed": st.from_dense(skewed),
    }


ROUTES = {
    "laplacian": ("DiaTiledMat", "DiaMat"),
    "band40": ("DiaTiledMat", "DiaMat"),
    "ell_friendly": ("EllMat", "EllMat"),
    "skewed": ("CsMat", "CsMat"),
}
# The port prepares a DIA operand once for both products (DiaTiledMat,
# a DiaMat that runs K1 or K2); the JAX package keeps a plain DiaMat for
# SpMM.  The route taken is the same.
PORT_SPMM = {"DiaMat": "DiaTiledMat"}


@pytest.mark.parametrize("name", sorted(ROUTES))
def test_routing_matches_jax(name):
    m = routing_cases()[name]
    t = port_of(m)
    spmv_kind, spmm_kind = ROUTES[name]
    x = np.random.default_rng(5).standard_normal(m.cols)
    xm = np.random.default_rng(6).standard_normal((m.cols, 3))

    # the port's SpMV route is the JAX package's TPU route (use_pallas);
    # values are compared with its compiled plain route
    _, j_prep = prepare_spmv(m, use_pallas=True)
    t_fn, t_prep = stt.prepare_spmv(t)
    assert type(j_prep).__name__ == type(t_prep).__name__ == spmv_kind
    j_fn, j_prep = prepare_spmv(m, use_pallas=False)
    np.testing.assert_allclose(
        t_fn(t_prep, torch.from_numpy(x)).numpy(),
        np.asarray(j_fn(j_prep, x)),
        rtol=1e-12,
        atol=1e-12,
    )

    j_fn, j_prep = prepare_spmm(m, use_pallas=False)
    t_fn, t_prep = stt.prepare_spmm(t)
    assert type(j_prep).__name__ == spmm_kind
    assert type(t_prep).__name__ == PORT_SPMM.get(spmm_kind, spmm_kind)
    np.testing.assert_allclose(
        t_fn(t_prep, torch.from_numpy(xm)).numpy(),
        np.asarray(j_fn(j_prep, xm)),
        rtol=1e-12,
        atol=1e-12,
    )


def test_shape_errors():
    t = port_of(matrices()["csr"])
    with pytest.raises(stt.ShapeError):
        stt.spmv(t, torch.zeros(t.cols + 1, dtype=torch.float64))
    with pytest.raises(stt.ShapeError):
        stt.spmm(t, torch.zeros(t.cols, dtype=torch.float64))
    with pytest.raises(stt.ShapeError):
        stt.dense_matmul_sparse(torch.zeros((2, t.rows + 1), dtype=torch.float64), t)
