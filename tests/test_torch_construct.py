"""Sparse construction of the PyTorch port against the JAX package:
``vstack``, ``hstack``, ``bmat``, ``block_diag``, ``kronecker_product``,
``is_symmetric``, ``Permutation`` and the four permuted transforms.

Tolerances: indptr, indices, shape, storage and capacity equal; float64
data equal (each output entry is one input entry, or one product for the
Kronecker product).
"""

import numpy as np
import pytest
import torch

import sprs_tpu as st
import sprs_tpu_torch as ts
from sprs_tpu_torch.errors import ShapeError, StructureError
from sprs_tpu_torch.interop import from_arrays


def port_of(m):
    return from_arrays(
        "csmat", m.shape, (np.asarray(m.indptr), np.asarray(m.indices), np.asarray(m.data)),
        storage=m.storage, device="cpu",
    )


def assert_same(port, jax_mat):
    assert port.shape == tuple(jax_mat.shape) and port.storage == jax_mat.storage
    assert port.cap == jax_mat.cap
    np.testing.assert_array_equal(port.indptr.numpy(), np.asarray(jax_mat.indptr))
    np.testing.assert_array_equal(port.indices.numpy(), np.asarray(jax_mat.indices))
    np.testing.assert_array_equal(port.data.numpy(), np.asarray(jax_mat.data))


def rand(shape, seed, *, storage="csr", pad=0):
    """Random matrix with an empty first row and ``pad`` padding slots."""
    rng = np.random.default_rng(seed)
    d = rng.standard_normal(shape)
    d[rng.random(shape) > 0.5] = 0.0
    d[0] = 0.0
    m = st.from_dense(d)
    m = m.with_cap(m.nnz + pad)
    return m if storage == "csr" else m.to_csc()


def test_stacks_and_blocks():
    a, b = rand((4, 5), 0, pad=2), rand((3, 5), 1, storage="csc")
    c = rand((4, 2), 2)
    ta, tb, tc = port_of(a), port_of(b), port_of(c)
    assert_same(ts.vstack([ta, tb]), st.vstack([a, b]))
    assert_same(ts.hstack([ta, tc]), st.hstack([a, c]))
    assert_same(ts.bmat([[ta, None], [tb, port_of(rand((3, 3), 3))]]),
                st.bmat([[a, None], [b, rand((3, 3), 3)]]))
    assert_same(ts.block_diag([ta, tb, tc]), st.ops.block_diag([a, b, c]))
    for bad in (lambda: ts.vstack([ta, tc]), lambda: ts.hstack([ta, tb]), lambda: ts.vstack([]),
                lambda: ts.bmat([[ta, None], [None, None]]), lambda: ts.bmat([[ta], [ta, tb]]),
                lambda: ts.bmat([[ta, tb]])):
        with pytest.raises(ShapeError):
            bad()


@pytest.mark.parametrize("storages", ["csr/csr", "csc/csr"])
def test_kronecker_product_rectangular(storages):
    sa, sb = storages.split("/")
    a, b = rand((3, 4), 4, storage=sa, pad=1), rand((2, 5), 5, storage=sb)
    assert_same(ts.kronecker_product(port_of(a), port_of(b)), st.kronecker_product(a, b))
    assert_same(ts.kronecker_product(port_of(a), port_of(b), out_cap=40),
                st.kronecker_product(a, b, out_cap=40))


def test_kronecker_sum_is_the_dirichlet_laplacian():
    """kron(I, T) + kron(T, I) = dirichlet_laplacian, entry for entry."""
    n = 5
    t = ts.diags([-1.0, 2.0, -1.0], [-1, 0, 1], (n, n), device="cpu")
    i = ts.eye(n, torch.float64, device="cpu")
    lap = ts.kronecker_product(i, t) + ts.kronecker_product(t, i)
    assert_same(lap, st.utils.dirichlet_laplacian((n, n)))


def test_is_symmetric():
    rng = np.random.default_rng(6)
    d = rng.standard_normal((6, 6))
    d[rng.random((6, 6)) > 0.4] = 0.0
    sym = d + d.T
    for dense, rtol, atol in ((sym, 0.0, 0.0), (d, 0.0, 0.0), (sym + np.triu(sym, 1) * 1e-9, 0.0, 0.0),
                              (sym + np.triu(sym, 1) * 1e-9, 1e-8, 0.0),
                              (sym + np.triu(sym != 0, 1) * 1e-9, 0.0, 1e-8)):
        m = st.from_dense(dense)
        assert ts.is_symmetric(port_of(m), rtol=rtol, atol=atol) == st.is_symmetric(m, rtol=rtol, atol=atol)
    assert ts.is_symmetric(port_of(st.from_dense(sym)).to_csc())
    assert not ts.is_symmetric(port_of(st.from_dense(np.ones((2, 3)))))


def test_permutation():
    p = np.random.default_rng(7).permutation(6)
    tp, jp = ts.Permutation.from_array(p, device="cpu"), st.Permutation.from_array(p)
    for got, want in ((tp.perm, jp.perm), (tp.inv, jp.inv), (tp.inverse().perm, jp.inverse().perm)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    x = np.arange(6.0) * 1.5
    np.testing.assert_array_equal((tp @ x).numpy(), np.asarray(jp @ x))
    np.testing.assert_array_equal(tp.apply_inv_vec(x).numpy(), np.asarray(jp.apply_inv_vec(x)))
    q = np.random.default_rng(8).permutation(6)
    comp = tp.compose(ts.Permutation.from_array(q, device="cpu"))
    np.testing.assert_array_equal(comp.perm.numpy(), np.asarray(jp.compose(st.Permutation.from_array(q)).perm))
    ident = ts.Permutation.identity(6, device="cpu")
    np.testing.assert_array_equal(ident.perm.numpy(), np.asarray(st.Permutation.identity(6).perm))
    moved = from_arrays("permutation", (6,), (np.asarray(jp.perm), np.asarray(jp.inv)), device="cpu")
    np.testing.assert_array_equal(moved.inv.numpy(), tp.inv.numpy())
    for bad in ([0, 0, 1], [0, 1, 3]):
        with pytest.raises(StructureError):
            ts.Permutation.from_array(bad, device="cpu")
        with pytest.raises(st.StructureError):
            st.Permutation.from_array(bad)


@pytest.mark.parametrize("storage", ["csr", "csc"])
def test_permuted_transforms(storage):
    rng = np.random.default_rng(9)
    sq = rand((6, 6), 10, storage=storage, pad=2)
    rect = rand((6, 4), 11, storage=storage)
    p, q = rng.permutation(6), rng.permutation(4)
    tp, jp = ts.Permutation.from_array(p, device="cpu"), st.Permutation.from_array(p)
    tq, jq = ts.Permutation.from_array(q, device="cpu"), st.Permutation.from_array(q)
    assert_same(ts.permute_rows(port_of(rect), tp), st.permute_rows(rect, jp))
    assert_same(ts.permute_cols(port_of(rect), tq), st.permute_cols(rect, jq))
    assert_same(ts.transform_mat_papt(port_of(sq), tp), st.transform_mat_papt(sq, jp))
    assert_same(ts.transform_mat_paq(port_of(rect), tp, tq), st.transform_mat_paq(rect, jp, jq))
    with pytest.raises(ShapeError):
        ts.transform_mat_papt(port_of(rect), tp)
    with pytest.raises(ShapeError):
        ts.permute_cols(port_of(rect), tp)
