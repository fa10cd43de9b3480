"""The rest of ``CsMat`` and the CsMat module functions of the PyTorch
port against the JAX package's ``sprs_tpu.formats.csmat``.

Operands hold an empty row, a stored zero and padding slots (cap above
nnz), in CSR and CSC.  Tolerances: indptr, indices, shape, storage and
capacity equal; float64 data equal, except ``sum``, ``mean`` and the
norms of ``allclose`` (1e-15 relative: the reductions run in another
order).
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import sprs_tpu as st
from sprs_tpu_torch.errors import ShapeError, StructureError
import sprs_tpu_torch as ts
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


def assert_same_vec(port, jax_vec):
    assert port.dim == jax_vec.dim and port.cap == jax_vec.cap and port.nnz == int(jax_vec.nnz)
    np.testing.assert_array_equal(port.indices.numpy(), np.asarray(jax_vec.indices))
    np.testing.assert_array_equal(port.data.numpy(), np.asarray(jax_vec.data))


def operand(storage, seed=0, shape=(9, 7)):
    """A random matrix with an empty row (2), an empty column (4), a
    stored zero and three padding slots."""
    rng = np.random.default_rng(seed)
    d = rng.standard_normal(shape)
    d[rng.random(shape) > 0.45] = 0.0
    d[2] = 0.0
    d[:, 4] = 0.0
    m = st.from_dense(d)
    m = m.with_data(m.data.at[1].set(0.0)).with_cap(m.nnz + 3)
    return m if storage == "csr" else m.to_csc()


STORAGES = ["csr", "csc"]


@pytest.mark.parametrize("storage", STORAGES)
def test_queries(storage):
    m = operand(storage)
    t = port_of(m)
    assert t.density == m.density
    for got, want in zip(t.coo_arrays(), m.coo_arrays()):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(t.degrees().numpy(), np.asarray(m.degrees()))
    for axis in (None, 0, 1):
        np.testing.assert_allclose(t.sum(axis).numpy(), np.asarray(m.sum(axis)), rtol=1e-15, atol=1e-15)
        np.testing.assert_allclose(t.mean(axis).numpy(), np.asarray(m.mean(axis)), rtol=1e-15, atol=1e-15)
    with pytest.raises(ValueError):
        t.sum(2)
    for r, c in ((0, 0), (2, 1), (8, 6)):
        assert float(t.get(r, c)) == float(m.get(r, c)) == float(t[r, c])
        assert int(t.nnz_index(r, c)) == int(m.nnz_index(r, c))
    with pytest.raises(TypeError):
        t[1]


@pytest.mark.parametrize("storage", STORAGES)
def test_onehot_structure_view_and_compact(storage):
    m = operand(storage, 1)
    t = port_of(m)
    assert_same(t.to_inner_onehot(), m.to_inner_onehot())
    assert_same(t.structure_view(), m.structure_view())
    assert t.structure_view().dtype == torch.int8
    assert_same(t.compact(), m.compact())
    assert_same(t.compact(out_cap=t.cap), m.compact(out_cap=m.cap))
    for k in (-1, 1):
        assert_same(t.tril(k), m.tril(k))
        assert_same(t.triu(k), m.triu(k))


@pytest.mark.parametrize("storage", STORAGES)
def test_slices_rows_and_vectors(storage):
    m = operand(storage, 2)
    t = port_of(m)
    for a, b in ((0, 3), (2, 3), (1, 1), (0, t.outer_dims)):
        assert_same(t.slice_outer(a, b), m.slice_outer(a, b))
    with pytest.raises(ShapeError):
        t.slice_outer(3, 2)
    blocks = list(t.outer_blocks(4))
    want = list(m.outer_blocks(4))
    assert [s for s, _ in blocks] == [s for s, _ in want]
    for (_, got), (_, w) in zip(blocks, want):
        assert_same(got, w)
    got = list(t.outer_vectors())
    assert [o for o, _ in got] == list(range(t.outer_dims))
    for o, w in list(m.outer_vectors())[1:3]:  # a populated and an empty one
        assert_same_vec(got[o][1], w)
    for i in (2, 8):
        assert_same_vec(t.row(i), m.row(i))
    for j in (4, 6):
        assert_same_vec(t.col(j), m.col(j))
    with pytest.raises(ShapeError):
        t.row(9)


@pytest.mark.parametrize("storage", STORAGES)
def test_host_edits(storage):
    m = operand(storage, 3)
    t = port_of(m)
    for r, c, v in ((0, 0, 7.5), (2, 3, -1.25), (8, 6, 2.0)):  # overwrite or new
        assert_same(t.insert(r, c, v), m.insert(r, c, v))
    with pytest.raises(ShapeError):
        t.insert(9, 0, 1.0)
    row = np.zeros(t.inner_dims)
    row[[0, 3]] = [1.5, -2.0]
    assert_same(t.append_outer(row), m.append_outer(row))
    with pytest.raises(ShapeError):
        t.append_outer(np.zeros(t.inner_dims + 1))
    assert_same(t.modify(lambda p, i, d: (p, i, d * 2)), m.modify(lambda p, i, d: (p, i, d * 2)))
    with pytest.raises(StructureError):
        t.modify(lambda p, i, d: (p, i.flip(0), d))


def test_elementwise_methods_and_allclose():
    a, b = operand("csr", 4), operand("csr", 5)
    ta, tb = port_of(a), port_of(b)
    assert_same(ta.multiply(tb), a.multiply(b))
    assert_same(ta.maximum(tb), a.maximum(b))
    assert_same(ta.minimum(tb), a.minimum(b))
    assert_same(ta / 4.0, a / 4.0)
    assert_same(3.0 * ta, 3.0 * a)
    with pytest.raises(TypeError):
        ta / tb
    dense = np.random.default_rng(6).standard_normal(a.shape)
    np.testing.assert_array_equal(ta.__radd__(dense).numpy(), np.asarray(a.__radd__(dense)))
    assert ta.allclose(ta.to_csc()) and a.allclose(a.to_csc())
    assert ta.allclose(ta * (1 + 1e-16))
    assert not ta.allclose(tb) and not a.allclose(b)
    assert not ta.allclose(port_of(st.from_dense(np.ones((2, 2)))))


@pytest.mark.parametrize("storage", STORAGES)
def test_scipy_round_trip(storage):
    m = operand(storage, 7)
    t = port_of(m)
    s = t.to_scipy()
    assert s.format == storage
    np.testing.assert_array_equal(s.toarray(), np.asarray(m.to_dense()))
    assert_same(ts.from_scipy(s, device="cpu"), st.from_scipy(s))
    assert_same(ts.from_scipy(s, storage="csr", cap=40, device="cpu"),
                st.from_scipy(s, storage="csr", cap=40))
    coo = sp.random(6, 5, density=0.4, format="coo", random_state=8)
    assert_same(ts.from_scipy(coo, device="cpu"), st.from_scipy(coo))


def test_module_constructors():
    indptr, indices, data = [0, 2, 2, 3], [0, 2, 1], [1.0, 2.0, 3.0]
    assert_same(ts.csr((3, 3), indptr, indices, data, device="cpu"),
                st.csr((3, 3), indptr, indices, data))
    assert_same(ts.csc((3, 3), indptr, indices, data, cap=5, device="cpu"),
                st.csc((3, 3), indptr, indices, data, cap=5))
    with pytest.raises(StructureError):
        ts.csr((3, 3), indptr, [2, 0, 1], data, device="cpu")
    for storage in STORAGES:
        assert_same(ts.empty((4, 3), torch.float64, storage=storage, cap=2, device="cpu"),
                    st.empty((4, 3), np.float64, storage=storage, cap=2))
    v = np.array([1.0, -2.0, 0.0, 4.0])
    assert_same(ts.diag_csmat(v, storage="csc", device="cpu"), st.diag_csmat(v, storage="csc"))
    cases = [
        (([-1.0, 2.0, -1.0], [-1, 0, 1], (6, 6)), {}),
        (([np.arange(1.0, 5.0), 3.0], [2, -1], None), {}),
        (([1.0, np.arange(1.0, 4.0)], [0, 2], (4, 5)), {"storage": "csc"}),
    ]
    for (diagonals, offsets, shape), kw in cases:
        assert_same(ts.diags(diagonals, offsets, shape, device="cpu", **kw),
                    st.diags(diagonals, offsets, shape, **kw))
    with pytest.raises(ShapeError):
        ts.diags([[1.0, 2.0]], [0], (4, 4), device="cpu")
    with pytest.raises(ShapeError):
        ts.diags([1.0], [5], (3, 3), device="cpu")
