"""``CsVec`` of the PyTorch port against the JAX package's
``sprs_tpu.formats.csvec``: constructors, the merge binops, ``dot``, the
row and column views, access, ``iter_perm`` and the norms.

Tolerances: indices, nnz and capacity equal; float64 data equal; ``dot``
and the norms within 1e-15 relative (another summation order).
"""

import numpy as np
import pytest
import torch

import sprs_tpu as st
import sprs_tpu_torch as ts
from sprs_tpu_torch.errors import CapacityError, ShapeError, StructureError
from sprs_tpu_torch.interop import from_arrays

DIM = 11


def port_of(v):
    return from_arrays("csvec", (v.dim,), (np.asarray(v.indices), np.asarray(v.data), int(v.nnz)),
                       device="cpu")


def assert_same(port, jax_vec):
    assert port.dim == jax_vec.dim and port.cap == jax_vec.cap and port.nnz == int(jax_vec.nnz)
    np.testing.assert_array_equal(port.indices.numpy(), np.asarray(jax_vec.indices))
    np.testing.assert_array_equal(port.data.numpy(), np.asarray(jax_vec.data))


def operands():
    """Two vectors with overlapping supports, one with padding slots."""
    a = st.csvec(DIM, [0, 3, 4, 9], [1.5, -2.0, 0.5, 4.0], cap=6)
    b = st.csvec(DIM, [3, 5, 9, 10], [1.0, 2.0, -4.0, 3.0])
    return a, b


def test_constructors():
    idx, val = [1, 4, 7], [2.0, -1.0, 3.0]
    assert_same(ts.csvec(DIM, idx, val, device="cpu"), st.csvec(DIM, idx, val))
    assert_same(ts.csvec(DIM, idx, val, cap=5, device="cpu"), st.csvec(DIM, idx, val, cap=5))
    with pytest.raises(StructureError):
        ts.csvec(DIM, [4, 1], [1.0, 2.0], device="cpu")
    with pytest.raises(StructureError):
        ts.csvec(DIM, [1, DIM], [1.0, 2.0], device="cpu")
    uidx, uval = [7, 1, 7, 4], [1.0, 2.0, 0.5, -3.0]  # a duplicate, summed
    assert_same(ts.csvec_from_unsorted(DIM, uidx, uval, device="cpu"),
                st.csvec_from_unsorted(DIM, uidx, uval))
    x = np.array([0.0, 0.3, -2.0, 0.0, 0.05, 1.0, 0.0, 0.0, -0.2, 0.0, 4.0])
    for eps in (0.0, 0.1):
        assert_same(ts.csvec_from_dense(x, eps=eps, device="cpu"), st.csvec_from_dense(x, eps=eps))
    assert_same(ts.empty_csvec(DIM, torch.float64, cap=3, device="cpu"),
                st.empty_csvec(DIM, np.float64, cap=3))


@pytest.mark.parametrize("op", ["add", "sub", "mul"])
def test_binops(op):
    a, b = operands()
    ta, tb = port_of(a), port_of(b)
    fn = {"add": lambda x, y: x + y, "sub": lambda x, y: x - y, "mul": lambda x, y: x * y}[op]
    assert_same(fn(ta, tb), fn(a, b))
    assert_same(ta._binop(tb, torch.add, out_cap=8), a._binop(b, np.add, out_cap=8))
    with pytest.raises(CapacityError):
        ta._binop(tb, torch.add, out_cap=5)
    with pytest.raises(ShapeError):
        ta + port_of(st.csvec(DIM + 1, [0], [1.0]))
    if op != "mul":  # a dense operand gives a dense result
        dense = np.arange(DIM, dtype=np.float64)
        np.testing.assert_array_equal(fn(ta, dense).numpy(), np.asarray(fn(a, dense)))


def test_dot_views_and_access():
    a, b = operands()
    ta, tb = port_of(a), port_of(b)
    for got, want in ((ta.dot(tb), a.dot(b)), (tb.dot(ta), b.dot(a)), (ta @ tb, a @ b)):
        np.testing.assert_allclose(float(got), float(want), rtol=1e-15)
    dense = np.linspace(-1.0, 2.0, DIM)
    np.testing.assert_allclose(float(ta.dot(dense)), float(a.dot(dense)), rtol=1e-15)
    with pytest.raises(ShapeError):
        ta.dot(np.ones(DIM + 1))
    for got, want in ((ta.row_view(), a.row_view()), (ta.col_view(), a.col_view())):
        assert got.shape == want.shape and got.storage == want.storage
        for g, w in zip((got.indptr, got.indices, got.data), (want.indptr, want.indices, want.data)):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(ta.to_dense().numpy(), np.asarray(a.to_dense()))
    for i in (0, 2, 9, 10):
        assert float(ta[i]) == float(a[i])
        assert int(ta.nnz_index(i)) == int(a.nnz_index(i))
    assert ta.to_set() == a.to_set()
    perm = np.random.default_rng(3).permutation(DIM)
    assert list(ta.iter_perm(perm)) == list(a.iter_perm(perm))
    assert list(ta.iter_perm(ts.Permutation.from_array(perm, device="cpu"))) == list(
        a.iter_perm(st.Permutation.from_array(perm)))


def test_norms_and_maps():
    a, _ = operands()
    ta = port_of(a)
    for p in (1, 2, 3, np.inf, -np.inf, 0):
        np.testing.assert_allclose(float(ta.norm(p)), float(a.norm(p)), rtol=1e-15)
    for name in ("squared_l2_norm", "l2_norm", "l1_norm", "sum", "mean"):
        np.testing.assert_allclose(float(getattr(ta, name)()), float(getattr(a, name)()), rtol=1e-15)
    assert_same(ta.unit_normalize(), a.unit_normalize())
    assert_same(-ta, -a)
    assert_same(ta / 4.0, a / 4.0)
    assert_same(3.0 * ta, 3.0 * a)
