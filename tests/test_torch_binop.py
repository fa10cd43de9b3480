"""Sparse elementwise operations of the PyTorch port against the JAX
package's ``sprs_tpu.ops``: ``eye``, ``scale``, ``+``, ``-``, ``*`` and the
other binary ops.

Tolerances: indptr and indices exactly equal; float64 data exactly equal
(each output entry is one operation on at most one value of each
operand, in the same order in both packages).
"""

import numpy as np
import pytest
import torch

import sprs_tpu as st
from sprs_tpu import ops as jops
from sprs_tpu.ops import binop as jbinop
from sprs_tpu_torch import ops as tops
from sprs_tpu_torch.errors import ShapeError
from sprs_tpu_torch.formats.csmat import eye
from sprs_tpu_torch.interop import from_arrays
from sprs_tpu_torch.ops import binop as tbinop


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


def operands(seed, shape=(9, 7)):
    """Two random matrices with overlapping patterns, an empty row, a stored
    zero in A, and padding slots (cap above nnz)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(2):
        d = rng.standard_normal(shape)
        d[rng.random(shape) > 0.4] = 0.0
        d[2] = 0.0
        out.append(st.from_dense(d).with_cap(int(np.count_nonzero(d)) + 3))
    a, b = out
    a = a.with_data(a.data.at[0].set(0.0))
    return a, b


@pytest.mark.parametrize("n,cap", [(1, None), (6, None), (6, 9)])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_eye_matches_jax(n, cap, dtype):
    tdt = torch.float32 if dtype == np.float32 else torch.float64
    got = eye(n, tdt, cap=cap, device="cpu")
    assert got.dtype == tdt
    assert_same(got, st.eye(n, dtype, cap=cap))


@pytest.mark.parametrize("alpha", [10.0, -0.5, 0.0])
def test_scale_neg_and_scalar_mul(alpha):
    a, _ = operands(1)
    t = port_of(a)
    assert_same(t.scale(alpha), a.scale(alpha))
    assert_same(t * alpha, a * alpha)
    assert_same(alpha * t, alpha * a)
    assert_same(t * np.float64(alpha), a * np.float64(alpha))
    assert_same(-t, -a)
    assert_same(t.map(torch.abs), a.map(np.abs))


@pytest.mark.parametrize("op", ["add", "sub", "mul"])
@pytest.mark.parametrize("storages", ["csr/csr", "csr/csc", "csc/csr"])
def test_sparse_binary_operators_match_jax(op, storages):
    a, b = operands(2)
    sa, sb = storages.split("/")
    a = a if sa == "csr" else a.to_csc()
    b = b if sb == "csr" else b.to_csc()
    ta, tb = port_of(a), port_of(b)
    fn = {"add": lambda x, y: x + y, "sub": lambda x, y: x - y, "mul": lambda x, y: x * y}[op]
    got, want = fn(ta, tb), fn(a, b)
    assert_same(got, want)
    got.check_structure()


@pytest.mark.parametrize("name", ["maximum", "minimum", "mul_elementwise", "add", "sub"])
def test_binop_functions_with_out_cap(name):
    a, b = operands(3)
    ta, tb = port_of(a), port_of(b)
    assert_same(getattr(tbinop, name)(ta, tb), getattr(jbinop, name)(a, b))
    assert_same(getattr(tbinop, name)(ta, tb, out_cap=4), getattr(jbinop, name)(a, b, out_cap=4))


def test_dense_operands():
    a, _ = operands(4)
    t = port_of(a)
    dense = np.random.default_rng(5).standard_normal(a.shape)
    np.testing.assert_array_equal((t + dense).numpy(), np.asarray(jops.add(a, dense)))
    np.testing.assert_array_equal(tops.add(dense, t).numpy(), np.asarray(jops.add(dense, a)))
    np.testing.assert_array_equal((t - dense).numpy(), np.asarray(jops.sub(a, dense)))
    np.testing.assert_array_equal(tops.sub(dense, t).numpy(), np.asarray(jops.sub(dense, a)))
    np.testing.assert_array_equal((torch.from_numpy(dense) - t).numpy(), np.asarray(jops.sub(dense, a)))
    assert_same(t * dense, a * dense)
    assert_same(tops.elementwise_mul(t, torch.from_numpy(dense)), jops.elementwise_mul(a, dense))
    assert_same(t.to_csc() * dense, a.to_csc() * dense)


def test_astype_with_data_and_errors():
    a, b = operands(6)
    t = port_of(a)
    assert t.astype(np.float32).dtype == torch.float32
    assert_same(t.astype(torch.float32), a.astype(np.float32))
    with pytest.raises(ShapeError):
        t.with_data(torch.zeros(t.cap + 1, dtype=torch.float64))
    with pytest.raises(ShapeError):
        t + port_of(st.from_dense(np.ones((2, 2))))
    with pytest.raises(ShapeError):
        t * np.ones(t.shape[1])


def test_step_operator_of_the_mesh_path():
    """eye + L·τ, as the unstructured slice forms its implicit step."""
    lap = st.utils.grid_laplacian((5, 4), dtype=np.float64)
    want = st.eye(20, np.float64) + lap * 10.0
    got = eye(20, torch.float64, device="cpu") + port_of(lap) * 10.0
    assert_same(got, want)
