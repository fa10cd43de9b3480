"""Triplet assembly of the PyTorch port against the JAX package: TriMat,
coo_to_csmat (through the port's compress_coo) and csmat_from_unsorted.

Tolerances: indptr and indices exactly equal; float64 data to 1e-15
(relative and absolute), because the JAX sort is unstable and may sum
three or more duplicates in another order than the port's stable sort.
"""

import numpy as np
import pytest
import torch

import sprs_tpu as st
from sprs_tpu.formats.triplet import coo_to_csmat as jax_coo_to_csmat
from sprs_tpu_torch.errors import ShapeError, StructureError
from sprs_tpu_torch.formats.csmat import csmat_from_unsorted
from sprs_tpu_torch.formats.triplet import TriMat, coo_to_csmat
from sprs_tpu_torch.formats.util import compress_coo


def assert_same(port, jax_mat):
    assert port.shape == tuple(jax_mat.shape) and port.storage == jax_mat.storage
    np.testing.assert_array_equal(port.indptr.numpy(), np.asarray(jax_mat.indptr))
    np.testing.assert_array_equal(port.indices.numpy(), np.asarray(jax_mat.indices))
    np.testing.assert_allclose(port.data.numpy(), np.asarray(jax_mat.data), rtol=1e-15, atol=1e-15)


def triplets(n, shape, seed):
    """Random triplets with many duplicates; rows skip the last two rows
    of ``shape``, so the result has empty trailing rows."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, shape[0] - 2, n).astype(np.int32)
    cols = rng.integers(0, shape[1], n).astype(np.int32)
    return rows, cols, rng.standard_normal(n)


@pytest.mark.parametrize("storage", ["csr", "csc"])
@pytest.mark.parametrize(
    "nnz,cap", [(None, None), (30, None), (30, 12), (60, 80)], ids=["full", "nnz30", "cap12", "cap80"]
)
def test_coo_to_csmat_matches_jax(storage, nnz, cap):
    rows, cols, vals = triplets(60, (9, 6), 1)
    want = jax_coo_to_csmat(rows, cols, vals, (9, 6), nnz=nnz, storage=storage, cap=cap)
    got = coo_to_csmat(rows, cols, vals, (9, 6), nnz=nnz, storage=storage, cap=cap, device="cpu")
    assert_same(got, want)


def test_compress_coo_reports_required_and_clamped_nnz():
    rows, cols, vals = triplets(60, (9, 6), 2)
    res = compress_coo(
        torch.from_numpy(rows), torch.from_numpy(cols), (torch.from_numpy(vals),), 60, 9, 6, 5
    )
    unique = len(set(zip(rows.tolist(), cols.tolist())))
    assert int(res.required_nnz) == unique > 5
    assert int(res.nnz) == 5 and int(res.indptr[-1]) == 5


def test_compress_coo_empty_input():
    res = compress_coo(
        torch.zeros(0, dtype=torch.int32), torch.zeros(0, dtype=torch.int32),
        (torch.zeros(0),), 0, 4, 3, 2,
    )
    assert res.indptr.tolist() == [0] * 5 and int(res.nnz) == 0 == int(res.required_nnz)


def test_builder_and_duplicates():
    t = TriMat((3, 4))
    jt = st.TriMat((3, 4))
    for m in (t, jt):
        m.add_triplet(0, 1, 2.0)
        m.add_triplet(2, 3, 1.0)
        m.add_triplet(0, 1, 3.0)
    assert t.nnz == jt.nnz == 3
    assert_same(t.to_csr(device="cpu"), jt.to_csr())
    assert_same(t.to_csc(device="cpu"), jt.to_csc())
    np.testing.assert_array_equal(t.to_dense(), jt.to_dense())
    assert t.to_csr(device="cpu").nnz == 2


@pytest.mark.parametrize("cap", [None, 3, 40])
def test_from_triplets_matches_jax(cap):
    rows, cols, vals = triplets(40, (7, 5), 3)
    t = TriMat.from_triplets((7, 5), rows, cols, vals)
    jt = st.TriMat.from_triplets((7, 5), rows, cols, vals)
    assert_same(t.to_csr(cap=cap, device="cpu"), jt.to_csr(cap=cap))
    assert_same(t.to_csc(cap=cap, device="cpu"), jt.to_csc(cap=cap))
    np.testing.assert_array_equal(t.row_inds(), jt.row_inds())
    np.testing.assert_array_equal(t.col_inds(), jt.col_inds())
    np.testing.assert_array_equal(t.data(), jt.data())


def test_locations_set_and_transpose_view():
    t = TriMat.from_triplets((2, 3), [0, 1, 0], [2, 0, 2], [1.0, 2.0, 3.0])
    jt = st.TriMat.from_triplets((2, 3), [0, 1, 0], [2, 0, 2], [1.0, 2.0, 3.0])
    assert t.find_locations(0, 2) == jt.find_locations(0, 2) == [0, 2]
    t.add_triplet(1, 1, 4.0)
    jt.add_triplet(1, 1, 4.0)
    assert t.find_locations(1, 1) == jt.find_locations(1, 1) == [3]
    for m in (t, jt):
        m.set_triplet(2, 1, 2, 7.0)
    assert_same(t.to_csr(device="cpu"), jt.to_csr())
    tt, jtt = t.transpose_view(), jt.transpose_view()
    assert tt.shape == (3, 2)
    assert_same(tt.to_csr(device="cpu"), jtt.to_csr())
    np.testing.assert_array_equal(tt.to_dense(), t.to_dense().T)


def test_transpose_view_is_live_as_in_jax():
    """A triplet added or set through the view is seen by its builder, and
    the other way round, as the JAX view shares the builder's lists."""
    t = TriMat.from_triplets((2, 3), [0, 1], [2, 0], [1.0, 2.0])
    jt = st.TriMat.from_triplets((2, 3), [0, 1], [2, 0], [1.0, 2.0])
    tt, jtt = t.transpose_view(), jt.transpose_view()
    for view, base in ((tt, t), (jtt, jt)):
        view.add_triplet(1, 0, 5.0)
        base.add_triplet(1, 2, 6.0)
        view.set_triplet(0, 2, 1, 3.0)
    assert t.nnz == jt.nnz == tt.nnz == 4
    assert_same(t.to_csr(device="cpu"), jt.to_csr())
    assert_same(tt.to_csc(device="cpu"), jtt.to_csc())
    np.testing.assert_array_equal(tt.to_dense(), t.to_dense().T)


def test_empty_builder_and_trailing_rows():
    t = TriMat((4, 2))
    jt = st.TriMat((4, 2))
    assert_same(t.to_csr(device="cpu"), jt.to_csr())
    t.add_triplet(0, 0, 1.0)
    jt.add_triplet(0, 0, 1.0)
    m = t.to_csr(device="cpu")
    assert m.indptr.tolist() == [0, 1, 1, 1, 1]
    assert_same(m, jt.to_csr())


def test_range_errors():
    t = TriMat((2, 2))
    with pytest.raises(StructureError):
        t.add_triplet(2, 0, 1.0)
    with pytest.raises(StructureError):
        t.add_triplet(0, -1, 1.0)
    with pytest.raises(StructureError):
        TriMat.from_triplets((2, 2), [0, 2], [0, 0], [1.0, 1.0])
    with pytest.raises(StructureError):
        TriMat.from_triplets((2, 2), [0, 1], [0, -1], [1.0, 1.0])
    with pytest.raises(ShapeError):
        TriMat.from_triplets((2, 2), [0, 1], [0], [1.0, 1.0])
    with pytest.raises(StructureError):
        TriMat((2**31 + 1, 2))
    with pytest.raises(StructureError):
        coo_to_csmat([0], [0], [1.0], (2, 2**31 + 1), device="cpu")


@pytest.mark.parametrize("storage", ["csr", "csc"])
@pytest.mark.parametrize("cap", [None, 40])
def test_csmat_from_unsorted_matches_jax(storage, cap):
    rng = np.random.default_rng(4)
    n_outer, n_inner = 6, 8
    counts = rng.integers(0, 5, n_outer)
    indptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    indices = rng.integers(0, n_inner, indptr[-1]).astype(np.int32)  # unsorted, duplicates
    data = rng.standard_normal(indptr[-1])
    shape = (n_outer, n_inner) if storage == "csr" else (n_inner, n_outer)
    want = st.csmat_from_unsorted(shape, indptr, indices, data, storage=storage, cap=cap)
    got = csmat_from_unsorted(shape, indptr, indices, data, storage=storage, cap=cap, device="cpu")
    assert_same(got, want)
    got.check_structure()
