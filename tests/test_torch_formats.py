"""Formats of the PyTorch port against the JAX package, array for array.

Every port operand is built through ``sprs_tpu_torch.interop.from_arrays``
from the JAX object's leaves (``np.asarray``), on the CPU.
"""

import numpy as np
import pytest
import torch

import sprs_tpu as st
import sprs_tpu_torch as stt
from sprs_tpu.formats.dia import dia_to_csmat, n_diags_of
from sprs_tpu.formats.ell import ell_overhead
from sprs_tpu.formats.util import row_ids_from_indptr
from sprs_tpu_torch.formats.dia import dia_to_csmat as t_dia_to_csmat
from sprs_tpu_torch.formats.dia import n_diags_of as t_n_diags_of
from sprs_tpu_torch.formats.ell import ell_overhead as t_ell_overhead
from sprs_tpu_torch.formats.util import row_ids_from_indptr as t_row_ids
from sprs_tpu_torch.interop import from_arrays


def random_sparse(r, c, density, seed, dtype=np.float64):
    rng = np.random.default_rng(seed)
    d = rng.standard_normal((r, c))
    d[rng.random((r, c)) > density] = 0.0
    return d.astype(dtype)


def port_of(m):
    """The port's CsMat carrying the JAX CsMat's arrays."""
    return from_arrays(
        "csmat",
        m.shape,
        (np.asarray(m.indptr), np.asarray(m.indices), np.asarray(m.data)),
        storage=m.storage,
        device="cpu",
    )


def assert_same_csmat(t, m):
    assert t.shape == tuple(m.shape) and t.storage == m.storage
    for name in ("indptr", "indices", "data"):
        a = getattr(t, name).numpy()
        b = np.asarray(getattr(m, name))
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)


MATRICES = {
    "square": (random_sparse(9, 9, 0.3, 1), 0.0),
    "wide": (random_sparse(5, 11, 0.4, 2), 0.0),
    "tall_empty_rows": (np.vstack([np.zeros((3, 6)), random_sparse(4, 6, 0.5, 3), np.zeros((2, 6))]), 0.0),
    "eps": (random_sparse(8, 7, 0.6, 4), 0.5),
}


@pytest.mark.parametrize("storage", ["csr", "csc"])
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_from_dense_arrays(name, storage):
    d, eps = MATRICES[name]
    m = st.from_dense(d, eps=eps, storage=storage)
    t = stt.from_dense(d, eps=eps, storage=storage, device="cpu")
    assert_same_csmat(t, m)
    assert t.nnz == m.nnz and t.cap == m.cap


def test_from_dense_small_cap():
    d = random_sparse(6, 6, 0.6, 5)
    assert_same_csmat(stt.from_dense(d, cap=7, device="cpu"), st.from_dense(d, cap=7))


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_queries_and_storage_conversion(name):
    d, eps = MATRICES[name]
    m = st.from_dense(d, eps=eps).with_cap(st.from_dense(d, eps=eps).cap + 3)
    t = port_of(m)
    np.testing.assert_array_equal(t.outer_ids().numpy(), np.asarray(m.outer_ids()))
    np.testing.assert_array_equal(t.to_dense().numpy(), np.asarray(m.to_dense()))
    np.testing.assert_array_equal(t.diag().numpy(), np.asarray(m.diag()))
    assert t.max_outer_nnz() == m.max_outer_nnz()
    assert_same_csmat(t.to_csc(), m.to_csc())
    assert_same_csmat(t.to_csc().to_csr(), m.to_csc().to_csr())
    np.testing.assert_array_equal(t.T.to_dense().numpy(), np.asarray(m.T.to_dense()))
    assert t.T.storage == m.T.storage


@pytest.mark.parametrize(
    "indptr,cap",
    [
        ([0, 2, 2, 5], 5),  # empty middle row, full
        ([0, 2, 2, 5], 9),  # capacity padding
        ([0, 0, 3, 3, 3], 6),  # leading and trailing empty rows
        ([0, 0, 0], 4),  # no entries at all
    ],
)
def test_row_ids_from_indptr_padding(indptr, cap):
    ip = np.asarray(indptr, np.int32)
    got = t_row_ids(torch.from_numpy(ip), cap)
    want = np.asarray(row_ids_from_indptr(ip, cap))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def banded(n, offsets, seed, cols=None, dtype=np.float64):
    cols = n if cols is None else cols
    rng = np.random.default_rng(seed)
    d = np.zeros((n, cols), dtype)
    for off in offsets:
        i = np.arange(max(0, -off), min(n, cols - off))
        d[i, i + off] = rng.standard_normal(i.size)
    return d


@pytest.mark.parametrize(
    "n,cols,offsets",
    [(23, 23, (-5, -1, 0, 1, 5)), (30, 21, (-7, 0, 3)), (12, 17, (-2, 4, 9))],
)
def test_to_dia(n, cols, offsets):
    m = st.from_dense(banded(n, offsets, 6, cols))
    t = port_of(m)
    dia, tdia = m.to_dia(), t.to_dia()
    assert tdia.offsets == dia.offsets and tdia.shape == tuple(dia.shape)
    np.testing.assert_array_equal(tdia.data.numpy(), np.asarray(dia.data))
    np.testing.assert_array_equal(tdia.to_dense().numpy(), np.asarray(dia.to_dense()))
    assert t_n_diags_of(t) == n_diags_of(m)
    assert_same_csmat(t_dia_to_csmat(tdia), dia_to_csmat(dia))
    with pytest.raises(stt.ShapeError):
        t.to_dia(max_diags=len(offsets) - 1)


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_to_ell(name):
    d, eps = MATRICES[name]
    m = st.from_dense(d, eps=eps)
    t = port_of(m)
    ell, tell = m.to_ell(), t.to_ell()
    np.testing.assert_array_equal(tell.indices.numpy(), np.asarray(ell.indices))
    np.testing.assert_array_equal(tell.data.numpy(), np.asarray(ell.data))
    np.testing.assert_array_equal(tell.to_dense().numpy(), np.asarray(ell.to_dense()))
    assert t_ell_overhead(t) == ell_overhead(m)


def test_to_ell_narrow_width_drops_tail():
    d = random_sparse(7, 9, 0.7, 8)
    m = st.from_dense(d)
    ell, tell = m.to_ell(width=2), port_of(m).to_ell(width=2)
    np.testing.assert_array_equal(tell.indices.numpy(), np.asarray(ell.indices))
    np.testing.assert_array_equal(tell.data.numpy(), np.asarray(ell.data))


@pytest.mark.parametrize("make", ["grid_laplacian", "dirichlet_laplacian"])
@pytest.mark.parametrize("shape", [(5, 7), (6, 6)])
def test_laplacians(make, shape):
    m = getattr(st.utils, make)(shape, dtype=np.float64)
    t = getattr(stt.utils, make)(shape, torch.float64, device="cpu")
    assert_same_csmat(t, m)


def test_from_arrays_carrier():
    """The state carrier: the port's objects from the JAX objects'
    leaves hold the same arrays and the same matrix."""
    m = st.from_dense(banded(14, (-3, 0, 2), 9)).with_cap(50)
    t = port_of(m)
    assert_same_csmat(t, m)
    assert t.cap == 50 and t.nnz == m.nnz
    dia = m.to_dia()
    tdia = from_arrays(
        "dia", dia.shape, (np.asarray(dia.data),), offsets=dia.offsets, device="cpu"
    )
    assert tdia.offsets == dia.offsets
    np.testing.assert_array_equal(tdia.to_dense().numpy(), np.asarray(dia.to_dense()))
    csc = m.to_csc()
    np.testing.assert_array_equal(port_of(csc).to_dense().numpy(), np.asarray(csc.to_dense()))
    with pytest.raises(ValueError):
        from_arrays("bsr", (2, 2), (np.zeros(1),), device="cpu")
    with pytest.raises(ValueError):
        from_arrays("dia", (2, 2), (np.zeros((1, 8)),), device="cpu")


@pytest.mark.parametrize(
    "indptr,indices,kind",
    [
        ([0, 2, 3], [1, 0, 2], "unsorted"),
        ([0, 2, 3], [0, 5, 1], "out_of_range"),
        ([1, 2, 3], [0, 1, 2], "out_of_range"),
        ([0, 3, 2], [0, 1, 2], "unsorted"),
    ],
)
def test_check_structure(indptr, indices, kind):
    with pytest.raises(st.StructureError) as ref:
        st.csmat((2, 3), indptr, indices, np.ones(3))
    with pytest.raises(stt.StructureError) as got:
        stt.csmat((2, 3), indptr, indices, np.ones(3), device="cpu")
    assert got.value.kind == ref.value.kind == kind


def test_index_capacity_guard():
    with pytest.raises(stt.StructureError) as e:
        stt.csmat((2**31, 2), [0], [0], [1.0], validate=False, device="cpu")
    assert e.value.kind == "index_overflow"
