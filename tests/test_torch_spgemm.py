"""SpGEMM of the PyTorch port against the JAX package's
``sprs_tpu.ops.spgemm``: ESC, the capacity helpers, the chunked path,
the dense and block-sparse routes, the ``method="auto"`` rule, the
sparse ``@`` dispatch, and the gradient.

Tolerances: indptr, indices, shape, storage and capacity equal; data
within 1e-14·max|C| in float64 and 1e-6·max|C| in float32 (a C entry
that sums three or more products may differ in its last bits: the JAX
sort is unstable, the port's stable); integer-valued products equal.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sprs_tpu as st
import sprs_tpu_torch as ts
from sprs_tpu_torch.errors import CapacityError
from sprs_tpu_torch.formats.bsr import BsrMat
from sprs_tpu_torch.formats.csmat import CsMat
from sprs_tpu_torch.interop import from_arrays

# the modules (their packages export a function of the same name)
jsg = importlib.import_module("sprs_tpu.ops.spgemm")
tsg = importlib.import_module("sprs_tpu_torch.ops.spgemm")


def port_of(m):
    if isinstance(m, st.CsVec):
        return from_arrays("csvec", (m.dim,), (np.asarray(m.indices), np.asarray(m.data), int(m.nnz)),
                           device="cpu")
    if hasattr(m, "brows"):
        return from_arrays("bsr", m.shape, (np.asarray(m.brows), np.asarray(m.bcols),
                                            np.asarray(m.blocks)), n_blocks=m.n_blocks, device="cpu")
    return from_arrays(
        "csmat", m.shape, (np.asarray(m.indptr), np.asarray(m.indices), np.asarray(m.data)),
        storage=m.storage, device="cpu",
    )


def assert_close_data(got, want):
    want = np.asarray(want)
    rtol = 1e-6 if want.dtype in (np.float32, np.complex64) else 1e-14
    scale = max(float(np.abs(want).max()) if want.size else 0.0, 1e-300)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=rtol * scale)


def assert_same(port, jax_mat):
    assert port.shape == tuple(jax_mat.shape) and port.storage == jax_mat.storage
    assert port.cap == jax_mat.cap
    np.testing.assert_array_equal(port.indptr.numpy(), np.asarray(jax_mat.indptr))
    np.testing.assert_array_equal(port.indices.numpy(), np.asarray(jax_mat.indices))
    assert_close_data(port.data, jax_mat.data)


def assert_same_bsr(port, jax_bsr):
    assert isinstance(port, BsrMat) and port.shape == tuple(jax_bsr.shape)
    assert port.n_blocks == jax_bsr.n_blocks and port.cap == jax_bsr.blocks.shape[0]
    np.testing.assert_array_equal(port.brows.numpy(), np.asarray(jax_bsr.brows))
    np.testing.assert_array_equal(port.bcols.numpy(), np.asarray(jax_bsr.bcols))
    assert_close_data(port.blocks, jax_bsr.blocks)


def rand(shape, seed, *, dtype=np.float64, pad=0, complex_=False):
    """A random matrix with an empty row (1), a stored zero and ``pad``
    padding slots."""
    rng = np.random.default_rng(seed)
    d = rng.standard_normal(shape)
    if complex_:
        d = d + 1j * rng.standard_normal(shape)
    d[rng.random(shape) > 0.45] = 0.0
    d[1] = 0.0
    m = st.from_dense(d.astype(dtype))
    m = m.with_data(m.data.at[0].set(0.0))
    return m.with_cap(m.nnz + pad)


def cancelling_pair():
    """C[0, 0] = 1·1 + 1·(-1) = 0: ESC keeps it stored, the dense routes
    drop it."""
    a = st.from_dense(np.array([[1.0, 1.0, 0.0], [0.0, 2.0, 0.0], [3.0, 0.0, 1.0]]))
    b = st.from_dense(np.array([[1.0, 0.0, 2.0], [-1.0, 3.0, 0.0], [0.0, 1.0, 1.0]]))
    return a, b


CASES = {
    "csr": lambda: (rand((9, 7), 0, pad=2), rand((7, 6), 1)),
    "csc lhs": lambda: (rand((9, 7), 2).to_csc(), rand((7, 6), 3, pad=3)),
    "cancellation": cancelling_pair,
    "complex128": lambda: (rand((6, 5), 6, complex_=True, dtype=np.complex128),
                           rand((5, 7), 7, complex_=True, dtype=np.complex128)),
    "float32": lambda: (rand((9, 7), 8, dtype=np.float32), rand((7, 6), 9, dtype=np.float32, pad=2)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_esc_matches_jax(case):
    a, b = CASES[case]()
    got = ts.spgemm(port_of(a), port_of(b))
    want = st.spgemm(a, b)
    assert_same(got, want)
    assert_same(port_of(a) @ port_of(b), want)
    if case == "cancellation":
        assert got.nnz == 8 and float(got.get(0, 0)) == 0.0


def test_caps_sort_batches_and_capacity_errors(monkeypatch):
    a, b = rand((9, 7), 10, pad=2), rand((7, 6), 11)
    ta, tb = port_of(a), port_of(b)
    assert ts.spgemm_caps(ta, tb) == st.spgemm_caps(a, b)
    prod, out = ts.spgemm_caps(ta, tb)
    for mod in (jsg, tsg):
        monkeypatch.setattr(mod, "SORT_BATCH_MIN", 8)
        monkeypatch.setattr(mod, "SORT_BATCH_TARGET", 10)
    got, want = tsg.spgemm_sort_batches(ta, tb), jsg.spgemm_sort_batches(a, b)
    assert len(got[0]) > 2
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert_same(ts.spgemm(ta, tb, sort_batches=got), st.spgemm(a, b, sort_batches=want))
    assert_same(ts.spgemm(ta, tb, out_cap=out - 3, check_capacity=False),
                st.spgemm(a, b, out_cap=out - 3, check_capacity=False))
    assert ts.spgemm(ta, tb, prod_cap=prod + 4, out_cap=out + 2).cap == out + 2
    for kw in ({"out_cap": out - 1}, {"prod_cap": prod - 1}):
        with pytest.raises(CapacityError):
            ts.spgemm(ta, tb, **kw)
    with pytest.raises(CapacityError):
        ts.spgemm(ta, tb, prod_cap=2**31)


def test_chunked_matches_jax(monkeypatch):
    a, b = rand((9, 7), 12, pad=1), rand((7, 6), 13)
    ta, tb = port_of(a), port_of(b)
    assert len(tsg.chunk_bounds(ta, tb, 7)) > 3
    assert_same(tsg._spgemm_chunked(ta, tb, 7), jsg._spgemm_chunked(a, b, 7))
    for mod in (jsg, tsg):
        monkeypatch.setattr(mod, "CHUNK_PRODUCT_BUDGET", 15)
    assert_same(ts.spgemm(ta, tb), st.spgemm(a, b))


def test_dense_routes_match_jax(monkeypatch):
    a, b = cancelling_pair()
    ta, tb = port_of(a), port_of(b)
    dense = ts.spgemm_dense(ta, tb)
    assert_same(dense, st.spgemm_dense(a, b))
    assert dense.nnz == 7  # the cancelled entry is gone
    assert_same(ts.spgemm(ta, tb, method="dense"), st.spgemm(a, b, method="dense"))
    a, b = rand((9, 7), 14), rand((7, 6), 15)
    ta, tb = port_of(a), port_of(b)
    assert_same(ts.spgemm_dense(ta, tb, eps=0.5), st.spgemm_dense(a, b, eps=0.5))
    assert_same(ts.spgemm_dense(ta, tb, out_cap=5), st.spgemm_dense(a, b, out_cap=5))
    assert_same(tsg._with_cap_truncating(ts.spgemm(ta, tb), 40),
                jsg._with_cap_truncating(st.spgemm(a, b), 40))
    assert_same_bsr(ts.spgemm_dense_bsr(ta, tb, block_size=4), st.spgemm_dense_bsr(a, b, block_size=4))
    assert_same_bsr(ts.spgemm(ta, tb, method="dense", out_format="bsr"),
                    st.spgemm(a, b, method="dense", out_format="bsr"))
    assert_same_bsr(ts.spgemm(ta, tb, out_format="bsr"), st.spgemm(a, b, out_format="bsr"))
    # A-row chunks of 4 rows: dense B (336 bytes) fits half the budget,
    # the whole product (1,272 bytes) does not fit it
    for mod in (jsg, tsg):
        monkeypatch.setattr(mod, "DENSE_BYTES_BUDGET", 800)
    assert_same_bsr(ts.spgemm_dense_bsr(ta, tb, block_size=4), st.spgemm_dense_bsr(a, b, block_size=4))
    for mod in (jsg, tsg):
        monkeypatch.setattr(mod, "DENSE_BYTES_BUDGET", 600)
    with pytest.raises(CapacityError):
        ts.spgemm_dense_bsr(ta, tb, block_size=4)


@pytest.mark.parametrize("ratio", [0.0, 1e9])
def test_auto_rule_matches_jax(monkeypatch, ratio):
    """The rule's arithmetic, with the break-even set in both packages:
    0 sends every product to the dense route, 1e9 none."""
    for mod in (jsg, tsg):
        monkeypatch.setattr(mod, "AUTO_DENSE_PRODUCTS_PER_MAC", ratio)
    a, b = cancelling_pair()
    ta, tb = port_of(a), port_of(b)
    assert_same(ts.spgemm(ta, tb, method="auto"), st.spgemm(a, b, method="auto"))
    got, want = ts.spgemm(ta, tb, method="auto", out_format="auto"), st.spgemm(a, b, method="auto",
                                                                                out_format="auto")
    if ratio == 0.0:
        assert_same_bsr(got, want)
    else:
        assert_same(got, want)


def test_sparse_matmul_dispatch():
    a, b = rand((9, 7), 16), rand((7, 6), 17)
    ta, tb = port_of(a), port_of(b)
    ja_bsr, jb_bsr = st.spgemm_dense_bsr(a, st.eye(7, np.float64), block_size=4), b.to_bsr(4)
    ta_bsr, tb_bsr = port_of(ja_bsr), port_of(jb_bsr)
    assert_same_bsr(ta @ tb_bsr, a @ jb_bsr)
    assert_same_bsr(ta_bsr @ tb, ja_bsr @ b)
    assert_same_bsr(ta_bsr @ tb_bsr, ja_bsr @ jb_bsr)
    v = st.csvec(7, [0, 3, 6], [1.0, -2.0, 0.5], cap=4)
    w = st.csvec(9, [2, 5], [3.0, 1.5])
    for got, want in ((ta @ port_of(v), a @ v), (port_of(w) @ ta, w @ a)):
        assert got.dim == want.dim and got.cap == want.cap and got.nnz == int(want.nnz)
        np.testing.assert_array_equal(got.indices.numpy(), np.asarray(want.indices))
        assert_close_data(got.data, want.data)
    np.testing.assert_array_equal(ts.assign_to_dense(np.ones(a.shape), ta).numpy(),
                                  np.asarray(st.ops.assign_to_dense(np.ones(a.shape), a)))


def _dense_of(m, data):
    rows, cols, _ = m.coo_arrays()
    nnz = m.nnz
    out = torch.zeros(m.shape, dtype=data.dtype)
    return out.index_put((rows[:nnz].long(), cols[:nnz].long()), data[:nnz], accumulate=True)


def test_gradient_matches_dense_oracle_and_jax():
    """d/d(A.data) and d/d(B.data) of Σ w∘C.data: against autograd
    through A_dense @ B_dense, and against jax.grad of the JAX spgemm."""
    a, b = rand((9, 7), 18, pad=2), rand((7, 6), 19, pad=1)
    ta, tb = port_of(a), port_of(b)
    w = torch.from_numpy(np.random.default_rng(20).standard_normal(st.spgemm(a, b).cap))

    def grads(fn):
        ad, bd = ta.data.clone().requires_grad_(True), tb.data.clone().requires_grad_(True)
        return torch.autograd.grad(fn(ad, bd), (ad, bd))

    def through_spgemm(ad, bd):
        c = ts.spgemm(CsMat(ta.indptr, ta.indices, ad, ta.shape, "csr"),
                      CsMat(tb.indptr, tb.indices, bd, tb.shape, "csr"))
        return (w * c.data).sum()

    c = ts.spgemm(ta, tb)
    wd = _dense_of(c, w)

    def through_dense(ad, bd):
        return (wd * (_dense_of(ta, ad) @ _dense_of(tb, bd))).sum()

    got, want = grads(through_spgemm), grads(through_dense)
    assert float(got[0].abs().sum()) > 0 and float(got[1].abs().sum()) > 0
    for g, o in zip(got, want):
        np.testing.assert_allclose(g.numpy(), o.numpy(), rtol=0, atol=1e-14 * float(o.abs().max()))
    jw = jnp.asarray(w.numpy())
    jga, jgb = jax.grad(
        lambda ad, bd: jnp.sum(jw * st.spgemm(a.with_data(ad), b.with_data(bd)).data), argnums=(0, 1)
    )(a.data, b.data)
    for g, j in zip(got, (jga, jgb)):
        np.testing.assert_allclose(g.numpy(), np.asarray(j), rtol=0,
                                   atol=1e-14 * float(np.abs(np.asarray(j)).max()))


@pytest.mark.gpu
def test_spgemm_on_the_card_matches_the_cpu():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    a, b = ts.utils.rand_csr((300, 200), 0.05, seed=0, device="cpu"), ts.utils.rand_csr(
        (200, 250), 0.05, seed=1, device="cpu")
    want = ts.spgemm(a, b)
    ca = CsMat(*(t.cuda() for t in (a.indptr, a.indices, a.data)), a.shape, a.storage)
    cb = CsMat(*(t.cuda() for t in (b.indptr, b.indices, b.data)), b.shape, b.storage)
    got = ts.spgemm(ca, cb)
    assert got.device.type == "cuda" and got.cap == want.cap
    assert torch.equal(got.indptr.cpu(), want.indptr) and torch.equal(got.indices.cpu(), want.indices)
    assert torch.allclose(got.data.cpu(), want.data, rtol=0, atol=1e-14 * float(want.data.abs().max()))
