"""The float sums by index that the port takes in one fixed order, against
the JAX package on the CPU.

``CsMat.sum(axis=0/1)``, ``CsMat.norm(1 / inf)``, K5's backward
(``ell_vjp``'s dx), K3's backward (``bsr_vjp``'s dX) and
``formats/bsr.py::bsr_spmm_plain`` sum through ``formats/util.py::
index_sum_``: an accumulating ``index_put_`` on a CUDA tensor (torch sorts
the slots stably and adds each run of equal slots in one order, where
``index_add_``'s atomics add in no fixed order), ``index_add_`` on the CPU
(whose accumulating ``index_put_`` adds float32 on several threads on
large inputs).  On the CPU the sums are the JAX package's scatter-adds,
bit for bit: the same values added in the same order.  The block products around the BSR
sums are made exact (one nonzero term per dot product: scaled permutation
blocks, one nonzero per row of X), so that only the order of the sums
over blocks is compared.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sprs_tpu as st
from sprs_tpu.formats.bsr import bsr_from_dense as jax_bsr_from_dense
from sprs_tpu.formats.bsr import bsr_spmm_xla
from sprs_tpu.ops.pallas import bsr_spmm_pallas, ell_spmv_pallas
from sprs_tpu_torch.formats.bsr import bsr_spmm_plain
from sprs_tpu_torch.interop import from_arrays
from sprs_tpu_torch.ops.cuda.bsr_spmm import bsr_vjp
from sprs_tpu_torch.ops.cuda.ell_spmv import ell_vjp

BITS = {np.dtype(np.float32): np.int32, np.dtype(np.float64): np.int64}


def assert_bits_equal(got: torch.Tensor, want):
    want = np.asarray(want)
    got = got.detach().numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got.view(BITS[got.dtype]), want.view(BITS[want.dtype]))


def random_sparse(r, c, density, seed, dtype=np.float64):
    rng = np.random.default_rng(seed)
    d = rng.standard_normal((r, c))
    d[rng.random((r, c)) > density] = 0.0
    d[5] = 0.0  # an empty row
    return d.astype(dtype)


def csmat_pair(storage, dtype):
    m = st.from_dense(random_sparse(300, 250, 0.1, 150, dtype))
    m = m.with_cap(m.cap + 7)  # padded
    if storage == "csc":
        m = m.to_csc()
    t = from_arrays("csmat", m.shape, (np.asarray(m.indptr), np.asarray(m.indices), np.asarray(m.data)),
                    storage=m.storage, device="cpu")
    return m, t


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("storage", ["csr", "csc"])
def test_sum_bit_equal_to_jax(storage, axis, dtype):
    m, t = csmat_pair(storage, dtype)
    assert_bits_equal(t.sum(axis), m.sum(axis))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("ord", [1, np.inf])
@pytest.mark.parametrize("storage", ["csr", "csc"])
def test_norm_bit_equal_to_jax(storage, ord, dtype):
    m, t = csmat_pair(storage, dtype)
    assert_bits_equal(t.norm(ord), m.norm(ord))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_ell_backward_bit_equal_to_the_jax_vjp(dtype):
    """``ell_vjp`` against ``jax.vjp`` of the Pallas K5 (interpret mode):
    ddata and dx, pad slots and pad rows included."""
    ell = st.from_dense(random_sparse(90, 40, 0.2, 151, dtype)).to_ell()
    tell = from_arrays("ell", ell.shape, (np.asarray(ell.indices), np.asarray(ell.data)), device="cpu")
    rng = np.random.default_rng(152)
    x = rng.standard_normal(40).astype(dtype)
    g = rng.standard_normal(90).astype(dtype)

    def f(data, v):
        return ell_spmv_pallas(type(ell)(ell.indices, data, ell.shape), v, interpret=True)

    _, vjp = jax.vjp(f, ell.data, jnp.asarray(x))
    want_ddata, want_dx = vjp(jnp.asarray(g))
    ddata, dx = ell_vjp(tell, torch.from_numpy(x), torch.from_numpy(g))
    assert_bits_equal(ddata, want_ddata)
    assert_bits_equal(dx, want_dx)


BS = 8


def exact_bsr_operands(seed):
    """(dense blocks matrix, X, G): 8×8 blocks that are scaled permutation
    matrices on a 12×10 block grid (block row 3 empty), X of one nonzero
    per row, G dense; float32."""
    rng = np.random.default_rng(seed)
    keep = rng.random((12, 10)) < 0.5
    keep[3] = False
    d = np.zeros((12 * BS, 10 * BS), np.float32)
    for i, j in zip(*np.nonzero(keep)):
        block = np.zeros((BS, BS), np.float32)
        block[np.arange(BS), rng.permutation(BS)] = rng.standard_normal(BS)
        d[i * BS : (i + 1) * BS, j * BS : (j + 1) * BS] = block
    d = d[:93, :77]
    x = np.zeros((77, 5), np.float32)
    x[np.arange(77), rng.integers(0, 5, 77)] = rng.standard_normal(77)
    g = rng.standard_normal((93, 5)).astype(np.float32)
    return d, x, g


def bsr_pair(d):
    jb = jax_bsr_from_dense(d, BS, dtype=np.float32)
    tb = from_arrays("bsr", jb.shape, (np.asarray(jb.brows), np.asarray(jb.bcols), np.asarray(jb.blocks)),
                     n_blocks=jb.n_blocks, device="cpu")
    return jb, tb


def test_bsr_backward_bit_equal_to_the_jax_vjp():
    """``bsr_vjp``'s dblocks and dX against ``jax.vjp`` of the Pallas K3
    (interpret mode)."""
    d, x, g = exact_bsr_operands(153)
    jb, tb = bsr_pair(d)

    def f(blocks, v):
        return bsr_spmm_pallas(type(jb)(jb.brows, jb.bcols, blocks, jb.shape, jb.n_blocks), v, interpret=True)

    _, vjp = jax.vjp(f, jb.blocks, jnp.asarray(x))
    want_db, want_dx = vjp(jnp.asarray(g))
    db, dx = bsr_vjp(tb, tb.blocks, torch.from_numpy(x), torch.from_numpy(g))
    assert_bits_equal(db, want_db)
    assert_bits_equal(dx, want_dx)


def test_bsr_plain_product_bit_equal_to_jax():
    """``bsr_spmm_plain`` against ``bsr_spmm_xla``: the sums over each
    block row's blocks."""
    d, x, _ = exact_bsr_operands(154)
    jb, tb = bsr_pair(d)
    x = np.random.default_rng(155).standard_normal((77, 5)).astype(np.float32)
    assert_bits_equal(bsr_spmm_plain(tb, torch.from_numpy(x)), bsr_spmm_xla(jb, jnp.asarray(x)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_index_sum_repeats_on_large_inputs(dtype):
    """At 700,000 entries the CPU's accumulating ``index_put_`` adds
    float32 on several threads, in no fixed order; ``index_sum_`` adds in
    index order on the CPU too: two runs give the same bits, those of
    numpy's ``np.add.at`` (sequential)."""
    from sprs_tpu_torch.formats.util import index_sum_

    rng = np.random.default_rng(156)
    idx = rng.integers(0, 100_000, 700_000)
    vals = rng.standard_normal(700_000).astype(np.float32 if dtype == torch.float32 else np.float64)
    want = np.zeros(100_000, vals.dtype)
    np.add.at(want, idx, vals)
    for _ in range(2):
        got = index_sum_(torch.zeros(100_000, dtype=dtype), torch.from_numpy(idx), torch.from_numpy(vals))
        assert_bits_equal(got, want)


def test_csr_products_repeat_on_large_float32_inputs():
    """``spmv``, ``spmm`` and ``compress_coo``'s duplicate sums on the CPU
    at a size where the accumulating ``index_put_`` ran on several threads:
    the same bits twice."""
    import sprs_tpu_torch as stt
    from sprs_tpu_torch.formats.util import compress_coo

    rng = np.random.default_rng(157)
    n, nnz = 100_000, 800_000
    rows, cols = rng.integers(0, n, nnz), rng.integers(0, n, nnz)
    vals = torch.from_numpy(rng.standard_normal(nnz).astype(np.float32))
    r, c = torch.from_numpy(rows).to(torch.int32), torch.from_numpy(cols).to(torch.int32)
    runs = [compress_coo(r, c, (vals,), nnz, n, n, nnz) for _ in range(2)]
    assert torch.equal(runs[0].values[0].view(torch.int32), runs[1].values[0].view(torch.int32))
    m = stt.CsMat(runs[0].indptr, runs[0].indices, runs[0].values[0], (n, n), "csr").to_csc()
    x = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    X = torch.from_numpy(rng.standard_normal((n, 3)).astype(np.float32))
    for fn in (lambda: stt.spmv(m, x), lambda: stt.spmm(m, X)):
        a, b = fn(), fn()
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
