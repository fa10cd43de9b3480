"""The port's same-pattern batch API (``sprs_tpu_torch.ops.batch``)
against the JAX package's ``sprs_tpu.ops.batch`` and against member-by-
member loops of the port's single-matrix calls: ``batch_spmv`` and
``batch_spmm`` (batched and broadcast operands), ``batch_spgemm`` (one
shared output pattern, equal to the JAX package's) and ``BatchedLdl``
(both plan kinds).  Products agree to 1e-12, the LDLᵀ factors and
solves to rtol 1e-10, in f64; inputs are made from seeds with numpy.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sprs_tpu as st
import sprs_tpu_torch as tt
from sprs_tpu.linalg import Ldl as JLdl
from sprs_tpu.ops import batch as j_batch
from sprs_tpu_torch.errors import ShapeError
from sprs_tpu_torch.linalg import Ldl
from sprs_tpu_torch.ops import BatchedLdl, batch_spgemm, batch_spmm, batch_spmv
from tests.test_torch_ldl_super import port_of

TOL = 1e-12


def pattern(seed, m=30, n=24, density=0.2):
    rng = np.random.default_rng(seed)
    return st.from_dense(rng.standard_normal((m, n)) * (rng.random((m, n)) < density))


def batch_data(mat, N, seed=1):
    rng = np.random.default_rng(seed)
    base = np.asarray(mat.data)
    noise = rng.standard_normal((N, base.shape[0]))
    return (base[None] * (rng.random((N, 1)) + 0.5) + 0.1 * noise) * np.asarray(mat.live_mask())


def close(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL * max(np.abs(want).max(), 1.0))


@pytest.mark.parametrize("case", ["both", "one_x", "one_matrix"])
def test_batch_spmv(case):
    m = pattern(0)
    pm = port_of(m)
    rng = np.random.default_rng(2)
    data = batch_data(m, 5) if case != "one_matrix" else np.asarray(m.data)
    x = rng.standard_normal((5, 24)) if case != "one_x" else rng.standard_normal(24)
    got = batch_spmv(pm, data, x)
    assert tuple(got.shape) == (5, 30)
    close(got, j_batch.batch_spmv(m, data, x))
    for i in range(5):
        di = data[i] if data.ndim == 2 else data
        xi = x[i] if x.ndim == 2 else x
        close(got[i], tt.spmv(pm.with_data(torch.from_numpy(np.array(di))), torch.from_numpy(xi)))


def test_batch_spmm_and_csc():
    m = pattern(6)
    pm = port_of(m)
    data = batch_data(m, 3)
    x = np.random.default_rng(7).standard_normal((3, 24, 4))
    got = batch_spmm(pm, data, x)
    close(got, j_batch.batch_spmm(m, data, x))
    for i in range(3):
        close(got[i], tt.spmm(pm.with_data(torch.from_numpy(data[i])), torch.from_numpy(x[i])))
    # a CSC operand sums the same slots the other way round
    c = pm.to_csc()
    dc = np.stack([pm.with_data(torch.from_numpy(data[i])).to_csc().data.numpy()
                   for i in range(3)])
    close(batch_spmv(c, dc, x[:, :, 0]), got[:, :, 0])
    with pytest.raises(ShapeError):
        batch_spmv(pm, data[None], x[:, :, 0])


def test_batch_spgemm():
    a, b = pattern(10, 20, 16, 0.25), pattern(11, 16, 18, 0.25)
    ad, bd = batch_data(a, 4, seed=12), batch_data(b, 4, seed=13)
    got = batch_spgemm(port_of(a), port_of(b), ad, bd)
    want = j_batch.batch_spgemm(a, b, ad, bd)
    assert got.n_batch == 4
    nnz = int(got.indptr[-1])
    np.testing.assert_array_equal(got.indptr.numpy(), np.asarray(want.indptr))
    np.testing.assert_array_equal(got.indices.numpy()[:nnz], np.asarray(want.indices)[:nnz])
    for i in range(4):
        close(got.member(i).to_dense(), want.member(i).to_dense())
        loop = tt.spgemm(port_of(a).with_data(torch.from_numpy(ad[i])),
                         port_of(b).with_data(torch.from_numpy(bd[i])))
        close(got.member(i).to_dense(), loop.to_dense())
    # one broadcast operand, explicit caps
    prod, out = tt.spgemm_caps(port_of(a), port_of(b))
    one = batch_spgemm(port_of(a), port_of(b), np.asarray(a.data), bd, prod_cap=prod,
                       out_cap=out)
    close(one.member(2).to_dense(), st.spgemm(a, b.with_data(jnp.asarray(bd[2]))).to_dense())


@pytest.mark.parametrize("kind", ["super", "mf"])
def test_batched_ldl(kind):
    m = st.utils.dirichlet_laplacian((6, 8))
    pm = port_of(m)
    jsym = JLdl().fill_in_reduction("camd").check_symmetry(False).symbolic(m)
    sym = Ldl().fill_in_reduction("camd").check_symmetry(False).symbolic(pm)
    scales = np.random.default_rng(20).random(4) + 0.5
    data = np.asarray(m.to_csr().data)[None] * scales[:, None]
    bl, jbl = BatchedLdl(sym, kind=kind), j_batch.BatchedLdl(jsym, kind=kind)
    lx, d = bl.factor(torch.from_numpy(data))
    jl, jd = jbl.factor(data)
    assert tuple(lx.shape) == (4, sym.nnz) and tuple(d.shape) == (4, 48)
    scale = np.abs(np.asarray(jl)).max()
    np.testing.assert_allclose(lx.numpy(), np.asarray(jl), rtol=1e-10, atol=1e-10 * scale)
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-10)
    rhs = np.random.default_rng(21).standard_normal((4, 48))
    perm = sym.perm.perm.numpy()
    x = bl.solve(lx, d, torch.from_numpy(rhs[:, perm])).numpy()
    jx = np.asarray(jbl.solve(jl, jd, rhs[:, perm]))
    np.testing.assert_allclose(x, jx, rtol=1e-10, atol=1e-10 * np.abs(jx).max())
    dense = pm.to_dense().numpy()
    for i in range(4):
        host = sym.factor(pm.with_data(pm.data * scales[i]), backend="host")
        np.testing.assert_allclose(lx[i].numpy(), host.l_data.numpy(), rtol=1e-10,
                                   atol=1e-10 * scale)
        ref = np.linalg.solve(scales[i] * dense, rhs[i])
        np.testing.assert_allclose(x[i][sym.perm.inv.numpy()], ref, rtol=1e-10,
                                   atol=1e-10 * np.abs(ref).max())
