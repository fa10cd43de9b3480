"""Dtype coverage of the PyTorch port and its tolerance table, the
counterpart of tests/test_dtypes.py, with the bfloat16 paths held against
the JAX package.

| dtype     | SpMV/SpMM rtol | notes                              |
|-----------|----------------|------------------------------------|
| float64   | 1e-12          | CPU parity path                    |
| float32   | 1e-5           | default device dtype               |
| bfloat16  | 5e-2           | storage bf16, accumulate f32       |

Against the JAX package, from one numpy seed, on the CPU:

* the plain versions of K1, K2 and K5 take products and sums in float32
  and round once, as the Pallas kernels do in interpret mode: bit-equal;
* the ``formats`` products keep the JAX package's XLA semantics (bfloat16
  products and partial sums): bit-equal to its ``dia_spmv``,
  ``dia_spmm`` and ``ell_spmv``;
* bfloat16 data with float32 x through ``prepare_spmv``: bit-equal to the
  JAX package's DIA arm, within 1e-6 of max|y| on the ELL arm (XLA's row
  sum runs in its own order);
* the host conversions of a bfloat16 CsMat (routing, ``to_dia``,
  ``to_scipy``, ``TriMat``, ``rand_csr``, npz, Matrix Market) equal the
  JAX package's outputs.

The kernels themselves run only on the card: the ``gpu``-marked tests.
"""

import io
import subprocess
import sys

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import sprs_tpu as st
import sprs_tpu.io.matrix_market as jmm
import sprs_tpu.io.serialize as jser
from sprs_tpu.formats.dia import dia_spmm as jax_dia_spmm
from sprs_tpu.formats.dia import dia_spmv as jax_dia_spmv
from sprs_tpu.formats.ell import ell_spmv as jax_ell_spmv
from sprs_tpu.linalg import cg as jax_cg
from sprs_tpu.linalg import expm_multiply as jax_expm
from sprs_tpu.ops.prod import prepare_spmm as jax_prepare_spmm
from sprs_tpu.ops.prod import prepare_spmv as jax_prepare_spmv
from sprs_tpu.ops.pallas import dia_spmm_pallas, ell_spmv_pallas
from sprs_tpu.ops.pallas import dia_tile as jax_dia_tile
from sprs_tpu.utils.special import dirichlet_laplacian as jax_dirichlet
from sprs_tpu.utils.special import grid_laplacian as jax_grid
import sprs_tpu_torch as pt
from sprs_tpu_torch.formats.bsr import bsr_from_dense, bsr_spmm_plain
from sprs_tpu_torch.formats.dia import DiaMat, dia_spmm, dia_spmv
from sprs_tpu_torch.formats.ell import EllMat, ell_spmv
from sprs_tpu_torch.io import matrix_market as tmm
from sprs_tpu_torch.io import serialize as tser
from sprs_tpu_torch.linalg import cg, expm_multiply
from sprs_tpu_torch.ops.cuda import dia_spmm as k2
from sprs_tpu_torch.ops.cuda import dia_spmv as k1
from sprs_tpu_torch.ops.cuda import ell_spmv as k5
from sprs_tpu_torch.ops.cuda.dia_spmv import dia_tile
from sprs_tpu_torch.utils import dirichlet_laplacian, grid_laplacian, rand_csr

RTOL = {np.float64: 1e-12, np.float32: 1e-5}
BF16_RTOL = 5e-2
BF = torch.bfloat16
JBF = ml_dtypes.bfloat16


def random_sparse(r, c, density, seed, dtype):
    rng = np.random.default_rng(seed)
    d = rng.standard_normal((r, c))
    d[rng.random((r, c)) > density] = 0.0
    return d.astype(dtype)


def bf16_t(a) -> torch.Tensor:
    """ml_dtypes' bfloat16 values as a bfloat16 tensor, bit for bit."""
    return torch.from_numpy(np.asarray(a).astype(JBF).view(np.int16).copy()).view(BF)


def bits(a) -> np.ndarray:
    """The bit patterns of a float32 or bfloat16 result, as int32 of
    float32 (a bfloat16 value is exact in float32)."""
    a = a.detach().cpu().float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float32)
    return a.view(np.int32)


def band(n=24, offsets=(-2, 0, 2), seed=5):
    """The 24 × 24 band of tests/test_dtypes.py, float32 values rounded to
    bfloat16, as a dense float32 array."""
    rng = np.random.default_rng(seed)
    d = np.zeros((n, n), np.float32)
    for off in offsets:
        for i in range(n):
            if 0 <= i + off < n:
                d[i, i + off] = rng.standard_normal()
    return d.astype(JBF).astype(np.float32)


def random_32x24(seed=0):
    return random_sparse(32, 24, 0.3, seed, np.float32).astype(JBF).astype(np.float32)


def both(dense):
    """(JAX bf16 CsMat, port bf16 CsMat) of one float32 array."""
    return (st.from_dense(dense).astype(jnp.bfloat16),
            pt.from_dense(dense, device="cpu").astype(BF))


# -- the tolerance table, float and bfloat16 -----------------------------


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
class TestFloatDtypes:
    def test_spmv(self, dtype):
        d = random_sparse(30, 20, 0.3, 0, dtype)
        x = np.random.default_rng(1).standard_normal(20).astype(dtype)
        y = pt.spmv(pt.from_dense(d, device="cpu"), torch.from_numpy(x))
        assert y.dtype == pt.formats.util.torch_dtype(dtype)
        np.testing.assert_allclose(y.numpy(), d.astype(np.float64) @ x.astype(np.float64),
                                   rtol=RTOL[dtype])

    def test_spgemm(self, dtype):
        da = random_sparse(15, 12, 0.3, 2, dtype)
        db = random_sparse(12, 18, 0.3, 3, dtype)
        c = pt.spgemm(pt.from_dense(da, device="cpu"), pt.from_dense(db, device="cpu"))
        assert c.data.numpy().dtype == dtype
        np.testing.assert_allclose(c.to_dense().numpy(), da.astype(np.float64) @ db.astype(np.float64),
                                   rtol=RTOL[dtype], atol=RTOL[dtype])

    def test_binop(self, dtype):
        da = random_sparse(10, 10, 0.4, 4, dtype)
        db = random_sparse(10, 10, 0.4, 5, dtype)
        c = pt.from_dense(da, device="cpu") + pt.from_dense(db, device="cpu")
        np.testing.assert_allclose(c.to_dense().numpy(), da + db, rtol=RTOL[dtype])


class TestBf16:
    """bf16 storage, f32 accumulation — the production mix."""

    def _mat(self, seed=0):
        d = random_sparse(32, 24, 0.3, seed, np.float64)
        d16 = torch.from_numpy(d).to(BF)
        return d16.double().numpy(), d16

    def test_spmv_csr(self):
        d64, d16 = self._mat()
        m = pt.from_dense(d16.float(), device="cpu").astype(BF)
        x = torch.from_numpy(np.random.default_rng(1).standard_normal(24)).to(BF)
        y = pt.spmv(m, x).double().numpy()
        np.testing.assert_allclose(y, d64 @ x.double().numpy(), rtol=BF16_RTOL, atol=1e-2)

    def test_ell_spmv(self):
        d64, d16 = self._mat(seed=2)
        ell = pt.from_dense(d16.float(), device="cpu").to_ell()
        ell = EllMat(ell.indices, ell.data.to(BF), ell.shape)
        x = torch.from_numpy(np.random.default_rng(3).standard_normal(24)).to(BF)
        y = ell_spmv(ell, x).double().numpy()
        np.testing.assert_allclose(y, d64 @ x.double().numpy(), rtol=BF16_RTOL, atol=1e-2)

    def test_bsr_spmm_f32_accum(self):
        rng = np.random.default_rng(4)
        d = rng.standard_normal((16, 16)).astype(np.float32)
        b = bsr_from_dense(torch.from_numpy(d).to(BF), 8, device="cpu")
        x = torch.from_numpy(rng.standard_normal((16, 8))).to(BF)
        y = bsr_spmm_plain(b, x).double().numpy()
        ref = b.to_dense().double().numpy() @ x.double().numpy()
        np.testing.assert_allclose(y, ref, rtol=BF16_RTOL, atol=5e-2)

    def test_dia_spmv(self):
        d16 = band()
        dia = pt.from_dense(d16, device="cpu").to_dia()
        dia = DiaMat(dia.data.to(BF), dia.offsets, dia.shape)
        x = torch.from_numpy(np.random.default_rng(5).standard_normal(24)).to(BF)
        y = dia_spmv(dia, x).double().numpy()
        np.testing.assert_allclose(y, d16.astype(np.float64) @ x.double().numpy(),
                                   rtol=BF16_RTOL, atol=1e-2)

    def test_astype_roundtrip(self):
        d = random_sparse(8, 8, 0.5, 6, np.float32)
        m = pt.from_dense(d, device="cpu").astype(BF)
        assert m.dtype == BF
        back = m.astype(torch.float32)
        np.testing.assert_array_equal(back.to_dense().numpy(), d.astype(JBF).astype(np.float32))


class TestComplex:
    def test_spmv_complex(self):
        rng = np.random.default_rng(7)
        d = (rng.standard_normal((10, 10)) + 1j * rng.standard_normal((10, 10))).astype(np.complex64)
        d[rng.random((10, 10)) > 0.4] = 0
        x = (rng.standard_normal(10) + 1j * rng.standard_normal(10)).astype(np.complex64)
        y = pt.spmv(pt.from_dense(d, device="cpu"), torch.from_numpy(x))
        np.testing.assert_allclose(y.numpy(), d @ x, rtol=1e-4)

    def test_spgemm_complex(self):
        rng = np.random.default_rng(8)
        d = (rng.standard_normal((8, 8)) + 1j * rng.standard_normal((8, 8))).astype(np.complex64)
        d[rng.random((8, 8)) > 0.5] = 0
        m = pt.from_dense(d, device="cpu")
        np.testing.assert_allclose(pt.spgemm(m, m).to_dense().numpy(), d @ d, rtol=1e-3, atol=1e-4)


class TestIntData:
    def test_spmv_int(self):
        d = np.array([[1, 0, 2], [0, 3, 0], [4, 0, 5]], np.int32)
        y = pt.spmv(pt.from_dense(d, device="cpu"), torch.tensor([1, 2, 3], dtype=torch.int32))
        np.testing.assert_array_equal(y.numpy(), d @ np.array([1, 2, 3]))


# -- the kernels' function on bfloat16, against the JAX kernels ------------


def jax_dia(dense32):
    """(JAX bf16 DiaMat, port bf16 DiaMat) of a banded float32 array."""
    jd = st.from_dense(dense32).to_dia()
    jd = type(jd)(jd.data.astype(jnp.bfloat16), jd.offsets, jd.shape)
    return jd, DiaMat(bf16_t(np.asarray(jd.data)), tuple(jd.offsets), tuple(jd.shape))


def test_k1_plain_bit_equal_to_the_pallas_kernel():
    """K1's plain version on (bf16, bf16) against ``dia_tile(...).spmv``
    in interpret mode: float32 products and sums, one rounding."""
    jd, td = jax_dia(band(200, (-3, -1, 0, 2, 5), 11))
    x = np.random.default_rng(12).standard_normal(200).astype(JBF)
    want = jax_dia_tile(jd).spmv(jnp.asarray(x), interpret=True)
    got = k1.dia_spmv_plain(td, bf16_t(x))
    assert got.dtype == BF and want.dtype == jnp.bfloat16
    np.testing.assert_array_equal(bits(got), bits(want))
    # the JAX package's XLA product rounds each partial sum: it differs
    assert (bits(jax_dia_spmv(jd, jnp.asarray(x))) != bits(got)).any()


def test_k2_plain_bit_equal_to_the_pallas_kernel():
    jd, td = jax_dia(band(160, (-4, 0, 1, 7), 13))
    x = np.random.default_rng(14).standard_normal((160, 12)).astype(JBF)
    want = dia_spmm_pallas(jd, jnp.asarray(x), interpret=True)
    got = k2.dia_spmm_plain(td, bf16_t(x))
    assert got.dtype == BF and got.shape == (160, 12)
    np.testing.assert_array_equal(bits(got), bits(want))


def test_k5_plain_bit_equal_to_the_pallas_kernel():
    """K5's plain version adds the slots in slot order in float32, as the
    Pallas kernel's row sum does in interpret mode."""
    d = random_sparse(96, 80, 0.12, 15, np.float32)
    ell = st.from_dense(d).to_ell()
    ell = type(ell)(ell.indices, ell.data.astype(jnp.bfloat16), ell.shape)
    tell = EllMat(torch.from_numpy(np.array(ell.indices)), bf16_t(np.asarray(ell.data)), ell.shape)
    x = np.random.default_rng(16).standard_normal(80).astype(JBF)
    want = ell_spmv_pallas(ell, jnp.asarray(x), interpret=True)
    got = k5.ell_spmv_plain(tell, bf16_t(x))
    assert got.dtype == BF
    np.testing.assert_array_equal(bits(got), bits(want))


def test_formats_products_bit_equal_to_jax_xla():
    """``formats`` keeps the XLA products' bfloat16 semantics."""
    jd, td = jax_dia(band(200, (-3, -1, 0, 2, 5), 17))
    rng = np.random.default_rng(18)
    x = rng.standard_normal(200).astype(JBF)
    X = rng.standard_normal((200, 6)).astype(JBF)
    np.testing.assert_array_equal(bits(dia_spmv(td, bf16_t(x))), bits(jax_dia_spmv(jd, jnp.asarray(x))))
    np.testing.assert_array_equal(bits(dia_spmm(td, bf16_t(X))), bits(jax_dia_spmm(jd, jnp.asarray(X))))
    ell = st.from_dense(random_sparse(64, 50, 0.15, 19, np.float32)).to_ell()
    ell = type(ell)(ell.indices, ell.data.astype(jnp.bfloat16), ell.shape)
    tell = EllMat(torch.from_numpy(np.array(ell.indices)), bf16_t(np.asarray(ell.data)), ell.shape)
    xe = rng.standard_normal(50).astype(JBF)
    np.testing.assert_array_equal(bits(ell_spmv(tell, bf16_t(xe))), bits(jax_ell_spmv(ell, jnp.asarray(xe))))


@pytest.mark.parametrize("dense, route", [(band, "dia"), (random_32x24, "ell")])
def test_mixed_forms_against_jax_prepare_spmv(dense, route):
    """bfloat16 data, float32 x through both packages' ``prepare_spmv``:
    float32 out; the DIA arm bit-equal, the ELL arm within 1e-6."""
    jm, tm = both(dense())
    x = np.random.default_rng(20).standard_normal(jm.shape[1]).astype(np.float32)
    jfn, jprep = jax_prepare_spmv(jm)
    tfn, tprep = pt.prepare_spmv(tm)
    assert {"DiaTiledMat": "dia", "EllMat": "ell"}[type(tprep).__name__] == route
    want = np.asarray(jfn(jprep, jnp.asarray(x)))
    got = tfn(tprep, torch.from_numpy(x))
    assert got.dtype == torch.float32 and want.dtype == np.float32
    if route == "dia":
        np.testing.assert_array_equal(bits(got), bits(want))
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6 * np.abs(want).max())


def test_cg_over_a_bf16_operator_matches_jax():
    """f32 CG over the 32² Dirichlet Laplacian stored in bfloat16 (its
    entries, -1 and 4, are exact): the JAX package's iteration count, x
    within 1e-6 of max|x| (the two packages' float32 dot products sum in
    other orders)."""
    b = np.random.default_rng(21).standard_normal(32 * 32).astype(np.float32)
    want = jax_cg(jax_dirichlet((32, 32)).astype(jnp.bfloat16), jnp.asarray(b), tol=1e-4)
    got = cg(dirichlet_laplacian((32, 32), BF, device="cpu"), torch.from_numpy(b), tol=1e-4)
    assert got.converged and got.x.dtype == torch.float32
    assert got.iterations == int(want.iterations)
    want_x = np.asarray(want.x)
    np.testing.assert_allclose(got.x.numpy(), want_x, rtol=0, atol=1e-6 * np.abs(want_x).max())


def test_expm_over_a_bf16_operator():
    """Block ``expm_multiply`` over the 16² grid Laplacian stored in
    bfloat16, with float32 sources: bit-equal to the same call over the
    float32-stored operator, within 1e-6 of the JAX package's."""
    n = 16 * 16
    B = np.zeros((n, 3), np.float32)
    B[[5, 100, 200], [0, 1, 2]] = 1.0
    got = expm_multiply(grid_laplacian((16, 16), BF, device="cpu"), torch.from_numpy(B), t=-1.0)
    f32 = expm_multiply(grid_laplacian((16, 16), torch.float32, device="cpu"), torch.from_numpy(B), t=-1.0)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(bits(got), bits(f32))
    want = np.asarray(jax_expm(jax_grid((16, 16)).astype(jnp.bfloat16), jnp.asarray(B), t=-1.0))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_backwards_widen_bf16():
    """The backwards of K1, K2 and K5 on bfloat16 operands give ddata in
    bfloat16 and dx in x's type, equal to torch's autograd of the plain
    version."""
    td = jax_dia(band(40, (-2, 0, 3), 22))[1]
    rng = np.random.default_rng(23)
    cases = [
        (k1.dia_spmv_kernel, k1.dia_spmv_plain, td, torch.from_numpy(rng.standard_normal(40)).float()),
        (k2.dia_spmm_kernel, k2.dia_spmm_plain, td, torch.from_numpy(rng.standard_normal((40, 4))).to(BF)),
    ]
    ell = pt.from_dense(random_sparse(30, 40, 0.2, 24, np.float32), device="cpu").to_ell()
    ell = EllMat(ell.indices, ell.data.to(BF), ell.shape)
    cases.append((k5.ell_spmv_kernel, k5.ell_spmv_plain, ell, torch.from_numpy(rng.standard_normal(40)).float()))
    for kernel, plain, op, x in cases:
        outs = []
        for fn in (kernel, plain):
            data = op.data.clone().requires_grad_(True)
            xg = x.clone().requires_grad_(True)
            m = type(op)(op.indices, data, op.shape) if isinstance(op, EllMat) else DiaMat(data, op.offsets, op.shape)
            y = fn(m, xg)
            g = torch.ones_like(y)
            outs.append(torch.autograd.grad(y, (data, xg), g))
        (dd, dx), (pd, px) = outs
        assert dd.dtype == BF and dx.dtype == x.dtype
        for a, b in ((dd, pd), (dx, px)):
            np.testing.assert_allclose(a.double().numpy(), b.double().numpy(), rtol=0,
                                       atol=2.0**-7 * float(b.double().abs().max()))


# -- fault 1: the host conversions of a bfloat16 CsMat ----------------------


ROUTE = {"DiaTiledMat": "dia", "DiaMat": "dia", "EllMat": "ell", "CsMat": "csr"}


@pytest.mark.parametrize("dense", [band, random_32x24])
def test_routes_and_to_dia_equal_jax(dense):
    jm, tm = both(dense())
    for jprep, tprep in ((jax_prepare_spmv, pt.prepare_spmv), (jax_prepare_spmm, pt.prepare_spmm)):
        jp, tp = jprep(jm)[1], tprep(tm)[1]
        assert ROUTE[type(jp).__name__] == ROUTE[type(tp).__name__]
    jd, td = jm.to_dia(), tm.to_dia()
    assert tuple(jd.offsets) == td.offsets and td.data.dtype == BF
    np.testing.assert_array_equal(bits(td.data), bits(np.asarray(jd.data)))
    back = pt.formats.dia.dia_to_csmat(td)
    assert back.dtype == BF
    np.testing.assert_array_equal(bits(back.to_dense()), bits(np.asarray(st.formats.dia.dia_to_csmat(jd).to_dense())))


@pytest.mark.parametrize("dense", [band, random_32x24])
def test_to_scipy_equal_jax(dense):
    jm, tm = both(dense())
    js, ts = jm.to_scipy(), tm.to_scipy()
    assert ts.dtype == js.dtype == JBF
    np.testing.assert_array_equal(ts.indptr, js.indptr)
    np.testing.assert_array_equal(ts.indices, js.indices)
    np.testing.assert_array_equal(ts.data.astype(np.float32), js.data.astype(np.float32))


def test_trimat_bf16_equal_jax():
    rows, cols = [0, 2, 1, 2], [1, 0, 2, 2]
    vals = [0.1, -2.3, 7.77, 1e-3]
    jt = st.TriMat((3, 3), dtype=jnp.bfloat16)
    tt = pt.TriMat((3, 3), dtype=BF)
    for r, c, v in zip(rows, cols, vals):
        jt.add_triplet(r, c, v)
        tt.add_triplet(r, c, v)
    assert tt.dtype == BF and np.dtype(jt.dtype).name == "bfloat16"
    np.testing.assert_array_equal(tt.data(), np.asarray(jt.data(), np.float32))
    np.testing.assert_array_equal(tt.to_dense(), np.asarray(jt.to_dense(), np.float32))
    jc, tc = jt.to_csr(), tt.to_csr(device="cpu")
    assert tc.dtype == BF
    np.testing.assert_array_equal(bits(tc.to_dense()), bits(np.asarray(jc.to_dense())))
    tf = pt.TriMat.from_triplets((3, 3), rows, cols, torch.tensor(vals).to(BF))
    np.testing.assert_array_equal(bits(tf.to_csr(device="cpu").to_dense()), bits(tc.to_dense()))


def test_rand_csr_bf16_equal_jax():
    from sprs_tpu.utils.rand import rand_csr as jax_rand_csr

    jm = jax_rand_csr((40, 30), 0.2, seed=3, dtype=jnp.bfloat16)
    tm = rand_csr((40, 30), 0.2, seed=3, dtype=BF, device="cpu")
    assert tm.dtype == BF
    np.testing.assert_array_equal(tm.indptr.numpy(), np.asarray(jm.indptr))
    np.testing.assert_array_equal(bits(tm.data), bits(np.asarray(jm.data)))


def test_npz_bf16_loads_in_both_packages(tmp_path):
    """The port's file loads in both packages (the JAX one sees float32
    values), and the JAX package's own file, which holds |V2 voids that its
    loader refuses, loads in the port."""
    jm, tm = both(random_32x24())
    path = str(tmp_path / "port.npz")
    tser.save_npz(path, tm)
    back = tser.load_npz(path, device="cpu")
    assert back.dtype == BF and torch.equal(back.data.view(torch.int16), tm.data.view(torch.int16))
    jback = jser.load_npz(path)
    np.testing.assert_array_equal(np.asarray(jback.to_dense()), np.asarray(jm.to_dense(), np.float32))
    jpath = str(tmp_path / "jax.npz")
    jser.save_npz(jpath, jm)
    fromjax = tser.load_npz(jpath, device="cpu")
    assert fromjax.dtype == BF and torch.equal(fromjax.data.view(torch.int16), tm.data.view(torch.int16))
    vec = pt.csvec(24, [1, 5], torch.tensor([0.5, -3.0]).to(BF), device="cpu")
    tser.save_npz(str(tmp_path / "v.npz"), vec)
    assert torch.equal(tser.load_npz(str(tmp_path / "v.npz"), device="cpu").data, vec.data)


@pytest.mark.parametrize("symmetry", ["general", "symmetric"])
def test_matrix_market_bf16_text_equal_jax(symmetry):
    jm, tm = both(band())
    jb, tb = io.StringIO(), io.StringIO()
    jmm.write_matrix_market(jb, jm, symmetry=symmetry)
    tmm.write_matrix_market(tb, tm, symmetry=symmetry)
    assert tb.getvalue() == jb.getvalue()


def test_bf16_paths_run_without_ml_dtypes():
    """The card's machine has no ml_dtypes: with it blocked from import,
    routing, ``dia_from_csmat`` and the bfloat16 plain versions run."""
    code = """
import sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name == "ml_dtypes" or name.startswith("ml_dtypes."):
            raise ImportError("ml_dtypes is blocked")
sys.meta_path.insert(0, Block())
import torch
import sprs_tpu_torch as pt
from sprs_tpu_torch.formats.dia import dia_from_csmat
from sprs_tpu_torch.ops.cuda.dia_spmm import dia_spmm_plain
from sprs_tpu_torch.ops.cuda.ell_spmv import ell_spmv_plain
from sprs_tpu_torch.utils import dirichlet_laplacian, rand_csr
lap = dirichlet_laplacian((8, 8), torch.bfloat16, device="cpu")
fn, prep = pt.prepare_spmv(lap)
y = fn(prep, torch.ones(64))
dia = dia_from_csmat(lap)
Y = dia_spmm_plain(dia, torch.ones(64, 3, dtype=torch.bfloat16))
m = rand_csr((50, 50), 0.1, seed=1, dtype=torch.bfloat16, device="cpu")
e = ell_spmv_plain(m.to_ell(), torch.ones(50, dtype=torch.bfloat16))
assert type(prep).__name__ == "DiaTiledMat" and y.dtype == torch.float32
assert Y.dtype == e.dtype == torch.bfloat16 and "ml_dtypes" not in sys.modules
print("ok")
"""
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stdout + proc.stderr


# -- the kernels on the card --------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.float32])
def test_bf16_kernels_match_plain_on_card(x_dtype):
    """K1, K2 (both variants) and K5 in their bfloat16 forms against their
    plain versions on the card: K1 and K2 bit-equal in (bf16, bf16), the
    rest within 1e-5 of max|y| for a float32 output and one bfloat16 step
    (2^-7 of max|y|) for K5's bfloat16 output."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    lap = grid_laplacian((48, 40), BF, device="cuda")
    dia = dia_tile(lap.to_dia())
    ell = rand_csr((500, 400), 0.02, seed=4, dtype=BF, device="cuda").to_ell()
    rng = np.random.default_rng(25)
    x = torch.from_numpy(rng.standard_normal(dia.cols)).to("cuda", x_dtype)
    cases = [(k1.dia_spmv_kernel, k1.dia_spmv_plain, dia, x)]
    for k in (16, 5):  # the vector variant, then the scalar one
        X = torch.from_numpy(rng.standard_normal((dia.cols, k))).to("cuda", x_dtype)
        cases.append((k2.dia_spmm_kernel, k2.dia_spmm_plain, dia, X))
    cases.append((k5.ell_spmv_kernel, k5.ell_spmv_plain, ell,
                  torch.from_numpy(rng.standard_normal(400)).to("cuda", x_dtype)))
    for kernel, plain, op, v in cases:
        y, ref = kernel(op, v), plain(op, v)
        assert y.dtype == ref.dtype == x_dtype
        if x_dtype == BF and kernel is not k5.ell_spmv_kernel:
            assert torch.equal(y.view(torch.int16), ref.view(torch.int16))
        else:
            limit = 2.0**-7 if x_dtype == BF else 1e-5
            err = float((y.float() - ref.float()).abs().max())
            assert err <= limit * float(ref.float().abs().max())
