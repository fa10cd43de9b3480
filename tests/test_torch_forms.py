"""The plain versions of K1, K2 and K5 in every (data, x) type pair of
float16, bfloat16, float32 and float64, against the JAX package's Pallas
kernels in interpret mode, from one numpy seed, on the CPU.

Tolerance: bit for bit where the output is 16-bit; otherwise within
1e-6 of max|y| for a float32 output and 1e-13 for float64 (the JAX
kernels' XLA sums may add in another order, and the JAX K5's ``jnp.sum``
does).  The Pallas K5 refuses the six pairs whose promotion is not the
data's type (its output has the data's type); there the port is held to
the JAX package's ``prepare_spmv`` ELL arm, which computes them in XLA.

Also pinned here: the float16 products of the plain K1 and K2 are
rounded to float16 before their float32 sum, as the Pallas kernels'
are, on a 3,000-row band.  The kernels themselves run only on the card:
the ``gpu``-marked tests, one per kernel.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import sprs_tpu as st
from sprs_tpu.ops.pallas import dia_spmm_pallas, ell_spmv_pallas
from sprs_tpu.ops.pallas import dia_tile as jax_dia_tile
from sprs_tpu.ops.prod import prepare_spmv as jax_prepare_spmv
from sprs_tpu_torch.formats.dia import DiaMat
from sprs_tpu_torch.formats.ell import EllMat
from sprs_tpu_torch.ops.cuda import dia_spmm as k2
from sprs_tpu_torch.ops.cuda import dia_spmv as k1
from sprs_tpu_torch.ops.cuda import ell_spmv as k5
from sprs_tpu_torch.ops.cuda.forms import FORMS, form_of, widened
from sprs_tpu_torch.utils import grid_laplacian, rand_csr

F16, BF, F32, F64 = torch.float16, torch.bfloat16, torch.float32, torch.float64
NP = {F16: np.float16, BF: ml_dtypes.bfloat16, F32: np.float32, F64: np.float64}
PAIRS = list(FORMS)
IDS = list(FORMS.values())
LIMIT = {F32: 1e-6, F64: 1e-13}
OFFSETS = (-3, -1, 0, 2, 5)


def t_of(a: np.ndarray) -> torch.Tensor:
    """A numpy array (ml_dtypes' bfloat16 included) as a tensor, bit for
    bit."""
    a = np.ascontiguousarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(BF)
    return torch.from_numpy(a.copy())


def as_f64(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().double().numpy()
    return np.asarray(a).astype(np.float64)


def assert_form_equal(got, want, out):
    """Bit for bit for a 16-bit output (float64 holds it exactly; the
    sign of a zero counts), else within LIMIT of max|want|."""
    g, w = as_f64(got), as_f64(want)
    assert g.shape == w.shape
    if out.itemsize == 2:
        np.testing.assert_array_equal(g.view(np.int64), w.view(np.int64))
    else:
        np.testing.assert_allclose(g, w, rtol=0, atol=LIMIT[out] * max(np.abs(w).max(), 1e-300))


def band(n, seed):
    """A random n × n band with OFFSETS, as float64."""
    rng = np.random.default_rng(seed)
    d = np.zeros((n, n))
    for off in OFFSETS:
        i = np.arange(max(0, -off), min(n, n - off))
        d[i, i + off] = rng.standard_normal(i.size)
    return d


def dia_pair(dense, dtype):
    """(JAX DiaMat, port DiaMat) of ``dense`` with values in ``dtype``,
    the same bits on both sides."""
    jd = st.from_dense(dense).to_dia()
    jd = type(jd)(jd.data.astype(NP[dtype]), jd.offsets, jd.shape)
    return jd, DiaMat(t_of(np.asarray(jd.data)), tuple(jd.offsets), tuple(jd.shape))


def ell_pair(dense, dtype):
    je = st.from_dense(dense).to_ell()
    je = type(je)(je.indices, je.data.astype(NP[dtype]), je.shape)
    return je, EllMat(torch.from_numpy(np.array(je.indices)), t_of(np.asarray(je.data)), je.shape)


def draw(shape, dtype, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(NP[dtype])


def random_dense(r, c, density, seed):
    rng = np.random.default_rng(seed)
    d = rng.standard_normal((r, c))
    d[rng.random((r, c)) > density] = 0.0
    return d


# -- the forms table ----------------------------------------------------------


def test_forms_are_every_pair_of_four_float_types():
    types = (F16, BF, F32, F64)
    assert set(FORMS) == {(d, x) for d in types for x in types} and len(set(IDS)) == 16
    assert FORMS[(F32, F64)] == "f32_f64" and FORMS[(F16, F16)] == "f16"
    assert FORMS[(BF, F32)] == "bf16_f32" and FORMS[(F64, F64)] == "f64"


@pytest.mark.parametrize("data, x", [(torch.complex64, torch.complex64), (torch.int32, torch.int32),
                                     (F32, torch.complex128)])
def test_form_of_refuses_complex_and_integer(data, x):
    with pytest.raises(TypeError, match="dia_spmv kernel takes"):
        form_of("dia_spmv", torch.zeros(1, dtype=data), torch.zeros(1, dtype=x))


@pytest.mark.parametrize("data, x", PAIRS, ids=IDS)
def test_widened_rule(data, x):
    """(out, acc, prod): out = promote(data, x), acc = promote(out, f32),
    products in float16 only for (float16, float16); None where neither
    operand is 16-bit."""
    wide = widened(torch.zeros(1, dtype=data), torch.zeros(1, dtype=x))
    if data.itemsize > 2 and x.itemsize > 2:
        assert wide is None
        return
    out = torch.promote_types(data, x)
    acc = torch.promote_types(out, F32)
    assert wide == (out, acc, F16 if data == x == F16 else acc)


# -- the kernels' function, pair by pair ----------------------------------------


@pytest.mark.parametrize("data, x", PAIRS, ids=IDS)
def test_k1_plain_matches_the_pallas_kernel(data, x):
    jd, td = dia_pair(band(300, 11), data)
    v = draw(300, x, 12)
    want = jax_dia_tile(jd).spmv(jnp.asarray(v), interpret=True)
    got = k1.dia_spmv_plain(td, t_of(v))
    out = torch.promote_types(data, x)
    assert got.dtype == out and np.dtype(want.dtype) == np.dtype(NP[out])
    assert_form_equal(got, want, out)
    assert k1.dia_spmv_kernel(td, t_of(v)).dtype == out  # the CPU wrapper: the plain version


@pytest.mark.parametrize("data, x", PAIRS, ids=IDS)
def test_k2_plain_matches_the_pallas_kernel(data, x):
    jd, td = dia_pair(band(200, 13), data)
    v = draw((200, 8), x, 14)
    want = dia_spmm_pallas(jd, jnp.asarray(v), interpret=True)
    got = k2.dia_spmm_plain(td, t_of(v))
    out = torch.promote_types(data, x)
    assert got.dtype == out and got.shape == (200, 8) and np.dtype(want.dtype) == np.dtype(NP[out])
    assert_form_equal(got, want, out)


@pytest.mark.parametrize("data, x", PAIRS, ids=IDS)
def test_k5_plain_matches_the_pallas_kernel_or_the_jax_route(data, x):
    """Where the Pallas K5 takes the pair, the port's plain K5 meets the
    form tolerance against it; where it raises (its output has the data's
    type), the port is within 1e-6 of max|y| of the JAX ``prepare_spmv``
    ELL arm, which returns promote(data, x)."""
    dense = random_dense(96, 80, 0.07, 15)
    je, te = ell_pair(dense, data)
    v = draw(80, x, 16)
    out = torch.promote_types(data, x)
    got = k5.ell_spmv_plain(te, t_of(v))
    assert got.dtype == out
    if out == data:
        want = ell_spmv_pallas(je, jnp.asarray(v), interpret=True)
        assert np.dtype(want.dtype) == np.dtype(NP[out])
        assert_form_equal(got, want, out)
        return
    with pytest.raises(ValueError):
        ell_spmv_pallas(je, jnp.asarray(v), interpret=True)
    jm = st.from_dense(dense).astype(NP[data])
    fn, prep = jax_prepare_spmv(jm)
    assert type(prep).__name__ == "EllMat"
    want = fn(prep, jnp.asarray(v))
    assert np.dtype(want.dtype) == np.dtype(NP[out])
    w = as_f64(want)
    np.testing.assert_allclose(as_f64(got), w, rtol=0, atol=1e-6 * np.abs(w).max())


# -- the float16 plain products (a fault of the earlier plain versions) -------------


def test_f16_plain_products_round_to_f16_as_the_pallas_kernels():
    """On (float16, float16) at 3,000 rows, K1's and K2's plain versions
    equal the Pallas kernels bit for bit: each product rounded to float16,
    then summed in float32 in diagonal order and rounded once.  Products
    kept in float32 differ in about 40 % of the outputs."""
    jd, td = dia_pair(band(3000, 21), F16)
    v = draw(3000, F16, 22)
    V = draw((3000, 8), F16, 23)
    want1 = jax_dia_tile(jd).spmv(jnp.asarray(v), interpret=True)
    want2 = dia_spmm_pallas(jd, jnp.asarray(V), interpret=True)
    got1 = k1.dia_spmv_plain(td, t_of(v))
    got2 = k2.dia_spmm_plain(td, t_of(V))
    assert got1.dtype == got2.dtype == F16
    assert_form_equal(got1, want1, F16)
    assert_form_equal(got2, want2, F16)
    f32_products = k1.dia_spmv_plain(DiaMat(td.data.float(), td.offsets, td.shape), t_of(v).float())
    assert (as_f64(f32_products.half()) != as_f64(want1)).mean() > 0.2


# -- the kernels on the card -------------------------------------------------------


def card_cases(kernel):
    """Every pair on a small band (K1, K2 at widths 3 and 24) or a random
    ELL (K5), on the card."""
    lap = grid_laplacian((40, 36), F64, device="cuda")
    ell64 = rand_csr((700, 600), 0.02, seed=4, dtype=F64, device="cuda").to_ell()
    gen = torch.Generator(device="cuda").manual_seed(5)
    for data, x in PAIRS:
        if kernel == "ell":
            op = EllMat(ell64.indices, ell64.data.to(data), ell64.shape)
            yield data, x, op, torch.randn(op.cols, generator=gen, device="cuda", dtype=F64).to(x)
            continue
        op = k1.dia_tile(DiaMat(lap.to_dia().data.to(data), lap.to_dia().offsets, lap.shape))
        if kernel == "k1":
            yield data, x, op, torch.randn(op.cols, generator=gen, device="cuda", dtype=F64).to(x)
        else:
            for k in (3, 24):
                yield data, x, op, torch.randn((op.cols, k), generator=gen, device="cuda", dtype=F64).to(x)


@pytest.mark.gpu
@pytest.mark.parametrize("kernel, wrapper, plain", [
    ("k1", k1.dia_spmv_kernel, k1.dia_spmv_plain),
    ("k2", k2.dia_spmm_kernel, k2.dia_spmm_plain),
    ("ell", k5.ell_spmv_kernel, k5.ell_spmv_plain),
], ids=["K1", "K2", "K5"])
def test_kernel_takes_every_pair_on_card(kernel, wrapper, plain):
    """Each pair launches its own form on the card (its counter moves by
    one) and meets the form tolerance against its plain version; K5's
    16-bit outputs within one 16-bit step of max|y| (its shuffle tree adds
    in another order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for data, x, op, v in card_cases(kernel):
        form = FORMS[(data, x)]
        before = getattr(wrapper, f"launches_{form}")
        y = wrapper(op, v)
        ref = plain(op, v)
        torch.cuda.synchronize()
        assert getattr(wrapper, f"launches_{form}") == before + 1
        out = torch.promote_types(data, x)
        assert y.dtype == ref.dtype == out
        if out.itemsize == 2 and kernel == "ell":
            step = 2.0**-7 if out == BF else 2.0**-10
            assert float((y.double() - ref.double()).abs().max()) <= step * float(ref.double().abs().max())
        else:
            assert_form_equal(y.cpu(), ref.cpu(), out)
