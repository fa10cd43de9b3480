"""K3 and K4 of the PyTorch port in every (blocks, X) type pair of float16,
bfloat16, float32 and float64, against the JAX package on the CPU.

The kernel wrappers (``bsr_spmm_kernel``, ``bsr_spmv_kernel``,
``bsr_spmm_grouped_kernel``) are the counterparts of the Pallas functions
(``bsr_spmm_pallas``, ``bsr_spmv_pallas``, ``bsr_spmm_pallas_grouped``,
run in interpret mode): Y in promote(blocks, X), products and sums in
float32, one rounding.  The public ``@`` is the counterpart of the JAX
``@`` (``bsr_spmm_xla``): Y in X's type where the blocks share it, else
float32.  Inputs come from one numpy seed and go to both packages.

Tolerance: within 1e-5 of max|Y| for a float32 or float64 Y (float32
sums in another order; a float64 operand is rounded to float32 in both
packages), one step of a 16-bit Y at its largest magnitude (2⁻⁷·max|Y|
for bfloat16, 2⁻¹⁰ for float16: the float32 sums, taken in another
order, may round to neighbouring 16-bit values).  The TF32 kernel's pass
rule is held by a model of its arithmetic in plain torch; the kernels
themselves run only on the card (the ``gpu``-marked test).
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from sprs_tpu.formats.bsr import bsr_from_dense as jax_bsr_from_dense
from sprs_tpu.formats.bsr import bsr_spmm_xla
from sprs_tpu.ops.pallas import (
    bsr_group as jax_bsr_group,
    bsr_spmm_pallas,
    bsr_spmm_pallas_grouped,
    bsr_spmv_pallas,
)
import sprs_tpu_torch.ops as ops
from sprs_tpu_torch.formats.bsr import BsrMat, bsr_from_dense, bsr_random, bsr_spmm_plain
from sprs_tpu_torch.interop import from_arrays
from sprs_tpu_torch.ops.cuda import bsr_spmm as k3
from sprs_tpu_torch.ops.cuda.bsr_spmm import (
    bsr_group,
    bsr_spmm_grouped_kernel,
    bsr_spmm_kernel,
    bsr_spmv_kernel,
)
from sprs_tpu_torch.ops.cuda.forms import FORMS, HALVES, form_of

F16, BF, F32, F64 = torch.float16, torch.bfloat16, torch.float32, torch.float64
NP = {F16: np.float16, BF: ml_dtypes.bfloat16, F32: np.float32, F64: np.float64}
PAIRS = list(FORMS)
IDS = list(FORMS.values())
LIMIT = {F32: 1e-5, F64: 1e-5, BF: 2.0**-7, F16: 2.0**-10}
BS = 8


def t_of(a) -> torch.Tensor:
    """A numpy or JAX array (ml_dtypes' bfloat16 included) as a tensor,
    bit for bit."""
    a = np.ascontiguousarray(np.asarray(a))
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(BF)
    return torch.from_numpy(a.copy())


def port_of(b):
    """The port's BsrMat holding a JAX BsrMat's arrays, padding included."""
    return from_arrays("bsr", b.shape, (np.asarray(b.brows), np.asarray(b.bcols), np.asarray(b.blocks)),
                       n_blocks=b.n_blocks, device="cpu")


def dense_fixture():
    """A 45×37 matrix of 8×8 blocks, block row 1 empty."""
    rng = np.random.default_rng(130)
    keep = rng.random((6, 5)) < 0.5
    keep[1] = False
    d = np.zeros((48, 40))
    for i, j in zip(*np.nonzero(keep)):
        d[i * BS : (i + 1) * BS, j * BS : (j + 1) * BS] = rng.standard_normal((BS, BS))
    return d[:45, :37]


def assert_same(got: torch.Tensor, want, out: torch.dtype):
    """``got`` has the type ``out`` and the shape of ``want``, and is
    within LIMIT[out] of max|want|."""
    assert got.dtype == out
    g, w = got.detach().double().numpy(), np.asarray(want).astype(np.float64)
    assert g.shape == w.shape
    np.testing.assert_allclose(g, w, rtol=0, atol=LIMIT[out] * max(np.abs(w).max(), 1e-300))


@pytest.fixture(scope="module")
def operands():
    """{(blocks dtype, X dtype): (JAX BsrMat, JAX X, port BsrMat, port
    X)}, every pair, from one seed; the operands of each type are built
    once."""
    d = dense_fixture()
    x = np.random.default_rng(131).standard_normal((37, 5))
    mats = {t: jax_bsr_from_dense(d.astype(NP[t]), BS, dtype=NP[t], cap=20) for t in NP}
    xs = {t: jnp.asarray(x.astype(NP[t])) for t in NP}
    return {(bd, xd): (mats[bd], xs[xd], port_of(mats[bd]), t_of(xs[xd])) for bd, xd in PAIRS}


# -- the kernels' output types and values (the Pallas functions) ------------------


@pytest.mark.parametrize("wrapper", ["spmm", "spmv", "grouped"])
@pytest.mark.parametrize("blocks_dtype, x_dtype", PAIRS, ids=IDS)
def test_kernel_wrappers_match_the_pallas_functions(operands, blocks_dtype, x_dtype, wrapper):
    """Y in promote(blocks, X) and the Pallas function's values; the six
    pairs that mix float64 with a narrower type came back in float32
    before the wrappers cast the plain version's sums."""
    jb, jx, tb, tx = operands[(blocks_dtype, x_dtype)]
    if wrapper == "spmm":
        want, got = bsr_spmm_pallas(jb, jx, interpret=True), bsr_spmm_kernel(tb, tx)
    elif wrapper == "spmv":
        want, got = bsr_spmv_pallas(jb, jx[:, 0], interpret=True), bsr_spmv_kernel(tb, tx[:, 0])
    else:
        want = bsr_spmm_pallas_grouped(jax_bsr_group(jb, 2), jx, group=2, interpret=True)
        got = bsr_spmm_grouped_kernel(bsr_group(tb, 2), tx, group=2)
    out = torch.promote_types(blocks_dtype, x_dtype)
    assert t_of(jnp.zeros(1, want.dtype)).dtype == out
    assert_same(got, want, out)


# -- the public product (the JAX ``@``) ----------------------------------------------


@pytest.mark.parametrize("blocks_dtype, x_dtype", PAIRS, ids=IDS)
def test_matmul_gives_the_types_and_values_of_the_jax_matmul(operands, blocks_dtype, x_dtype):
    """``BsrMat @ X`` and ``ops.matmul``, with a block of columns and a
    vector, against ``bsr_spmm_xla``: X's type where the blocks share it,
    else float32."""
    jb, jx, tb, tx = operands[(blocks_dtype, x_dtype)]
    want = bsr_spmm_xla(jb, jx)
    out = t_of(jnp.zeros(1, want.dtype)).dtype
    assert out == (x_dtype if x_dtype == blocks_dtype else F32)
    assert_same(tb @ tx, want, out)
    assert_same(ops.matmul(tb, tx), want, out)
    assert_same(tb @ tx[:, 0], np.asarray(want)[:, 0], out)


# -- the backward (``jax.vjp`` of the Pallas function) -----------------------------


@pytest.mark.parametrize("blocks_dtype, x_dtype", [(BF, F32), (F32, F64), (F16, F16), (F64, BF)],
                         ids=["bf16_f32", "f32_f64", "f16", "f64_bf16"])
def test_backward_matches_the_jax_vjp(operands, blocks_dtype, x_dtype):
    """dblocks in the blocks' type and dX in X's, as the JAX ``_spmm_bwd``
    gives them, each within its type's limit of the largest entry."""
    jb, jx, tb, tx = operands[(blocks_dtype, x_dtype)]
    out = torch.promote_types(blocks_dtype, x_dtype)
    g = np.random.default_rng(132).standard_normal((45, 5)).astype(NP[out])

    def f(blocks, v):
        return bsr_spmm_pallas(type(jb)(jb.brows, jb.bcols, blocks, jb.shape, jb.n_blocks), v, interpret=True)

    _, vjp = jax.vjp(f, jb.blocks, jx)
    want_db, want_dx = vjp(jnp.asarray(g))
    blocks = tb.blocks.clone().requires_grad_(True)
    xg = tx.clone().requires_grad_(True)
    y = bsr_spmm_kernel(BsrMat(tb.brows, tb.bcols, blocks, tb.shape, tb.n_blocks), xg)
    db, dx = torch.autograd.grad(y, (blocks, xg), t_of(g))
    assert (t_of(jnp.zeros(1, want_db.dtype)).dtype, t_of(jnp.zeros(1, want_dx.dtype)).dtype) == (
        blocks_dtype, x_dtype)
    assert_same(db, want_db, blocks_dtype)
    assert_same(dx, want_dx, x_dtype)


# -- the rules --------------------------------------------------------------------


@pytest.mark.parametrize("blocks_dtype, x_dtype", PAIRS, ids=IDS)
def test_tf32_passes_rule(blocks_dtype, x_dtype):
    """One pass where both operands are 16-bit (exact in TF32), two where
    one is, three where neither is."""
    wide = (blocks_dtype not in HALVES) + (x_dtype not in HALVES)
    assert k3.tf32_passes(blocks_dtype, x_dtype) == {0: 1, 1: 2, 2: 3}[wide]


@pytest.mark.parametrize("blocks_dtype, x_dtype", PAIRS, ids=IDS)
def test_variant_rule_takes_wgmma_for_same_type_16_bit_only(blocks_dtype, x_dtype):
    kind = k3.variant(blocks_dtype, 128, 512, 4096, 8192, x_dtype)
    assert kind == ("tc" if blocks_dtype == x_dtype and blocks_dtype in HALVES else "tf32x3")
    if blocks_dtype == x_dtype:
        assert k3.variant(blocks_dtype, 128, 512, 4096, 8192) == kind  # X's type defaults to the blocks'


def test_every_form_has_an_entry_the_source_defines():
    """Each suffix of FORMS names a TF32 entry that ``csrc/bsr_spmm.cu``
    defines with the pass count of ``tf32_passes``; both wgmma entries are
    defined (a text check: there is no nvcc here)."""
    src = (Path(k3.__file__).resolve().parents[2] / "csrc" / "bsr_spmm.cu").read_text()
    table = {m.group(1): int(m.group(2)) for m in re.finditer(
        r"^SPRS_BSR_SPMM_TF32_ENTRY\((\w+), \w+, \w+, \w+, (\d)\)$", src, re.M)}
    assert len(table) == 16
    for pair, form in FORMS.items():
        name = k3._ENTRY[pair]
        assert name == f"sprs_bsr_spmm_tf32x3_{form}"
        assert table[name] == k3.tf32_passes(*pair)
    assert set(k3._TC_ENTRY) == set(HALVES)
    for name in k3._TC_ENTRY.values():
        assert re.search(rf"^SPRS_BSR_SPMM_TC_ENTRY\({name}, \w+\)$", src, re.M)


@pytest.mark.parametrize("blocks_dtype, x_dtype", [(torch.complex64, F32), (torch.int32, F32),
                                                   (F32, torch.complex128)])
def test_form_of_refuses_complex_and_integer(blocks_dtype, x_dtype):
    with pytest.raises(TypeError, match="bsr_spmm kernel takes"):
        form_of("bsr_spmm", torch.zeros(1, dtype=blocks_dtype), torch.zeros(1, dtype=x_dtype))


# -- the pass model ---------------------------------------------------------------


def tf32_parts(v):
    """The kernel's split of float32 values (``split`` in
    ``csrc/bsr_spmm.cu``): hi with the low 13 mantissa bits cleared, hx
    (hi, or 0 where v is not finite) and lo = v - hi rounded to TF32, 0
    where v is not finite."""
    finite = torch.isfinite(v)
    hi = (v.view(torch.int32) & -0x2000).view(torch.float32)
    lo = torch.where(finite, v - hi, torch.zeros_like(v))
    lo = ((lo.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)
    hx = torch.where(finite, hi, torch.zeros_like(v))
    hi = torch.where(torch.isnan(v), torch.full_like(v, float("nan")), hi)
    return hi, hx, lo


def tf32_model(bsr, x, passes):
    """The TF32 kernel's arithmetic in plain torch for a pass count: an
    operand is split where the count takes its lo (three: both; two: the
    one wider than 16 bits); one not split enters as its hi, which the
    tensor cores read (a 16-bit value is its own: exact in TF32), and as
    0 in the cross terms where it is not finite.  Per
    block lo_a·hx_x + hx_a·lo_x + hi_a·hi_x over the split sides, each
    product and sum in float32, then summed per block row."""
    bs, k = bsr.block_size, x.shape[1]
    xp = x.new_zeros((bsr.n_block_cols * bs, k))
    xp[: bsr.cols] = x
    xb = xp.reshape(bsr.n_block_cols, bs, k)[bsr.bcols.long()]

    def parts(v, dtype):
        hi, hx, lo = tf32_parts(v.float())
        return hi, hx, lo if passes == 3 or (passes == 2 and dtype not in HALVES) else None

    (ah, ax, al), (bh, bx, bl) = parts(bsr.blocks, bsr.dtype), parts(xb, x.dtype)

    def prod(a, b):
        return (a[:, :, :, None] * b[:, None, :, :]).sum(2)

    prods = prod(ah, bh)
    if bl is not None:
        prods = prod(ax, bl) + prods
    if al is not None:
        prods = prod(al, bx) + prods
    out = prods.new_zeros((bsr.n_block_rows, bs, k))
    out.index_add_(0, bsr.brows.long(), prods)
    return out.reshape(-1, k)[: bsr.rows]


def wide_forms():
    """The forms with exactly one 16-bit operand, and those with two."""
    one = [p for p in PAIRS if (p[0] in HALVES) != (p[1] in HALVES)]
    two = [p for p in PAIRS if p[0] in HALVES and p[1] in HALVES]
    return one, two


def model_case(blocks_dtype, x_dtype, seed):
    """A 60×75 operand of 16×16 blocks with entries ±2^e, e uniform in
    [-12, 12] (inside float16's normal range), and X, each rounded to its
    type; the float64 reference of the rounded operands."""
    rng = np.random.default_rng(seed)
    d = np.zeros((64, 80))
    keep = rng.random((4, 5)) < 0.6
    for i, j in zip(*np.nonzero(keep)):
        d[i * 16 : (i + 1) * 16, j * 16 : (j + 1) * 16] = (
            rng.choice([-1.0, 1.0], (16, 16)) * 2.0 ** rng.uniform(-12, 12, (16, 16)))
    d = d[:60, :75]
    x = rng.standard_normal((75, 12))
    t = bsr_from_dense(d, 16, dtype=blocks_dtype, device="cpu")
    xt = torch.from_numpy(x).to(x_dtype)
    want = t.to_dense().double().numpy() @ xt.double().numpy()
    return t, xt, want


@pytest.mark.parametrize("blocks_dtype, x_dtype", wide_forms()[0], ids=[FORMS[p] for p in wide_forms()[0]])
def test_two_passes_hold_the_gate_with_one_16_bit_operand(blocks_dtype, x_dtype):
    """Two passes hold 1e-5 of max|Y| against the float64 reference of
    the rounded operands (a float64 operand rounded to float32 first, as
    in the kernel); one pass does not."""
    t, xt, want = model_case(blocks_dtype, x_dtype, 133)
    scale = float(np.abs(want).max())
    err2 = float(np.abs(tf32_model(t, xt, 2).double().numpy() - want).max())
    err1 = float(np.abs(tf32_model(t, xt, 1).double().numpy() - want).max())
    assert err2 <= 1e-5 * scale
    assert err1 > 1e-5 * scale


@pytest.mark.parametrize("blocks_dtype, x_dtype", wide_forms()[1], ids=[FORMS[p] for p in wide_forms()[1]])
def test_one_pass_holds_the_gate_with_both_operands_16_bit(blocks_dtype, x_dtype):
    t, xt, want = model_case(blocks_dtype, x_dtype, 134)
    err1 = float(np.abs(tf32_model(t, xt, 1).double().numpy() - want).max())
    assert err1 <= 1e-5 * float(np.abs(want).max())


@pytest.mark.parametrize("in_x", [False, True], ids=["blocks", "x"])
@pytest.mark.parametrize("blocks_dtype, x_dtype", [(BF, F32), (F32, F16)], ids=["bf16_f32", "f32_f16"])
def test_two_pass_model_puts_inf_and_nan_where_plain_does(blocks_dtype, x_dtype, in_x):
    """inf and NaN in one operand against small integers in the other
    (exact in TF32, so a naive cross term would give inf·0 = NaN where the
    product is inf), the 16-bit side and the split side each taking the
    non-finite values."""
    rng = np.random.default_rng(135)
    d = np.zeros((64, 80))
    keep = rng.random((4, 5)) < 0.6
    for i, j in zip(*np.nonzero(keep)):
        d[i * 16 : (i + 1) * 16, j * 16 : (j + 1) * 16] = rng.integers(-3, 4, (16, 16)) + 0.5
    x = rng.integers(-3, 4, (75, 12)).astype(np.float64)
    d = d[:60, :75]
    bad = x if in_x else d
    rows, cols = np.nonzero(bad)
    bad[rows[3], cols[3]], bad[rows[-5], cols[-5]], bad[rows[20], cols[20]] = np.inf, -np.inf, np.nan
    t = bsr_from_dense(d.astype(np.float32), 16, dtype=blocks_dtype, device="cpu")
    xt = torch.from_numpy(x).to(x_dtype)
    got, want = tf32_model(t, xt, 2), bsr_spmm_plain(t, xt)
    for mask in (torch.isnan, torch.isposinf, torch.isneginf):
        assert torch.equal(mask(got), mask(want))
    assert bool(torch.isinf(want).any()) and bool(torch.isnan(want).any())
    fin = torch.isfinite(want)
    assert float((got - want)[fin].abs().max()) <= 1e-5 * float(want[fin].abs().max())


# -- on the card ------------------------------------------------------------------


@pytest.mark.gpu
def test_kernels_take_every_pair_on_card():
    """K3 and K4 launch each pair's own form (its counter moves by one),
    Y in promote(blocks, X) within its limit of the plain version (run
    where a GPU is)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    base = bsr_random(136, (300, 260), 16, 0.3, device="cuda")
    x64 = torch.randn((260, 40), generator=torch.Generator("cuda").manual_seed(137), device="cuda",
                      dtype=F64)
    for bd, xd in PAIRS:
        bsr = BsrMat(base.brows, base.bcols, base.blocks.to(bd), base.shape, base.n_blocks)
        x = x64.to(xd)
        out = torch.promote_types(bd, xd)
        for fn, b in ((bsr_spmm_kernel, bsr), (bsr_spmm_grouped_kernel, bsr_group(bsr, 4))):
            before = getattr(fn, f"launches_{FORMS[(bd, xd)]}")
            y = fn(b, x)
            ref = bsr_spmm_plain(b, x)
            torch.cuda.synchronize()
            assert getattr(fn, f"launches_{FORMS[(bd, xd)]}") == before + 1
            assert y.dtype == out
            err = float((y.double() - ref.double()).abs().max())
            assert err <= LIMIT[out] * float(ref.double().abs().max())
