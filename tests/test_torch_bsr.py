"""BSR format and kernels K3/K4 of the PyTorch port against the JAX package.

Conversions (``bsr_from_dense``, ``bsr_from_csmat``, ``bsr_group``,
``slice_block_rows``, ``bsr_random``) must give the JAX package's arrays
exactly.  Products: both packages take products and sums in float32 for
every operand type (the JAX ``preferred_element_type``), so values agree
to float32 rounding in another order: rtol 1e-5 with atol 1e-5·max|Y|
for float32 and float64 operands, one bfloat16 step at the largest
magnitude (2⁻⁷·max|Y|) for bfloat16 outputs, where the float32 sums,
taken in another order, may round to neighbouring bfloat16 values.  On the CPU the wrappers take the plain version; the
CUDA kernel runs only on the card (the ``gpu``-marked test).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import sprs_tpu as st
from sprs_tpu.formats.bsr import bsr_from_csmat as jax_bsr_from_csmat
from sprs_tpu.formats.bsr import bsr_from_dense as jax_bsr_from_dense
from sprs_tpu.formats.bsr import bsr_random as jax_bsr_random
from sprs_tpu.formats.bsr import bsr_spmm_xla
from sprs_tpu.ops.pallas import (
    bsr_group as jax_bsr_group,
    bsr_spmm_pallas,
    bsr_spmm_pallas_grouped,
    bsr_spmv_pallas,
)
import sprs_tpu_torch as stt
from sprs_tpu_torch.errors import ShapeError
from sprs_tpu_torch.formats.bsr import (
    BsrMat,
    bsr_from_csmat,
    bsr_from_dense,
    bsr_random,
    bsr_spmm_plain,
)
from sprs_tpu_torch.interop import from_arrays
from sprs_tpu_torch.ops.cuda import bsr_spmm as k3
from sprs_tpu_torch.ops.cuda.bsr_spmm import (
    bsr_group,
    bsr_spmm_grouped_kernel,
    bsr_spmm_kernel,
    bsr_spmv_kernel,
    launch_config,
)


def random_block_dense(rbr, rbc, bs, block_density, seed):
    rng = np.random.default_rng(seed)
    keep = rng.random((rbr, rbc)) < block_density
    dense = np.zeros((rbr * bs, rbc * bs), np.float32)
    for i, j in zip(*np.nonzero(keep)):
        dense[i * bs : (i + 1) * bs, j * bs : (j + 1) * bs] = rng.standard_normal((bs, bs))
    return dense


def port_of(b):
    """The port's BsrMat holding a JAX BsrMat's arrays, padding included."""
    return from_arrays(
        "bsr",
        b.shape,
        (np.asarray(b.brows), np.asarray(b.bcols), np.asarray(b.blocks)),
        n_blocks=b.n_blocks,
        device="cpu",
    )


def assert_same_arrays(t, j):
    assert t.shape == tuple(j.shape) and t.n_blocks == j.n_blocks and t.cap == j.cap
    np.testing.assert_array_equal(t.brows.numpy(), np.asarray(j.brows))
    np.testing.assert_array_equal(t.bcols.numpy(), np.asarray(j.bcols))
    if t.dtype == torch.bfloat16:
        np.testing.assert_array_equal(t.blocks.float().numpy(), np.asarray(j.blocks, np.float32))
    else:
        np.testing.assert_array_equal(t.blocks.numpy(), np.asarray(j.blocks))
    assert t.brows.dtype == torch.int32 and t.bcols.dtype == torch.int32


def assert_close(got, want, dtype=np.float32):
    got = got.float().numpy() if got.dtype == torch.bfloat16 else got.numpy()
    want = np.asarray(want, np.float32 if dtype == "bf16" else None)
    assert got.shape == want.shape
    scale = float(np.abs(want).max())
    if dtype == "bf16":
        np.testing.assert_allclose(got, want, rtol=0, atol=2.0**-7 * scale)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * scale)


def empty_row_dense():
    d = np.zeros((24, 24), np.float32)
    d[0, 0] = 2.0
    d[17, 5] = -1.0  # block rows 0 and 2; row 1 empty
    return d


DENSE_CASES = {
    "aligned": lambda: random_block_dense(4, 3, 8, 0.5, seed=1),
    "unaligned": lambda: random_block_dense(3, 3, 8, 0.6, seed=2)[:20, :19],
    "empty_row": empty_row_dense,
    "all_empty": lambda: np.zeros((16, 9), np.float32),
}


@pytest.mark.parametrize("cap_extra", [0, 3])
@pytest.mark.parametrize("name", sorted(DENSE_CASES))
def test_from_dense_arrays_equal(name, cap_extra):
    d = DENSE_CASES[name]()
    n = jax_bsr_from_dense(d, 8).n_blocks
    j = jax_bsr_from_dense(d, 8, cap=n + cap_extra)
    t = bsr_from_dense(d, 8, cap=n + cap_extra, device="cpu")
    assert_same_arrays(t, j)
    np.testing.assert_array_equal(t.to_dense().numpy(), d)
    assert t.block_density == j.block_density


@pytest.mark.parametrize("cap_extra", [0, 2])
def test_from_csmat_and_to_bsr_arrays_equal(cap_extra):
    rng = np.random.default_rng(3)
    d = rng.standard_normal((27, 21)) * (rng.random((27, 21)) < 0.08)
    d[8:16] = 0.0  # an empty block row
    jm = st.from_dense(d)
    n = jax_bsr_from_csmat(jm, 8).n_blocks
    j = jax_bsr_from_csmat(jm, 8, cap=n + cap_extra)
    tm = stt.from_dense(d, device="cpu")
    assert_same_arrays(bsr_from_csmat(tm, 8, cap=n + cap_extra), j)
    assert_same_arrays(tm.to_bsr(8), jm.to_bsr(8))
    assert_same_arrays(tm.T.to_bsr(8), jm.T.to_bsr(8))


@pytest.mark.parametrize("group", [2, 4])
def test_bsr_group_arrays_equal(group):
    d = random_block_dense(5, 4, 8, 0.4, seed=17)
    j = jax_bsr_group(jax_bsr_from_dense(d, 8, cap=20), group)
    t = bsr_group(bsr_from_dense(d, 8, cap=20, device="cpu"), group)
    assert_same_arrays(t, j)
    assert t.n_blocks % group == 0
    np.testing.assert_array_equal(t.to_dense().numpy(), d)


@pytest.mark.parametrize("r0,r1", [(8, 20), (0, 16), (16, 16)])
def test_slice_block_rows_arrays_equal(r0, r1):
    d = random_block_dense(3, 3, 8, 0.6, seed=2)[:20, :19]
    j = jax_bsr_from_dense(d, 8, cap=12).slice_block_rows(r0, r1)
    t = bsr_from_dense(d, 8, cap=12, device="cpu").slice_block_rows(r0, r1)
    assert_same_arrays(t, j)
    np.testing.assert_array_equal(t.to_dense().numpy(), d[r0:r1])


def test_slice_block_rows_rejects_unaligned_bounds():
    t = bsr_from_dense(random_block_dense(3, 3, 8, 0.6, seed=2), 8, device="cpu")
    with pytest.raises(ShapeError):
        t.slice_block_rows(3, 16)


def test_to_csmat_matches_jax():
    d = random_block_dense(3, 2, 8, 0.7, seed=4)
    j = jax_bsr_from_dense(d, 8).to_csmat()
    t = bsr_from_dense(d, 8, device="cpu").to_csmat()
    np.testing.assert_array_equal(t.indptr.numpy(), np.asarray(j.indptr))
    np.testing.assert_array_equal(t.indices.numpy(), np.asarray(j.indices))
    np.testing.assert_array_equal(t.data.numpy(), np.asarray(j.data))


@pytest.mark.parametrize("dtype", [np.float32, np.float64, "bf16"])
def test_bsr_random_arrays_equal(dtype):
    """Seeded by an int (a torch.Generator also works); the JAX package
    draws its int from a JAX key, which is handed over here."""
    jdt = jnp.bfloat16 if dtype == "bf16" else dtype
    tdt = torch.bfloat16 if dtype == "bf16" else dtype
    key = jax.random.PRNGKey(5)
    seed = int(jax.random.randint(key, (), 0, 2**31 - 1))
    j = jax_bsr_random(key, (60, 45), 16, 0.3, dtype=jdt)
    t = bsr_random(seed, (60, 45), 16, 0.3, dtype=tdt, device="cpu")
    assert_same_arrays(t, j)
    g = torch.Generator().manual_seed(0)
    assert bsr_random(g, (60, 45), 16, 0.3, device="cpu").shape == (60, 45)


@pytest.mark.parametrize("dtype", [np.float32, np.float64, "bf16"])
def test_plain_matches_xla_twin(dtype):
    d = random_block_dense(4, 3, 8, 0.5, seed=12)[:30, :21]
    x = np.random.default_rng(6).standard_normal((21, 5)).astype(np.float32)
    if dtype == "bf16":
        jb = jax_bsr_from_dense(d, 8, dtype=jnp.bfloat16)
        want = bsr_spmm_xla(jb, jnp.asarray(x, jnp.bfloat16))
        xt = torch.from_numpy(x).to(torch.bfloat16)
    else:
        jb = jax_bsr_from_dense(d.astype(dtype), 8)
        want = bsr_spmm_xla(jb, x.astype(dtype))
        xt = torch.from_numpy(x.astype(dtype))
    t = port_of(jb)
    got = bsr_spmm_plain(t, xt)
    assert got.dtype == xt.dtype
    assert_close(got, want, dtype)
    assert_close(bsr_spmm_kernel(t, xt), want, dtype)


@pytest.mark.parametrize("name", ["aligned", "unaligned", "empty_row"])
def test_wrapper_matches_pallas(name):
    d = DENSE_CASES[name]()
    jb = jax_bsr_from_dense(d, 8, cap=jax_bsr_from_dense(d, 8).n_blocks + 2)
    x = np.random.default_rng(7).standard_normal((d.shape[1], 16)).astype(np.float32)
    want = bsr_spmm_pallas(jb, x, interpret=True)
    assert_close(bsr_spmm_kernel(port_of(jb), torch.from_numpy(x)), want)
    np.testing.assert_allclose(np.asarray(want), d @ x, rtol=1e-4, atol=1e-5)


def test_spmv_wrapper_matches_pallas():
    d = random_block_dense(3, 3, 8, 0.6, seed=14)
    jb = jax_bsr_from_dense(d, 8)
    x = np.random.default_rng(8).standard_normal(24).astype(np.float32)
    want = bsr_spmv_pallas(jb, x, interpret=True)
    got = bsr_spmv_kernel(port_of(jb), torch.from_numpy(x))
    assert got.shape == (24,)
    assert_close(got, want)


@pytest.mark.parametrize(
    "name,group", [("grouped4", 4), ("grouped2", 2), ("empty_row", 2)]
)
def test_grouped_wrapper_matches_pallas_grouped(name, group):
    d = empty_row_dense() if name == "empty_row" else random_block_dense(5, 4, 8, 0.4, seed=17)
    jb = jax_bsr_group(jax_bsr_from_dense(d, 8), group)
    x = np.random.default_rng(9).standard_normal((d.shape[1], 8)).astype(np.float32)
    want = bsr_spmm_pallas_grouped(jb, x, group=group, interpret=True)
    tb = bsr_group(bsr_from_dense(d, 8, device="cpu"), group)
    assert_close(bsr_spmm_grouped_kernel(tb, torch.from_numpy(x), group=group), want)


def test_grouped_takes_the_per_block_path_when_not_aligned():
    """cap % group != 0: the per-block path (K3), as the JAX function."""
    d = random_block_dense(3, 3, 8, 0.6, seed=18)
    jb = jax_bsr_from_dense(d, 8, cap=7)
    x = np.random.default_rng(10).standard_normal((24, 4)).astype(np.float32)
    want = bsr_spmm_pallas_grouped(jb, x, group=4, interpret=True)
    got = bsr_spmm_grouped_kernel(port_of(jb), torch.from_numpy(x), group=4)
    assert_close(got, want)


def test_unsorted_blocks_give_the_same_product():
    """The row pointer (row_order) frees the product from block order."""
    d = random_block_dense(4, 4, 8, 0.5, seed=19)
    t = bsr_from_dense(d, 8, device="cpu")
    perm = torch.from_numpy(np.random.default_rng(0).permutation(t.cap))
    shuffled = BsrMat(t.brows[perm], t.bcols[perm], t.blocks[perm], t.shape, t.n_blocks)
    row_ptr, order = shuffled.row_order
    assert row_ptr.tolist() == [0] + np.cumsum(np.bincount(t.brows.numpy(), minlength=4)).tolist()
    assert (shuffled.brows[order.long()].diff() >= 0).all()
    x = torch.from_numpy(np.random.default_rng(11).standard_normal((32, 6)).astype(np.float32))
    assert_close(bsr_spmm_kernel(shuffled, x), d @ x.numpy())


def test_backward_matches_jax_grad():
    d = random_block_dense(2, 2, 8, 1.0, seed=15)
    jb = jax_bsr_from_dense(d, 8, cap=5)
    x = np.random.default_rng(12).standard_normal((16, 8)).astype(np.float32)

    def loss(blocks, v):
        bb = type(jb)(jb.brows, jb.bcols, blocks, jb.shape, jb.n_blocks)
        return jnp.sum(bsr_spmm_pallas(bb, v, interpret=True) ** 2)

    g_blocks, g_x = jax.grad(loss, argnums=(0, 1))(jb.blocks, x)
    t = port_of(jb)
    blocks = t.blocks.clone().requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    y = bsr_spmm_kernel(BsrMat(t.brows, t.bcols, blocks, t.shape, t.n_blocks), xt)
    (y**2).sum().backward()
    assert_close(blocks.grad, g_blocks)
    assert_close(xt.grad, g_x)


def test_backward_matches_torch_autograd_of_plain():
    d = random_block_dense(3, 2, 8, 0.7, seed=16)[:22, :13]
    t = bsr_from_dense(d.astype(np.float64), 8, cap=8, device="cpu")
    x = torch.from_numpy(np.random.default_rng(13).standard_normal((13, 3)))
    g = torch.from_numpy(np.random.default_rng(14).standard_normal((22, 3)))
    grads = []
    for fn in (bsr_spmm_kernel, bsr_spmm_plain):
        blocks = t.blocks.clone().requires_grad_(True)
        xt = x.clone().requires_grad_(True)
        y = fn(BsrMat(t.brows, t.bcols, blocks, t.shape, t.n_blocks), xt)
        grads.append(torch.autograd.grad(y, (blocks, xt), g))
    for a, b in zip(*grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-6)


def test_matmul_dispatch():
    d = random_block_dense(3, 3, 8, 0.6, seed=20)
    t = bsr_from_dense(d, 8, device="cpu")
    x = np.random.default_rng(15).standard_normal((24, 4)).astype(np.float32)
    before = bsr_spmm_plain.calls
    assert_close(t @ torch.from_numpy(x), d @ x)
    assert_close(t @ x[:, 0], d @ x[:, 0])  # a numpy vector goes to the device
    assert bsr_spmm_plain.calls == before + 2
    m = stt.from_dense(d.astype(np.float64), device="cpu")
    xd = x.astype(np.float64)
    np.testing.assert_allclose((m @ torch.from_numpy(xd)).numpy(), d @ xd, rtol=1e-12)
    np.testing.assert_allclose((torch.from_numpy(xd.T) @ m).numpy(), xd.T @ d, rtol=1e-12)
    np.testing.assert_allclose(stt.rmatmul(xd[:, 0], m).numpy(), xd[:, 0] @ d, rtol=1e-12)
    # sparse @ sparse is SpGEMM: ESC for two CsMats, else the dense route
    # to a BsrMat at the BSR operand's block size
    for lhs, rhs, kind in ((t, t, BsrMat), (m, m, stt.CsMat), (m, t, BsrMat), (t, m, BsrMat)):
        got = lhs @ rhs
        assert isinstance(got, kind)
        assert_close(got.to_dense().to(torch.float32), (d @ d).astype(np.float32))


@pytest.mark.parametrize("ord", ["fro", 1, np.inf, "max"])
def test_csmat_norm_matches_jax(ord):
    rng = np.random.default_rng(21)
    d = rng.standard_normal((9, 7)) * (rng.random((9, 7)) < 0.4)
    jm = st.from_dense(d)
    tm = stt.from_dense(d, cap=40, device="cpu")
    for jj, tt in ((jm, tm), (jm.T, tm.T), (jm.to_csc(), tm.to_csc())):
        np.testing.assert_allclose(float(tt.norm(ord)), float(jj.norm(ord)), rtol=1e-14)


def test_from_arrays_round_trip():
    d = random_block_dense(3, 3, 8, 0.6, seed=22)[:21, :23]
    jb = jax_bsr_from_dense(d, 8, cap=10)
    t = port_of(jb)
    assert_same_arrays(t, jb)
    assert t.block_density == jb.block_density and t.n_block_rows == jb.n_block_rows
    np.testing.assert_array_equal(t.to_dense().numpy(), np.asarray(jb.to_dense()))
    with pytest.raises(ValueError, match="n_blocks"):
        from_arrays("bsr", (8, 8), (np.zeros(1), np.zeros(1), np.zeros((1, 8, 8))), device="cpu")


@pytest.mark.parametrize("nbr,k,grid", [(1, 1, (1, 1)), (32, 512, (32, 4)), (4, 65, (4, 1))])
def test_launch_config(nbr, k, grid):
    """The 3xTF32 kernel: one CTA of 16 warps per (block row, 128 columns
    of X), whatever the block size."""
    assert launch_config(nbr, k, "tf32x3", 8) == (grid, k3.THREADS)
    assert launch_config(nbr, k, "tf32x3", 128) == (grid, k3.THREADS)


@pytest.mark.parametrize(
    "nbr,k,bs,grid,threads",
    [
        (32, 512, 128, (32, 4), 288),  # the main shape: 128 CTAs, one wave
        (128, 512, 128, (128, 4), 288),  # n = 16384
        (16, 200, 64, (16, 2), 160),  # a partial 128-column tile
        (1, 8, 128, (1, 1), 288),
    ],
)
def test_launch_config_tensor_cores(nbr, k, bs, grid, threads):
    """One CTA per (block row, 128 columns): bs / 64 consumer warpgroups
    and one producer warp."""
    assert launch_config(nbr, k, "tc", bs) == (grid, threads)


@pytest.mark.parametrize(
    "dtype,bs,k,x_off,b_off,kind",
    [
        (torch.bfloat16, 128, 512, 0, 0, "tc"),
        (torch.bfloat16, 64, 200, 0, 0, "tc"),
        (torch.bfloat16, 128, 8, 16, 32, "tc"),
        (torch.bfloat16, 128, 70, 0, 0, "tf32x3"),  # rows of 140 bytes
        (torch.bfloat16, 128, 1, 0, 0, "tf32x3"),  # bsr_spmv_kernel
        (torch.bfloat16, 8, 64, 0, 0, "tf32x3"),
        (torch.bfloat16, 32, 64, 0, 0, "tf32x3"),
        (torch.float32, 128, 512, 0, 0, "tf32x3"),
        (torch.float64, 128, 512, 0, 0, "tf32x3"),
        (torch.bfloat16, 128, 512, 2, 0, "tf32x3"),  # X off 16 bytes
        (torch.bfloat16, 128, 512, 0, 8, "tf32x3"),  # blocks off 16 bytes
        (torch.float32, 8, 512, 0, 0, "tf32x3"),
        (torch.float64, 16, 512, 0, 0, "tf32x3"),
        (torch.float32, 128, 1, 0, 0, "tf32x3"),
        (torch.float32, 64, 512, 4, 0, "tf32x3"),  # X off 16 bytes
    ],
)
def test_variant_rule(dtype, bs, k, x_off, b_off, kind):
    """The wgmma kernel takes bfloat16 at bs 64 or 128 when TMA can read X
    and the blocks; the rest goes to the 3xTF32 kernel."""
    assert k3.variant(dtype, bs, k, 4096 + x_off, 8192 + b_off) == kind


def tf32_parts(v):
    """The 3xTF32 kernel's split of float32 values (csrc/bsr_spmm.cu,
    ``split``): hi with the low 13 mantissa bits cleared, hx (hi, or 0
    where v is not finite) and lo = v - hi rounded to TF32 (to nearest,
    ties away from zero), 0 where v is not finite; a NaN's hi is the
    canonical NaN."""
    finite = torch.isfinite(v)
    hi = (v.view(torch.int32) & -0x2000).view(torch.float32)
    lo = torch.where(finite, v - hi, torch.zeros_like(v))
    lo = ((lo.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)
    hx = torch.where(finite, hi, torch.zeros_like(v))
    hi = torch.where(torch.isnan(v), torch.full_like(v, float("nan")), hi)
    return hi, hx, lo


def tf32x3_model(bsr, x, passes=3):
    """The kernel's arithmetic in plain torch: per block, lo_a·hx_x +
    hx_a·lo_x + hi_a·hi_x (or hi_a·hi_x alone, one pass), each product
    and sum in float32, then summed per block row.  Products are taken
    elementwise, so inf·0 gives NaN as on the tensor cores."""
    bs, k = bsr.block_size, x.shape[1]
    xp = x.new_zeros((bsr.n_block_cols * bs, k))
    xp[: bsr.cols] = x
    xb = xp.reshape(bsr.n_block_cols, bs, k)[bsr.bcols.long()].float()
    (ah, ax, al), (bh, bx, bl) = tf32_parts(bsr.blocks.float()), tf32_parts(xb)

    def prod(a, b):
        return (a[:, :, :, None] * b[:, None, :, :]).sum(2)

    prods = prod(ah, bh)
    if passes == 3:
        prods = prod(al, bx) + prod(ax, bl) + prods
    out = prods.new_zeros((bsr.n_block_rows, bs, k))
    out.index_add_(0, bsr.brows.long(), prods)
    return out.reshape(-1, k)[: bsr.rows]


def wide_magnitude_dense(seed):
    """Block entries sign·2^e, e uniform in [-20, 20]."""
    rng = np.random.default_rng(seed)
    d = random_block_dense(4, 5, 16, 0.6, seed)[:60, :75]
    mag = 2.0 ** rng.uniform(-20, 20, d.shape)
    return (np.sign(d) * mag).astype(np.float32)


@pytest.mark.parametrize("case", ["normal", "wide"])
def test_tf32x3_model_holds_the_float32_gate(case):
    """Three TF32 passes hold 1e-5 of max|Y| against the JAX reference
    taken in float64; one pass does not."""
    if case == "normal":
        d = random_block_dense(4, 5, 16, 0.6, seed=30)[:60, :75]
    else:
        d = wide_magnitude_dense(31)
    x = np.random.default_rng(32).standard_normal((75, 12))
    want = np.asarray(bsr_spmm_xla(jax_bsr_from_dense(d.astype(np.float64), 16), x))
    t = bsr_from_dense(d, 16, device="cpu")
    xt = torch.from_numpy(x.astype(np.float32))
    scale = float(np.abs(want).max())
    err3 = float(np.abs(tf32x3_model(t, xt).numpy() - want).max())
    err1 = float(np.abs(tf32x3_model(t, xt, passes=1).numpy() - want).max())
    assert err3 <= 1e-5 * scale
    assert err1 > 1e-5 * scale


def test_tf32x3_model_puts_inf_and_nan_where_plain_does():
    """An inf and a NaN block entry against X of small integers (exact in
    TF32, so lo = 0: a naive split would give inf·0 = NaN where the
    product is inf), zeros among them (inf·0 = NaN as IEEE)."""
    d = random_block_dense(4, 5, 16, 0.6, seed=33)[:60, :75]
    rows, cols = np.nonzero(d)
    d[rows[3], cols[3]] = np.inf
    d[rows[-5], cols[-5]] = -np.inf
    d[rows[40], cols[40]] = np.nan
    x = np.random.default_rng(34).integers(-3, 4, (75, 12)).astype(np.float32)
    t = bsr_from_dense(d, 16, device="cpu")
    xt = torch.from_numpy(x)
    got, want = tf32x3_model(t, xt), bsr_spmm_plain(t, xt)
    for mask in (torch.isnan, torch.isposinf, torch.isneginf):
        assert torch.equal(mask(got), mask(want))
    assert bool(torch.isinf(want).any()) and bool(torch.isnan(want).any())
    fin = torch.isfinite(want)
    assert float((got - want)[fin].abs().max()) <= 1e-5 * float(want[fin].abs().max())


def test_launch_refuses_what_the_kernel_does_not_take():
    t = bsr_from_dense(random_block_dense(2, 2, 8, 1.0, seed=23), 8, device="cpu")
    x = torch.zeros((16, 2))
    with pytest.raises(ValueError, match="CUDA"):
        k3._launch(t, t.blocks, x, bsr_spmm_kernel)
    counts = [(f.launches, f.launches_tc, f.launches_tf32x3)
              for f in (bsr_spmm_kernel, bsr_spmm_grouped_kernel)]
    bsr_spmm_kernel(t, x)  # CPU tensors: the plain version, no launch
    bsr_spmm_grouped_kernel(bsr_group(t, 2), x, group=2)
    assert counts == [(f.launches, f.launches_tc, f.launches_tf32x3)
                      for f in (bsr_spmm_kernel, bsr_spmm_grouped_kernel)]
    with pytest.raises(ShapeError):
        bsr_spmm_kernel(t, torch.zeros((15, 2)))


def test_launch_refuses_int64_block_columns():
    """The kernel reads bcols as int32: wider indices raise, not misread."""
    t = bsr_from_dense(random_block_dense(2, 2, 8, 1.0, seed=23), 8, device="cpu")
    wide = BsrMat(t.brows.long(), t.bcols.long(), t.blocks, t.shape, t.n_blocks)
    with pytest.raises(TypeError, match="bcols"):
        k3._launch(wide, wide.blocks, torch.zeros((16, 2)), bsr_spmm_kernel)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float64])
def test_kernels_match_plain_on_card(dtype):
    """K3 and K4 on the card against the plain version (run where a GPU is)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    d = random_block_dense(6, 5, 8, 0.4, seed=24)[:45, :37]
    t = bsr_from_dense(d, 8, cap=40, dtype=dtype, device="cuda")
    x = torch.randn((37, 70), device="cuda").to(dtype)
    limit = 2.0**-7 if dtype == torch.bfloat16 else 1e-5
    for fn, b in ((bsr_spmm_kernel, t), (bsr_spmm_grouped_kernel, bsr_group(t, 4))):
        before = fn.launches
        y = fn(b, x)
        ref = bsr_spmm_plain(b, x)
        torch.cuda.synchronize()
        assert fn.launches == before + 1
        err = float((y.float() - ref.float()).abs().max())
        assert err <= limit * float(ref.float().abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("bs", [64, 128])
def test_tensor_core_variant_matches_plain_on_card(bs):
    """K3's tensor-core variant (bfloat16) on the card against the plain
    version: a partial last block row, X rows past ``cols``, a partial
    128-column tile, shuffled blocks and the K4 repack (run where a GPU
    is)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    t = bsr_random(3, (1000, 900), bs, 0.3, torch.bfloat16, device="cuda")
    perm = torch.randperm(t.cap, device="cuda")
    shuffled = BsrMat(t.brows[perm], t.bcols[perm], t.blocks[perm], t.shape, t.n_blocks)
    x = torch.randn((900, 200), device="cuda").to(torch.bfloat16)
    for fn, b in ((bsr_spmm_kernel, t), (bsr_spmm_kernel, shuffled),
                  (bsr_spmm_grouped_kernel, bsr_group(t, 4))):
        before = fn.launches_tc
        y = fn(b, x)
        ref = bsr_spmm_plain(b, x)
        torch.cuda.synchronize()
        assert fn.launches_tc == before + 1
        err = float((y.float() - ref.float()).abs().max())
        assert err <= 2.0**-7 * float(ref.float().abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("bs", [8, 16, 64, 128])
def test_tf32x3_variant_matches_plain_on_card(bs, dtype):
    """K3's 3xTF32 variant on the card against the plain version, within
    1e-5 of max|Y|: an odd k, k = 1, an X off a 16-byte boundary,
    shuffled blocks and the K4 repack (run where a GPU is)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    t = bsr_random(4, (1000, 900), bs, 0.3, dtype, device="cuda")
    perm = torch.randperm(t.cap, device="cuda")
    shuffled = BsrMat(t.brows[perm], t.bcols[perm], t.blocks[perm], t.shape, t.n_blocks)
    x = torch.randn((900, 201), device="cuda").to(dtype)
    off = torch.empty(x.numel() + 1, dtype=dtype, device="cuda")[1:].view(x.shape)
    off.copy_(x)  # one element past a 16-byte boundary
    for fn, b, xx in ((bsr_spmm_kernel, t, x), (bsr_spmm_kernel, t, x[:, :1].contiguous()),
                      (bsr_spmm_kernel, t, off), (bsr_spmm_kernel, shuffled, x),
                      (bsr_spmm_grouped_kernel, bsr_group(t, 4), x)):
        before = fn.launches_tf32x3
        y = fn(b, xx)
        ref = bsr_spmm_plain(b, xx)
        torch.cuda.synchronize()
        assert fn.launches_tf32x3 == before + 1
        err = float((y.float() - ref.float()).abs().max())
        assert err <= 1e-5 * float(ref.float().abs().max())
