"""Kernel K5 (ELL SpMV) of the PyTorch port against the JAX package.

On the CPU the port's wrapper takes the plain torch version; it is held
against the Pallas kernel run in interpret mode (as tests/test_pallas.py
runs it) and against the JAX package's plain ``ell_spmv``.  Tolerances:
float32 rtol 1e-5 with atol 1e-5·max|y| (entries that cancel to about 0
fail a pure relative check), float64 rtol 1e-12; gradients the same.
The CUDA kernel itself runs only on the card: the ``gpu``-marked test.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import sprs_tpu as st
from sprs_tpu.formats.ell import ell_spmv as jax_ell_spmv
from sprs_tpu.ops.pallas import ell_spmv_pallas
from sprs_tpu_torch.errors import ShapeError
from sprs_tpu_torch.formats.ell import EllMat
from sprs_tpu_torch.interop import from_arrays
from sprs_tpu_torch.ops.cuda import ell_spmv as k5
from sprs_tpu_torch.ops.cuda.ell_spmv import ell_spmv_kernel, ell_spmv_plain, launch_config


def random_sparse(r, c, density, seed, dtype):
    rng = np.random.default_rng(seed)
    dense = rng.standard_normal((r, c))
    dense[rng.random((r, c)) > density] = 0.0
    return dense.astype(dtype)


def operands(r, c, density, seed, dtype):
    """(JAX EllMat, port EllMat, x as numpy) for one random matrix."""
    ell = st.from_dense(random_sparse(r, c, density, seed, dtype)).to_ell()
    tell = from_arrays(
        "ell", ell.shape, (np.asarray(ell.indices), np.asarray(ell.data)), device="cpu"
    )
    x = np.random.default_rng(seed + 100).standard_normal(c).astype(dtype)
    return ell, tell, x


def assert_close(got, want, dtype):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    if dtype == np.float64:
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * float(np.abs(want).max()))


# the cases of tests/test_pallas.py::TestEllPallas: rows a multiple of the
# row block, rows not a multiple of it, the VJP case; then a square one
CASES = [(64, 48, 0.2, 7), (37, 11, 0.3, 8), (24, 16, 0.3, 9), (50, 50, 0.1, 10)]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("case", range(len(CASES)))
def test_kernel_on_cpu_matches_pallas_and_plain(case, dtype):
    ell, tell, x = operands(*CASES[case], dtype)
    want = ell_spmv_pallas(ell, x, interpret=True)
    got = ell_spmv_kernel(tell, torch.from_numpy(x)).numpy()
    assert_close(got, want, dtype)
    assert_close(got, jax_ell_spmv(ell, x), dtype)
    assert_close(ell_spmv_plain(tell, torch.from_numpy(x)).numpy(), want, dtype)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_backward_matches_jax_grad(dtype):
    """The autograd.Function's backward (the plain form of the JAX _bwd)
    against jax.grad through the Pallas kernel's custom VJP, pad slots
    included."""
    ell, tell, x = operands(24, 16, 0.3, 9, dtype)

    def loss(data, v):
        e = type(ell)(ell.indices, data, ell.shape)
        return jnp.sum(ell_spmv_pallas(e, v, interpret=True) ** 2)

    g_data, g_x = jax.grad(loss, argnums=(0, 1))(ell.data, x)
    data = tell.data.clone().requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    y = ell_spmv_kernel(EllMat(tell.indices, data, tell.shape), xt)
    (y**2).sum().backward()
    assert_close(data.grad.numpy(), g_data, dtype)
    assert_close(xt.grad.numpy(), g_x, dtype)


def test_backward_matches_torch_autograd_of_plain():
    """The hand-written backward equals torch's autograd of the plain
    version, pad slots and pad rows included, on a rectangular matrix."""
    _, tell, x = operands(37, 11, 0.3, 11, np.float64)
    g = torch.from_numpy(np.random.default_rng(12).standard_normal(37))
    grads = []
    for fn in (ell_spmv_kernel, ell_spmv_plain):
        data = tell.data.clone().requires_grad_(True)
        xt = torch.from_numpy(x).requires_grad_(True)
        y = fn(EllMat(tell.indices, data, tell.shape), xt)
        grads.append(torch.autograd.grad(y, (data, xt), g))
    for a, b in zip(*grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-13, atol=1e-15)


def test_nonfinite_x0_reaches_pad_slots_as_in_plain():
    """Pad slots add 0·x[0], so a NaN at x[0] spreads to every row, in the
    wrapper as in the JAX package's plain ell_spmv."""
    ell, tell, x = operands(12, 9, 0.3, 13, np.float64)
    x[0] = np.nan
    got = ell_spmv_kernel(tell, torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(np.asarray(jax_ell_spmv(ell, x))))


@pytest.mark.parametrize(
    "rows,width,n_sm,grid",
    [
        (1, 7, 132, 1),
        (32, 7, 132, 1),  # 8 lanes per row: 32 rows per block
        (33, 7, 132, 2),
        (1_048_576, 7, 132, 1056),  # the mesh step: one wave of 8 blocks per SM
        (2_097_152, 8, 114, 912),
        (45, 45, 132, 6),  # a row of 32 lanes: 8 rows per block
        (300, 1, 132, 2),  # a lane per row: 256 rows per block
    ],
)
def test_launch_config(rows, width, n_sm, grid):
    assert launch_config(rows, width, n_sm) == (grid, k5.BLOCK)


@pytest.mark.parametrize(
    "width,lanes", [(0, 1), (1, 1), (2, 2), (3, 4), (7, 8), (8, 8), (9, 16), (32, 32), (33, 32), (100, 32)]
)
def test_group_lanes(width, lanes):
    assert k5.group_lanes(width) == lanes


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_rows_wider_than_a_warp_match_pallas(dtype):
    """A row of more than 32 slots (the kernel loops over 32-slot chunks)
    on 45 rows, not a multiple of any group's rows per pass."""
    ell, tell, x = operands(45, 120, 0.45, 17, dtype)
    assert tell.width > 32
    want = ell_spmv_pallas(ell, x, interpret=True)
    assert_close(ell_spmv_kernel(tell, torch.from_numpy(x)).numpy(), want, dtype)


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    _, tell, x = operands(20, 20, 0.3, 14, np.float32)
    before, calls = ell_spmv_kernel.launches, ell_spmv_plain.calls
    ell_spmv_kernel(tell, torch.from_numpy(x))
    assert ell_spmv_kernel.launches == before and ell_spmv_plain.calls == calls + 1


def test_launch_refuses_cpu_and_mixed_devices():
    _, tell, x = operands(20, 16, 0.3, 15, np.float32)
    with pytest.raises(ValueError, match="CUDA"):
        k5._launch(tell, torch.from_numpy(x))
    with pytest.raises(ShapeError):
        ell_spmv_kernel(tell, torch.zeros(20))


def test_launch_checks_refuse_types_and_layouts():
    """What ``_launch`` refuses after the device check: complex or integer
    data (every pair of float16, bfloat16, float32 and float64 is a form),
    int64 indices, mismatched shapes, non-contiguous operands."""
    _, tell, x = operands(20, 16, 0.3, 16, np.float32)
    xt = torch.from_numpy(x)
    k5._check(tell, xt)
    idx, data = tell.indices, tell.data
    cases = [
        (EllMat(idx, data.to(torch.complex64), tell.shape), xt.to(torch.complex64), TypeError),
        (EllMat(idx, data.to(torch.int32), tell.shape), xt.to(torch.int32), TypeError),
        (EllMat(idx.to(torch.int64), data, tell.shape), xt, TypeError),
        (EllMat(idx, data[:, :1].contiguous(), tell.shape), xt, ShapeError),
        (EllMat(idx.t().contiguous().t(), data, tell.shape), xt, ValueError),
        (tell, torch.from_numpy(np.stack([x, x], 1))[:, 0], ValueError),
    ]
    for ell, v, err in cases:
        with pytest.raises(err):
            k5._check(ell, v)


@pytest.mark.gpu
@pytest.mark.parametrize("density", [0.05, 0.2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_matches_plain_on_card(dtype, density):
    """K5 on the card against its plain version (run where a GPU is); at
    density 0.2 the rows are wider than 32 slots."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from sprs_tpu_torch import from_dense

    d = torch.from_numpy(random_sparse(300, 257, density, 20, np.float64)).to(dtype)
    ell = from_dense(d, device="cuda").to_ell()
    x = torch.randn(257, dtype=dtype, device="cuda")
    before = ell_spmv_kernel.launches
    y = ell_spmv_kernel(ell, x)
    ref = ell_spmv_plain(ell, x)
    torch.cuda.synchronize()
    assert ell_spmv_kernel.launches == before + 1
    limit = 1e-12 if dtype == torch.float64 else 1e-5
    assert float((y - ref).abs().max()) <= limit * float(ref.abs().max())
