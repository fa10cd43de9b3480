"""Kernel K1 (banded SpMV) of the PyTorch port against the JAX package.

On the CPU the port's wrapper takes the plain torch version; it is held
against the Pallas kernels run in interpret mode (as tests/test_pallas.py
runs them) and against the JAX package's plain ``dia_spmv``.  Tolerances:
float64 rtol 1e-12; float32 rtol 1e-5 with atol 1e-5·max|y|, because
entries that cancel to ~0 fail a pure relative check.  The CUDA kernel
itself runs only on the card: the ``gpu``-marked test.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import sprs_tpu as st
from sprs_tpu.formats.dia import dia_spmv as jax_dia_spmv
from sprs_tpu.ops.pallas import dia_spmv_pallas
from sprs_tpu.ops.pallas import dia_tile as jax_dia_tile
from sprs_tpu_torch.errors import ShapeError
from sprs_tpu_torch.formats.dia import dia_spmm as t_dia_spmm
from sprs_tpu_torch.interop import from_arrays
from sprs_tpu_torch.ops.cuda import dia_spmv as k1
from sprs_tpu_torch.ops.cuda.dia_spmv import (
    DiaTiledMat,
    dia_spmv_kernel,
    dia_spmv_plain,
    dia_tile,
    launch_config,
)


def banded(rows, cols, offsets, seed, dtype):
    rng = np.random.default_rng(seed)
    d = np.zeros((rows, cols))
    for off in offsets:
        i = np.arange(max(0, -off), min(rows, cols - off))
        d[i, i + off] = rng.standard_normal(i.size)
    return d.astype(dtype)


def operands(rows, cols, offsets, seed, dtype):
    """(JAX DiaMat, port DiaMat, x as numpy) for one banded matrix."""
    dia = st.from_dense(banded(rows, cols, offsets, seed, dtype)).to_dia()
    tdia = from_arrays(
        "dia", dia.shape, (np.asarray(dia.data),), offsets=dia.offsets, device="cpu"
    )
    x = np.random.default_rng(seed + 100).standard_normal(cols).astype(dtype)
    return dia, tdia, x


def assert_close(got, want, dtype):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    if dtype == np.float64:
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    else:
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * scale)


# offsets beyond ±blk/2 of the minimum 1024-row block, rows != cols
CASES = [
    (2300, 2300, (-700, -3, 0, 2, 650)),
    (2100, 1900, (-600, -1, 0, 1, 530)),
    (64, 64, (-5, -1, 0, 1, 5)),
]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("variant", ["lag", "carry", "flat", "flatg"])
@pytest.mark.parametrize("case", range(len(CASES)))
def test_plain_matches_pallas_variants(case, variant, dtype):
    rows, cols, offsets = CASES[case]
    dia, tdia, x = operands(rows, cols, offsets, case, dtype)
    want = dia_spmv_pallas(
        dia, x, blk=1024, grp=2 if variant == "flatg" else None,
        variant=variant, interpret=True,
    )
    assert_close(dia_spmv_plain(tdia, torch.from_numpy(x)).numpy(), want, dtype)
    # the wrapper on CPU tensors is the plain version
    assert_close(dia_spmv_kernel(tdia, torch.from_numpy(x)).numpy(), want, dtype)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("grp", [2, 4])
def test_tiled_matches_pallas_prepared(grp, dtype):
    rows, cols, offsets = CASES[0]
    dia, tdia, x = operands(rows, cols, offsets, 7, dtype)
    want = jax_dia_tile(dia, blk=1024, grp=grp).spmv(x, interpret=True)
    tiled = dia_tile(tdia)
    assert isinstance(tiled, DiaTiledMat)
    assert_close(tiled.spmv(torch.from_numpy(x)).numpy(), want, dtype)
    assert_close((tiled @ torch.from_numpy(x)).numpy(), want, dtype)


@pytest.mark.parametrize("case", range(len(CASES)))
def test_plain_matches_jax_plain_exactly(case):
    """Same sum order as the JAX package's dia_spmv: equal in float64."""
    rows, cols, offsets = CASES[case]
    dia, tdia, x = operands(rows, cols, offsets, 11 + case, np.float64)
    got = dia_spmv_plain(tdia, torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_dia_spmv(dia, x)))


def test_dia_spmm_matches_jax():
    from sprs_tpu.formats.dia import dia_spmm

    dia, tdia, _ = operands(300, 280, (-40, 0, 3), 12, np.float64)
    xm = np.random.default_rng(13).standard_normal((280, 5))
    got = t_dia_spmm(tdia, torch.from_numpy(xm)).numpy()
    np.testing.assert_allclose(got, np.asarray(dia_spmm(dia, xm)), rtol=1e-12)


def test_backward_matches_jax_grad():
    """The autograd.Function's backward (plain form of the JAX _bwd)
    against jax.grad of the flat Pallas variant, on live entries."""
    dia, tdia, x = operands(40, 40, (-2, 0, 1), 30, np.float64)

    def loss_flat(data, v):
        m = type(dia)(data, dia.offsets, dia.shape)
        return jnp.sum(dia_spmv_pallas(m, v, variant="flat", interpret=True) ** 2)

    g_data, g_x = jax.grad(loss_flat, argnums=(0, 1))(dia.data, x)
    live = np.asarray(dia.data) != 0

    data = tdia.data.clone().requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    y = dia_spmv_kernel(type(tdia)(data, tdia.offsets, tdia.shape), xt)
    (y**2).sum().backward()
    np.testing.assert_allclose(data.grad.numpy()[live], np.asarray(g_data)[live], rtol=1e-12)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(g_x), rtol=1e-12)


def test_backward_matches_torch_autograd_of_plain():
    """The hand-written backward equals torch's autograd of the plain
    version, padding slots included, on a rectangular band."""
    _, tdia, x = operands(50, 37, (-9, -1, 0, 4, 30), 31, np.float64)
    g = torch.from_numpy(np.random.default_rng(32).standard_normal(50))
    grads = []
    for fn in (dia_spmv_kernel, dia_spmv_plain):
        data = tdia.data.clone().requires_grad_(True)
        xt = torch.from_numpy(x).requires_grad_(True)
        y = fn(type(tdia)(data, tdia.offsets, tdia.shape), xt)
        grads.append(torch.autograd.grad(y, (data, xt), g))
    for a, b in zip(*grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-13, atol=1e-15)


@pytest.mark.parametrize(
    "rows,n_sm,grid",
    [(1, 132, 1), (256, 132, 1), (257, 132, 2), (100_000, 132, 391), (16_777_216, 132, 1056)],
)
def test_launch_config(rows, n_sm, grid):
    assert launch_config(rows, n_sm) == (grid, k1.BLOCK)


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    _, tdia, x = operands(64, 64, (-5, 0, 5), 40, np.float32)
    before = dia_spmv_kernel.launches
    dia_spmv_kernel(tdia, torch.from_numpy(x))
    assert dia_spmv_kernel.launches == before


def test_launch_refuses_non_cuda_tensors():
    _, tdia, x = operands(64, 64, (-5, 0, 5), 41, np.float32)
    with pytest.raises(ValueError, match="CUDA"):
        k1._launch(tdia, torch.from_numpy(x))


def test_shape_checks():
    _, tdia, x = operands(64, 48, (-5, 0, 5), 42, np.float64)
    with pytest.raises(ShapeError):
        dia_spmv_kernel(tdia, torch.zeros(64, dtype=torch.float64))
    wide = from_arrays(
        "dia", (80, 80), (np.zeros((k1.MAX_DIAGS + 1, 80)),),
        offsets=range(-32, 33), device="cpu",
    )
    with pytest.raises(ShapeError):
        dia_tile(wide)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_matches_plain_on_card(dtype):
    """K1 on the card against its plain version (run where a GPU is)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from sprs_tpu_torch import from_dense
    from sprs_tpu_torch.utils import grid_laplacian

    band = banded(500, 450, (-70, -3, -1, 0, 2, 65), 50, np.float64)
    for mat in (
        grid_laplacian((64, 64), dtype, device="cuda"),
        from_dense(torch.from_numpy(band).to(dtype), device="cuda"),
    ):
        dia = dia_tile(mat.to_dia())
        x = torch.randn(dia.cols, dtype=dtype, device="cuda")
        before = dia_spmv_kernel.launches
        y = dia_spmv_kernel(dia, x)
        ref = dia_spmv_plain(dia, x)
        torch.cuda.synchronize()
        assert dia_spmv_kernel.launches == before + 1
        limit = 1e-12 if dtype == torch.float64 else 1e-5
        assert float((y - ref).abs().max()) <= limit * float(ref.abs().max())
