"""Kernel K2 (banded SpMM) of the PyTorch port against the JAX package.

On the CPU the port's wrapper takes the plain torch version; it is held
against the Pallas kernel in interpret mode (both schedules, as
tests/test_pallas.py runs them) and against the JAX package's plain
``dia_spmm``.  Tolerances: rtol 1e-12 in float64 and 1e-5 in float32,
each with an atol of the same multiple of max|Y|, because entries that
cancel to ~0 fail a pure relative check (XLA fuses the Pallas sum with
another rounding).  The CUDA kernel itself runs only on the card: the ``gpu``-marked
test.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import sprs_tpu as st
from sprs_tpu.formats.dia import dia_spmm as jax_dia_spmm
from sprs_tpu.ops.pallas import dia_spmm_pallas
from sprs_tpu.ops.prod import prepare_spmm as jax_prepare_spmm
from sprs_tpu_torch.errors import ShapeError
from sprs_tpu_torch.interop import from_arrays
from sprs_tpu_torch.ops import prepare_spmm
from sprs_tpu_torch.ops.cuda import dia_spmm as k2
from sprs_tpu_torch.ops.cuda.dia_spmm import dia_spmm_kernel, dia_spmm_plain, launch_config
from sprs_tpu_torch.ops.cuda.dia_spmv import DiaTiledMat, dia_tile


def banded(rows, cols, offsets, seed, dtype):
    rng = np.random.default_rng(seed)
    d = np.zeros((rows, cols))
    for off in offsets:
        i = np.arange(max(0, -off), min(rows, cols - off))
        d[i, i + off] = rng.standard_normal(i.size)
    return d.astype(dtype)


def operands(rows, cols, offsets, k, seed, dtype):
    """(JAX DiaMat, port DiaMat, X as numpy) for one banded matrix."""
    dia = st.from_dense(banded(rows, cols, offsets, seed, dtype)).to_dia()
    tdia = from_arrays(
        "dia", dia.shape, (np.asarray(dia.data),), offsets=dia.offsets, device="cpu"
    )
    x = np.random.default_rng(seed + 100).standard_normal((cols, k)).astype(dtype)
    return dia, tdia, x


def assert_close(got, want, dtype):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    tol = 1e-12 if dtype == np.float64 else 1e-5
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * float(np.abs(want).max()))


# (rows, cols, offsets, RHS width): square and rectangular, offsets far
# apart, widths below, at and past one 128-lane tile
CASES = [
    (300, 300, (-70, -3, -1, 0, 2, 65), 24),
    (260, 230, (-9, 0, 4, 30), 1),
    (150, 170, (-2, 0, 1), 130),
]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("variant", ["lagflat", "carry"])
@pytest.mark.parametrize("case", range(len(CASES)))
def test_plain_and_wrapper_match_pallas(case, variant, dtype):
    rows, cols, offsets, k = CASES[case]
    dia, tdia, x = operands(rows, cols, offsets, k, case, dtype)
    want = dia_spmm_pallas(dia, x, variant=variant, interpret=True)
    assert_close(dia_spmm_plain(tdia, torch.from_numpy(x)).numpy(), want, dtype)
    # the wrapper on CPU tensors is the plain version
    assert_close(dia_spmm_kernel(tdia, torch.from_numpy(x)).numpy(), want, dtype)


@pytest.mark.parametrize("k", [1, 5, 48])
def test_plain_matches_jax_plain_exactly(k):
    """Same sum order as the JAX package's dia_spmm: equal in float64."""
    dia, tdia, x = operands(120, 110, (-40, -1, 0, 3), k, 11 + k, np.float64)
    got = dia_spmm_plain(tdia, torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_dia_spmm(dia, x)))


@pytest.mark.parametrize("variant", ["lagflat", "carry"])
def test_backward_matches_jax_grad(variant):
    """The autograd.Function's backward (the plain form of the JAX _bwd)
    against jax.grad through the Pallas kernel, on live entries."""
    dia, tdia, x = operands(40, 40, (-2, 0, 1), 3, 30, np.float64)

    def loss(data, v):
        m = type(dia)(data, dia.offsets, dia.shape)
        return jnp.sum(dia_spmm_pallas(m, v, variant=variant, interpret=True) ** 2)

    g_data, g_x = jax.grad(loss, argnums=(0, 1))(dia.data, x)
    live = np.asarray(dia.data) != 0

    data = tdia.data.clone().requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    y = dia_spmm_kernel(type(tdia)(data, tdia.offsets, tdia.shape), xt)
    (y**2).sum().backward()
    np.testing.assert_allclose(data.grad.numpy()[live], np.asarray(g_data)[live], rtol=1e-12)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(g_x), rtol=1e-12)


def test_backward_matches_torch_autograd_of_plain():
    """The hand-written backward equals torch's autograd of the plain
    version, padding slots included, on a rectangular band."""
    _, tdia, x = operands(50, 37, (-9, -1, 0, 4, 30), 6, 31, np.float64)
    g = torch.from_numpy(np.random.default_rng(32).standard_normal((50, 6)))
    grads = []
    for fn in (dia_spmm_kernel, dia_spmm_plain):
        data = tdia.data.clone().requires_grad_(True)
        xt = torch.from_numpy(x).requires_grad_(True)
        y = fn(type(tdia)(data, tdia.offsets, tdia.shape), xt)
        grads.append(torch.autograd.grad(y, (data, xt), g))
    for a, b in zip(*grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-13, atol=1e-15)


@pytest.mark.parametrize(
    "rows,k,itemsize,acc,kind,config",
    [
        pytest.param(1, 1, 8, 8, "scalar", (1, 256, 256, 1), id="1-1-1"),
        pytest.param(100, 24, 8, 8, "tma", (2, 544, 80, 24), id="100-24-10"),
        pytest.param(1_048_576, 256, 8, 8, "tma", (132, 544, 16, 128), id="1048576-256-1056"),
        pytest.param(2_097_152, 1, 8, 8, "scalar", (396, 256, 256, 1), id="2097152-1-1056"),
        # the f32 timing shape: tiles of 64 rows by 128 columns (32 KB of
        # X), one persistent CTA per SM
        (2_097_152, 128, 4, 4, "tma", (132, 544, 64, 128)),
        # 130 f32 columns are not whole 16-byte vectors: scalar, one run
        (150, 130, 4, 4, "scalar", (38, 256, 1, 1)),
        # wider than one tile: 16 chunks of 128 columns
        (64, 2048, 4, 4, "tma", (16, 544, 64, 128)),
        # the few-sources expm width (f64, 3 columns)
        (1_048_576, 3, 8, 8, "scalar", (396, 256, 85, 1)),
        # bf16 X with f32 sums: 128 rows of 128 columns, one tile
        (128, 128, 2, 4, "tma", (1, 544, 128, 128)),
    ],
)
def test_launch_config(rows, k, itemsize, acc, kind, config):
    """(grid, block, tile_rows, tile_cols).  tma: a tile of T rows by kc
    columns (``tile_shape``: 32 KB of X with f32 sums, 16 KB with f64), at
    most one persistent CTA per SM over the (tile, chunk) items.  scalar:
    a tile is as many runs of 4 rows as a CTA's threads cover across k, at
    most one wave of 3 CTAs per SM."""
    assert launch_config(rows, k, 132, itemsize, kind, acc) == config


@pytest.mark.parametrize(
    "k,itemsize,offset,kind",
    [
        (128, 4, 0, "tma"),
        (4, 4, 16, "tma"),
        (2, 8, 0, "tma"),
        (256, 8, 32, "tma"),
        (130, 4, 0, "scalar"),  # 520-byte rows
        (1, 8, 0, "scalar"),
        (3, 8, 0, "scalar"),
        (12, 4, 0, "tma"),
        (128, 4, 4, "scalar"),  # X one f32 past a 16-byte boundary
        (24, 8, 8, "scalar"),  # X one f64 past a 16-byte boundary
    ],
)
def test_variant_rule(k, itemsize, offset, kind):
    """The tma variant needs rows of X of whole 16 bytes and X on a
    16-byte boundary (TMA's row stride and base); everything else takes
    the scalar variant."""
    assert k2.variant(k, itemsize, 4096 + offset) == kind


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_variant_rule_on_a_misaligned_view(dtype):
    """A contiguous view that starts one element into its storage (what
    chip_smoke.py's misaligned gates build) takes the scalar variant."""
    buf = torch.zeros(48 * 8 + 1, dtype=dtype)
    x = buf[1:].view(48, 8)
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    assert k2.variant(8, x.element_size(), x.data_ptr()) == "scalar"
    aligned = torch.zeros((48, 8), dtype=dtype)
    assert k2.variant(8, aligned.element_size(), aligned.data_ptr()) == "tma"


@pytest.mark.parametrize("k", [1, 24, 255, 256, 300])
def test_prepare_spmm_takes_the_wrapper_at_every_width(k):
    """The DIA route prepares a DiaTiledMat whose SpMM goes through the K2
    wrapper at every RHS width (the JAX package sends only k >= 256 to
    its kernel on a TPU); on the CPU the wrapper runs the plain version,
    and the values equal the JAX route's."""
    m = st.utils.grid_laplacian((9, 9), dtype=np.float64)
    t = from_arrays(
        "csmat",
        m.shape,
        (np.asarray(m.indptr), np.asarray(m.indices), np.asarray(m.data)),
        device="cpu",
    )
    fn, prepared = prepare_spmm(t)
    assert isinstance(prepared, DiaTiledMat)
    x = np.random.default_rng(k).standard_normal((81, k))
    before = dia_spmm_plain.calls
    got = fn(prepared, torch.from_numpy(x))
    assert dia_spmm_plain.calls == before + 1
    j_fn, j_prep = jax_prepare_spmm(m, use_pallas=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(j_fn(j_prep, x)), rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose((prepared @ torch.from_numpy(x)).numpy(), got.numpy(), rtol=0)


def launch_counts():
    k = dia_spmm_kernel
    return k.launches, k.launches_tma, k.launches_scalar


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    _, tdia, x = operands(64, 64, (-5, 0, 5), 8, 40, np.float32)
    before = launch_counts()
    dia_spmm_kernel(tdia, torch.from_numpy(x))
    assert launch_counts() == before


def test_launch_refuses_non_cuda_tensors():
    _, tdia, x = operands(64, 64, (-5, 0, 5), 8, 41, np.float32)
    with pytest.raises(ValueError, match="CUDA"):
        k2._launch(tdia, torch.from_numpy(x))


def test_shape_checks_and_column_major_input():
    _, tdia, x = operands(64, 48, (-5, 0, 5), 4, 42, np.float64)
    with pytest.raises(ShapeError):
        dia_spmm_kernel(tdia, torch.zeros((64, 4), dtype=torch.float64))
    with pytest.raises(ShapeError):
        dia_spmm_kernel(tdia, torch.zeros(48, dtype=torch.float64))
    xt = torch.from_numpy(x)
    fortran = xt.T.contiguous().T  # column-major, as torch.linalg.qr returns
    assert not fortran.is_contiguous()
    np.testing.assert_array_equal(
        dia_spmm_kernel(dia_tile(tdia), fortran).numpy(), dia_spmm_plain(tdia, xt).numpy()
    )


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_matches_plain_on_card(dtype):
    """K2 on the card against its plain version (run where a GPU is)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from sprs_tpu_torch import from_dense

    band = banded(500, 450, (-70, -3, -1, 0, 2, 65), 50, np.float64)
    dia = dia_tile(from_dense(torch.from_numpy(band).to(dtype), device="cuda").to_dia())
    for k in (1, 24, 48, 130, 256):
        aligned = torch.randn((dia.cols, k), dtype=dtype, device="cuda")
        buf = torch.empty(aligned.numel() + 1, dtype=dtype, device="cuda")
        misaligned = buf[1:].view(aligned.shape)
        misaligned.copy_(aligned)
        for x in (aligned, misaligned):
            kind = k2.variant_for(dia, x)
            before = dia_spmm_kernel.launches, getattr(dia_spmm_kernel, f"launches_{kind}")
            y = dia_spmm_kernel(dia, x)
            ref = dia_spmm_plain(dia, x)
            torch.cuda.synchronize()
            after = dia_spmm_kernel.launches, getattr(dia_spmm_kernel, f"launches_{kind}")
            assert after == (before[0] + 1, before[1] + 1)
            limit = 1e-12 if dtype == torch.float64 else 1e-5
            assert float((y - ref).abs().max()) <= limit * float(ref.abs().max())
    # a complex operand on the card raises: K2 is real only
    cdia = type(dia)(dia.data.to(torch.complex128), dia.offsets, dia.shape)
    with pytest.raises(TypeError):
        dia_spmm_kernel(cdia, torch.zeros((dia.cols, 2), dtype=torch.complex128, device="cuda"))
