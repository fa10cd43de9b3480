"""K1's launch plan (``ops/cuda/dia_spmv.py``, ``csrc/dia_spmv.cu``),
checked on the CPU: the grid that the C plan is given and the constants
it mirrors, the routing between the direct launch and the autograd path
(gradients against ``jax.grad`` of the Pallas kernel), and that a
prepared operand changes nothing on the CPU.  The kernel itself runs on
the card: the ``gpu`` test.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import sprs_tpu as st
from sprs_tpu.ops.pallas import dia_spmv_pallas
from sprs_tpu_torch.formats.dia import DiaMat
from sprs_tpu_torch.interop import from_arrays
from sprs_tpu_torch.ops.cuda import dia_spmv as k1
from sprs_tpu_torch.ops.cuda.dia_spmv import dia_spmv_kernel, dia_spmv_plain, dia_tile
from sprs_tpu_torch.ops.cuda.forms import FORMS

SOURCE = Path(k1.__file__).resolve().parents[2] / "csrc" / "dia_spmv.cu"
N_SM = 132

# (rows, cols, offsets): the main path's sizes, a wide band (offsets
# ±rows/2), rows != cols, rows not a multiple of 8 (rows_pad > rows),
# k = 1 and k = 64
SHAPES = [
    (4096**2, 4096**2, (-4096, -1, 0, 1, 4096)),
    (1024**2, 1024**2, (-1024, -1, 0, 1, 1024)),
    (64**2, 64**2, (-64, -1, 0, 1, 64)),
    (3000, 3000, (-1500, -1, 0, 1, 1499)),
    (5001, 4803, (-70, -3, -1, 0, 2, 65)),
    (2000, 2000, (3,)),
    (3000, 3000, tuple(range(-32, 32))),
]


def band(rows, cols, offsets, seed, dtype=np.float64, rows_pad=None):
    """A port DiaMat on the CPU of normal values, zero where a diagonal
    leaves the matrix."""
    rng = np.random.default_rng(seed)
    rows_pad = -(-rows // 8) * 8 if rows_pad is None else rows_pad
    data = rng.standard_normal((len(offsets), rows_pad))
    i = np.arange(rows_pad)
    for d, off in enumerate(offsets):
        data[d, (i >= rows) | (i + off < 0) | (i + off >= cols)] = 0.0
    return from_arrays("dia", (rows, cols), (data.astype(dtype),), offsets=offsets, device="cpu")


@pytest.mark.parametrize("rows, cols, offsets", SHAPES)
def test_grid_covers_every_row_in_one_wave(rows, cols, offsets):
    """The plan's launch: a thread per row, at most one wave of
    BLOCKS_PER_SM blocks per SM, the grid-stride loop covering every row
    exactly once, and a grid the C plan accepts (an int of at least 1)."""
    grid, block = k1.launch_config(rows, N_SM)
    assert block == k1.BLOCK and 1 <= grid <= N_SM * k1.BLOCKS_PER_SM
    assert grid == min(-(-rows // block), N_SM * k1.BLOCKS_PER_SM)
    threads = grid * block
    per_thread = -(-rows // threads)
    assert (per_thread - 1) * threads < rows <= per_thread * threads
    assert 1 <= len(offsets) <= k1.MAX_DIAGS
    # the kernel's 64-bit index d * rows_pad + i stays inside the (k, rows_pad) array
    rows_pad = -(-rows // 8) * 8
    assert (len(offsets) - 1) * rows_pad + rows - 1 < len(offsets) * rows_pad


def test_c_source_mirrors_the_constants():
    """kBlock and kMaxDiags in the source state the Python mirror's
    numbers, and every form has its plan entry (a text check: there is no
    nvcc here)."""
    src = SOURCE.read_text()
    consts = {m.group(1): m.group(2) for m in re.finditer(r"^constexpr int (\w+) = ([^;]+);", src, re.M)}
    assert int(consts["kBlock"]) == k1.BLOCK
    assert int(consts["kMaxDiags"]) == k1.MAX_DIAGS
    for form in FORMS.values():
        assert f"SPRS_DIA_SPMV_PLAN({form}," in src


@pytest.mark.parametrize("pair", list(FORMS), ids=list(FORMS.values()))
@pytest.mark.parametrize("view", ["whole", "x[1:]"])
def test_prepared_operand_changes_nothing_on_the_cpu(pair, view):
    """On the CPU a prepared operand has no plan, and its product in every
    form, on a whole x and on a view such as x[1:] (off a 16-byte
    boundary), is the plain version's, bit for bit."""
    data_t, x_t = pair
    base = band(300, 280, (-40, -1, 0, 1, 3), 11)
    tiled = dia_tile(DiaMat(base.data.to(data_t), base.offsets, base.shape))
    assert tiled.plan is None
    x64 = torch.from_numpy(np.random.default_rng(12).standard_normal(281))
    x = x64[1:].to(x_t) if view == "whole" else x64.to(x_t)[1:]
    assert x.is_contiguous() and (view == "whole" or x.storage_offset() == 1)
    got, want = tiled.spmv(x), dia_spmv_plain(tiled, x)
    assert got.dtype == want.dtype and torch.equal(got, want)


class _CountingPlan:
    """Stands in for a K1Plan on the CPU: counts direct launches."""

    def __init__(self, dia):
        self.dia, self.calls = dia, 0

    def __call__(self, x):
        self.calls += 1
        return dia_spmv_plain(self.dia, x)


def test_direct_launch_only_without_gradient():
    """A prepared operand's product takes its plan's direct launch when no
    input needs a gradient (or grad mode is off), and the autograd
    Function otherwise, whose gradients equal jax.grad of the flat Pallas
    variant on live entries."""
    jdia = st.from_dense(np.asarray(band(40, 40, (-2, 0, 1), 30).to_dense())).to_dia()
    tdia = from_arrays("dia", jdia.shape, (np.asarray(jdia.data),), offsets=jdia.offsets, device="cpu")
    x = np.random.default_rng(31).standard_normal(40)
    data = tdia.data.clone().requires_grad_(True)
    tiled = dia_tile(DiaMat(data, tdia.offsets, tdia.shape))
    plan = _CountingPlan(tiled)
    object.__setattr__(tiled, "plan", plan)

    xt = torch.from_numpy(x).requires_grad_(True)
    y = dia_spmv_kernel(tiled, xt)
    assert plan.calls == 0 and y.grad_fn is not None
    (y**2).sum().backward()

    def loss_flat(d, v):
        m = type(jdia)(d, jdia.offsets, jdia.shape)
        return jnp.sum(dia_spmv_pallas(m, v, variant="flat", interpret=True) ** 2)

    g_data, g_x = jax.grad(loss_flat, argnums=(0, 1))(jdia.data, x)
    live = np.asarray(jdia.data) != 0
    np.testing.assert_allclose(data.grad.numpy()[live], np.asarray(g_data)[live], rtol=1e-12)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(g_x), rtol=1e-12)

    with torch.no_grad():
        dia_spmv_kernel(tiled, xt)
    assert plan.calls == 1
    plain_op = dia_tile(tdia)
    object.__setattr__(plain_op, "plan", _CountingPlan(plain_op))
    y = plain_op.spmv(torch.from_numpy(x))
    assert plain_op.plan.calls == 1 and y.grad_fn is None


def test_plan_refuses_coefficients_off_the_card():
    """K1Plan raises as the kernel does on CPU coefficients (ValueError
    naming CUDA), so a CPU operand is never planned."""
    with pytest.raises(ValueError, match="CUDA"):
        k1.K1Plan(band(64, 64, (-1, 0, 1), 40))


@pytest.mark.gpu
def test_direct_launch_matches_plain_and_the_per_call_path_on_card():
    """The kernel through a prepared operand's plan (the direct launch)
    against the plain version in all sixteen forms, on a band with
    rows != cols, on a whole x and on a view off a 16-byte boundary:
    bit-equal where the output is 16-bit or the products are rounded
    before the add ((f16, f16)), else within ``FORM_LIMIT``; and bit-equal
    to the same kernel through the autograd Function on a bare DiaMat (a
    plan built per call), with one launch counted for each."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    base = band(5001, 4803, (-70, -3, -1, 0, 2, 65), 50)
    x64 = torch.from_numpy(np.random.default_rng(52).standard_normal(4803)).cuda()
    for (data_t, x_t), form in FORMS.items():
        op = dia_tile(DiaMat(base.data.to(data_t).cuda(), base.offsets, base.shape))
        bare = DiaMat(op.data, op.offsets, op.shape)
        buf = torch.empty(4804, dtype=x_t, device="cuda")
        for x in (x64.to(x_t), buf[1:].copy_(x64.to(x_t))):
            before = dia_spmv_kernel.launches
            y, y_bare, ref = op.spmv(x), dia_spmv_kernel(bare, x), dia_spmv_plain(op, x)
            torch.cuda.synchronize()
            assert dia_spmv_kernel.launches == before + 2
            assert torch.equal(y, y_bare), form
            out = torch.promote_types(data_t, x_t)
            if out.itemsize == 2:
                assert torch.equal(y, ref), form
            else:
                err = float((y.double() - ref.double()).abs().max() / ref.double().abs().max())
                assert err <= FORM_LIMIT[out], (form, err)


# the kernel's output against the plain version's, relative to max|y|,
# where the kernel contracts a product and its sum into one fused
# multiply-add (chip_smoke.py: FORM_GATE_LIMIT)
FORM_LIMIT = {torch.float32: 1e-6, torch.float64: 1e-13}
