"""K2's tma variant (``csrc/dia_spmm.cu``): its tile shape, slab plan and
ring, which the C entry mirrors, checked on the CPU; the schedule they
make, emulated in torch, against the plain version and the JAX package;
and the kernel itself in all sixteen forms on the card (the ``gpu``
test).

The emulation reads X through the same zero-filled boxes the TMA unit
delivers (rows outside [0, cols) are zeros) and sums each output's
diagonals in storage order, so it must equal the plain version bit for
bit in float64.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import sprs_tpu as st
from sprs_tpu.formats.dia import dia_spmm as jax_dia_spmm
from sprs_tpu_torch.formats.dia import DiaMat
from sprs_tpu_torch.interop import from_arrays
from sprs_tpu_torch.ops.cuda import dia_spmm as k2
from sprs_tpu_torch.ops.cuda.dia_spmm import dia_spmm_kernel, dia_spmm_plain
from sprs_tpu_torch.ops.cuda.dia_spmv import MAX_DIAGS, dia_tile
from sprs_tpu_torch.ops.cuda.forms import FORMS

SOURCE = Path(k2.__file__).resolve().parents[2] / "csrc" / "dia_spmm.cu"
ITEMSIZES = (2, 4, 8)
WIDTHS = (1, 8, 24, 48, 128, 256, 264)

# (rows, cols, offsets): rows not a multiple of the tile rows, offsets at
# or past the row count, unsorted offsets, the grid Laplacians' five
SHAPES = [
    (100, 110, (-70, -3, -1, 0, 2, 65)),
    (30, 200, (-40, -30, -1, 0, 1, 30, 150, 250)),
    (77, 77, (2, -1, 0, 65, -70, 1, -3)),
    (96, 96, (-32, -1, 0, 1, 32)),
]


def random_offsets(n, seed):
    """``n`` distinct offsets in storage order as a hand-built DiaMat may
    hold them: runs of neighbours (which merge) among far ones, shuffled."""
    rng = np.random.default_rng(seed)
    near = list(range(-(n // 4), n - n // 4))[: n // 2]
    far = rng.choice(np.setdiff1d(np.arange(-500, 500), near), n - len(near), replace=False)
    offs = near + [int(o) for o in far]
    if seed % 2:
        rng.shuffle(offs)
    return tuple(offs)


@pytest.mark.parametrize("n", [1, 2, 3, 5, 17, 64])
@pytest.mark.parametrize("seed", [0, 1])
def test_slab_plan_covers_every_read_once(n, seed):
    """Each (row, diagonal) read of a tile lies in exactly one slab: its
    X row i + off_d is a row of that slab's box [i0 + lo, i0 + lo + T +
    span), and the slabs list every diagonal once, in storage order."""
    offsets = random_offsets(n, seed)
    plan = k2.slab_plan(offsets)
    tile_rows = 16
    seen = np.zeros((tile_rows, n), int)
    order = []
    for d0, nd, lo, span in plan:
        assert 1 <= nd <= k2.SLAB_DIAGS and 0 <= span <= k2.MAX_SPAN
        for d in range(d0, d0 + nd):
            order.append(d)
            shift = offsets[d] - lo  # the diagonal's first row within the slab
            assert 0 <= shift <= span
            for r in range(tile_rows):
                assert 0 <= r + shift < tile_rows + span
                seen[r, d] += 1
    assert order == list(range(n))
    assert (seen == 1).all()


@pytest.mark.parametrize(
    "offsets,slabs",
    [
        ((-1024, -1, 0, 1, 1024), [(0, 1, -1024, 0), (1, 3, -1, 2), (4, 1, 1024, 0)]),
        ((0, 1, -1, 2, 3, 4, 5), [(0, 3, -1, 2), (3, 3, 2, 2), (6, 1, 5, 0)]),
        ((1, -1, 0), [(0, 3, -1, 2)]),
        ((0, 2, 1), [(0, 3, 0, 2)]),
        ((0, 3, 1), [(0, 1, 0, 0), (1, 2, 1, 2)]),
        ((0, 5, 1), [(0, 1, 0, 0), (1, 1, 5, 0), (2, 1, 1, 0)]),
        ((5,), [(0, 1, 5, 0)]),
        ((-70, -3, -1, 0, 2, 65), [(0, 1, -70, 0), (1, 2, -3, 2), (3, 2, 0, 2), (5, 1, 65, 0)]),
    ],
)
def test_slab_plan_merges_only_consecutive_diagonals(offsets, slabs):
    """Only neighbours in storage order share a slab, so an unsorted
    DiaMat keeps its order of summation: in (0, 5, 1), 0 and 1 lie one
    row apart but take slabs of their own."""
    assert k2.slab_plan(offsets) == slabs


def test_slab_plan_of_the_c_entry():
    """``plan_slabs`` in the source states the same rule (a text check:
    there is no nvcc here)."""
    src = SOURCE.read_text()
    body = src[src.index("int plan_slabs("):]
    body = body[: body.index("\n}\n")]
    assert "nd < kSlabDiags" in body and "nhi - nlo > kMaxSpan" in body


def test_c_source_mirrors_the_constants():
    src = SOURCE.read_text()
    consts = {m.group(1): m.group(2) for m in re.finditer(r"^constexpr (?:int|long long) (\w+) = ([^;]+);", src, re.M)}
    assert int(consts["kTmaConsumerWarps"]) * 32 + 32 == k2.TMA_THREADS
    assert int(consts["kTmaCtasPerSm"]) == k2.TMA_CTAS_PER_SM
    assert int(consts["kTmaConsumerWarps"]) * 32 == k2.TMA_CONSUMERS
    assert "constexpr int kPairs = sizeof(Acc) == 8 ? 2 : 4;" in src and k2.PAIRS == {4: 4, 8: 2}
    assert int(consts["kMaxTileCols"]) == k2.MAX_TILE_COLS
    assert int(consts["kMaxTileRows"]) == k2.MAX_TILE_ROWS
    assert int(consts["kMaxSpan"]) == k2.MAX_SPAN
    assert consts["kSlabDiags"] == "kMaxSpan + 1"
    assert int(consts["kMaxStages"]) == k2.MAX_STAGES
    assert int(consts["kSmemAlign"]) == k2.SMEM_ALIGN
    assert consts["kSmemPerCta"] == "233472 / kTmaCtasPerSm - 1024"
    assert k2.SMEM_PER_CTA == 233472 // k2.TMA_CTAS_PER_SM - 1024
    assert consts["kCoordLimit"] == "1ll << 30" and k2.COORD_LIMIT == 1 << 30
    assert int(consts["kThreads"]) == k2.THREADS and int(consts["kRun"]) == k2.RUN
    assert int(consts["kMinBlocks"]) == k2.BLOCKS_PER_SM
    assert int(consts["kMaxDiags"]) == MAX_DIAGS


@pytest.mark.parametrize("x_itemsize", ITEMSIZES)
@pytest.mark.parametrize("data_itemsize", ITEMSIZES)
@pytest.mark.parametrize("k", WIDTHS)
def test_ring_fits_in_shared_memory(x_itemsize, data_itemsize, k):
    """Every form's stage holds the largest slab and its strips, the ring
    has 2 to MAX_STAGES stages, and TMA_CTAS_PER_SM CTAs fit on an SM's
    228 KB (each within 227 KB), whatever the number of diagonals (1 to 64): a slab's
    height and strip count are bounded by MAX_SPAN, never by n_diags."""
    acc = 8 if 8 in (x_itemsize, data_itemsize) else 4
    tile_rows, tile_cols, chunks = k2.tile_shape(k, x_itemsize, acc)
    stages, stage, smem = k2.ring(tile_rows, tile_cols, x_itemsize, data_itemsize)
    assert 2 <= stages <= k2.MAX_STAGES
    assert smem <= 232_448 and k2.TMA_CTAS_PER_SM * (smem + 1024) <= k2.SM_SMEM
    x_area = (tile_rows + k2.MAX_SPAN) * tile_cols * x_itemsize
    strip = -(-tile_rows * data_itemsize // k2.SMEM_ALIGN) * k2.SMEM_ALIGN
    assert stage >= x_area + k2.SLAB_DIAGS * strip and stage % k2.SMEM_ALIGN == 0
    for n in (1, 3, 17, MAX_DIAGS):
        for _, nd, _, span in k2.slab_plan(random_offsets(n, k)):
            assert (tile_rows + span) * tile_cols * x_itemsize <= x_area and nd <= k2.SLAB_DIAGS


@pytest.mark.parametrize("x_itemsize,acc", [(2, 4), (4, 4), (2, 8), (4, 8), (8, 8)])
@pytest.mark.parametrize("k", WIDTHS)
def test_tile_shape(x_itemsize, acc, k):
    """kc: whole 16-byte vectors, at most MAX_TILE_COLS, the chunks
    covering k with less than one vector a chunk to spare; T: a multiple
    of 8 with at most ``tile_vectors`` 16-byte vectors of X in the tile
    (32 KB with f32 sums: 128 and 64 rows at 128 columns of 16-bit and
    f32 X; 16 KB with f64 sums: 64, 32 and 16 rows)."""
    tile_rows, tile_cols, chunks = k2.tile_shape(k, x_itemsize, acc)
    per_vec = 16 // x_itemsize
    assert tile_cols % per_vec == 0 and tile_cols <= k2.MAX_TILE_COLS
    assert chunks * tile_cols >= k > (chunks - 1) * tile_cols
    assert chunks == -(-k // k2.MAX_TILE_COLS)
    assert tile_rows % 8 == 0 and 8 <= tile_rows <= k2.MAX_TILE_ROWS
    assert tile_rows * tile_cols <= k2.tile_vectors(acc) * per_vec
    if k >= 128 and k % 128 == 0:
        rows = {2: 64, 4: 32, 8: 16}[x_itemsize] * (2 if acc == 4 else 1)
        assert (tile_rows, tile_cols) == (rows, 128)


def emulate_tma(dia, x):
    """The tma variant's schedule in torch: for each (tile, chunk), each
    slab's box of X (zeros outside [0, cols) and past k) and coefficient
    strips (zeros past rows_pad), each output summing its diagonals in
    storage order, Y written where row < rows and column < k."""
    rows, cols, k = dia.rows, dia.cols, x.shape[1]
    acc = k2.acc_itemsize(dia.dtype, x.dtype)
    tile_rows, tile_cols, chunks = k2.tile_shape(k, x.element_size(), acc)
    plan = k2.slab_plan(dia.offsets)
    dtype = x.dtype
    wide_x = torch.zeros((cols + 4 * (rows + 300), chunks * tile_cols), dtype=dtype)
    pad = 2 * (rows + 300)
    wide_x[pad : pad + cols, :k] = x
    data = torch.zeros((dia.n_diags, dia.rows_pad + tile_rows), dtype=dtype)
    data[:, : dia.rows_pad] = dia.data
    y = torch.full((rows, k), float("nan"), dtype=dtype)
    for i0 in range(0, rows, tile_rows):
        for c0 in range(0, chunks * tile_cols, tile_cols):
            acc = torch.zeros((tile_rows, tile_cols), dtype=dtype)
            for d0, nd, lo, span in plan:
                box = wide_x[pad + i0 + lo : pad + i0 + lo + tile_rows + span, c0 : c0 + tile_cols]
                for d in range(d0, d0 + nd):
                    shift = dia.offsets[d] - lo
                    acc += data[d, i0 : i0 + tile_rows, None] * box[shift : shift + tile_rows]
            n_rows, n_cols = min(tile_rows, rows - i0), min(tile_cols, k - c0)
            y[i0 : i0 + n_rows, c0 : c0 + n_cols] = acc[:n_rows, :n_cols]
    return y


def band(rows, cols, offsets, seed):
    rng = np.random.default_rng(seed)
    rows_pad = -(-rows // 8) * 8
    data = rng.standard_normal((len(offsets), rows_pad))
    i = np.arange(rows_pad)
    for d, off in enumerate(offsets):
        data[d, (i >= rows) | (i + off < 0) | (i + off >= cols)] = 0.0
    return data


@pytest.mark.parametrize("shape", range(len(SHAPES)))
@pytest.mark.parametrize("k", [8, 24, 128, 256])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_emulated_schedule_equals_plain_and_jax(shape, k, dtype):
    """The tiles (32 KB of X with float32 sums, 16 KB with float64),
    chunks and slabs cover Y exactly, and their sums equal the plain
    version and the JAX package's ``dia_spmm`` bit for bit (the same
    order of additions, one rounding each)."""
    rows, cols, offsets = SHAPES[shape]
    data = band(rows, cols, offsets, shape).astype(dtype)
    dia = DiaMat(torch.from_numpy(data), offsets, (rows, cols))
    x = np.random.default_rng(10 + shape).standard_normal((cols, k)).astype(dtype)
    want = dia_spmm_plain(dia, torch.from_numpy(x))
    torch.testing.assert_close(emulate_tma(dia, torch.from_numpy(x)), want, rtol=0, atol=0)
    if dtype == np.float64:
        jax_dia = st.formats.dia.DiaMat(jnp.asarray(data), offsets, (rows, cols))
        np.testing.assert_array_equal(want.numpy(), np.asarray(jax_dia_spmm(jax_dia, x)))


@pytest.mark.parametrize("dtype", [torch.float16, torch.float32, torch.float64])
def test_tma_data_pads_what_tma_cannot_read(dtype):
    """A DiaMat built by hand with rows of 5 values (not whole 16 bytes)
    or starting off a 16-byte boundary is staged into rows padded to 8;
    aligned data is read in place."""
    buf = torch.arange(3 * 5 + 1, dtype=dtype)
    odd = DiaMat(buf[:15].view(3, 5), (-1, 0, 1), (5, 5))
    staged, rows_pad = k2._tma_data(odd)
    assert rows_pad == 8 and staged.shape == (3, 8)
    assert torch.equal(staged[:, :5], odd.data) and not staged[:, 5:].any()
    shifted = DiaMat(buf[1:].view(3, 5), (-1, 0, 1), (5, 5))
    assert k2._tma_data(shifted)[1] == 8
    aligned = DiaMat(torch.zeros((3, 16), dtype=dtype), (-1, 0, 1), (16, 16))
    data, rows_pad = k2._tma_data(aligned)
    assert data is aligned.data and rows_pad == 16


def test_variant_for_keeps_tma_within_its_coordinates():
    """Rows, columns or an offset at 2^30 are past TMA's 32-bit
    coordinates, and an X of no rows has no tensor map: the scalar
    variant takes them."""
    x = torch.zeros((8, 8))
    assert k2.variant_for(DiaMat(torch.zeros((1, 8)), (0,), (8, 8)), x) == "tma"
    for offsets, shape in (((1 << 30,), (8, 8)), ((0,), (8, 1 << 30)), ((-(1 << 30),), (8, 8))):
        assert k2.variant_for(DiaMat(torch.zeros((1, 8)), offsets, shape), x) == "scalar"
    assert k2.variant_for(DiaMat(torch.zeros((1, 8)), (0,), (8, 8)), torch.zeros((8, 3))) == "scalar"
    assert k2.variant_for(DiaMat(torch.zeros((1, 8)), (0,), (8, 0)), torch.zeros((0, 8))) == "scalar"


@pytest.mark.parametrize("rows,k,itemsize,acc,grid,tile", [
    (2_097_152, 128, 4, 4, 132, (64, 128)),
    (2_097_152, 128, 2, 4, 132, (128, 128)),
    (2_097_152, 128, 2, 8, 132, (64, 128)),
    (1_048_576, 256, 8, 8, 132, (16, 128)),
    (1_048_576, 24, 8, 8, 132, (80, 24)),
    (100, 24, 8, 8, 2, (80, 24)),
    (64, 8, 4, 4, 1, (128, 8)),
])
def test_tma_launch_config(rows, k, itemsize, acc, grid, tile):
    """At most one persistent CTA per SM (132 SMs), fewer where the
    (tile, chunk) items are fewer."""
    assert k2.launch_config(rows, k, 132, itemsize, "tma", acc) == (grid, k2.TMA_THREADS, *tile)


@pytest.mark.gpu
def test_tma_kernel_matches_plain_in_every_form_on_card():
    """K2 on the card in all sixteen forms on SHAPES at k = 8, 24, 128 and
    256 (the tma variant) and a misaligned X (the scalar variant), against
    the plain version: bit-equal where Y is 16-bit, else within 1e-6 (Y
    float32) or 1e-13 (float64) of max|Y| (FMA contraction)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    limit = {torch.float32: 1e-6, torch.float64: 1e-13}
    for shape, (rows, cols, offsets) in enumerate(SHAPES):
        wide = from_arrays("dia", (rows, cols), (band(rows, cols, offsets, shape),), offsets=offsets,
                           device="cuda")
        block = torch.from_numpy(np.random.default_rng(20 + shape).standard_normal((cols, 256))).cuda()
        for (data_dtype, x_dtype), form in FORMS.items():
            dia = dia_tile(DiaMat(wide.data.to(data_dtype), offsets, (rows, cols)))
            xs = [block[:, :k].to(x_dtype).contiguous() for k in (8, 24, 128, 256)]
            buf = torch.empty(cols * 24 + 1, dtype=x_dtype, device="cuda")
            xs.append(buf[1:].view(cols, 24))
            xs[-1].copy_(block[:, :24])
            for x in xs:
                kind = k2.variant_for(dia, x)
                assert kind == ("scalar" if x.data_ptr() % 16 else "tma")
                before = getattr(dia_spmm_kernel, f"launches_{kind}"), getattr(dia_spmm_kernel, f"launches_{form}")
                y = dia_spmm_kernel(dia, x)
                ref = dia_spmm_plain(dia, x)
                torch.cuda.synchronize()
                after = getattr(dia_spmm_kernel, f"launches_{kind}"), getattr(dia_spmm_kernel, f"launches_{form}")
                assert after == (before[0] + 1, before[1] + 1)
                assert y.dtype == ref.dtype == torch.promote_types(data_dtype, x_dtype)
                if y.element_size() == 2:
                    assert torch.equal(y.view(torch.int16), ref.view(torch.int16)), (form, shape, x.shape)
                else:
                    err = float((y - ref).abs().max())
                    assert err <= limit[y.dtype] * float(ref.abs().max()), (form, shape, x.shape)
