"""Kernel K7 (merge-path CSR SpMV) of the PyTorch port.

On the CPU the wrapper takes the plain torch version, which is the CSR
product as it was before K7 (a gather and ``index_sum_``); it is held
bit for bit against that product written out here.  The kernel's
partition of the merge path (the tiles' two searches, each thread's walk
and segmented scan, the carries across tiles) is emulated in numpy step
for step on integer values, whose sums are exact in any order, so that
every row is written once and right.  The CUDA kernel itself runs only
on the card: the ``gpu``-marked tests, which import no JAX:
``python -m pytest --noconftest tests/test_torch_csr_spmv.py -q -m gpu``.
"""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from sprs_tpu_torch.errors import ShapeError
from sprs_tpu_torch.formats.csmat import CsMat
from sprs_tpu_torch.interop import from_arrays
from sprs_tpu_torch.ops import prod
from sprs_tpu_torch.ops.cuda import csr_spmv as k7
from sprs_tpu_torch.ops.cuda.csr_spmv import TILE, csr_spmv_kernel, csr_spmv_plain, tiles
from sprs_tpu_torch.ops.cuda.forms import FORMS

SOURCE = Path(__file__).resolve().parents[1] / "sprs_tpu_torch" / "csrc" / "csr_spmv.cu"


def lengths_power_law(rows: int, seed: int, hub: int, tile: int = TILE) -> np.ndarray:
    """Row lengths with a Zipf tail, one hub row of ``hub`` entries,
    empty rows leading, trailing and in an interior run, one row whose
    end item is a tile's last item and one whose entries end a tile (its
    end item then opens the next)."""
    rng = np.random.default_rng(seed)
    n = np.minimum(rng.zipf(1.8, rows) - 1, 400)
    n[:3] = 0
    n[-3:] = 0
    n[rows // 2: rows // 2 + 40] = 0
    n[rows // 3] = hub
    for r, after in ((rows // 4, 1), (rows // 5 * 3, 0)):
        # path index of row r's end item: r + indptr[r + 1]
        end = r + int(n[: r + 1].sum())
        n[r] += (-(end + after)) % tile
    return n


def csr_arrays(lengths, cols, seed, pad=0, integer=False):
    """(indptr, indices, data) of a CSR pattern with ``lengths[r]``
    sorted random columns in row r (repeats allowed: a CsMat may hold
    duplicates) and ``pad`` padding slots."""
    rng = np.random.default_rng(seed + 1)
    indptr = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int32)
    indices = np.concatenate([np.sort(rng.integers(0, cols, int(k))) for k in lengths]
                             + [np.zeros(pad, np.int64)]).astype(np.int32)
    nnz = int(indptr[-1])
    data = (rng.integers(-4, 5, nnz) if integer else rng.standard_normal(nnz)).astype(np.float64)
    return indptr, indices, np.concatenate([data, np.zeros(pad)])


def csmat_of(arrays, shape, device="cpu", dtype=torch.float64) -> CsMat:
    indptr, indices, data = arrays
    return from_arrays("csmat", shape, (indptr, indices, data), device=device).astype(dtype)


def before(mat: CsMat, x: torch.Tensor) -> torch.Tensor:
    """The CPU's CSR product as ``ops/prod.py::spmv`` computed it before
    K7: row ids from indptr, padding masked to row 0 with a zero
    contribution, a gather of x and ``index_add_`` in index order."""
    outer = mat.outer_ids()
    live = outer < mat.rows
    rows = torch.where(live, outer, torch.zeros_like(outer)).to(torch.int64)
    contrib = mat.data * x[mat.indices.to(torch.int64)]
    contrib = torch.where(live, contrib, torch.zeros_like(contrib))
    y = torch.zeros(mat.rows, dtype=contrib.dtype)
    return y.index_add_(0, rows, contrib)


# ---------------------------------------------------------------------------
# the CPU path
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("form", sorted(FORMS.items(), key=lambda kv: kv[1]), ids=lambda kv: kv[1])
def test_cpu_tensors_take_the_plain_version_bit_equal_to_before(form):
    """Every form on CPU tensors: the wrapper and ``prod.spmv`` call the
    plain version, launch nothing, and give the bits of the product as it
    was before K7."""
    (dd, xd), _ = form
    rng = np.random.default_rng(3)
    lengths = lengths_power_law(300, 4, hub=500, tile=64)
    mat = csmat_of(csr_arrays(lengths, 200, 5, pad=11), (300, 200), dtype=dd)
    x = torch.from_numpy(rng.standard_normal(200)).to(xd)
    want = before(mat, x)
    launches, calls = csr_spmv_kernel.launches, csr_spmv_plain.calls
    for got in (csr_spmv_kernel(mat, x), prod.spmv(mat, x), mat @ x):
        assert got.dtype == want.dtype
        assert torch.equal(got.view(torch.int8), want.view(torch.int8))
    assert csr_spmv_kernel.launches == launches and csr_spmv_plain.calls == calls + 3
    assert not k7.takes(mat, x)


def test_prepare_spmv_keeps_the_csmat_for_the_csr_route():
    """The CSR arm of ``prepare_spmv`` returns ``prod.spmv`` and the
    matrix itself: the route is named by the prepared object's type."""
    mat = csmat_of(csr_arrays(lengths_power_law(300, 6, hub=250, tile=64), 300, 7), (300, 300))
    assert prod._route(mat) == "csr"
    fn, prepared = prod.prepare_spmv(mat)
    assert fn is prod.spmv and prepared is mat


def test_csc_products_keep_the_scatter_form():
    """A CSC product is no K7 product: the plain scatter form, as before."""
    mat = csmat_of(csr_arrays(lengths_power_law(120, 8, hub=90, tile=64), 150, 9), (120, 150))
    csc = mat.to_csc()
    x = torch.from_numpy(np.random.default_rng(10).standard_normal(150))
    calls = csr_spmv_plain.calls
    y = prod.spmv(csc, x)
    assert csr_spmv_plain.calls == calls + 1
    torch.testing.assert_close(y, mat.to_dense() @ x, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_vjp_matches_torch_autograd_of_plain(dtype):
    """The autograd path's backward (``csr_vjp``) against torch's autograd
    through the plain product, padding slots included (their ddata 0)."""
    mat = csmat_of(csr_arrays(lengths_power_law(200, 11, hub=300, tile=64), 150, 12, pad=9),
                   (200, 150), dtype=dtype)
    rng = np.random.default_rng(13)
    x = torch.from_numpy(rng.standard_normal(150)).to(dtype)
    g = torch.from_numpy(rng.standard_normal(200)).to(dtype)
    data = mat.data.clone().requires_grad_(True)
    xr = x.clone().requires_grad_(True)
    csr_spmv_plain(mat.with_data(data), xr).backward(g)
    ddata, dx = k7.csr_vjp(mat, x, g)
    tol = {"rtol": 1e-12, "atol": 1e-12} if dtype == torch.float64 else {"rtol": 1e-5, "atol": 1e-5}
    torch.testing.assert_close(ddata, data.grad, **tol)
    torch.testing.assert_close(dx, xr.grad, **tol)
    assert torch.all(ddata[int(mat.indptr[-1]):] == 0)


@pytest.mark.parametrize("data_dtype, x_dtype", [
    (torch.float64, torch.float64), (torch.float32, torch.float32), (torch.float64, torch.float32),
])
def test_cpu_product_needing_a_gradient_runs_the_function(data_dtype, x_dtype):
    """On CPU tensors that need a gradient the wrapper runs ``_CsrSpmv``, as
    on the card: its output is the plain product's bit for bit, and its
    gradients (``csr_vjp``) match torch's autograd through the plain
    product."""
    mat = csmat_of(csr_arrays(lengths_power_law(200, 14, hub=300, tile=64), 150, 15, pad=9),
                   (200, 150), dtype=data_dtype)
    rng = np.random.default_rng(16)
    x = torch.from_numpy(rng.standard_normal(150)).to(x_dtype)
    g = torch.from_numpy(rng.standard_normal(200)).to(torch.promote_types(data_dtype, x_dtype))
    data, xr = mat.data.clone().requires_grad_(True), x.clone().requires_grad_(True)
    y = csr_spmv_kernel(mat.with_data(data), xr)
    assert type(y.grad_fn).__name__ == "_CsrSpmvBackward"
    assert torch.equal(y.detach(), csr_spmv_plain(mat, x))
    y.backward(g)
    want_data, want_x = mat.data.clone().requires_grad_(True), x.clone().requires_grad_(True)
    csr_spmv_plain(mat.with_data(want_data), want_x).backward(g)
    wide = data_dtype == x_dtype == torch.float64
    tol = {"rtol": 1e-12, "atol": 1e-12} if wide else {"rtol": 1e-5, "atol": 1e-5}
    torch.testing.assert_close(data.grad, want_data.grad, **tol)
    torch.testing.assert_close(xr.grad, want_x.grad, **tol)


# ---------------------------------------------------------------------------
# the grid and the source's constants
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rows, cap, want", [
    (0, 0, 0),  # zero rows: no launch
    (1, 0, 1),  # zero entries: the row ends alone
    (TILE, 0, 1),
    (TILE + 1, 0, 2),
    (0, TILE + 1, 2),
    (10, 5 * TILE, 6),  # cap > nnz: tiles past rows + nnz return at once
    (8_388_608, 258_669_824, 94837),  # kron23 with cap = nnz
])
def test_tiles(rows, cap, want):
    n = tiles(rows, cap)
    assert n == want
    assert n * TILE >= rows + cap > (n - 1) * TILE or n == 0


def test_constants_match_the_source():
    """TILE is the source's kThreads * kItems and CARRY_BYTES its scratch
    per tile: two accumulators of up to 8 bytes and an int row id."""
    text = SOURCE.read_text()
    threads = int(re.search(r"constexpr int kThreads = (\d+);", text).group(1))
    items = int(re.search(r"constexpr int kItems = (\d+);", text).group(1))
    assert TILE == threads * items
    assert "work` holds tiles * 20 bytes" in text and k7.CARRY_BYTES == 20
    for suffix in FORMS.values():
        assert f"SPRS_CSR_SPMV_ENTRY(sprs_csr_spmv_{suffix}," in text


# ---------------------------------------------------------------------------
# the wrapper's refusals
# ---------------------------------------------------------------------------


def small():
    mat = csmat_of(csr_arrays(np.array([2, 0, 3, 1]), 5, 14, pad=2), (4, 5), dtype=torch.float32)
    return mat, torch.ones(5, dtype=torch.float32)


def test_wrapper_refuses_a_wrong_shape():
    mat, x = small()
    with pytest.raises(ShapeError):
        csr_spmv_kernel(mat, torch.ones(4))
    with pytest.raises(ShapeError):
        k7._check(CsMat(mat.indptr[:-1], mat.indices, mat.data, mat.shape, "csr"), x)
    with pytest.raises(ShapeError):
        k7._check(CsMat(mat.indptr, mat.indices, mat.data[:-1], mat.shape, "csr"), x)


@pytest.mark.parametrize("which", ["indices", "indptr"])
def test_wrapper_refuses_int64_indices(which):
    mat, x = small()
    arrays = {"indptr": mat.indptr, "indices": mat.indices}
    arrays[which] = arrays[which].to(torch.int64)
    wide = CsMat(arrays["indptr"], arrays["indices"], mat.data, mat.shape, "csr")
    with pytest.raises(TypeError, match="int32"):
        k7._check(wide, x)
    assert not k7.takes(wide, x)


@pytest.mark.parametrize("dtype", [torch.complex64, torch.int32, torch.float8_e4m3fn])
def test_wrapper_refuses_a_form_outside_forms(dtype):
    mat, x = small()
    odd = mat.with_data(mat.data.to(dtype))
    with pytest.raises(TypeError, match="csr_spmv kernel takes"):
        k7._check(odd, x.to(dtype))
    assert (dtype, dtype) not in FORMS


def test_wrapper_refuses_cpu_and_mixed_devices():
    """``_launch`` needs every operand on one CUDA device; CPU tensors and
    a matrix and x on two devices are refused before any launch."""
    mat, x = small()
    with pytest.raises(ValueError, match="CUDA"):
        k7._launch(mat, x)
    meta = torch.empty(5, dtype=torch.float32, device="meta")
    with pytest.raises(ValueError, match="one CUDA device"):
        k7._launch(mat, meta)


def test_wrapper_refuses_csc_and_strided_operands():
    mat, x = small()
    with pytest.raises(ValueError, match="CSR"):
        k7._check(CsMat(mat.indptr, mat.indices, mat.data, mat.shape, "csc"), x)
    with pytest.raises(ValueError, match="contiguous"):
        k7._check(mat, torch.ones(10)[::2])


@pytest.mark.parametrize("case", ["csc", "complex64", "int32 values", "int64 indices",
                                  "int64 indptr"])
def test_takes_refuses_what_check_refuses(case):
    """One rule decides both which products ``prod.spmv`` sends to K7
    (``takes``) and what the kernel raises on (``_check``): a storage or
    type that one refuses, the other refuses too."""
    mat, x = small()
    if case == "csc":
        mat = CsMat(mat.indptr, mat.indices, mat.data, mat.shape, "csc")
    elif case == "complex64":
        mat, x = mat.with_data(mat.data.to(torch.complex64)), x.to(torch.complex64)
    elif case == "int32 values":
        mat, x = mat.with_data(mat.data.to(torch.int32)), x.to(torch.int32)
    elif case == "int64 indices":
        mat = CsMat(mat.indptr, mat.indices.to(torch.int64), mat.data, mat.shape, "csr")
    else:
        mat = CsMat(mat.indptr.to(torch.int64), mat.indices, mat.data, mat.shape, "csr")
    err = k7._refusal(mat, x)
    assert err is not None
    with pytest.raises(type(err)):
        k7._check(mat, x)
    meta = CsMat(*(t.to("meta") for t in (mat.indptr, mat.indices, mat.data)), mat.shape,
                 mat.storage)
    assert not k7.takes(mat, x) and not k7.takes(meta, x.to("meta"))


def test_plain_product_is_shared_from_formats_util():
    """The plain product and its contributions live in ``formats/util.py``;
    the K7 wrapper and ``ops/prod.py`` use that one function, whose call
    count is the one every caller reads."""
    from sprs_tpu_torch.formats import util

    assert k7.csr_spmv_plain is util.csr_spmv_plain is prod.csr_spmv_plain
    assert prod.contributions is util.contributions
    mat, x = small()
    calls = util.csr_spmv_plain.calls
    y = prod.spmm(mat, torch.stack([x, 2 * x], 1))
    assert util.csr_spmv_plain.calls == calls
    torch.testing.assert_close(y[:, 1], 2 * csr_spmv_plain(mat, x))


# ---------------------------------------------------------------------------
# the kernel's algorithm, emulated
# ---------------------------------------------------------------------------


def warp_split(indptr, rows, nnz, d):
    """csr_spmv.cu::warp_split: 32 pivots a round over [lo, hi)."""
    lo, hi = max(d - nnz, 0), min(d, rows)
    rounds = 0
    while lo < hi:
        p = [lo + ((hi - lo) * lane) // 32 for lane in range(32)]
        before_ = [int(indptr[q + 1]) <= d - q - 1 for q in p]
        k = sum(before_)
        assert before_ == [True] * k + [False] * (32 - k)  # a prefix
        if k > 0:
            lo = p[k - 1] + 1
        if k < 32:
            hi = p[k]
        rounds += 1
    return lo, rounds


def join(a_row, a, b_row, b):
    return a + b if a_row == b_row else b


def emulate(indptr, indices, data, x, rows, cols, cap, threads, items):
    """csr_spmv.cu's two kernels step for step in numpy; returns y and
    how many times each row was written."""
    tile = threads * items
    warps = threads // 32
    n_tiles = -(-(rows + cap) // tile)
    nnz = min(max(int(indptr[rows]), 0), cap)
    total = rows + nnz
    y = np.full(rows, np.nan)
    writes = np.zeros(rows, np.int64)
    carry, head, carry_row = np.zeros(n_tiles), np.zeros(n_tiles), np.full(n_tiles, -7)

    def write(r, v):
        y[r] = v
        writes[r] += 1

    for b in range(n_tiles):
        d0 = b * tile
        if d0 >= total:
            continue
        d1 = min(d0 + tile, total)
        (x0, _), (x1, _) = warp_split(indptr, rows, nnz, d0), warp_split(indptr, rows, nnz, d1)
        y0, y1 = d0 - x0, d1 - x1
        n_ends, n_nz, length = x1 - x0, y1 - y0, d1 - d0
        assert 0 <= n_ends <= tile and 0 <= n_nz <= tile
        continued = y0 > indptr[x0]
        s_end = indptr[x0 + 1: x0 + 1 + n_ends]
        c = np.clip(indices[y0:y1], 0, cols - 1)
        s_prod = data[y0:y1] * x[c]
        lx_t, run_t, first_t, first_row_t = [], [], [], []
        for t in range(threads):
            a = min(t * items, length)
            e = min(a + items, length)
            lo, hi = max(a - n_nz, 0), min(a, n_ends)
            while lo < hi:
                p = (lo + hi) >> 1
                if s_end[p] <= y0 + a - p - 1:
                    lo = p + 1
                else:
                    hi = p
            lx, ly, run, first, first_row = lo, a - lo, 0.0, 0.0, -1
            for _ in range(a, e):
                if ly < n_nz and (lx >= n_ends or y0 + ly < s_end[lx]):
                    run += s_prod[ly]
                    ly += 1
                else:
                    if first_row < 0:
                        first_row, first = lx, run
                    elif x0 + lx < rows:
                        write(x0 + lx, run)
                    run = 0.0
                    lx += 1
            lx_t.append(lx)
            run_t.append(run)
            first_t.append(first)
            first_row_t.append(first_row)
        # segmented scan: Hillis-Steele in each warp, then the warps' totals
        inc = list(run_t)
        for w in range(warps):
            lanes = range(w * 32, w * 32 + 32)
            off = 1
            while off < 32:
                prev = {t: (lx_t[t - off], inc[t - off]) for t in lanes if t - w * 32 >= off}
                for t, (r, s) in prev.items():
                    inc[t] = join(r, s, lx_t[t], inc[t])
                off <<= 1
        wrow = [lx_t[w * 32 + 31] for w in range(warps)]
        wsum = [inc[w * 32 + 31] for w in range(warps)]
        for t in range(threads):
            w, lane = divmod(t, 32)
            pre_row, pre = -1, 0.0
            for v in range(w):
                pre = join(pre_row, pre, wrow[v], wsum[v]) if v > 0 else wsum[v]
                pre_row = wrow[v]
            in_row, inn = pre_row, pre
            if lane > 0:
                ex_row, ex = lx_t[t - 1], inc[t - 1]
                inn = join(pre_row, pre, ex_row, ex) if w > 0 else ex
                in_row = ex_row
            if first_row_t[t] >= 0:
                fr = first_row_t[t]
                v = inn + first_t[t] if (t > 0 and in_row == fr) else first_t[t]
                if fr == 0 and continued:
                    head[b] = v
                elif x0 + fr < rows:
                    write(x0 + fr, v)
            if t == threads - 1:
                carry[b] = join(pre_row, pre, lx_t[t], inc[t]) if w > 0 else inc[t]
                carry_row[b] = x1 if (x1 < rows and y1 > indptr[x1]) else -1
    live = -(-total // tile)
    for t in range(live):
        r = carry_row[t]
        if r < 0 or (t > 0 and carry_row[t - 1] == r):
            continue
        total_sum, base = 0.0, t
        while True:
            inn = [base + lane < live and carry_row[base + lane] == r for lane in range(32)]
            total_sum += sum(carry[base + lane] for lane in range(32) if inn[lane])
            if not all(inn):
                base += sum(inn)
                break
            base += 32
        assert base < live
        write(r, total_sum + head[base])
    return y, writes


EMULATED = [
    # (rows, cols, seed, hub, pad, threads, items)
    (400, 300, 20, 900, 0, 64, 3),
    (400, 300, 21, 900, 37, 64, 3),  # cap > nnz
    (250, 64, 22, 40, 0, 32, 5),  # one warp a tile
    (1500, 2000, 23, 4 * TILE, 5, 256, 7),  # the kernel's own tile; a hub over four tiles
]


@pytest.mark.parametrize("case", EMULATED, ids=lambda c: f"{c[0]}x{c[1]}-t{c[5]}x{c[6]}-pad{c[4]}")
def test_emulated_kernel_writes_every_row_once(case):
    """The merge path, the walks, the scan and the carries on integer
    values: every row written exactly once and equal to the product;
    the warp search's pivots always a prefix (asserted inside)."""
    rows, cols, seed, hub, pad, threads, items = case
    lengths = lengths_power_law(rows, seed, hub=hub, tile=threads * items)
    indptr, indices, data = csr_arrays(lengths, cols, seed, pad=pad, integer=True)
    x = np.random.default_rng(seed + 2).integers(-3, 4, cols).astype(np.float64)
    y, writes = emulate(indptr, indices, data, x, rows, cols, indices.size, threads, items)
    assert np.all(writes == 1)
    mat = csmat_of((indptr, indices, data), (rows, cols))
    np.testing.assert_array_equal(y, csr_spmv_plain(mat, torch.from_numpy(x)).numpy())


def test_emulated_kernel_on_empty_and_edge_patterns():
    """No entries; every row empty but one; one row only; all in one row."""
    for lengths, cols in (([0] * 50, 7), ([0] * 30 + [500] + [0] * 30, 600), ([700], 800),
                          ([3] * 64, 10)):
        lengths = np.array(lengths)
        indptr, indices, data = csr_arrays(lengths, cols, 30, pad=3, integer=True)
        x = np.random.default_rng(31).integers(-3, 4, cols).astype(np.float64)
        y, writes = emulate(indptr, indices, data, x, len(lengths), cols, indices.size, 64, 3)
        assert np.all(writes == 1)
        mat = csmat_of((indptr, indices, data), (len(lengths), cols))
        np.testing.assert_array_equal(y, csr_spmv_plain(mat, torch.from_numpy(x)).numpy())


def test_warp_split_rounds_at_kron23_scale():
    """The 32-way search needs about log32(rows) rounds: at most 6 over
    8.4M rows, where a binary search takes 23."""
    rows = 8_388_608
    indptr = np.concatenate([[0], np.cumsum(np.full(rows, 31, np.int64))])
    nnz = int(indptr[-1])
    worst = 0
    for d in np.random.default_rng(40).integers(0, rows + nnz, 50):
        split, rounds = warp_split(indptr, rows, nnz, int(d))
        assert indptr[split] <= d - split and (split == rows or indptr[split + 1] > d - split - 1)
        worst = max(worst, rounds)
    assert worst <= 6


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

# unit roundoff of each type, and of the accumulator each form sums in
UNIT = {torch.float16: 2.0**-11, torch.bfloat16: 2.0**-8, torch.float32: 2.0**-24,
        torch.float64: 2.0**-53}
# half the spacing of float16's subnormals: the absolute error of a
# rounding to float16 below its least normal value, 2^-14
F16_SUBNORMAL = 2.0**-25


def card_operands(seed=50, pad=113):
    """A power-law CSR on the card: a hub row over about 30 tiles, empty
    rows leading, trailing and inside, one row ending a tile's last item
    and one whose end item opens a tile, and ``pad`` padding slots."""
    rows, cols = 6000, 65536
    lengths = lengths_power_law(rows, seed, hub=30 * TILE - 5)
    arrays = csr_arrays(lengths, cols, seed, pad=pad)
    x = np.random.default_rng(seed + 3).standard_normal(cols)
    return arrays, (rows, cols), x


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def bound_per_row(mat, x, out):
    """|y - y_exact| bounds of a form before its rounding to the output:
    (length + 1) roundings of the accumulator over the row's sum of
    |terms|, and for (f16, f16) each product's rounding to float16,
    relative above 2^-14 and absolute (F16_SUBNORMAL) below."""
    dd, xd = mat.data.dtype, x.dtype
    acc = torch.promote_types(out, torch.float32)
    absmat = mat.with_data(mat.data.abs().double())
    mag = csr_spmv_plain(absmat, x.abs().double())
    lengths = (mat.indptr[1:] - mat.indptr[:-1]).double()
    bound = (lengths + 1) * UNIT[acc] * mag
    if dd == xd == torch.float16:
        bound = bound + UNIT[torch.float16] * mag + lengths * F16_SUBNORMAL
    return 1.01 * bound


@pytest.mark.gpu
@pytest.mark.parametrize("form", sorted(FORMS.items(), key=lambda kv: kv[1]), ids=lambda kv: kv[1])
def test_kernel_matches_plain_on_card(form):
    """K7 in every form against the plain version over float64 copies of
    the same operands.  Tolerance per row and form (``bound_per_row``):
    the kernel sums in promote(out, float32) in another order than the
    plain version, rounds (f16, f16) products to float16 and rounds once
    to the output (half a step of a 16-bit output; half float16's
    subnormal spacing below 2^-14)."""
    need_card()
    (dd, xd), suffix = form
    arrays, shape, xn = card_operands()
    mat = csmat_of(arrays, shape, device="cuda", dtype=dd)
    x = torch.from_numpy(xn).to("cuda", xd)
    out = torch.promote_types(dd, xd)
    before_all = csr_spmv_kernel.launches
    before_form = getattr(csr_spmv_kernel, f"launches_{suffix}")
    y = csr_spmv_kernel(mat, x)
    torch.cuda.synchronize()
    assert y.dtype == out and y.shape == (shape[0],)
    assert csr_spmv_kernel.launches == before_all + 1
    assert getattr(csr_spmv_kernel, f"launches_{suffix}") == before_form + 1
    ref = csr_spmv_plain(mat.astype(torch.float64), x.double())
    limit = bound_per_row(mat, x, out)
    if out.itemsize < 4:  # one rounding to the output
        limit = limit + UNIT[out] * (ref.abs() + limit) + F16_SUBNORMAL * (out == torch.float16)
    err = (y.double() - ref).abs()
    assert bool(torch.all(err <= limit)), float((err - limit).max())
    # empty rows are exact zeros, whatever the neighbours
    empty = (mat.indptr[1:] == mat.indptr[:-1])
    assert bool(torch.all(y[empty] == 0))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.bfloat16])
def test_two_runs_are_bit_equal_on_card(dtype):
    need_card()
    arrays, shape, xn = card_operands(seed=51)
    mat = csmat_of(arrays, shape, device="cuda", dtype=dtype)
    x = torch.from_numpy(xn).to("cuda", dtype)
    bits = {8: torch.int64, 4: torch.int32, 2: torch.int16}[dtype.itemsize]
    first = csr_spmv_kernel(mat, x).view(bits)
    for _ in range(3):
        assert torch.equal(csr_spmv_kernel(mat, x).view(bits), first)


@pytest.mark.gpu
def test_prod_spmv_routes_card_csr_products_to_k7():
    """``prod.spmv`` and ``@`` on a CUDA CSR matrix launch K7 and call no
    plain version; ``prepare_spmv`` hands back the matrix itself."""
    need_card()
    arrays, shape, xn = card_operands(seed=52)
    mat = csmat_of(arrays, shape, device="cuda", dtype=torch.float32)
    x = torch.from_numpy(xn).to("cuda", torch.float32)
    fn, prepared = prod.prepare_spmv(mat)
    assert fn is prod.spmv and prepared is mat
    launches, calls = csr_spmv_kernel.launches, csr_spmv_plain.calls
    strided = torch.stack([x, x], 1)[:, 0]  # every other value of a buffer
    ys = [fn(prepared, x), mat @ x, prod.spmv(mat, strided)]
    assert csr_spmv_kernel.launches == launches + 3 and csr_spmv_plain.calls == calls
    for y in ys[1:]:
        assert torch.equal(y, ys[0])


@pytest.mark.gpu
@pytest.mark.parametrize("form", sorted(FORMS.items(), key=lambda kv: kv[1]), ids=lambda kv: kv[1])
def test_prod_spmv_sends_every_form_to_k7_on_card(form):
    """Every form of ``FORMS`` with int32 indices takes K7 through
    ``prod.spmv`` on the card, one launch of its form and no call of the
    plain version: no type the main path uses can drift onto it unseen."""
    need_card()
    (dd, xd), suffix = form
    arrays, shape, xn = card_operands(seed=56)
    mat = csmat_of(arrays, shape, device="cuda", dtype=dd)
    x = torch.from_numpy(xn).to("cuda", xd)
    launches, calls = getattr(csr_spmv_kernel, f"launches_{suffix}"), csr_spmv_plain.calls
    y = prod.spmv(mat, x)
    assert getattr(csr_spmv_kernel, f"launches_{suffix}") == launches + 1
    assert csr_spmv_plain.calls == calls
    assert torch.equal(y, csr_spmv_kernel(mat, x))


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["complex64", "int64 indices"])
def test_prod_spmv_sends_types_k7_lacks_to_plain_on_card(case):
    """The fixed dispatch by type: a card CSR product in a type K7 lacks
    runs the plain version (one call, no launch), against float64 within
    the plain version's own rounding."""
    need_card()
    arrays, shape, xn = card_operands(seed=57)
    base = csmat_of(arrays, shape, device="cuda", dtype=torch.float32)
    x = torch.from_numpy(xn).to("cuda", torch.float32)
    mat, xm = base, x
    if case == "complex64":
        mat, xm = base.with_data(base.data.to(torch.complex64)), x.to(torch.complex64)
    else:
        mat = CsMat(base.indptr, base.indices.to(torch.int64), base.data, base.shape, "csr")
    launches, calls = csr_spmv_kernel.launches, csr_spmv_plain.calls
    y = prod.spmv(mat, xm)
    assert csr_spmv_kernel.launches == launches and csr_spmv_plain.calls == calls + 1
    assert y.dtype == xm.dtype
    ref = csr_spmv_plain(base.astype(torch.float64), x.double())
    limit = bound_per_row(base, x, torch.float32)
    assert bool(torch.all((y.real.double() - ref).abs() <= limit))


@pytest.mark.gpu
def test_prod_spmv_takes_strided_operands_on_card():
    """A CSR matrix whose indptr, indices and data are strided views takes
    K7 through ``prod.spmv`` (the operands made contiguous first), with
    the bits of the same product on contiguous operands."""
    need_card()
    arrays, shape, xn = card_operands(seed=58)
    mat = csmat_of(arrays, shape, device="cuda", dtype=torch.float32)
    x = torch.from_numpy(xn).to("cuda", torch.float32)
    every_other = [torch.stack([t, t], 1)[:, 0] for t in (mat.indptr, mat.indices, mat.data)]
    strided = CsMat(*every_other, mat.shape, "csr")
    assert not any(t.is_contiguous() for t in every_other)
    launches, calls = csr_spmv_kernel.launches, csr_spmv_plain.calls
    y = prod.spmv(strided, x)
    assert csr_spmv_kernel.launches == launches + 1 and csr_spmv_plain.calls == calls
    assert torch.equal(y, csr_spmv_kernel(mat, x))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_gradients_match_plain_on_card(dtype):
    """The autograd path (forward K7, backward ``csr_vjp``) against torch's
    autograd through the plain version, in data and in x."""
    need_card()
    arrays, shape, xn = card_operands(seed=53)
    mat = csmat_of(arrays, shape, device="cuda", dtype=dtype)
    g = torch.from_numpy(np.random.default_rng(54).standard_normal(shape[0])).to("cuda", dtype)
    grads = []
    for fn in (csr_spmv_kernel, csr_spmv_plain):
        data = mat.data.clone().requires_grad_(True)
        x = torch.from_numpy(xn).to("cuda", dtype).requires_grad_(True)
        launches = csr_spmv_kernel.launches
        y = fn(mat.with_data(data), x)
        assert csr_spmv_kernel.launches == launches + (fn is csr_spmv_kernel)
        y.backward(g)
        grads.append((y.detach(), data.grad, x.grad))
    tol = {"rtol": 1e-12, "atol": 1e-10} if dtype == torch.float64 else {"rtol": 1e-5, "atol": 1e-3}
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, **tol)


@pytest.mark.gpu
def test_direct_launch_reads_nothing_back():
    """Under ``set_sync_debug_mode("error")`` a direct launch (no
    gradient) raises nothing: it reads no device value back."""
    need_card()
    arrays, shape, xn = card_operands(seed=55)
    mat = csmat_of(arrays, shape, device="cuda", dtype=torch.float32)
    x = torch.from_numpy(xn).to("cuda", torch.float32)
    want = csr_spmv_kernel(mat, x)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = [csr_spmv_kernel(mat, x) for _ in range(3)] + [prod.spmv(mat, x)]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    for y in got:
        assert torch.equal(y, want)
