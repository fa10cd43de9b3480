"""K5 on a renumbered operand: the rule and the Cuthill–McKee ordering of
``ops/renumber.py``, the renumbered ELL layout (``EllMat.order``), its
plain products and gradients, and, on the card, K5's gather pass and
scattering store.

A renumbered operand computes the same arithmetic as the operator as
given (each row keeps its slots in their order, each slot reads the same
entry of x), so products are compared bit for bit, not within a
tolerance.  This file imports no JAX: run its card tests with
``python -m pytest --noconftest tests/test_torch_ell_renumber.py -q -m gpu``.
"""

import numpy as np
import pytest
import torch

from sprs_tpu_torch.errors import ShapeError
from sprs_tpu_torch.formats.csmat import CsMat, from_dense
from sprs_tpu_torch.formats.ell import (
    EllMat,
    ell_from_csmat,
    ell_in_caller_order,
    ell_spmm,
    ell_spmv,
    ell_to_csmat,
)
from sprs_tpu_torch.formats.triplet import coo_to_csmat
from sprs_tpu_torch.linalg import cg
from sprs_tpu_torch.ops import renumber
from sprs_tpu_torch.ops.cuda import ell_spmv as k5
from sprs_tpu_torch.ops.cuda import launch
from sprs_tpu_torch.ops.cuda.ell_spmv import ell_spmv_kernel, ell_spmv_plain
from sprs_tpu_torch.ops.cuda.forms import FORMS
from sprs_tpu_torch.ops.prod import prepare_spmv
from sprs_tpu_torch.utils.special import grid_laplacian, tri_mesh_graph_laplacian

H100_L2 = 50 * 2**20  # torch.cuda.get_device_properties(...).L2_cache_size on the card


def stencil27(nx, ny, nz, seed=None, dtype=torch.float64, device="cpu"):
    """HPCG's 27-point operator (26 on the diagonal, -1 per in-grid
    neighbour) as CSR, its unknowns numbered in a random order drawn from
    ``seed``, or in grid order where ``seed`` is None."""
    n = nx * ny * nz
    idx = torch.arange(n)
    ix, iy, iz = idx % nx, (idx // nx) % ny, idx // (nx * ny)
    rows, cols, vals = [], [], []
    for dz in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                ok = ((ix + dx >= 0) & (ix + dx < nx) & (iy + dy >= 0) & (iy + dy < ny)
                      & (iz + dz >= 0) & (iz + dz < nz))
                rows.append(idx[ok])
                cols.append(idx[ok] + dz * nx * ny + dy * nx + dx)
                vals.append(torch.full((int(ok.sum()),), 26.0 if dx == dy == dz == 0 else -1.0))
    rows, cols, vals = torch.cat(rows), torch.cat(cols), torch.cat(vals)
    if seed is not None:
        perm = torch.randperm(n, generator=torch.Generator().manual_seed(seed))
        rows, cols = perm[rows], perm[cols]
    return coo_to_csmat(rows.to(torch.int32), cols.to(torch.int32), vals.to(dtype), (n, n),
                        device=device)


def is_permutation(order, n):
    return torch.equal(torch.sort(order.long().cpu()).values, torch.arange(n))


def renumbered_pair(csr):
    """(plain EllMat, the same operand renumbered by its ordering)."""
    order = renumber.cuthill_mckee_levels(csr).to(torch.int32)
    return ell_from_csmat(csr), ell_from_csmat(csr, order=order)


def x_of(n, seed, dtype=torch.float64, device="cpu"):
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal(n))
    return x.to(device=device, dtype=dtype)


def test_ordering_is_a_deterministic_permutation_that_cuts_the_gather():
    """On a randomly numbered 16³ 27-point stencil the ordering is a
    permutation, comes out the same twice, cuts the mean gather distance
    at least MIN_CUT times, and the rule keeps it where x outgrows the
    L2 given."""
    csr = stencil27(16, 16, 16, seed=1)
    order = renumber.cuthill_mckee_levels(csr)
    assert is_permutation(order, csr.rows)
    assert torch.equal(order, renumber.cuthill_mckee_levels(csr))
    before = renumber.mean_gather(csr)
    after = renumber.mean_gather(csr, renumber.inverse(order))
    assert before >= renumber.MIN_CUT * after
    kept = renumber.locality_order(csr, l2=4096)
    assert kept.dtype == torch.int32 and torch.equal(kept.long(), order)


def test_ordering_starts_at_the_least_degree_vertex_with_the_lowest_id():
    csr = stencil27(4, 4, 4, seed=2)
    deg = (csr.indptr[1:] - csr.indptr[:-1]).long()
    order = renumber.cuthill_mckee_levels(csr)
    corners = torch.nonzero(deg == deg.min()).reshape(-1)
    assert int(order[0]) == int(corners.min())
    assert int(deg.min()) == 8  # a corner of the grid


def mesh_step(side, seed=0):
    """chip_smoke.py's mesh step I + L, L the graph Laplacian of a side²
    triangulated grid with its vertices randomly labelled."""
    ii, jj = np.meshgrid(np.arange(side - 1), np.arange(side - 1), indexing="ij")
    v = (ii * side + jj).ravel()
    tri = np.concatenate([np.stack([v, v + 1, v + side], 1),
                          np.stack([v + 1, v + side + 1, v + side], 1)])
    perm = np.random.default_rng(seed).permutation(side * side)
    lap = tri_mesh_graph_laplacian(side * side, perm[tri], device="cpu")
    n = side * side
    diag = torch.arange(n, dtype=torch.int32)
    lap_coo = lap.to_csr()
    rows = torch.repeat_interleave(torch.arange(n), (lap_coo.indptr[1:] - lap_coo.indptr[:-1]).long())
    nnz = lap_coo.nnz
    return coo_to_csmat(torch.cat([rows.to(torch.int32), diag]),
                        torch.cat([lap_coo.indices[:nnz], diag]),
                        torch.cat([lap_coo.data[:nnz], torch.ones(n, dtype=lap.dtype)]), (n, n),
                        device="cpu")


def refuse(name):
    def refused(*args):
        raise AssertionError(f"{name} called")
    return refused


@pytest.mark.parametrize("case", ["natural stencil", "mesh step", "rectangular", "x within the L2"])
def test_rule_leaves_alone(case, monkeypatch):
    """No ordering where it cannot help or is not needed: a stencil in its
    grid order gathers near (its mean distance is measured, no ordering
    computed); chip_smoke.py's 1024² mesh step and any x within the L2
    never pay for a measurement; a rectangular matrix has no
    renumbering."""
    monkeypatch.setattr(renumber, "cuthill_mckee_levels", refuse("cuthill_mckee_levels"))
    if case == "natural stencil":
        csr, l2 = stencil27(16, 16, 16), 4096
        assert 2 * renumber.mean_gather(csr) * 8 <= l2
        assert renumber.locality_order(csr, l2) is None
        return
    monkeypatch.setattr(renumber, "mean_gather", refuse("mean_gather"))
    if case == "mesh step":
        csr, l2 = mesh_step(1024), H100_L2
        assert csr.rows * 8 <= l2
    elif case == "rectangular":
        dense = np.random.default_rng(3).standard_normal((300, 200))
        dense[np.random.default_rng(4).random((300, 200)) > 0.05] = 0.0
        csr, l2 = from_dense(dense, device="cpu"), 64
    else:
        csr, l2 = stencil27(16, 16, 16, seed=5), 4096 * 8
    assert renumber.locality_order(csr, l2) is None
    assert renumber.locality_order(csr, None) is None


def test_rule_drops_an_ordering_that_does_not_help():
    """A random graph of eight slots a row (chip_smoke.py's random8 at a
    small size) has a small diameter: the ordering is computed, cuts the
    distance less than MIN_CUT times, and is dropped."""
    n, slots = 4096, 8
    rng = np.random.default_rng(6)
    rows = torch.from_numpy(np.repeat(np.arange(n), slots).astype(np.int32))
    cols = torch.from_numpy(rng.integers(0, n, n * slots).astype(np.int32))
    csr = coo_to_csmat(rows, cols, torch.ones(n * slots, dtype=torch.float32), (n, n),
                       device="cpu")
    assert renumber.locality_order(csr, l2=1024) is None
    before = renumber.mean_gather(csr)
    after = renumber.mean_gather(csr, renumber.inverse(renumber.cuthill_mckee_levels(csr)))
    assert 2 * before * 4 > 1024 and after * renumber.MIN_CUT > before


def awkward_operator():
    """Two randomly numbered stencils side by side, isolated vertices (a
    diagonal entry alone), empty rows and explicit zeros, all under one
    random numbering: 2 × 60 + 7 + 5 = 132 rows, padded to 136."""
    a, b = stencil27(3, 4, 5, seed=7), stencil27(5, 4, 3, seed=8)
    n = a.rows + b.rows + 12
    parts = []
    for m, shift in ((a, 0), (b, a.rows)):
        r = torch.repeat_interleave(torch.arange(m.rows), (m.indptr[1:] - m.indptr[:-1]).long())
        parts.append((r + shift, m.indices[: m.nnz].long() + shift, m.data[: m.nnz]))
    iso = torch.arange(a.rows + b.rows, a.rows + b.rows + 7)
    parts.append((iso, iso, torch.full((7,), 2.0, dtype=torch.float64)))
    rows, cols, vals = (torch.cat(t) for t in zip(*parts))
    vals = torch.where(torch.arange(vals.shape[0]) % 9 == 4, 0.0, vals)  # explicit zeros
    perm = torch.randperm(n, generator=torch.Generator().manual_seed(9))
    return coo_to_csmat(perm[rows].to(torch.int32), perm[cols].to(torch.int32), vals, (n, n),
                        device="cpu")


@pytest.mark.parametrize("max_levels", [renumber.MAX_LEVELS, 5])
def test_ordering_handles_parts_isolated_and_empty_rows_and_zeros(max_levels, monkeypatch):
    """Disconnected parts restart at the least-degree vertex left;
    isolated vertices and empty rows, which nothing reaches, start no
    part and follow at the end in their original order; explicit zeros
    count as structure; pad rows and pad slots stay pads.  The product
    stays bit-equal, also when the level bound cuts the ordering short."""
    monkeypatch.setattr(renumber, "MAX_LEVELS", max_levels)
    csr = awkward_operator()
    plain, ren = renumbered_pair(csr)
    order = ren.order.long()
    assert is_permutation(order, csr.rows) and plain.rows_pad == ren.rows_pad > csr.rows
    deg = (csr.indptr[1:] - csr.indptr[:-1]).long()
    lone = torch.tensor([bool((csr.indices[int(csr.indptr[r]) : int(csr.indptr[r + 1])] == r).all())
                         for r in range(csr.rows)])
    assert int(lone.sum()) == 12
    starts = torch.nonzero(~lone & (deg == deg[~lone].min())).reshape(-1)
    assert int(order[0]) == int(starts.min())
    assert torch.equal(order[lone[order]], torch.nonzero(lone).reshape(-1))
    if max_levels >= csr.rows:  # room for every level
        assert bool(lone[order[-12:]].all())
    assert torch.equal(ren.indices[csr.rows :], plain.indices[csr.rows :])
    assert torch.equal(ren.data[csr.rows :], plain.data[csr.rows :])
    x = x_of(csr.rows, 10)
    assert torch.equal(ell_spmv_plain(ren, x), ell_spmv_plain(plain, x))
    np.testing.assert_allclose(ell_spmv(ren, x).numpy(), csr.to_dense().numpy() @ x.numpy(),
                               rtol=1e-13, atol=1e-13)


def test_path_graph_past_the_level_bound(monkeypatch):
    """A path of 50 vertices from an end takes 50 levels; under a bound of
    10 the first 10 follow the path and the other 40 keep their original
    order.  Still a permutation, and the product is still right."""
    n = 50
    labels = torch.randperm(n, generator=torch.Generator().manual_seed(11))
    a, b = labels[:-1], labels[1:]
    rows = torch.cat([a, b, labels]).to(torch.int32)
    cols = torch.cat([b, a, labels]).to(torch.int32)
    vals = torch.cat([-torch.ones(2 * (n - 1)), 2 * torch.ones(n)]).to(torch.float64)
    csr = coo_to_csmat(rows, cols, vals, (n, n), device="cpu")
    monkeypatch.setattr(renumber, "MAX_LEVELS", 10)
    order = renumber.cuthill_mckee_levels(csr)
    assert is_permutation(order, n)
    ends = sorted([int(labels[0]), int(labels[-1])])
    walk = labels if int(order[0]) == int(labels[0]) else labels.flip(0)
    assert int(order[0]) == ends[0]
    assert torch.equal(order[:10], walk[:10])
    rest = order[10:]
    assert torch.equal(rest, torch.sort(rest).values)
    ren = ell_from_csmat(csr, order=order.to(torch.int32))
    x = x_of(n, 12)
    assert torch.equal(ell_spmv_kernel(ren, x), ell_spmv_kernel(ell_from_csmat(csr), x))


def relabelled(csr, seed):
    """``csr`` with its unknowns numbered in a random order drawn from
    ``seed``."""
    n = csr.rows
    rows = torch.repeat_interleave(torch.arange(n), (csr.indptr[1:] - csr.indptr[:-1]).long())
    perm = torch.randperm(n, generator=torch.Generator().manual_seed(seed))
    return coo_to_csmat(perm[rows].to(torch.int32), perm[csr.indices[: csr.nnz].long()].to(torch.int32),
                        csr.data[: csr.nnz], (n, n), device="cpu")


def test_identity_border_rows_cost_no_level():
    """The heat example's operator (``grid_laplacian``: identity rows on
    the border) at 1026², randomly numbered, has more identity rows than
    the ordering has levels.  They start no part, so the levels go to the
    interior, and the rule keeps an ordering that cuts the mean gather
    distance MIN_CUT times."""
    side = 1026
    csr = relabelled(grid_laplacian((side, side), device="cpu"), 35)
    assert 4 * (side - 1) > renumber.MAX_LEVELS
    order = renumber.locality_order(csr, l2=1 << 16)
    assert order is not None and is_permutation(order, csr.rows)
    before = renumber.mean_gather(csr)
    assert before >= renumber.MIN_CUT * renumber.mean_gather(csr, renumber.inverse(order))


@pytest.mark.parametrize("form", sorted(FORMS, key=str), ids=lambda f: FORMS[f])
def test_renumbered_plain_product_is_bit_equal_in_every_form(form):
    """The plain twin (and the wrapper on CPU tensors) on the renumbered
    operand equals, bit for bit, its product on the operand as given, in
    each (data, x) form; pad rows included (315 rows padded to 320)."""
    data_t, x_t = form
    csr = stencil27(5, 7, 9, seed=13, dtype=data_t)
    plain, ren = renumbered_pair(csr)
    assert ren.rows_pad == 320 > ren.rows
    x = x_of(csr.rows, 14, x_t)
    want = ell_spmv_plain(plain, x)
    assert torch.equal(ell_spmv_plain(ren, x), want)
    assert torch.equal(ell_spmv_kernel(ren, x), want)


def test_nonfinite_x0_reaches_the_same_rows_through_pad_slots():
    """A renumbered row's pad slots read inv[0], that is x[0] as before:
    a NaN there reaches the same rows, and the rest stay bit-equal."""
    csr = stencil27(4, 5, 6, seed=15)
    plain, ren = renumbered_pair(csr)
    ell = EllMat(plain.indices, plain.data, plain.shape)
    assert bool((ell.data[: ell.rows] == 0).any())  # rows with pad slots
    x = x_of(csr.rows, 16)
    x[0] = float("nan")
    torch.testing.assert_close(ell_spmv_plain(ren, x), ell_spmv_plain(plain, x), rtol=0, atol=0,
                               equal_nan=True)


def test_layout_round_trips_and_every_format_function_takes_the_callers_order():
    """Put back in the caller's order the renumbered operand is the plain
    one, array for array; ``to_dense``, ``ell_to_csmat`` and ``ell_spmm``
    answer as for the plain operand."""
    csr = stencil27(4, 4, 5, seed=17)
    plain, ren = renumbered_pair(csr)
    back = ell_in_caller_order(ren)
    assert back.order is None
    assert torch.equal(back.indices, plain.indices) and torch.equal(back.data, plain.data)
    assert torch.equal(ren.to_dense(), plain.to_dense())
    a, b = ell_to_csmat(ren), ell_to_csmat(plain)
    assert all(torch.equal(getattr(a, f), getattr(b, f)) for f in ("indptr", "indices", "data"))
    xs = torch.from_numpy(np.random.default_rng(18).standard_normal((csr.rows, 3)))
    assert torch.equal(ell_spmm(ren, xs), ell_spmm(plain, xs))
    assert ren.renumbered and not plain.renumbered


def test_gradients_through_a_renumbered_operand_match_autograd_of_the_plain_product():
    """The Function's backward on a renumbered operand (ddata in the
    stored layout, dx in the caller's order) against torch's autograd of
    the plain product on the same operand; dx also against the operand
    as given."""
    csr = stencil27(4, 5, 6, seed=19)
    plain, ren = renumbered_pair(csr)
    g = x_of(csr.rows, 20)
    grads = []
    for fn, ell in ((ell_spmv_kernel, ren), (ell_spmv_plain, ren), (ell_spmv_kernel, plain)):
        data = ell.data.clone().requires_grad_(True)
        x = x_of(csr.rows, 21).requires_grad_(True)
        y = fn(EllMat(ell.indices, data, ell.shape, ell.order), x)
        grads.append(torch.autograd.grad(y, (data, x), g))
    (dd_k, dx_k), (dd_p, dx_p), (_, dx_given) = grads
    np.testing.assert_allclose(dd_k.numpy(), dd_p.numpy(), rtol=1e-13, atol=1e-15)
    np.testing.assert_allclose(dx_k.numpy(), dx_p.numpy(), rtol=1e-13, atol=1e-13)
    np.testing.assert_allclose(dx_k.numpy(), dx_given.numpy(), rtol=1e-13, atol=1e-13)


def test_cg_on_a_renumbered_operand_gives_the_same_x_bits():
    """50 CG iterations on a randomly numbered 8³ stencil, through the
    renumbered operand and the plain one: the same x, bit for bit."""
    csr = stencil27(8, 8, 8, seed=22)
    plain, ren = renumbered_pair(csr)
    b = x_of(csr.rows, 23)
    xs = [cg(lambda v, e=e: ell_spmv_kernel(e, v), b, tol=0.0, max_iter=50).x for e in (ren, plain)]
    assert torch.equal(xs[0], xs[1])


def test_prepare_spmv_off_the_card_keeps_the_plain_operand():
    """On the CPU no L2 is read and nothing is renumbered: the ELL arm
    returns today's operand, with no gather measured."""
    _, prepared = prepare_spmv(stencil27(8, 8, 8, seed=24))
    assert isinstance(prepared, EllMat) and prepared.order is None


def test_launch_checks_refuse_a_bad_order():
    csr = stencil27(3, 3, 4, seed=25)
    plain, ren = renumbered_pair(csr)
    x = x_of(csr.rows, 26)
    k5._check(ren, x)
    for order, err in ((ren.order.long(), TypeError), (ren.order[:-1], ShapeError)):
        with pytest.raises(err):
            k5._check(EllMat(ren.indices, ren.data, ren.shape, order), x)
    wide = EllMat(plain.indices, plain.data, (csr.rows, csr.rows + 1), ren.order)
    with pytest.raises(ShapeError):
        k5._check(wide, torch.zeros(csr.rows + 1, dtype=torch.float64))
    with pytest.raises(ShapeError):
        ell_from_csmat(csr, order=ren.order[:-1])


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_a_renumbered_operand_takes_its_way_by_the_one_rule(device, monkeypatch):
    """The renumbered operand goes the way ``launch.run`` says, the order
    travelling with it: the plain twin on the CPU, the direct launch on
    the card (``meta`` here)."""
    csr = stencil27(3, 3, 4, seed=27)
    _, ren = renumbered_pair(csr)
    ren = EllMat(ren.indices.to(device), ren.data.to(device), ren.shape, ren.order.to(device))
    taken = []
    monkeypatch.setattr(k5, "ell_spmv_plain", lambda ell, x: taken.append(("plain", ell)))
    monkeypatch.setattr(k5, "_launch", lambda ell, x: taken.append(("direct", ell)))
    ell_spmv_kernel(ren, torch.zeros(csr.rows, dtype=torch.float64, device=device))
    assert [(way, ell.order is ren.order) for way, ell in taken] == [
        ("plain" if device == "cpu" else "direct", True)]


def test_the_renumbered_counter_is_zeroed_with_the_others():
    launch.zero(ell_spmv_kernel)
    assert ell_spmv_kernel.launches_renumbered == 0


def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("form", sorted(FORMS, key=str), ids=lambda f: FORMS[f])
def test_k5_on_a_renumbered_operand_is_bit_equal_on_card(form):
    """K5 with its gather pass and scattering store, on a randomly
    numbered 64³ stencil, against K5 on the operand as given: bit-equal in
    each form; one launch counted a product, the renumbered one in
    ``launches_renumbered``; no plain call."""
    dev = card()
    data_t, x_t = form
    csr = stencil27(64, 64, 64, seed=28, dtype=data_t, device=dev)
    order = renumber.cuthill_mckee_levels(csr).to(torch.int32)
    plain, ren = ell_from_csmat(csr), ell_from_csmat(csr, order=order)
    x = x_of(csr.rows, 29, x_t, dev)
    launch.zero(ell_spmv_kernel)
    calls = ell_spmv_plain.calls
    want = ell_spmv_kernel(plain, x)
    got = ell_spmv_kernel(ren, x)
    again = ell_spmv_kernel(ren, x)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(again, want)
    assert (ell_spmv_kernel.launches, ell_spmv_kernel.launches_renumbered) == (3, 2)
    assert getattr(ell_spmv_kernel, f"launches_{FORMS[form]}") == 3
    assert ell_spmv_plain.calls == calls


@pytest.mark.gpu
def test_ordering_on_card_equals_the_cpus_and_the_rule_engages():
    """The ordering computed on the card is the CPU's, entry for entry;
    with a small L2 given the rule keeps it, and K5 on the renumbered
    operand is bit-equal to K5 on the operand as given and agrees with
    the plain twin on the CPU to rounding (K5's shuffle tree sums a row
    in another order than the plain row sum)."""
    dev = card()
    csr = stencil27(32, 32, 32, seed=30)
    on_card = renumber.cuthill_mckee_levels(stencil27(32, 32, 32, seed=30, device=dev))
    assert torch.equal(on_card.cpu(), renumber.cuthill_mckee_levels(csr))
    order = renumber.locality_order(stencil27(32, 32, 32, seed=30, device=dev), l2=1 << 16)
    assert order is not None
    assert renumber.mean_gather(csr) >= renumber.MIN_CUT * renumber.mean_gather(
        csr, renumber.inverse(order.cpu()))
    ren = ell_from_csmat(stencil27(32, 32, 32, seed=30, device=dev), order=order)
    x = x_of(csr.rows, 31)
    y = ell_spmv_kernel(ren, x.to(dev))
    plain = ell_from_csmat(stencil27(32, 32, 32, seed=30, device=dev))
    assert torch.equal(y, ell_spmv_kernel(plain, x.to(dev)))
    ref = ell_spmv_plain(ell_from_csmat(csr), x)
    torch.testing.assert_close(y.cpu(), ref, rtol=0, atol=1e-12 * float(ref.abs().max()))


@pytest.mark.gpu
def test_gradients_through_a_renumbered_operand_on_card():
    dev = card()
    csr = stencil27(16, 16, 16, seed=32, device=dev)
    order = renumber.cuthill_mckee_levels(csr).to(torch.int32)
    grads = []
    for ell in (ell_from_csmat(csr, order=order), ell_from_csmat(csr)):
        data = ell.data.clone().requires_grad_(True)
        x = x_of(csr.rows, 33, device=dev).requires_grad_(True)
        y = ell_spmv_kernel(EllMat(ell.indices, data, ell.shape, ell.order), x)
        grads.append(torch.autograd.grad(y, (data, x), x_of(csr.rows, 34, device=dev)))
    (_, dx_r), (_, dx_p) = grads
    torch.testing.assert_close(dx_r, dx_p, rtol=1e-13, atol=1e-13)
