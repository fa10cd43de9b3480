"""The port's distributed layer (``sprs_tpu_torch.parallel``) against the
JAX package's ``sprs_tpu.parallel`` on the 8-device CPU mesh that
``tests/conftest.py`` provides, with the port's mesh as 8 ``"cpu"``
slots.

Exactly equal: the stacked shards (row, halo, split and 2-D layouts,
padding and the row-id sentinel included), the per-shard caps, the
``plan_b_gather`` integers, the routing kind, the stacked SpGEMM
patterns, ``block_jacobi_ldl``'s permutation and plan, and ``dist_cg``'s
iteration counts.  Within 1e-12 of the JAX result (relative to its
largest entry, f64): every product (the 2-D sum runs in another order
than XLA's ``psum``) and the SpGEMM values.  Within rtol 1e-10:
``block_jacobi_ldl``'s ``d`` and ``precond(r)``.  The JAX references are
computed once per module: ``shard_map`` compiles per call.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

import sprs_tpu as st
import sprs_tpu_torch as tt
from sprs_tpu import parallel as jp
from sprs_tpu_torch import parallel as tp
from sprs_tpu_torch.errors import ShapeError
from tests.test_torch_ldl_super import port_of

TOL = 1e-12
S = 8


def jmesh(n=S):
    return JMesh(np.array(jax.devices()[:n]), axis_names=("shards",))


def tmesh(n=S):
    return tp.Mesh(["cpu"] * n, ("shards",))


def host(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def stacked(tensors):
    return np.stack([t.numpy() for t in tensors])


def close(got, want):
    got, want = host(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * max(np.abs(want).max(), 1.0))


def random_sparse(m, n, density, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((m, n)) * (rng.random((m, n)) < density)


MATS = {
    "lap": lambda: st.utils.grid_laplacian((8, 8), dtype=np.float64),
    "rnd": lambda: st.from_dense(random_sparse(37, 37, 0.15, 0)),
    "rect": lambda: st.from_dense(random_sparse(29, 41, 0.2, 1)),
    "spd": lambda: st.utils.dirichlet_laplacian((8, 8), dtype=np.float64),
    "band": lambda: st.from_dense(np.diag(np.arange(1.0, 41.0)) + np.diag(np.ones(39), 1)
                                  + np.diag(-np.ones(39), -1)),
}
X_SEED = 11


def vec(n, k=None, seed=X_SEED):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(n if k is None else (n, k))


# The products the JAX package computes for the comparisons (each call
# compiles its own shard_map program, so the set is kept small); the
# host-side layouts and plans are compared for every matrix.
SPMV_CASES = [("rnd", "nnz"), ("rect", "rows")]
GRIDS = [(2, 4), (4, 2), (1, 8)]


@pytest.fixture(scope="module")
def ref():
    """Every JAX result the module compares against, computed once."""
    m1 = jmesh()
    out = {"mats": {k: f() for k, f in MATS.items()}}
    mats = out["mats"]
    for name in ("rnd", "rect", "lap"):
        for bal in ("rows", "nnz"):
            out[name, bal] = jp.shard_csr_rows(mats[name], S, balance=bal)
        out[name, "prep"] = jp.prepare_dist_spmv(mats[name], S)
    for name, bal in SPMV_CASES:
        dm, x = out[name, bal], vec(mats[name].shape[1])
        out[name, bal, "spmv"] = np.asarray(dm.assemble(jp.dist_spmv(dm, x, m1)))
        out[name, bal, "spmv_sharded"] = np.asarray(jp.dist_spmv(dm, x, m1, x_sharded=True))
    dm = out["rnd", "nnz"]
    out["spmm"] = np.asarray(jp.dist_spmm(dm, vec(37, 3), m1))
    out["spmm_sharded"] = np.asarray(jp.dist_spmm(dm, vec(37, 3), m1, x_sharded=True))
    for name in ("lap", "rnd"):  # the halo route (overlapped) and the all-gather route
        out[name, "prep_y"] = np.asarray(out[name, "prep"](vec(mats[name].shape[1]), m1))
    for name in ("lap", "band"):
        out[name, "halo"] = jp.shard_csr_rows_halo(mats[name], S)
        out[name, "split"] = jp.shard_csr_rows_halo_split(mats[name], S)
    out["halo_y"] = np.asarray(jp.dist_spmv_halo(out["lap", "halo"], vec(64), m1))
    # SpGEMM: A row-sharded against B replicated, all-gathered, gathered by plan
    out["spgemm"] = jp.dist_spgemm(out["rnd", "nnz"], mats["rnd"], m1)
    dl, dr = out["lap", "rows"], out["rnd", "rows"]
    out["bshard"] = jp.dist_spgemm_bshard(dl, dl, m1)
    out["plan_lap"] = jp.plan_b_gather(dl, dl)
    out["plan_rnd"] = jp.plan_b_gather(dr, dr)
    for grid in GRIDS:
        out["2d", grid] = jp.shard_csr_2d(mats["rect"], grid)
    d2, cp = out["2d", GRIDS[0]]
    mesh2 = JMesh(np.array(jax.devices()[:8]).reshape(GRIDS[0]), axis_names=("r", "c"))
    out["2d_y"] = np.asarray(jp.dist_spmv_2d(d2, cp, vec(41), mesh2))
    # block-Jacobi LDLᵀ and distributed CG
    spd = mats["spd"]
    M = jp.block_jacobi_ldl(spd, S)
    out["bj"] = M
    out["bj_r"] = np.asarray(M.precond(vec(64, seed=5)))
    ds = jp.shard_csr_rows(spd, S, balance="nnz")
    b = vec(64, seed=6)
    # "jacobi" as the callable it builds (r / diag), which skips a gather
    # of the shards that would compile one more program
    diag = np.diag(np.asarray(spd.to_dense()))
    out["cg"] = {pc: jp.dist_cg(ds, b, m1, precond=(lambda r: r / diag) if pc == "jacobi" else pc,
                                tol=1e-10, max_iter=500)
                 for pc in (None, "jacobi", "block_ldl")}
    return out


def tmat(ref, name):
    return port_of(ref["mats"][name])


def assert_rows_equal(got, want):
    for f in ("indptr", "indices", "data", "row_ids"):
        np.testing.assert_array_equal(stacked(getattr(got, f)), np.asarray(getattr(want, f)),
                                      err_msg=f)
    assert got.shape == want.shape
    assert (got.n_shards, got.rows_per_shard, got.cap_per_shard, got.padded_rows) == (
        want.n_shards, want.rows_per_shard, want.cap_per_shard, want.padded_rows)


def test_mesh():
    m = tp.Mesh(np.array(["cpu"] * 8, dtype=object).reshape(2, 4), ("r", "c"))
    assert m.shape == {"r": 2, "c": 4} and m.size == 8
    assert m.axis_devices("c", "r").shape == (4, 2)
    assert list(m.axis_devices("c")) == [torch.device("cpu")] * 4
    with pytest.raises(ShapeError):
        tp.Mesh(["cpu"] * 4, ("a", "b"))
    with pytest.raises(ShapeError):
        tp.dist_spmv(tp.shard_csr_rows(tt.eye(8, device="cpu"), 4), torch.ones(8), tmesh(8))


@pytest.mark.parametrize("name", ["rnd", "rect", "lap"])
@pytest.mark.parametrize("balance", ["rows", "nnz"])
def test_row_shards(ref, name, balance):
    pm = tmat(ref, name)
    dm = tp.shard_csr_rows(pm, S, balance=balance, device=tmesh())
    assert_rows_equal(dm, ref[name, balance])
    np.testing.assert_array_equal(dm.to_csmat().to_dense().numpy(), pm.to_dense().numpy())


@pytest.mark.parametrize("name,balance", SPMV_CASES)
def test_dist_spmv(ref, name, balance):
    pm = tmat(ref, name)
    dm = tp.shard_csr_rows(pm, S, balance=balance, device=tmesh())
    x = torch.from_numpy(vec(pm.cols))
    close(dm.assemble(tp.dist_spmv(dm, x, tmesh())), ref[name, balance, "spmv"])
    close(tp.dist_spmv(dm, x, tmesh(), x_sharded=True), ref[name, balance, "spmv_sharded"])


def test_spmm(ref):
    dm = tp.shard_csr_rows(tmat(ref, "rnd"), S, balance="nnz")
    x = vec(37, 3)
    close(tp.dist_spmm(dm, x, tmesh()), ref["spmm"])
    close(tp.dist_spmm(dm, torch.from_numpy(x), tmesh(), x_sharded=True), ref["spmm_sharded"])


@pytest.mark.parametrize("name,kind", [("lap", "halo"), ("rnd", "allgather"), ("rect", "allgather")])
def test_prepare_routes_as_jax(ref, name, kind):
    prep = tp.prepare_dist_spmv(tmat(ref, name), S)
    want = ref[name, "prep"]
    assert prep.kind == want.kind == kind and prep.n_shards == S and prep.shape == want.shape
    if kind == "allgather":
        assert_rows_equal(prep.dmat, want.dmat)
    else:
        for f in HALO_FIELDS:
            np.testing.assert_array_equal(stacked(getattr(prep.dmat, f)),
                                          np.asarray(getattr(want.dmat, f)), err_msg=f)
    if (name, "prep_y") in ref:
        close(prep(vec(prep.shape[1]), tmesh()), ref[name, "prep_y"])


HALO_FIELDS = ("int_indptr", "int_indices", "int_data", "bnd_indptr", "bnd_indices", "bnd_data")


@pytest.mark.parametrize("name", ["lap", "band"])
def test_halo_shards(ref, name):
    pm = tmat(ref, name)
    h = tp.shard_csr_rows_halo(pm, S, device=tmesh())
    hs = tp.shard_csr_rows_halo_split(pm, S)
    jh, jhs = ref[name, "halo"], ref[name, "split"]
    assert (h.halo, h.shape, h.rows_per_shard) == (jh.halo, jh.shape, jh.rows_per_shard)
    for f in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(stacked(getattr(h, f)), np.asarray(getattr(jh, f)), err_msg=f)
    assert hs.halo == jhs.halo and hs.n_shards == jhs.n_shards
    for f in HALO_FIELDS:
        np.testing.assert_array_equal(stacked(getattr(hs, f)), np.asarray(getattr(jhs, f)), err_msg=f)
    # both halo products agree with the plain product on every matrix
    x = torch.from_numpy(vec(pm.cols))
    want = tt.spmv(pm, x).numpy()
    close(tp.dist_spmv_halo(h, x, tmesh())[: pm.rows], want)
    close(tp.dist_spmv_halo_overlap(hs, x, tmesh())[: pm.rows], want)
    if name == "lap":
        close(tp.dist_spmv_halo(h, x, tmesh()), ref["halo_y"])


def test_halo_refusals(ref):
    wide = np.diag(np.ones(16)) + np.diag(np.ones(6), 10)
    with pytest.raises(ShapeError):
        tp.shard_csr_rows_halo(tt.from_dense(wide, device="cpu"), 8)
    with pytest.raises(st.errors.ShapeError):
        jp.shard_csr_rows_halo(st.from_dense(wide), 8)
    with pytest.raises(ShapeError):
        tp.shard_csr_rows_halo(tmat(ref, "rect"), 4)
    diag = tt.from_dense(np.diag(np.arange(1.0, 17.0)), device="cpu")
    h = tp.shard_csr_rows_halo_split(diag, 4)
    assert h.halo == 0
    close(tp.dist_spmv_halo_overlap(h, torch.ones(16, dtype=torch.float64), tmesh(4))[:16],
          np.arange(1.0, 17.0))


def assert_dist_product_equal(got, want):
    for f in ("indptr", "indices", "row_ids"):
        np.testing.assert_array_equal(stacked(getattr(got, f)), np.asarray(getattr(want, f)),
                                      err_msg=f)
    close(stacked(got.data), np.asarray(want.data))
    assert got.shape == want.shape and got.cap_per_shard == want.cap_per_shard


def test_dist_spgemm_replicated_b(ref):
    pm = tmat(ref, "rnd")
    dm = tp.shard_csr_rows(pm, S, balance="nnz")
    c = tp.dist_spgemm(dm, pm, tmesh())
    assert_dist_product_equal(c, ref["spgemm"])
    np.testing.assert_allclose(c.to_csmat().to_dense().numpy(),
                               pm.to_dense().numpy() @ pm.to_dense().numpy(), atol=1e-12)


def test_dist_spgemm_bshard_and_bgather(ref):
    pl = tmat(ref, "lap")
    dl = tp.shard_csr_rows(pl, S, device=tmesh())
    assert_dist_product_equal(tp.dist_spgemm_bshard(dl, dl, tmesh()), ref["bshard"])
    plan = tp.plan_b_gather(dl, dl)
    assert_plans_equal(plan, ref["plan_lap"])
    assert plan.comm_blocks < plan.full_blocks
    c = tp.dist_spgemm_bgather(dl, dl, tmesh(), plan=plan)
    assert_dist_product_equal(c, ref["bshard"])  # the same product, fetched by the plan
    pr = tmat(ref, "rnd")
    dr = tp.shard_csr_rows(pr, S)
    plan = tp.plan_b_gather(dr, dr)
    assert_plans_equal(plan, ref["plan_rnd"])
    assert plan.rounds > 1
    d = pr.to_dense().numpy()
    np.testing.assert_allclose(tp.dist_spgemm_bgather(dr, dr, tmesh()).to_csmat().to_dense().numpy(),
                               d @ d, rtol=0, atol=1e-12)


def assert_plans_equal(got, want):
    assert (got.rounds, got.perms, got.comm_blocks, got.mean_blocks, got.full_blocks) == (
        want.rounds, want.perms, want.comm_blocks, want.mean_blocks, want.full_blocks)
    np.testing.assert_array_equal(got.slot_of_block, want.slot_of_block)
    assert got.comm_fraction == want.comm_fraction


def test_b_sharded_products_need_rows_balanced_b(ref):
    pr = tmat(ref, "rnd")
    a, bad = tp.shard_csr_rows(pr, S), tp.shard_csr_rows(pr, S, balance="nnz")
    for fn in (tp.dist_spgemm_bshard, tp.dist_spgemm_bgather):
        with pytest.raises(ShapeError):
            fn(a, bad, tmesh())


@pytest.mark.parametrize("grid", GRIDS)
def test_2d_shards_and_spmv(ref, grid):
    pm = tmat(ref, "rect")
    d2, cp = tp.shard_csr_2d(pm, grid)
    jd2, jcp = ref["2d", grid]
    assert cp == jcp and d2.grid == jd2.grid and d2.rows_per == jd2.rows_per
    for f in ("indptr", "indices", "data"):
        got = np.stack([stacked(row) for row in getattr(d2, f)])
        np.testing.assert_array_equal(got, np.asarray(getattr(jd2, f)), err_msg=f)
    mesh2 = tp.Mesh(np.array(["cpu"] * 8, dtype=object).reshape(grid), ("r", "c"))
    y = tp.dist_spmv_2d(d2, cp, vec(41), mesh2)
    if grid == GRIDS[0]:
        close(y, ref["2d_y"])
    close(y[:29], tt.spmv(pm, torch.from_numpy(vec(41))).numpy())


def test_block_jacobi_ldl(ref):
    want = ref["bj"]
    M = tp.block_jacobi_ldl(tmat(ref, "spd"), S)
    assert (M.n, M.S, M.m) == (want.n, want.S, want.m)
    np.testing.assert_array_equal(M.perm, np.asarray(want.perm))
    np.testing.assert_array_equal(M.inv, np.asarray(want.inv))
    for f in ("n", "S", "W", "MR", "P"):
        assert getattr(M.plan, f) == getattr(want.plan, f), f
    np.testing.assert_allclose(M.d.numpy(), np.asarray(want.d), rtol=1e-10)
    np.testing.assert_allclose(M.panels.numpy(), np.asarray(want.panels), rtol=1e-10, atol=1e-14)
    np.testing.assert_allclose(M.precond(vec(64, seed=5)).numpy(), ref["bj_r"], rtol=1e-10)
    with pytest.raises(ShapeError):
        tp.block_jacobi_ldl(tmat(ref, "spd"), 5)


@pytest.mark.parametrize("pc", [None, "jacobi", "block_ldl"])
def test_dist_cg_iterations_equal(ref, pc):
    ds = tp.shard_csr_rows(tmat(ref, "spd"), S, balance="nnz", device=tmesh())
    res = tp.dist_cg(ds, vec(64, seed=6), tmesh(), precond=pc, tol=1e-10, max_iter=500)
    want = ref["cg"][pc]
    assert res.converged and res.iterations == int(want.iterations)
    np.testing.assert_allclose(res.x.numpy(), np.asarray(want.x), rtol=1e-9, atol=1e-12)


def test_dryrun_multichip_on_cpu_slots(capsys):
    from sprs_tpu_torch.entry import dryrun_multichip

    dryrun_multichip(8, device="cpu")
    assert "dryrun_multichip OK on 8 slots of cpu" in capsys.readouterr().out


@pytest.mark.gpu
def test_distributed_layer_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from sprs_tpu_torch.entry import dryrun_multichip

    mesh = tp.Mesh(["cuda:0"] * 4, ("shards",))
    lap = tt.utils.dirichlet_laplacian((32, 32), device="cuda")
    dm = tp.shard_csr_rows(lap, 4, balance="nnz", device=mesh)
    x = torch.linspace(0, 1, lap.cols, dtype=torch.float64, device="cuda")
    y = dm.assemble(tp.dist_spmv(dm, x, mesh))
    assert y.device.type == "cuda"
    torch.testing.assert_close(y, tt.spmv(lap, x), rtol=0, atol=1e-12)
    dryrun_multichip(4, device="cuda")
