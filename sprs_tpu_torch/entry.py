"""Entry points: the flagship forward step of the port and the
multi-device dry run.

:func:`entry` is the counterpart of the JAX package's
``__graft_entry__.entry``: SpMV on the 5-point grid Laplacian of a
128×128 grid in float32, here through the prepared DIA operand and the
CUDA kernel K1 on the card.  :func:`dryrun_multichip` is the counterpart
of ``__graft_entry__.dryrun_multichip`` on a port :class:`Mesh`.
"""

from __future__ import annotations

import numpy as np
import torch

from .formats.util import DEFAULT_DEVICE
from .ops.cuda.dia_spmv import dia_tile
from .utils.special import grid_laplacian


def _spmv(mat, x):
    return mat.spmv(x)


def entry(device=DEFAULT_DEVICE):
    """``(fn, example_args)`` with ``fn(*example_args)`` the SpMV."""
    mat = dia_tile(grid_laplacian((128, 128), torch.float32, device=device).to_dia())
    x = torch.from_numpy(np.linspace(0.0, 1.0, mat.cols).astype(np.float32))
    return _spmv, (mat, x.to(device))


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def dryrun_multichip(n_devices: int, device=DEFAULT_DEVICE) -> None:
    """The distributed solve step on a mesh of ``n_devices`` slots, all
    on ``device``, at tiny shapes and in float32, with the JAX dry run's
    steps and asserts: row-sharded SpMV (replicated and all-gathered x),
    the three distributed SpGEMMs, a 2-D (rows × cols) SpMV with the
    partials summed over the column axis, the halo-exchange SpMV and the
    halo routing, a distributed BiCGSTAB, Jacobi-preconditioned CG and
    block-Jacobi-LDLᵀ-preconditioned CG."""
    from .linalg import bicgstab, cg
    from .parallel import (
        Mesh,
        block_jacobi_ldl,
        dist_spgemm,
        dist_spgemm_bgather,
        dist_spgemm_bshard,
        dist_spmv,
        dist_spmv_2d,
        dist_spmv_halo,
        plan_b_gather,
        prepare_dist_spmv,
        shard_csr_2d,
        shard_csr_rows,
        shard_csr_rows_halo,
    )
    from .utils.special import dirichlet_laplacian

    devices = np.array([torch.device(device)] * n_devices, dtype=object)
    lap = grid_laplacian((8, n_devices), torch.float32, device=device)
    dense = _host(lap.to_dense())
    n = lap.shape[0]
    x = torch.from_numpy(np.linspace(1.0, 2.0, n).astype(np.float32)).to(device)
    want = dense @ _host(x)

    # --- 1-D row sharding: SpMV (replicated + all-gathered x) + SpGEMM ----
    mesh1 = Mesh(devices, ("shards",))
    dmat = shard_csr_rows(lap, n_devices, balance="nnz", device=mesh1)
    y1 = _host(dmat.assemble(dist_spmv(dmat, x, mesh1)))
    np.testing.assert_allclose(y1, want, rtol=1e-5, atol=1e-5)
    y2 = _host(dmat.assemble(dist_spmv(dmat, x, mesh1, x_sharded=True)))
    np.testing.assert_allclose(y2, want, rtol=1e-5, atol=1e-5)
    c = dist_spgemm(dmat, lap, mesh1).to_csmat()
    np.testing.assert_allclose(_host(c.to_dense()), dense @ dense, rtol=1e-5)
    # both operands sharded: all-gather of B's row shards
    da = shard_csr_rows(lap, n_devices, device=mesh1)  # rows-balanced
    c2 = dist_spgemm_bshard(da, da, mesh1).to_csmat()
    np.testing.assert_allclose(_host(c2.to_dense()), dense @ dense, rtol=1e-5, atol=1e-5)
    # referenced-block gather schedule (ppermute rounds, no B replication)
    plan = plan_b_gather(da, da)
    assert plan.comm_blocks < plan.full_blocks or n_devices <= 2
    c3 = dist_spgemm_bgather(da, da, mesh1, plan=plan).to_csmat()
    np.testing.assert_allclose(_host(c3.to_dense()), dense @ dense, rtol=1e-5, atol=1e-5)

    # --- 2-D block sharding: SpMV with the partials summed over columns --
    R = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    C = n_devices // R
    mesh2 = Mesh(devices.reshape(R, C), ("r", "c"))
    dmat2, cols_per = shard_csr_2d(lap, (R, C), device=mesh2)
    y3 = _host(dist_spmv_2d(dmat2, cols_per, x, mesh2))[:n]
    np.testing.assert_allclose(y3, want, rtol=1e-5, atol=1e-5)

    # --- halo-exchange SpMV (ppermute boundary slices, O(halo) copies) ---
    hmat = shard_csr_rows_halo(lap, n_devices, device=mesh1)
    y4 = _host(dist_spmv_halo(hmat, x, mesh1))[:n]
    np.testing.assert_allclose(y4, want, rtol=1e-5, atol=1e-5)

    # --- prepare-time routing: the Laplacian must pick the halo path ---
    prep = prepare_dist_spmv(lap, n_devices, device=mesh1)
    assert prep.kind == "halo", prep.kind
    y5 = _host(prep(x, mesh1)).reshape(-1)[:n]
    np.testing.assert_allclose(y5, want, rtol=1e-5, atol=1e-5)

    # --- distributed BiCGSTAB: dist SpMV inside the solver loop ---------
    def matvec(v):
        return dmat.assemble(dist_spmv(dmat, v, mesh1))

    b = torch.from_numpy((dense @ np.ones(n)).astype(np.float32)).to(device)
    res = bicgstab(matvec, b, tol=1e-4, max_iter=50)
    np.testing.assert_allclose(_host(res.x), np.ones(n), atol=1e-2)

    # --- distributed Jacobi-preconditioned CG (SPD operator) -----------
    spd = dirichlet_laplacian((4, 2 * n_devices), torch.float32, device=device)
    sdense = _host(spd.to_dense())
    sn = spd.shape[0]
    sd = shard_csr_rows(spd, n_devices, balance="nnz", device=mesh1)

    def smv(v):
        return sd.assemble(dist_spmv(sd, v, mesh1))

    sb = torch.from_numpy((sdense @ np.ones(sn)).astype(np.float32)).to(device)
    diag = spd.diag()
    pres = cg(smv, sb, tol=1e-5, max_iter=200, precond=lambda r: r / diag)
    np.testing.assert_allclose(_host(pres.x), np.ones(sn), atol=1e-2)

    # --- block-Jacobi LDLᵀ preconditioner: the diagonal blocks as lanes
    # of one batched panel factor and solve on one static plan ---------
    M = block_jacobi_ldl(spd, n_devices)
    bres = cg(smv, sb, tol=1e-5, max_iter=200, precond=M.precond)
    np.testing.assert_allclose(_host(bres.x), np.ones(sn), atol=1e-2)
    assert bres.iterations <= pres.iterations

    print(
        f"dryrun_multichip OK on {n_devices} slots of {device}: "
        f"1-D spmv/spgemm (+bgather {plan.comm_blocks}/{plan.full_blocks} "
        f"remote blocks), 2-D ({R}x{C}) summed spmv, distributed "
        f"bicgstab + jacobi-pcg + block-jacobi-ldl-pcg "
        f"({bres.iterations} vs {pres.iterations} iters)"
    )
