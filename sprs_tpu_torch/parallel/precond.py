"""Distributed preconditioners, the counterpart of
``sprs_tpu/parallel/precond.py``.

Block-Jacobi with per-block supernodal LDLᵀ solves: the rows are split
into S equal chunks and block s is the diagonal block A[s·m:(s+1)·m,
s·m:(s+1)·m].  All blocks are factored against one symbolic plan, that
of the union of the block patterns (entries a block lacks are explicit
zeros; LDLᵀ on a pattern superset is exact), the JAX package's plan
integer for integer.  The JAX package factors and solves the blocks
with ``vmap`` over that plan; here the S blocks are the member lanes of
the same-pattern batched numeric and panel solve (``ops/batch.py``,
``linalg/ldl_batched.py``): one factor and one solve for all blocks.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..errors import ShapeError
from ..formats.csmat import CSR, CsMat, csmat
from ..formats.util import as_tensor, host_array


@dataclasses.dataclass
class BlockJacobiLdl:
    """Factored block-Jacobi preconditioner; ``precond`` applies M⁻¹.

    The array state is ``panels (S, P)`` and ``d (S, m)`` on the
    matrix's device, plus the host permutation maps and the plan's
    round schedule (``sched``), which the panel solve takes.
    """

    n: int
    S: int
    m: int
    plan: object  # SuperPlan shared by every block
    panels: torch.Tensor  # (S, P)
    d: torch.Tensor  # (S, m)
    perm: Optional[np.ndarray]  # block-local fill-reducing permutation
    inv: Optional[np.ndarray]
    sched: object = None

    def precond(self, r) -> torch.Tensor:
        """x = M⁻¹ r with M = blockdiag(A₀₀, …, A_{S-1,S-1})."""
        from ..ops.batch import batched_panel_solve

        r = r if isinstance(r, torch.Tensor) else as_tensor(r, device=self.panels.device)
        if r.shape[0] != self.n:
            raise ShapeError(f"precond rhs {tuple(r.shape)} vs n={self.n}")
        rs = r.reshape(self.S, self.m)
        if self.perm is not None:
            rs = rs[:, torch.as_tensor(self.perm, dtype=torch.int64, device=r.device)]
        xs = batched_panel_solve(self.plan, self.panels, self.d, rs, sched=self.sched)
        if self.inv is not None:
            xs = xs[:, torch.as_tensor(self.inv, dtype=torch.int64, device=r.device)]
        return xs.reshape(-1).to(r.dtype)

    __call__ = precond


def dist_cg(dmat, b, mesh, *, precond=None, **cg_kw):
    """Distributed preconditioned CG on a row-sharded SPD system.

    The matvec is :func:`~sprs_tpu_torch.parallel.dist_spmv` (replicated
    x over the mesh, the result assembled on its first device);
    ``precond`` may be None, ``"jacobi"`` (diagonal), ``"block_ldl"``
    (:func:`block_jacobi_ldl` over the shards' row blocks) or any
    callable ``r -> M⁻¹ r``.  Returns :class:`~sprs_tpu_torch.linalg.cg.CgResult`.
    """
    from ..linalg import cg
    from .dist import dist_spmv

    first = mesh.axis_devices("shards")[0]
    b = b if isinstance(b, torch.Tensor) else as_tensor(b, device=first)

    def matvec(v):
        return dmat.assemble(dist_spmv(dmat, v, mesh))

    if precond == "jacobi":
        diag = dmat.to_csmat().diag().to(b.device)
        pc = lambda r: r / diag  # noqa: E731
    elif precond == "block_ldl":
        pc = block_jacobi_ldl(dmat.to_csmat(), dmat.n_shards).precond
    else:
        pc = precond
    return cg(matvec, b, precond=pc, **cg_kw)


def block_jacobi_ldl(mat: CsMat, n_shards: int, *, fill: str = "camd") -> BlockJacobiLdl:
    """Factor a block-Jacobi LDLᵀ preconditioner for SPD ``mat``.

    Host: the S diagonal blocks and the union of their patterns, whose
    symbolic, supernodal plan and round schedule serve every block.
    Device (the matrix's): one batched numeric over the (S, nnz) block
    values.  Requires ``mat.shape[0] % n_shards == 0``.
    """
    n = mat.shape[0]
    if mat.shape[0] != mat.shape[1]:
        raise ShapeError(f"block_jacobi_ldl needs square, got {mat.shape}")
    if n % n_shards:
        raise ShapeError(f"rows {n} not divisible by n_shards {n_shards}")
    m = n // n_shards
    csr = mat.to_csr()
    ip = csr.indptr.cpu().numpy()
    nnz = int(ip[-1])
    rows = np.repeat(np.arange(csr.rows, dtype=np.int64), np.diff(ip))[:nnz]
    cols = csr.indices[:nnz].cpu().numpy().astype(np.int64)
    vals = host_array(csr.data[:nnz])  # bfloat16 as float32: exact

    shard_of = rows // m
    in_block = shard_of == (cols // m)
    br = (rows - shard_of * m)[in_block]
    bc = (cols - shard_of * m)[in_block]
    bs = shard_of[in_block]
    bv = vals[in_block]
    key = br * np.int64(m) + bc  # block-local (row, col) key

    # union pattern over the blocks
    ukeys = np.unique(key)
    kn = ukeys.shape[0]
    urows = (ukeys // m).astype(np.int64)
    ucols = (ukeys % m).astype(np.int32)
    uptr = np.zeros(m + 1, dtype=np.int64)
    np.cumsum(np.bincount(urows, minlength=m), out=uptr[1:])
    # per-block values aligned to the union slots (zeros where absent)
    slot = np.searchsorted(ukeys, key)
    data_s = np.zeros((n_shards, kn), dtype=vals.dtype)
    data_s[bs, slot] = bv

    from ..linalg import Ldl
    from ..linalg.ldl_batched import numeric_batched
    from ..linalg.ldl_super import panels_from_csc

    pattern = csmat((m, m), uptr.astype(np.int32), ucols, np.ones(kn, dtype=np.float64),
                    storage=CSR, validate=False, device=mat.device)
    sym = Ldl().fill_in_reduction(fill).check_symmetry(False).symbolic(pattern)
    plan = sym.super_plan()
    sched = sym.round_schedule(plan)
    lx, d = numeric_batched(plan, sched, torch.from_numpy(data_s).to(mat.device, mat.dtype))
    perm = inv = None
    if sym.perm is not None:
        perm = sym.perm.perm.cpu().numpy()
        inv = sym.perm.inv.cpu().numpy()
    return BlockJacobiLdl(n=n, S=n_shards, m=m, plan=plan, panels=panels_from_csc(plan, lx),
                          d=d, perm=perm, inv=inv, sched=sched)
