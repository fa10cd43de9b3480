"""Multi-device distribution: row-, halo- and block-sharded sparse
kernels over a :class:`Mesh` of devices in one process."""

from .dist import (
    BGatherPlan,
    Dist2DCsMat,
    DistCsMat,
    Mesh,
    PreparedDistSpmv,
    dist_spgemm,
    dist_spgemm_bgather,
    dist_spgemm_bshard,
    dist_spmm,
    dist_spmv,
    dist_spmv_2d,
    plan_b_gather,
    prepare_dist_spmv,
    shard_csr_2d,
    shard_csr_rows,
)
from .precond import BlockJacobiLdl, block_jacobi_ldl, dist_cg
from .halo import (
    HaloCsMat,
    HaloSplitCsMat,
    dist_spmv_halo,
    dist_spmv_halo_overlap,
    shard_csr_rows_halo,
    shard_csr_rows_halo_split,
)

__all__ = [
    "BGatherPlan",
    "BlockJacobiLdl",
    "block_jacobi_ldl",
    "dist_cg",
    "Dist2DCsMat",
    "DistCsMat",
    "HaloCsMat",
    "HaloSplitCsMat",
    "Mesh",
    "dist_spmv_halo_overlap",
    "shard_csr_rows_halo_split",
    "dist_spgemm",
    "dist_spgemm_bgather",
    "dist_spgemm_bshard",
    "plan_b_gather",
    "dist_spmm",
    "dist_spmv",
    "dist_spmv_2d",
    "dist_spmv_halo",
    "PreparedDistSpmv",
    "prepare_dist_spmv",
    "shard_csr_2d",
    "shard_csr_rows",
    "shard_csr_rows_halo",
]
