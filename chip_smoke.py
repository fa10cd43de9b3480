#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``sprs_tpu_torch``) on one GPU.

Phases, each of which raises on failure (the script then exits non-zero
and prints no result):

1. device: the card's name and count, and ``nvidia-smi``'s name and
   power limit;
2. build: every CUDA source of the port, compiled from ``csrc/`` (one
   ``nvcc`` per source, all started together);
3. gate: each kernel against its plain torch version on the card —
   K1 (banded SpMV) and K2 (banded SpMM) on grid Laplacians and a random
   band in float32 and float64, K2 also on the 1024² Dirichlet Laplacian
   and the band's transpose, at every RHS width the block main paths and
   correctness solves give it (4 to 256) and at 1, 48 and 130, each
   width also on an X that starts off a 16-byte boundary (K2's vector
   and scalar variants, each gate checking which one ran); K3 and K4
   (block-sparse SpMM) at block size 8 (odd shapes, an empty block row,
   padding blocks, unsorted blocks) and 128 in float32, bfloat16 and
   float64; K3's wgmma variant in bfloat16 at block sizes 64 and 128 (a
   1000×900 shape with a partial last block row and X rows past
   ``cols``, a sliced and unsorted operand, an empty block row, k = 200
   and k = 70, the latter sent to the 3xTF32 variant by the wrapper's
   rule, and the K4 repack); K3's 3xTF32 variant in float32 and float64
   at block sizes 8, 16, 64 and 128 (the 1000×900 shape at an odd k,
   k = 1 and an aligned k, an X off a 16-byte boundary, a sliced and
   unsorted operand, an empty block row, the K4 repack), on blocks of
   magnitudes 2⁻²⁰ to 2²⁰, and on inf and NaN entries, which must land
   where the plain version puts them; K5 (ELL SpMV) on the 1024² mesh step (float64), the
   "random8" matrix (float32), small odd ELLs (rows not a multiple of a
   warp's rows, an empty row, width 1, rows wider than 32 slots) and a
   non-finite x[0], which reaches the pad slots as in the plain version;
   K6 (row sort) on random, tied and float keys, float keys with +0.0,
   -0.0 and other ties (also against the plain version on the CPU) and a
   single row, bit for bit; the backwards of K1, K2, K3 and K5 against
   torch's autograd of the plain version on the CPU;
4. timing, with CUDA events, beside each kernel's bound, its plain
   version and one library call (K2-K6 also with the profiler's device
   time per launch, ``device_ms``): K1 at the 4096×4096-grid SpMV
   and the 1024² float64 solve size; K2 at the 2048×1024 grid with 128
   RHS (float32) and at 1024² float64 with 24, 48 and 256 RHS (vector
   variant) and 3 RHS (scalar variant); K3 at n = 4096, k = 512,
   bs = 128, block densities 0.125/0.25/0.5 (bfloat16, wgmma) and in
   float32 and float64 (3xTF32), and at n = 16384 (bfloat16, float32); K4
   at the first of those; K5
   at the 1024² mesh step (float64, its main path) and "random8"
   (n = 2,097,152, 8 uniform slots per row, float32), with the L2 sectors
   its gathers read; K6 at 43,750 × 128 (int32 and float32 keys); SpGEMM
   (not a kernel) at the JAX bench's three points;
5. main paths, each with the launch counts set to 0 just before and read
   just after:
   a. BiCGSTAB and CG at 1024² float64 through ``prepare_spmv`` and K1
      (3·iters+2 and iters+2 launches), then a profiler window;
   b. the block solvers through ``prepare_spmm`` and K2: heat diffusion
      from 256 point sources, ``expm_multiply`` on the 1024² grid
      Laplacian (float64), held against the same call over the plain
      version (K2's vector variant), and the same from 3 sources (its
      scalar variant); LOBPCG at 1024² for a fixed 50 iterations (2·50+2
      launches), with a profiler window; the plain versions' call counts
      stay at 0;
   c. block-sparse products ``BsrMat @ X`` (K3's wgmma variant) and the
      grouped product (K4) at n = 4096, k = 512, bs = 128, bfloat16, and
      ``BsrMat @ X`` in float32 (K3's 3xTF32 variant);
   d. the unstructured path: an implicit heat step I + 10·L on a 1024²
      vertex triangle mesh with permuted labels, assembled on the card
      (``tri_mesh_graph_laplacian``, ``eye``, ``+``, ``*``) and held
      against scipy, routed by ``prepare_spmv`` to ELL, solved by CG
      through K5 (iters+2 launches, the plain version's calls 0), held
      against the same CG over the plain version, then a profiler
      window;
   e. K6 through its own entry point on 43,750 rows of 128;
   f. the SpGEMM path: L = kron(I, T) + kron(T, I) at side 1024 (equal to
      ``dirichlet_laplacian``), the biharmonic step A = I + L @ L through
      ``spgemm`` (equal to scipy's), A permuted by ``transform_mat_papt``
      (symmetric), GMRES(30) on the permuted A through K5 (ELL, width 13)
      and on A through K1 (DIA), each with 1 + cycles·31 launches and the
      plain versions' calls 0; the JAX bench's SpGEMM points against
      scipy, the 140.6M-product one also in at least 4 row chunks (the
      same arrays), and its dense-route BSR product times X through K3's
      3xTF32 variant (1 launch);
6. correctness solves: BiCGSTAB and CG at 32² and CG on the 16² mesh
   step against a dense solve;
   LOBPCG at 128² Dirichlet (8 eigenpairs against the closed form,
   2·iters+2 K2 launches) and ``svds(k=4)`` on the random band against
   ``torch.linalg.svdvals`` (4·iters+5 K2 launches); GMRES on a
   convection–diffusion operator at 32², LSQR on a Tikhonov system at 32²
   and the sparse-iterate BiCGSTAB at 16² against dense solves, and the
   stacks and permutations against their dense equivalents;
7. the SpGEMM line (phase 4's SpGEMM rows: the port at the JAX bench's
   three points beside ``torch.sparse.mm`` and scipy, the split of its
   device time, its peak memory per product, and at the densest point
   the dense route and the break-even that sets
   ``AUTO_DENSE_PRODUCTS_PER_MAC``), the kernels line, then the last line
   ``{"ok": true, "device": {"platform": "gpu", ...}}``.

Run from the repository root: ``python3 chip_smoke.py``.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

from sprs_tpu_torch.formats.bsr import BsrMat, bsr_from_dense, bsr_random, bsr_spmm_plain
from sprs_tpu_torch.formats.csmat import diags, eye, from_dense
from sprs_tpu_torch.formats.csvec import csvec
from sprs_tpu_torch.formats.dia import dia_to_csmat
from sprs_tpu_torch.formats.ell import EllMat, ell_from_csmat
from sprs_tpu_torch.formats.triplet import coo_to_csmat
from sprs_tpu_torch.formats.util import compress_coo, round_up
from sprs_tpu_torch.interop import from_arrays
from sprs_tpu_torch.linalg import (
    bicgstab,
    bicgstab_sparse,
    cg,
    expm_multiply,
    gmres,
    lobpcg,
    lsqr,
    svds,
)
from sprs_tpu_torch.ops import (
    Permutation,
    block_diag,
    bmat,
    hstack,
    is_symmetric,
    kronecker_product,
    permute_cols,
    permute_rows,
    prepare_spmm,
    prepare_spmv,
    spgemm,
    spmv,
    transform_mat_papt,
    transform_mat_paq,
    vstack,
)
from sprs_tpu_torch.ops.cuda import build
from sprs_tpu_torch.ops.cuda import bsr_spmm as k3
from sprs_tpu_torch.ops.cuda import dia_spmm as k2
from sprs_tpu_torch.ops.cuda.bsr_spmm import (
    bsr_group,
    bsr_spmm_grouped_kernel,
    bsr_spmm_kernel,
)
from sprs_tpu_torch.ops.cuda.dia_spmm import dia_spmm_kernel, dia_spmm_plain
from sprs_tpu_torch.ops.cuda.dia_spmv import (
    dia_spmv_kernel,
    dia_spmv_plain,
    dia_tile,
)
from sprs_tpu_torch.ops.cuda.ell_spmv import ell_spmv_kernel, ell_spmv_plain
from sprs_tpu_torch.ops.cuda.sort import sort_rows_kernel, sort_rows_plain
from sprs_tpu_torch.ops.spgemm import (
    _exact_prod_count,
    _expand_products,
    _matmul_precision,
    _free_bytes,
    _spgemm_chunked,
    chunk_bounds,
    chunk_product_budget,
    dense_bytes_budget,
)
from sprs_tpu_torch.utils import dirichlet_laplacian, grid_laplacian, rand_csr, tri_mesh_graph_laplacian

DEVICE = "cuda"
# H100 SXM data sheet: HBM3 rate; CUDA-core peaks (K1, K2) and the
# tensor-core peaks taken for K3's bound: bf16 dense for the wgmma
# variant, TF32 for the 3xTF32 variant, which takes every product three
# times (once for bf16, whose values are exact in TF32).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}
BF16_TC_FLOPS = 989e12
TF32_TC_FLOPS = 495e12
# K1/K2 vs plain: the same sum order over the diagonals; only FMA
# contraction differs.  Relative to max |y|.
GATE_LIMIT = {torch.float32: 1e-5, torch.float64: 1e-12}
# K3/K4 vs plain: both take products and sums in float32 for every type
# (as the JAX package does), in another order; a bfloat16 output may
# round to a neighbouring value: one step at the largest magnitude.
BSR_GATE_LIMIT = {torch.float32: 1e-5, torch.float64: 1e-5, torch.bfloat16: 2.0**-7}
SOLVE_TOL = 1e-8
SOLVE_SIDE = 1024
SPMV_SIDE = 4096
# Rehearsed on the CPU: iterations grow linearly with the side (side
# 256: BiCGSTAB 464, CG 454), so 1024 needs about 1,900.
MAX_ITER = 10000
PROFILE_ITERS = 50
SPMM_GRID = (2048, 1024)  # the JAX package's measured K2 shape (2M rows)
# 8 and 24: LOBPCG's X and basis at m = 8; 4 and 12: svds(k=4); 256:
# the expm block; 1, 48 and 130 for odd and wide tiles.
SPMM_WIDTHS = (1, 4, 8, 12, 24, 48, 130, 256)
BAND_OFFSETS = (-70, -3, -1, 0, 2, 65)
EXPM_SOURCES = 256
# a heat diffusion from 3 sources: rows of 24 bytes, K2's scalar variant
EXPM_FEW_SOURCES = 3
LOBPCG_M = 8
LOBPCG_FIXED_ITERS = 50
EIG_SIDE = 128
# Rehearsed on the CPU with the port: LOBPCG at 128², m = 8, tol 1e-6
# took 644 iterations; svds(k=4) on the band took 52.
EIG_MAX_ITER = 2000
SVDS_MAX_ITER = 500
BSR_N, BSR_K, BSR_BS = 4096, 512, 128
BSR_DENSITIES = (0.125, 0.25, 0.5)
BSR_BIG_N = 16384
BSR_GROUP = 8
# the wgmma variant's gates: both block sizes it takes
TC_BLOCK_SIZES = (64, 128)
# the 3xTF32 variant's gates
TF32_BLOCK_SIZES = (8, 16, 64, 128)
# The unstructured path: a 1024² vertex mesh, labels permuted, step
# I + τL with τ = 10 (scipy's CG took 85 iterations to 1e-8 at this size).
MESH_SIDE = 1024
MESH_TAU = 10.0
MESH_SMALL_SIDE = 16
# The JAX package's ELL timing shape (benches/r4/r4_format_spmv.py:84-99):
# 8 uniform column draws per row, duplicates summed.
RANDOM8_N = 2**21
RANDOM8_SLOTS = 8
# The row count of the JAX sort kernel's TPU measurement (5.6M elements).
SORT_ROWS = 43750
# SpGEMM at the JAX bench's points (benches/spgemm_bench.py), on its own
# operands rand_csr(shape_a, d, seed=0) @ rand_csr(shape_b, d, seed=1) in
# float32 (:111-113): the largest point of the quick shape sweep, density
# 4/n (:391-395), and the density sweep at (15000, 25000) @ (25000, 15000)
# (:372-389).
SPGEMM_POINTS = (
    ((150000, 150000), (150000, 150000), 4.0 / 150000),
    ((15000, 25000), (25000, 15000), 1e-3),
    ((15000, 25000), (25000, 15000), 5e-3),
)
SPGEMM_REPS = 5
# the forced-chunk run at the last point: at least this many row chunks
SPGEMM_MIN_CHUNKS = 4
# the bench's tolerance against scipy (spgemm_bench.py:212-213)
SPGEMM_RTOL, SPGEMM_ATOL = 1e-4, 1e-5
# X of the chained product C_bsr @ X at the last point
CHAIN_K = 256
# The implicit biharmonic step I + τL² (τ = 1) on the side² Dirichlet
# grid: L @ L is 26M products, 13.6M entries; cond(A) <= 1 + 8² = 65.
BIHARM_SIDE = 1024
GMRES_RESTART = 30
GMRES_MAX_ITER = 3000


def log(msg: str) -> None:
    print(msg, flush=True)


def sync() -> None:
    torch.cuda.synchronize()


def phase_device():
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        timeout=60,
        check=True,
    ).stdout.strip().splitlines()[0]
    log(f"device: {name}, count {count}, torch {torch.__version__}, cuda {torch.version.cuda}")
    log(smi)
    return name, count, smi


def phase_build():
    t0 = time.perf_counter()
    infos = build.build()
    log(f"build: {len(infos)} source(s) in {time.perf_counter() - t0:.3f} s")
    for info in infos.values():
        log(f"  {info.name}: {info.seconds:.3f} s -> {info.path.name}")
        for line in info.log.splitlines():
            log(f"    {line}")


def check_rel(name, err, ref_max, limit):
    rel = err / max(ref_max, 1e-300)
    log(f"gate {name}: max_abs_err {err!r} rel {rel!r} (limit {limit})")
    if not rel <= limit:
        raise AssertionError(f"gate {name}: rel {rel} > {limit}")
    return err


# ---------------------------------------------------------------------------
# operands
# ---------------------------------------------------------------------------


def band_dia(rows, cols, offsets, dtype, seed):
    """Random DIA operand with zeros where a diagonal leaves the matrix."""
    rng = np.random.default_rng(seed)
    rows_pad = round_up(rows, 8)
    data = rng.standard_normal((len(offsets), rows_pad))
    i = np.arange(rows_pad)
    for d, off in enumerate(offsets):
        data[d, (i >= rows) | (i + off < 0) | (i + off >= cols)] = 0.0
    return dia_tile(
        from_arrays("dia", (rows, cols), (data.astype(dtype),), offsets=offsets, device=DEVICE)
    )


def banded_operand(rows, cols, offsets, dtype, seed):
    dia = band_dia(rows, cols, offsets, dtype, seed)
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal(cols).astype(dtype))
    return dia, x.to(DEVICE)


def laplacian_operand(mat, seed):
    dia = dia_tile(mat.to_dia())
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal(dia.cols)).to(DEVICE, dia.dtype)
    return dia, x


def rhs_block(rows, k, dtype, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal((rows, k))).to(DEVICE, dtype)


def csr_twin(mat):
    nnz = mat.nnz
    return torch.sparse_csr_tensor(mat.indptr, mat.indices[:nnz], mat.data[:nnz], size=mat.shape)


# ---------------------------------------------------------------------------
# gates
# ---------------------------------------------------------------------------


def gate_spmv(name, dia, x):
    y = dia_spmv_kernel(dia, x)
    ref = dia_spmv_plain(dia, x)
    sync()
    if y.shape != (dia.rows,) or not bool(torch.isfinite(y).all()):
        raise AssertionError(f"gate {name}: bad output {tuple(y.shape)}")
    err = float((y - ref).abs().max())
    return check_rel(name, err, float(ref.abs().max()), GATE_LIMIT[dia.dtype])


# the largest gate error of each kernel variant, by its name in the
# kernels line
GATE_ERRS = {}


def gate_spmm(name, dia, x):
    """K2 against its plain version; the variant the wrapper's rule picks
    for this X must be the one that launched."""
    kind = k2.variant(x.shape[1], x.element_size(), x.data_ptr())
    before = getattr(dia_spmm_kernel, f"launches_{kind}")
    y = dia_spmm_kernel(dia, x)
    ref = dia_spmm_plain(dia, x)
    sync()
    if getattr(dia_spmm_kernel, f"launches_{kind}") != before + 1:
        raise AssertionError(f"gate {name}: the {kind} variant did not launch")
    if y.shape != (dia.rows, x.shape[1]) or not bool(torch.isfinite(y).all()):
        raise AssertionError(f"gate {name}: bad output {tuple(y.shape)}")
    err = float((y - ref).abs().max())
    err = check_rel(f"{name} ({kind})", err, float(ref.abs().max()), GATE_LIMIT[dia.dtype])
    GATE_ERRS.setdefault(f"dia_spmm_{kind}", []).append(err)
    return err


def misaligned_copy(x):
    """A contiguous copy of X that starts one element past a 16-byte
    boundary."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    out = buf[1:].view(x.shape)
    out.copy_(x)
    return out


def gate_bsr(name, fn, bsr, x, counter=bsr_spmm_kernel, expect=None):
    """K3 (or K4, ``counter`` = its wrapper) against the plain version;
    the variant the wrapper's rule picks must be the one that launched,
    and ``expect`` when given."""
    kind = k3.variant(x.dtype, bsr.block_size, x.shape[1], x.data_ptr(), bsr.blocks.data_ptr())
    if expect is not None and kind != expect:
        raise AssertionError(f"gate {name}: the rule picks {kind}, expected {expect}")
    before = getattr(counter, f"launches_{kind}")
    y = fn(bsr, x)
    ref = bsr_spmm_plain(bsr, x)
    sync()
    if getattr(counter, f"launches_{kind}") != before + 1:
        raise AssertionError(f"gate {name}: the {kind} variant did not launch")
    if y.shape != (bsr.rows, x.shape[1]) or y.dtype != x.dtype or not bool(torch.isfinite(y).all()):
        raise AssertionError(f"gate {name}: bad output {tuple(y.shape)} {y.dtype}")
    err = float((y.float() - ref.float()).abs().max())
    err = check_rel(f"{name} ({kind})", err, float(ref.float().abs().max()), BSR_GATE_LIMIT[x.dtype])
    key = "bsr_spmm_grouped" if counter is bsr_spmm_grouped_kernel else f"bsr_spmm_{kind}"
    GATE_ERRS.setdefault(key, []).append(err)
    return err


def gate_grads():
    """The autograd backwards on the card against torch's own autograd of
    the plain versions on the CPU: the largest error of each kernel's."""
    errs = {}
    dia, x = laplacian_operand(grid_laplacian((64, 64), device=DEVICE), 7)
    for label, fn, plain, xx, g in (
        ("K1", dia_spmv_kernel, dia_spmv_plain, x, rhs_block(dia.rows, 1, torch.float64, 8)[:, 0]),
        ("K2", dia_spmm_kernel, dia_spmm_plain, rhs_block(dia.cols, 24, torch.float64, 9),
         rhs_block(dia.rows, 24, torch.float64, 10)),
    ):
        data = dia.data.clone().requires_grad_(True)
        xg = xx.clone().requires_grad_(True)
        dd, dx = torch.autograd.grad(fn(type(dia)(data, dia.offsets, dia.shape), xg), (data, xg), g)
        data_c = dia.data.cpu().requires_grad_(True)
        x_c = xx.cpu().requires_grad_(True)
        y_c = plain(type(dia)(data_c, dia.offsets, dia.shape), x_c)
        dd_c, dx_c = torch.autograd.grad(y_c, (data_c, x_c), g.cpu())
        err = max(float((dd.cpu() - dd_c).abs().max()), float((dx.cpu() - dx_c).abs().max()))
        log(f"gate grad {label} (64x64 grid, float64): max_abs_err {err!r}")
        if not err <= 1e-12:
            raise AssertionError(f"gate grad {label}: {err}")
        errs[label] = err
    GATE_ERRS["dia_spmm_vector"].append(errs["K2"])

    bsr = bsr_random(11, (300, 260), 8, 0.3, torch.float32, device=DEVICE)
    x = rhs_block(260, 20, torch.float32, 12)
    g = rhs_block(300, 20, torch.float32, 13)
    blocks = bsr.blocks.clone().requires_grad_(True)
    xg = x.clone().requires_grad_(True)
    y = bsr_spmm_kernel(BsrMat(bsr.brows, bsr.bcols, blocks, bsr.shape, bsr.n_blocks), xg)
    db, dx = torch.autograd.grad(y, (blocks, xg), g)
    blocks_c = bsr.blocks.cpu().requires_grad_(True)
    x_c = x.cpu().requires_grad_(True)
    cpu = BsrMat(bsr.brows.cpu(), bsr.bcols.cpu(), blocks_c, bsr.shape, bsr.n_blocks)
    db_c, dx_c = torch.autograd.grad(bsr_spmm_plain(cpu, x_c), (blocks_c, x_c), g.cpu())
    errs["K3"] = max(
        check_rel(f"grad K3 {label} (bs 8, float32)", float((a.cpu() - b).abs().max()),
                  float(b.abs().max()), 1e-5)
        for label, a, b in (("dblocks", db, db_c), ("dX", dx, dx_c))
    )
    GATE_ERRS["bsr_spmm_tf32x3"].append(errs["K3"])
    return errs


def odd_block_dense(dtype):
    """A 45×37 matrix of 8×8 blocks with an empty block row (rows 8-15)."""
    rng = np.random.default_rng(20)
    keep = rng.random((6, 5)) < 0.5
    keep[1] = False
    dense = np.zeros((48, 40), np.float32)
    for i, j in zip(*np.nonzero(keep)):
        dense[i * 8 : (i + 1) * 8, j * 8 : (j + 1) * 8] = rng.standard_normal((8, 8))
    return torch.from_numpy(dense[:45, :37]).to(dtype)


def unsorted_slice(bsr, seed):
    """Block rows 1 and on of ``bsr``, with the blocks shuffled out of
    row order."""
    bs = bsr.block_size
    sliced = bsr.slice_block_rows(bs, bsr.rows)
    perm = torch.from_numpy(np.random.default_rng(seed).permutation(sliced.cap)).to(DEVICE)
    return BsrMat(sliced.brows[perm], sliced.bcols[perm], sliced.blocks[perm],
                  sliced.shape, sliced.n_blocks)


def without_row_one(bsr):
    """``bsr`` with block row 1 left with no block."""
    keep = torch.nonzero(bsr.brows[: bsr.n_blocks] != 1)[:, 0]
    holed = BsrMat(bsr.brows[keep], bsr.bcols[keep], bsr.blocks[keep], bsr.shape, int(keep.numel()))
    if int(holed.row_order[0][2] - holed.row_order[0][1]) != 0:
        raise AssertionError("gate: block row 1 still holds a block")
    return holed


def gate_tf32x3(bs, dtype):
    """K3's 3xTF32 variant at block size ``bs`` (float32 or float64): the
    1000×900 shape (a partial last block row, X rows past ``cols``) at
    k = 201 (rows of X not whole 16 bytes, a partial 128-column tile),
    k = 256 (16-byte copies) and k = 1 (the SpMV); an X one element off
    a 16-byte boundary; a sliced and unsorted operand; an empty block
    row; the K4 repack."""
    big = bsr_random(80 + bs, (1000, 900), bs, 0.3, dtype, device=DEVICE)
    x = rhs_block(900, 256, dtype, 81)
    for k in (201, 256, 1):
        gate_bsr(f"K3 bs{bs} 1000x900 k={k} {dtype}", bsr_spmm_kernel, big,
                 x[:, :k].contiguous(), expect="tf32x3")
    gate_bsr(f"K3 bs{bs} misaligned X {dtype}", bsr_spmm_kernel, big, misaligned_copy(x),
             expect="tf32x3")
    gate_bsr(f"K3 bs{bs} sliced+unsorted {dtype}", bsr_spmm_kernel, unsorted_slice(big, 82), x,
             expect="tf32x3")
    gate_bsr(f"K3 bs{bs} empty block row {dtype}", bsr_spmm_kernel, without_row_one(big), x,
             expect="tf32x3")
    gate_bsr(f"K4 bs{bs} group 4 {dtype}", lambda b, v: bsr_spmm_grouped_kernel(b, v, 4),
             bsr_group(big, 4), x, counter=bsr_spmm_grouped_kernel, expect="tf32x3")


def wide_magnitude(bsr, seed):
    """``bsr`` with its block entries replaced by ±2^e, e uniform in
    [-20, 20]."""
    rng = np.random.default_rng(seed)
    shape = tuple(bsr.blocks.shape)
    vals = rng.choice([-1.0, 1.0], shape) * 2.0 ** rng.uniform(-20, 20, shape)
    blocks = torch.from_numpy(vals).to(DEVICE, bsr.dtype)
    return BsrMat(bsr.brows, bsr.bcols, blocks, bsr.shape, bsr.n_blocks)


def gate_nonfinite(dtype):
    """K3's 3xTF32 variant on blocks holding +inf, -inf and NaN, against
    X of small integers with zeros among them (exact in TF32, so their lo
    is 0: inf·0 must stay out of the cross terms): NaN and ±inf where
    the plain version puts them, the finite entries within 1e-5 of their
    max."""
    bsr = bsr_random(90, (1000, 900), 128, 0.3, dtype, device=DEVICE)
    blocks = bsr.blocks.clone()
    blocks[0, 3, 5] = float("inf")
    blocks[1, 7, 2] = float("-inf")
    blocks[2, 0, 0] = float("nan")
    bsr = BsrMat(bsr.brows, bsr.bcols, blocks, bsr.shape, bsr.n_blocks)
    rng = np.random.default_rng(91)
    x = torch.from_numpy(rng.integers(-3, 4, (900, 256)).astype(np.float64)).to(DEVICE, dtype)
    name = f"K3 bs128 inf/NaN {dtype}"
    before = bsr_spmm_kernel.launches_tf32x3
    y = bsr_spmm_kernel(bsr, x)
    ref = bsr_spmm_plain(bsr, x)
    sync()
    if bsr_spmm_kernel.launches_tf32x3 != before + 1:
        raise AssertionError(f"gate {name}: the tf32x3 variant did not launch")
    for mask in (torch.isnan, torch.isposinf, torch.isneginf):
        if not torch.equal(mask(y), mask(ref)):
            raise AssertionError(f"gate {name}: {mask.__name__} differs from the plain version")
    fin = torch.isfinite(ref)
    if not (bool(torch.isnan(ref).any()) and bool(torch.isinf(ref).any())):
        raise AssertionError(f"gate {name}: the fixture gives no NaN or no inf")
    err = float((y.float() - ref.float())[fin].abs().max())
    GATE_ERRS["bsr_spmm_tf32x3"].append(
        check_rel(f"{name} (finite entries)", err, float(ref.float()[fin].abs().max()), 1e-5))


def gate_tc(bs):
    """K3's wgmma variant at block size ``bs`` (bfloat16): a 1000×900
    shape with a partial last block row and X rows past ``cols``, at
    k = 200 (a partial 128-column tile) and k = 70 (rows of X not whole
    16 bytes: the rule sends it to the 3xTF32 variant); a slice with its
    blocks shuffled out of row order; block row 1 left with no block; the
    K4 repack."""
    bf = torch.bfloat16
    big = bsr_random(25, (1000, 900), bs, 0.3, bf, device=DEVICE)
    for k in (200, 70):
        gate_bsr(f"K3 bs{bs} 1000x900 k={k} bfloat16", bsr_spmm_kernel, big,
                 rhs_block(900, k, bf, 26 + k), expect="tc" if k % 8 == 0 else "tf32x3")
    x = rhs_block(900, 200, bf, 27)
    gate_bsr(f"K3 bs{bs} sliced+unsorted bfloat16", bsr_spmm_kernel, unsorted_slice(big, 28), x,
             expect="tc")
    gate_bsr(f"K3 bs{bs} empty block row bfloat16", bsr_spmm_kernel, without_row_one(big), x,
             expect="tc")
    gate_bsr(f"K4 bs{bs} group 4 bfloat16", lambda b, v: bsr_spmm_grouped_kernel(b, v, 4),
             bsr_group(big, 4), x, counter=bsr_spmm_grouped_kernel, expect="tc")


def phase_gate(lap_spmv):
    k1_errs = []
    for dtype in (np.float32, np.float64):
        tdt = torch.float32 if dtype == np.float32 else torch.float64
        lap = grid_laplacian((64, 64), tdt, device=DEVICE)
        k1_errs.append(gate_spmv(f"K1 64x64 grid {tdt}", *laplacian_operand(lap, 1)))
        k1_errs.append(gate_spmv(f"K1 band 5000x4803 {BAND_OFFSETS} {tdt}",
                                 *banded_operand(5000, 4803, BAND_OFFSETS, dtype, 2)))
        # every operand of the block main paths and correctness solves:
        # the grid (expm), the Dirichlet Laplacian (LOBPCG), the band and
        # its transpose (svds' A and Aᵀ)
        band = band_dia(5000, 4803, BAND_OFFSETS, dtype, 3)
        for label, dia in (
            ("64x64 grid", dia_tile(lap.to_dia())),
            (f"{SOLVE_SIDE}^2 grid", dia_tile(grid_laplacian((SOLVE_SIDE,) * 2, tdt, device=DEVICE).to_dia())),
            (f"{SOLVE_SIDE}^2 dirichlet",
             dia_tile(dirichlet_laplacian((SOLVE_SIDE,) * 2, tdt, device=DEVICE).to_dia())),
            (f"band 5000x4803 {BAND_OFFSETS}", band),
            ("band transposed", dia_tile(dia_to_csmat(band).T.to_csr().to_dia())),
        ):
            for k in SPMM_WIDTHS:
                x = rhs_block(dia.cols, k, tdt, k)
                gate_spmm(f"K2 {label} k={k} {tdt}", dia, x)
                gate_spmm(f"K2 {label} k={k} {tdt} misaligned X", dia, misaligned_copy(x))
    for mat, label in (
        (grid_laplacian((SOLVE_SIDE,) * 2, device=DEVICE), "grid"),
        (dirichlet_laplacian((SOLVE_SIDE,) * 2, device=DEVICE), "dirichlet"),
    ):
        k1_errs.append(gate_spmv(f"K1 {SOLVE_SIDE}^2 {label} float64", *laplacian_operand(mat, 3)))
    spmv_err = gate_spmv(f"K1 {SPMV_SIDE}^2 grid float32", *lap_spmv)

    for tdt in (torch.float32, torch.bfloat16, torch.float64):
        # bs 8: odd shape, an empty block row, padding blocks; then a
        # slice whose blocks are shuffled out of row order; then grouped
        bsr = bsr_from_dense(odd_block_dense(tdt), 8, cap=40, device=DEVICE)
        sliced = bsr.slice_block_rows(8, 45)
        perm = torch.from_numpy(np.random.default_rng(21).permutation(sliced.cap)).to(DEVICE)
        unsorted = BsrMat(sliced.brows[perm], sliced.bcols[perm], sliced.blocks[perm],
                          sliced.shape, sliced.n_blocks)
        x = rhs_block(37, 70, tdt, 22)
        gate_bsr(f"K3 bs8 45x37 padded {tdt}", bsr_spmm_kernel, bsr, x)
        gate_bsr(f"K3 bs8 sliced+unsorted {tdt}", bsr_spmm_kernel, unsorted, x)
        gate_bsr(f"K3 bs8 spmv {tdt}", bsr_spmm_kernel, bsr, x[:, :1].contiguous())
        gate_bsr(f"K4 bs8 group 4 {tdt}", lambda b, v: bsr_spmm_grouped_kernel(b, v, 4),
                 bsr_group(bsr, 4), x, counter=bsr_spmm_grouped_kernel)
        # bs 128 at an odd size (bfloat16: the tensor-core variant)
        big = bsr_random(23, (1000, 900), 128, 0.3, tdt, device=DEVICE)
        xb = rhs_block(900, 200, tdt, 24)
        gate_bsr(f"K3 bs128 1000x900 {tdt}", bsr_spmm_kernel, big, xb)
        gate_bsr(f"K4 bs128 group 4 {tdt}", lambda b, v: bsr_spmm_grouped_kernel(b, v, 4),
                 bsr_group(big, 4), xb, counter=bsr_spmm_grouped_kernel)
    for bs in TC_BLOCK_SIZES:
        gate_tc(bs)
    for tdt in (torch.float32, torch.float64):
        for bs in TF32_BLOCK_SIZES:
            gate_tf32x3(bs, tdt)
        for bs in (16, 128):
            wide = wide_magnitude(bsr_random(85, (1000, 900), bs, 0.3, tdt, device=DEVICE), 86)
            gate_bsr(f"K3 bs{bs} magnitudes 2^-20..2^20 {tdt}", bsr_spmm_kernel, wide,
                     rhs_block(900, 256, tdt, 87), expect="tf32x3")
        gate_nonfinite(tdt)
    grad = gate_grads()
    errs = {name: max(v) for name, v in GATE_ERRS.items()}
    errs["dia_spmv"] = max(k1_errs + [spmv_err, grad["K1"]])
    return errs


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------


def time_ms(fn, reps):
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    sync()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    sync()
    return start.elapsed_time(end) / reps


def device_ms(fn, key, reps):
    """The profiler's device time per launch of the kernels whose name
    holds ``key`` over ``reps`` calls of ``fn`` (the time of the kernel
    alone, without the wrapper's host cost that back-to-back calls may
    expose in ``time_ms``).  The average is over the launches the trace
    recorded, which may miss one of a run; a trace that recorded none is
    taken again, up to three times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    sync()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            sync()
        events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA and key in e.key]
        launches = sum(e.count for e in events)
        if launches:
            break
    if not 0 < launches <= reps:
        raise AssertionError(f"device_ms: {launches} launches of {key!r} for {reps} calls")
    return sum(e.self_device_time_total for e in events) / 1e3 / launches


def bound(nbytes, flops, peak):
    """Least time in ms: every input byte read once and every output byte
    written once at the HBM rate, or the operations at the peak."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def timing_row(label, ms, plain_ms, library_ms, nbytes, flops, peak, **extra):
    b_ms, b_by = bound(nbytes, flops, peak)
    row = {
        "shape": label,
        "ms": ms,
        "plain_ms": plain_ms,
        "library_ms": library_ms,
        "bound_ms": b_ms,
        "bound_by": b_by,
        "bytes": nbytes,
        "flops": flops,
        "roofline_share": b_ms / ms,
        **extra,
    }
    log(f"timing {json.dumps(row)}")
    return row


def timing_spmv(label, mat, dia, x, reps):
    ms = time_ms(lambda: dia_spmv_kernel(dia, x), reps)
    plain_ms = time_ms(lambda: dia_spmv_plain(dia, x), max(reps // 5, 3))
    csr = csr_twin(mat)
    lib_err = float((torch.mv(csr, x) - dia_spmv_plain(dia, x)).abs().max())
    library_ms = time_ms(lambda: torch.mv(csr, x), reps)
    nbytes = (dia.data.numel() + x.numel() + dia.rows) * dia.data.element_size()
    flops = 2 * dia.n_diags * dia.rows
    return timing_row(label, ms, plain_ms, library_ms, nbytes, flops, PEAK_FLOPS[dia.dtype],
                      kernel="dia_spmv", library="torch.mv (CSR)", library_max_abs_err=lib_err)


def timing_spmm(label, mat, dia, x, reps):
    ms = time_ms(lambda: dia_spmm_kernel(dia, x), reps)
    dev_ms = device_ms(lambda: dia_spmm_kernel(dia, x), "dia_spmm_kernel", reps)
    plain_ms = time_ms(lambda: dia_spmm_plain(dia, x), max(reps // 5, 3))
    csr = csr_twin(mat)
    lib_err = float((torch.sparse.mm(csr, x) - dia_spmm_kernel(dia, x)).abs().max())
    library_ms = time_ms(lambda: torch.sparse.mm(csr, x), reps)
    k = x.shape[1]
    nbytes = (dia.data.numel() + x.numel() + dia.rows * k) * dia.data.element_size()
    flops = 2 * dia.n_diags * dia.rows * k
    kind = k2.variant(k, x.element_size(), x.data_ptr())
    return timing_row(label, ms, plain_ms, library_ms, nbytes, flops, PEAK_FLOPS[dia.dtype],
                      kernel=f"dia_spmm_{kind}", device_ms=dev_ms,
                      library="torch.sparse.mm (CSR)", library_max_abs_err=lib_err)


def torch_bsr_twin(bsr):
    row_ptr, order = bsr.row_order
    idx = order.to(torch.int64)
    return torch.sparse_bsr_tensor(
        row_ptr, bsr.bcols[idx], bsr.blocks[idx], size=bsr.shape
    )


def bsr_peak(kind, dtype):
    """The operation rate K3's bound takes: the bf16 tensor cores for the
    wgmma variant; for the 3xTF32 variant the TF32 tensor cores over its
    passes (three; one for bfloat16)."""
    if kind == "tc":
        return BF16_TC_FLOPS
    return TF32_TC_FLOPS / (1 if dtype == torch.bfloat16 else 3)


def timing_bsr(label, name, fn, bsr, x, reps, product=None):
    """``product``: the matrix whose product ``fn`` computes, where
    ``bsr`` is a repack of it with zero padding blocks; the bound counts
    the product's blocks, not the padding."""
    kind = k3.variant(x.dtype, bsr.block_size, x.shape[1], x.data_ptr(), bsr.blocks.data_ptr())
    ms = time_ms(lambda: fn(bsr, x), reps)
    dev_ms = device_ms(lambda: fn(bsr, x), f"bsr_spmm_{kind}_kernel", reps)
    plain_ms = time_ms(lambda: bsr_spmm_plain(bsr, x), max(reps // 5, 3))
    dense = bsr.to_dense()
    library_ms = time_ms(lambda: torch.matmul(dense, x), reps)
    del dense
    try:
        twin = torch_bsr_twin(bsr)
        lib_bsr_err = float((twin @ x - fn(bsr, x)).float().abs().max())
        lib_bsr_ms = time_ms(lambda: twin @ x, reps)
        lib_bsr = None
    except Exception as e:  # torch's own BSR product: not every type runs
        lib_bsr_err = lib_bsr_ms = None
        lib_bsr = f"{type(e).__name__}: {str(e).splitlines()[0][:160]}"
    k = x.shape[1]
    size = x.element_size()
    bs = bsr.block_size
    n_blocks = (bsr if product is None else product).n_blocks
    nbytes = (n_blocks * bs * bs + bsr.cols * k + bsr.rows * k) * size
    flops = 2 * n_blocks * bs * bs * k
    return timing_row(label, ms, plain_ms, library_ms, nbytes, flops, bsr_peak(kind, x.dtype),
                      kernel=name, variant=kind, device_ms=dev_ms, library="torch.matmul (dense A)",
                      torch_bsr_ms=lib_bsr_ms, torch_bsr_max_abs_err=lib_bsr_err,
                      torch_bsr_error=lib_bsr, n_blocks=bsr.n_blocks,
                      block_density=bsr.block_density)


def phase_timing(lap_spmv, spmv_operand):
    rows = {}
    rows["dia_spmv"] = timing_spmv(f"{SPMV_SIDE}^2 grid float32", lap_spmv, *spmv_operand, reps=50)
    lap_solve = grid_laplacian((SOLVE_SIDE,) * 2, device=DEVICE)
    timing_spmv(f"{SOLVE_SIDE}^2 grid float64", lap_solve, *laplacian_operand(lap_solve, 4), reps=200)
    lap_small = grid_laplacian((64, 64), device=DEVICE)
    timing_spmv("64^2 grid float64", lap_small, *laplacian_operand(lap_small, 5), reps=2000)

    lap2 = grid_laplacian(SPMM_GRID, torch.float32, device=DEVICE)
    dia2 = dia_tile(lap2.to_dia())
    rows["dia_spmm_vector"] = timing_spmm(
        f"{SPMM_GRID[0]}x{SPMM_GRID[1]} grid float32 k=128", lap2, dia2,
        rhs_block(dia2.cols, 128, torch.float32, 30), reps=20,
    )
    del lap2, dia2
    dia_solve = dia_tile(lap_solve.to_dia())
    for k in (24, 48, 256):
        timing_spmm(f"{SOLVE_SIDE}^2 grid float64 k={k}", lap_solve, dia_solve,
                    rhs_block(dia_solve.cols, k, torch.float64, 31 + k), reps=20)
    rows["dia_spmm_scalar"] = timing_spmm(
        f"{SOLVE_SIDE}^2 grid float64 k={EXPM_FEW_SOURCES}", lap_solve, dia_solve,
        rhs_block(dia_solve.cols, EXPM_FEW_SOURCES, torch.float64, 34), reps=50,
    )

    for density in BSR_DENSITIES:
        bsr = bsr_random(40, (BSR_N, BSR_N), BSR_BS, density, torch.bfloat16, device=DEVICE)
        x = rhs_block(BSR_N, BSR_K, torch.bfloat16, 41)
        row = timing_bsr(f"n={BSR_N} k={BSR_K} bs={BSR_BS} density {density} bfloat16",
                         "bsr_spmm", bsr_spmm_kernel, bsr, x, reps=50)
        if density == BSR_DENSITIES[0]:
            rows["bsr_spmm_tc"] = row
            grouped = bsr_group(bsr, BSR_GROUP)
            rows["bsr_spmm_grouped"] = timing_bsr(
                f"n={BSR_N} k={BSR_K} bs={BSR_BS} density {density} bfloat16 group {BSR_GROUP}",
                "bsr_spmm_grouped",
                lambda b, v: bsr_spmm_grouped_kernel(b, v, BSR_GROUP), grouped, x, reps=50,
                product=bsr,
            )
    tf32 = []
    for tdt in (torch.float32, torch.float64):
        bsr = bsr_random(40, (BSR_N, BSR_N), BSR_BS, BSR_DENSITIES[0], tdt, device=DEVICE)
        tf32.append(timing_bsr(
            f"n={BSR_N} k={BSR_K} bs={BSR_BS} density {BSR_DENSITIES[0]} {tdt}", "bsr_spmm",
            bsr_spmm_kernel, bsr, rhs_block(BSR_N, BSR_K, tdt, 41), reps=20,
        ))
    for tdt, row in ((torch.bfloat16, rows["bsr_spmm_tc"]), (torch.float32, tf32[0])):
        bsr = bsr_random(42, (BSR_BIG_N, BSR_BIG_N), BSR_BS, BSR_DENSITIES[0], tdt, device=DEVICE)
        x = rhs_block(BSR_BIG_N, BSR_K, tdt, 43)
        big = timing_bsr(f"n={BSR_BIG_N} k={BSR_K} bs={BSR_BS} density {BSR_DENSITIES[0]} {tdt}",
                         "bsr_spmm", bsr_spmm_kernel, bsr, x, reps=20)
        row.setdefault("other_shapes", []).append(big)
    rows["bsr_spmm_tf32x3"] = tf32[0]
    tf32[0]["other_shapes"].insert(0, tf32[1])
    return rows


# ---------------------------------------------------------------------------
# main paths
# ---------------------------------------------------------------------------


def check_solution(name, res, a_dia, b, launches, expected):
    true_res = float(torch.linalg.vector_norm(b - dia_spmv_plain(a_dia, res.x)))
    b_norm = float(torch.linalg.vector_norm(b))
    log(
        f"{name}: iterations {res.iterations} converged {res.converged} "
        f"true residual {true_res!r} (limit {SOLVE_TOL * b_norm!r}) "
        f"K1 launches {launches} (expected {expected})"
    )
    if not res.converged:
        raise AssertionError(f"{name} did not converge in {res.iterations} iterations")
    if not bool(torch.isfinite(res.x).all()) or res.x.shape != b.shape:
        raise AssertionError(f"{name}: bad solution")
    if not true_res <= SOLVE_TOL * b_norm:
        raise AssertionError(f"{name}: true residual {true_res} > {SOLVE_TOL * b_norm}")
    if launches != expected:
        raise AssertionError(f"{name}: K1 launched {launches} times, expected {expected}")


def check_small_against_dense():
    """BiCGSTAB and CG on 32x32 grids on the card against numpy's dense
    solve.  Both solves stop at a residual of 1e-8·‖b‖ and the operators'
    condition numbers are about 440, so x may differ from the dense
    solution by about 4.4e-6 of max|x|: the limit is 1e-5.  (Iteration
    counts may differ from a CPU run by a few: BiCGSTAB amplifies the
    rounding of reductions taken in another order.)"""
    side = 32
    n = side * side
    rhs = np.zeros(n)
    rhs[(side // 2) * side + side // 2] = 1.0
    for name, solver, make in (
        ("bicgstab", bicgstab, grid_laplacian),
        ("cg", cg, dirichlet_laplacian),
    ):
        a = make((side, side), device=DEVICE)
        res = solver(a, rhs, tol=SOLVE_TOL, max_iter=MAX_ITER)
        ref = np.linalg.solve(a.to_dense().cpu().numpy(), rhs)
        rel = float(np.abs(res.x.cpu().numpy() - ref).max() / np.abs(ref).max())
        log(f"small {name} 32x32 vs dense solve: iterations {res.iterations} rel err {rel!r}")
        if not (res.converged and rel <= 1e-5):
            raise AssertionError(f"small {name}: rel err {rel}, converged {res.converged}")


def phase_main_spmv():
    side = SOLVE_SIDE
    n = side * side
    lap = grid_laplacian((side, side), device=DEVICE)
    rhs = torch.zeros(n, dtype=torch.float64, device=DEVICE)
    rhs[(side // 2) * side + side // 2] = 1.0
    spd = dirichlet_laplacian((side, side), device=DEVICE)
    spd_dia = spd.to_dia()
    b = dia_spmv_plain(spd_dia, torch.ones(n, dtype=torch.float64, device=DEVICE))
    lap_dia = lap.to_dia()
    for label, mat in (("grid", lap), ("dirichlet", spd)):
        t0 = time.perf_counter()
        prepare_spmv(mat)
        log(f"prepare_spmv {side}^2 {label}: {time.perf_counter() - t0!r} s")
    sync()

    dia_spmv_kernel.launches = 0
    t0 = time.perf_counter()
    res_b = bicgstab(lap, rhs, tol=SOLVE_TOL, max_iter=MAX_ITER)
    sync()
    wall_b = time.perf_counter() - t0
    launches_b = dia_spmv_kernel.launches
    t0 = time.perf_counter()
    res_c = cg(spd, b, tol=SOLVE_TOL, max_iter=MAX_ITER)
    sync()
    wall_c = time.perf_counter() - t0
    launches = dia_spmv_kernel.launches

    log(f"bicgstab {side}^2 float64: wall {wall_b!r} s (prepare_spmv included)")
    check_solution("bicgstab", res_b, lap_dia, rhs, launches_b, 3 * res_b.iterations + 2)
    log(f"cg {side}^2 float64: wall {wall_c!r} s (prepare_spmv included)")
    check_solution("cg", res_c, spd_dia, b, launches - launches_b, res_c.iterations + 2)
    if launches == 0:
        raise AssertionError("the SpMV main path launched no K1 kernel")
    return launches, lap, rhs


def profile_window(label, run, kernel_key):
    """Device busy share of ``run`` (set-up excluded): torch.profiler over
    one run, the same run timed untraced beside it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def timed():
        t0 = time.perf_counter()
        run()
        sync()
        return (time.perf_counter() - t0) * 1e3

    timed()
    untraced_ms = timed()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        traced_ms = timed()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    kernel_ms = sum(e.self_device_time_total for e in kernels if kernel_key in e.key) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    row = {
        "untraced_ms": untraced_ms,
        "traced_ms": traced_ms,
        "device_busy_ms": busy_ms,
        "device_idle_share": 1.0 - busy_ms / traced_ms,
        f"{kernel_key}_ms": kernel_ms,
        "top_kernels": [[e.key[:60], e.count, e.self_device_time_total / 1e3] for e in top],
    }
    log(f"profile {label} {json.dumps(row)}")
    return row


def phase_profile_bicgstab(lap, rhs):
    fn, prepared = prepare_spmv(lap)
    profile_window(
        f"bicgstab {SOLVE_SIDE}^2 float64, {PROFILE_ITERS} iterations",
        lambda: bicgstab(lambda v: fn(prepared, v), rhs, tol=SOLVE_TOL, max_iter=PROFILE_ITERS),
        "dia_spmv",
    )


def reset_counts():
    for fn in (dia_spmv_kernel, dia_spmm_kernel, bsr_spmm_kernel, bsr_spmm_grouped_kernel,
               ell_spmv_kernel, sort_rows_kernel):
        fn.launches = 0
    dia_spmm_kernel.launches_vector = dia_spmm_kernel.launches_scalar = 0
    for fn in (bsr_spmm_kernel, bsr_spmm_grouped_kernel):
        fn.launches_tc = fn.launches_tf32x3 = 0
    for fn in (dia_spmv_plain, dia_spmm_plain, bsr_spmm_plain, ell_spmv_plain, sort_rows_plain):
        fn.calls = 0


def check_expm(label, lap, B, y, launches):
    """``y`` = expm_multiply(lap, B, t=-1) against the same call over the
    plain version on the card.  The callable computes 2A·v with t/2:
    expm_multiply's fixed budget for a callable (‖A‖₁ = 16) then gives
    the CsMat path's substeps (norm(1) = 8), and the arithmetic is the
    same term for term, since scaling by 2 is exact.  So its call count
    is the SpMM count that K2's launches must equal."""
    ref_dia = lap.to_dia()
    ref_calls = [0]

    def ref_op(v):
        ref_calls[0] += 1
        return 2.0 * dia_spmm_plain(ref_dia, v)

    ref = expm_multiply(ref_op, B, t=-0.5)
    sync()
    if y.shape != B.shape or not bool(torch.isfinite(y).all()):
        raise AssertionError(f"expm {label}: bad output")
    rel = float((y - ref).abs().max()) / float(ref.abs().max())
    log(f"expm {label} vs plain reference: rel {rel!r} (limit 1e-10), reference SpMMs {ref_calls[0]}")
    if not rel <= 1e-10:
        raise AssertionError(f"expm {label}: rel {rel} > 1e-10")
    if launches != ref_calls[0] or launches == 0:
        raise AssertionError(f"expm {label}: K2 launched {launches} times for {ref_calls[0]} SpMMs")
    # heat from unit sources: mass stays in [0, 1] per column
    col_sums = y.sum(0)
    if not bool(((col_sums > 0) & (col_sums <= 1.0 + 1e-9)).all()):
        raise AssertionError(f"expm {label}: column sums outside (0, 1]")


def phase_main_block():
    """The block solvers through prepare_spmm and K2 (see the module
    note).  Returns the launches of K2's two variants over this path."""
    side = SOLVE_SIDE
    n = side * side
    lap = grid_laplacian((side, side), device=DEVICE)
    anorm = float(lap.norm(1))
    if anorm != 8.0:
        raise AssertionError(f"norm(1) of the grid Laplacian is {anorm}, expected 8")
    src = np.random.default_rng(50).choice(n, EXPM_SOURCES, replace=False)
    B = torch.zeros((n, EXPM_SOURCES), dtype=torch.float64, device=DEVICE)
    B[torch.from_numpy(src).to(DEVICE), torch.arange(EXPM_SOURCES, device=DEVICE)] = 1.0
    B_few = B[:, :EXPM_FEW_SOURCES].contiguous()
    spd = dirichlet_laplacian((side, side), device=DEVICE)
    x0 = rhs_block(n, LOBPCG_M, torch.float64, 51)
    for label, mat in (("grid", lap), ("dirichlet", spd)):
        t0 = time.perf_counter()
        prepare_spmm(mat)
        sync()
        log(f"prepare_spmm {side}^2 {label}: {time.perf_counter() - t0!r} s")

    reset_counts()
    t0 = time.perf_counter()
    y = expm_multiply(lap, B, t=-1.0)
    sync()
    wall_e = time.perf_counter() - t0
    expm_launches = dia_spmm_kernel.launches
    t0 = time.perf_counter()
    res = lobpcg(spd, x0, tol=0.0, max_iter=LOBPCG_FIXED_ITERS)
    sync()
    wall_l = time.perf_counter() - t0
    launches = dia_spmm_kernel.launches
    lobpcg_launches = launches - expm_launches
    t0 = time.perf_counter()
    y_few = expm_multiply(lap, B_few, t=-1.0)
    sync()
    wall_f = time.perf_counter() - t0
    few_launches = dia_spmm_kernel.launches - launches
    plain_calls = dia_spmm_plain.calls
    variants = {"dia_spmm_vector": dia_spmm_kernel.launches_vector,
                "dia_spmm_scalar": dia_spmm_kernel.launches_scalar}
    log(
        f"expm_multiply {side}^2 grid float64, {EXPM_SOURCES} sources, t=-1: wall {wall_e!r} s "
        f"(prepare_spmm included), K2 launches {expm_launches}"
    )
    log(
        f"lobpcg {side}^2 dirichlet float64 m={LOBPCG_M}, {res.iterations} iterations: wall "
        f"{wall_l!r} s (prepare_spmm included), {wall_l / max(res.iterations, 1) * 1e3!r} ms per "
        f"iteration, K2 launches {lobpcg_launches} (expected {2 * LOBPCG_FIXED_ITERS + 2})"
    )
    log(
        f"expm_multiply {side}^2 grid float64, {EXPM_FEW_SOURCES} sources, t=-1: wall {wall_f!r} s, "
        f"K2 launches {few_launches}; K2 launches by variant {variants}"
    )
    if plain_calls != 0:
        raise AssertionError(f"the plain dia_spmm ran {plain_calls} times on the main path")
    if variants != {"dia_spmm_vector": launches, "dia_spmm_scalar": few_launches}:
        raise AssertionError(f"K2 variants: {variants}, expected {launches} vector and "
                             f"{few_launches} scalar launches")
    if res.iterations != LOBPCG_FIXED_ITERS or lobpcg_launches != 2 * LOBPCG_FIXED_ITERS + 2:
        raise AssertionError(f"lobpcg: {res.iterations} iterations, {lobpcg_launches} K2 launches")
    if not bool(torch.isfinite(res.eigenvalues).all()) or res.eigenvectors.shape != (n, LOBPCG_M):
        raise AssertionError("lobpcg: bad result")

    check_expm(f"{EXPM_SOURCES} sources", lap, B, y, expm_launches)
    check_expm(f"{EXPM_FEW_SOURCES} sources", lap, B_few, y_few, few_launches)

    fn, prepared = prepare_spmm(spd)
    profile_window(
        f"lobpcg {side}^2 float64 m={LOBPCG_M}, {LOBPCG_FIXED_ITERS} iterations",
        lambda: lobpcg(lambda v: fn(prepared, v), x0, tol=0.0, max_iter=LOBPCG_FIXED_ITERS),
        "dia_spmm",
    )
    return variants


def phase_main_bsr():
    """Block-sparse products at the JAX bench's shape: ``BsrMat @ X``
    (K3, wgmma) and the grouped product (K4), four of each, in bfloat16;
    then ``BsrMat @ X`` in float32 (K3, 3xTF32), two."""
    bsr = bsr_random(60, (BSR_N, BSR_N), BSR_BS, BSR_DENSITIES[0], torch.bfloat16, device=DEVICE)
    grouped = bsr_group(bsr, BSR_GROUP)
    x = rhs_block(BSR_N, BSR_K, torch.bfloat16, 61)
    want = bsr.to_dense().float() @ x.float()
    bsr32 = bsr_random(62, (BSR_N, BSR_N), BSR_BS, BSR_DENSITIES[0], torch.float32, device=DEVICE)
    x32 = rhs_block(BSR_N, BSR_K, torch.float32, 63)
    want32 = bsr32.to_dense() @ x32
    sync()
    reset_counts()
    t0 = time.perf_counter()
    ys = [bsr @ x for _ in range(4)]
    ys += [bsr_spmm_grouped_kernel(grouped, x, group=BSR_GROUP) for _ in range(4)]
    ys32 = [bsr32 @ x32 for _ in range(2)]
    sync()
    wall = time.perf_counter() - t0
    launches = {
        "bsr_spmm_tc": bsr_spmm_kernel.launches_tc,
        "bsr_spmm_tf32x3": bsr_spmm_kernel.launches_tf32x3,
        "bsr_spmm_grouped": bsr_spmm_grouped_kernel.launches_tc,
    }
    others = bsr_spmm_grouped_kernel.launches_tf32x3 + bsr_spmm_plain.calls
    log(f"bsr main path n={BSR_N} k={BSR_K} bs={BSR_BS} bfloat16 and float32: wall {wall!r} s, "
        f"launches {launches}, K4 on the 3xTF32 variant and plain calls {others}")
    expected = {"bsr_spmm_tc": 4, "bsr_spmm_tf32x3": 2, "bsr_spmm_grouped": 4}
    if launches != expected or others != 0:
        raise AssertionError(f"bsr: launches {launches}, expected {expected}; others {others}")
    for y, ref, dtype, limit in [(y, want, torch.bfloat16, 2.0**-7) for y in ys] + [
        (y, want32, torch.float32, 1e-5) for y in ys32
    ]:
        if y.dtype != dtype or y.shape != ref.shape:
            raise AssertionError("bsr: bad output")
        err = float((y.float() - ref).abs().max())
        scale = float(ref.abs().max())
        if not err <= limit * scale:
            raise AssertionError(f"bsr {dtype}: {err} against the dense product (limit {limit * scale})")
    return launches


def phase_eigen_checks():
    """LOBPCG against the closed-form Dirichlet eigenvalues and svds
    against torch.linalg.svdvals, with exact K2 launch counts."""
    side = EIG_SIDE
    spd = dirichlet_laplacian((side, side), device=DEVICE)
    x0 = rhs_block(side * side, LOBPCG_M, torch.float64, 70)
    dia_spmm_kernel.launches = 0
    t0 = time.perf_counter()
    res = lobpcg(spd, x0, tol=1e-6, max_iter=EIG_MAX_ITER)
    sync()
    wall = time.perf_counter() - t0
    h = np.pi / (side + 1)
    closed = sorted(4 - 2 * math.cos(i * h) - 2 * math.cos(j * h)
                    for i in range(1, 6) for j in range(1, 6))[:LOBPCG_M]
    err = float(np.abs(res.eigenvalues.cpu().numpy() - np.array(closed)).max())
    launches = dia_spmm_kernel.launches
    log(f"lobpcg {side}^2 m={LOBPCG_M} tol 1e-6: iterations {res.iterations} converged "
        f"{res.converged} wall {wall!r} s, max eigenvalue error {err!r} (limit 1e-6), "
        f"K2 launches {launches} (expected {2 * res.iterations + 2})")
    if not (res.converged and err <= 1e-6 and launches == 2 * res.iterations + 2):
        raise AssertionError("lobpcg correctness solve failed")

    band = dia_to_csmat(band_dia(5000, 4803, BAND_OFFSETS, np.float64, 71))
    dia_spmm_kernel.launches = 0
    t0 = time.perf_counter()
    sv = svds(band, k=4, max_iter=SVDS_MAX_ITER)
    sync()
    wall = time.perf_counter() - t0
    launches = dia_spmm_kernel.launches
    ref = torch.linalg.svdvals(band.to_dense())[:4]
    rel = float((sv.s - ref).abs().max() / ref[0])
    log(f"svds k=4 band 5000x4803: iterations {sv.iterations} converged {sv.converged} wall "
        f"{wall!r} s, rel error {rel!r} (limit 1e-8), K2 launches {launches} "
        f"(expected {4 * sv.iterations + 5})")
    if not (sv.converged and rel <= 1e-8 and launches == 4 * sv.iterations + 5):
        raise AssertionError("svds correctness solve failed")


# ---------------------------------------------------------------------------
# the unstructured slice: K5 (ELL SpMV) and K6 (row sort)
# ---------------------------------------------------------------------------


def permuted_mesh(side, seed=0):
    """A regular triangulation of a side×side vertex grid (two triangles
    per cell) with labels permuted by ``default_rng(seed)``: (n, triangles,
    label of the grid's centre vertex)."""
    ii, jj = np.meshgrid(np.arange(side - 1), np.arange(side - 1), indexing="ij")
    v = (ii * side + jj).ravel()
    tri = np.concatenate([np.stack([v, v + 1, v + side], 1),
                          np.stack([v + 1, v + side + 1, v + side], 1)])
    perm = np.random.default_rng(seed).permutation(side * side)
    return side * side, perm[tri], int(perm[(side // 2) * side + side // 2])


def mesh_step(n, tri):
    """(L, A = I + τL) assembled on the card through the port's triplet
    builder, ``eye`` and the sparse ``+`` and ``*``, with the seconds of
    each part."""
    sync()
    t0 = time.perf_counter()
    lap = tri_mesh_graph_laplacian(n, tri, device=DEVICE)
    sync()
    t1 = time.perf_counter()
    a = eye(n, dtype=torch.float64, device=DEVICE) + lap * MESH_TAU
    sync()
    return lap, a, {"assembly_s": t1 - t0, "binop_s": time.perf_counter() - t1}


def scipy_mesh_step(n, tri):
    """The same L and A from the triangles by scipy, independently of the
    port: adjacency from the three edges of each triangle, duplicates
    merged."""
    import scipy.sparse as sp

    u = np.concatenate([tri[:, 0], tri[:, 1], tri[:, 0]])
    v = np.concatenate([tri[:, 1], tri[:, 2], tri[:, 2]])
    adj = sp.coo_matrix((np.ones(2 * u.size), (np.concatenate([u, v]), np.concatenate([v, u]))),
                        shape=(n, n)).tocsr()
    adj.data[:] = 1.0
    lap = (sp.diags(np.diff(adj.indptr).astype(np.float64)) - adj).tocsr()
    a = (sp.identity(n, format="csr") + MESH_TAU * lap).tocsr()
    for m in (lap, a):
        m.sort_indices()
    return lap, a


def check_against_scipy(name, mat, ref):
    nnz = mat.nnz
    indptr = mat.indptr.cpu().numpy()
    indices = mat.indices[:nnz].cpu().numpy()
    data = mat.data[:nnz].cpu().numpy()
    if not (np.array_equal(indptr, ref.indptr) and np.array_equal(indices, ref.indices)):
        raise AssertionError(f"{name}: structure differs from scipy's")
    err = float(np.abs(data - ref.data).max())
    log(f"{name} vs scipy: nnz {nnz}, indptr and indices equal, data max_abs_err {err!r} (limit 1e-15 of max)")
    if not err <= 1e-15 * float(np.abs(ref.data).max()):
        raise AssertionError(f"{name}: data differs from scipy's by {err}")


def random8_operand():
    """(CsMat, EllMat, x) of the JAX package's "random8" ELL shape, f32,
    assembled on the card by ``coo_to_csmat``."""
    rng = np.random.default_rng(80)
    n = RANDOM8_N
    rows = np.repeat(np.arange(n, dtype=np.int32), RANDOM8_SLOTS)
    cols = rng.integers(0, n, rows.size).astype(np.int32)
    vals = rng.random(rows.size, np.float32)
    mat = coo_to_csmat(rows, cols, vals, (n, n), device=DEVICE)
    x = torch.from_numpy(rng.random(n, np.float32)).to(DEVICE)
    return mat, ell_from_csmat(mat), x


def small_ells():
    """Odd ELL operands: 45 rows (a multiple of no group's rows per
    pass), an empty row, width 1, a rectangular shape, rows wider than 32
    slots."""
    rng = np.random.default_rng(81)
    width1 = np.zeros((45, 37))
    for r in range(45):
        if r != 7:
            width1[r, rng.integers(37)] = rng.standard_normal()
    wide = rng.standard_normal((45, 37))
    wide[rng.random((45, 37)) > 0.15] = 0.0
    wide[3] = 0.0
    wider = rng.standard_normal((45, 120))
    wider[rng.random((45, 120)) > 0.45] = 0.0
    out = []
    for dtype in (torch.float32, torch.float64):
        for label, d in (("45x37 width 1, empty row", width1), ("45x37 random, empty row", wide),
                         ("45x120 rows over 32 slots", wider)):
            ell = from_dense(torch.from_numpy(d).to(dtype), device=DEVICE).to_ell()
            x = torch.from_numpy(rng.standard_normal(d.shape[1])).to(DEVICE, dtype)
            out.append((f"{label} {dtype}", ell, x))
    if out[2][1].width <= 32:
        raise AssertionError(f"gate: the wide ELL has width {out[2][1].width}")
    return out


def gate_ell(name, ell, x):
    y = ell_spmv_kernel(ell, x)
    ref = ell_spmv_plain(ell, x)
    sync()
    if y.shape != (ell.rows,) or not bool(torch.isfinite(y).all()):
        raise AssertionError(f"gate {name}: bad output {tuple(y.shape)}")
    err = float((y - ref).abs().max())
    return check_rel(name, err, float(ref.abs().max()), GATE_LIMIT[ell.dtype])


def gate_ell_nonfinite(name, ell, x):
    """K5 with x[0] non-finite: every pad slot adds 0·x[0], so NaN and
    inf land where the plain version puts them; the finite entries agree
    within the gate's limit."""
    y = ell_spmv_kernel(ell, x)
    ref = ell_spmv_plain(ell, x)
    sync()
    fin = torch.isfinite(ref)
    same = torch.equal(torch.isnan(y), torch.isnan(ref)) and torch.equal(
        torch.isinf(y), torch.isinf(ref)) and torch.equal(y[torch.isinf(ref)], ref[torch.isinf(ref)])
    log(f"gate {name}: non-finite entries where plain has them {same} "
        f"({int((~fin).sum())} of {ref.numel()})")
    if not same or bool(fin.all()):
        raise AssertionError(f"gate {name}: non-finite entries differ from plain's")
    err = float((y[fin] - ref[fin]).abs().max()) if bool(fin.any()) else 0.0
    return check_rel(name, err, float(ref[fin].abs().max()) if bool(fin.any()) else 1.0,
                     GATE_LIMIT[ell.dtype])


def gate_grad_ell():
    """K5's backward on the card against torch's autograd of the plain
    version on the CPU (float64, a small odd ELL)."""
    _, ell, x = small_ells()[4]
    g = rhs_block(ell.rows, 1, torch.float64, 82)[:, 0]
    data = ell.data.clone().requires_grad_(True)
    xg = x.clone().requires_grad_(True)
    dd, dx = torch.autograd.grad(ell_spmv_kernel(EllMat(ell.indices, data, ell.shape), xg), (data, xg), g)
    data_c = ell.data.cpu().requires_grad_(True)
    x_c = x.cpu().requires_grad_(True)
    y_c = ell_spmv_plain(EllMat(ell.indices.cpu(), data_c, ell.shape), x_c)
    dd_c, dx_c = torch.autograd.grad(y_c, (data_c, x_c), g.cpu())
    err = max(float((dd.cpu() - dd_c).abs().max()), float((dx.cpu() - dx_c).abs().max()))
    log(f"gate grad K5 (45x37, float64): max_abs_err {err!r}")
    if not err <= 1e-12:
        raise AssertionError(f"gate grad K5: {err}")
    return err


def sort_case(rows, kind, seed):
    rng = np.random.default_rng(seed)
    if kind == "int32":
        keys = rng.integers(0, 1 << 30, (rows, 128)).astype(np.int32)
    elif kind == "ties":
        keys = rng.integers(0, 8, (rows, 128)).astype(np.int32)
    elif kind == "zeros":  # float ties, +0.0 against -0.0 among them
        keys = rng.choice(np.array([-1.0, -0.0, 0.0, 1.0, 2.0], np.float32), (rows, 128))
    elif kind == "nan":  # NaN and inf bit patterns among the numbers
        keys = rng.standard_normal((rows, 128)).astype(np.float32)
        odd = np.array(NAN_AND_INF_BITS, np.uint32).view(np.float32)
        pick = rng.random((rows, 128)) < 0.2
        keys[pick] = rng.choice(odd, int(pick.sum()))
    else:
        keys = rng.standard_normal((rows, 128)).astype(np.float32)
    vals = rng.random((rows, 128)).astype(np.float32)
    return torch.from_numpy(keys).to(DEVICE), torch.from_numpy(vals).to(DEVICE)


# +NaN with every mantissa bit set (the largest int of the order map), the
# quiet NaN, their negatives (-NaN sorts first), +-inf, +-0.0
NAN_AND_INF_BITS = (0x7FFFFFFF, 0x7FC00000, 0xFFFFFFFF, 0xFFC00000, 0x7F800000, 0xFF800000,
                    0x00000000, 0x80000000)


def gate_sort(name, keys, vals, on_cpu=False):
    """K6 against its plain version bit for bit (keys and values), and the
    keys against ``torch.sort`` as numbers (it may put +0.0 and -0.0 in
    either order) where no key is NaN (it puts every NaN last).
    ``on_cpu``: also against the plain version on the CPU, which shows
    that the function does not depend on the device."""
    ks, vs = sort_rows_kernel(keys, vals)
    pk, pv = sort_rows_plain(keys, vals)
    nan = bool(torch.isnan(keys).any())
    lib = None if nan else torch.sort(keys, dim=1).values
    sync()
    bits = [t.view(torch.int32) for t in (ks, pk, vs, pv)]
    same = torch.equal(bits[0], bits[1]) and torch.equal(bits[2], bits[3])
    if on_cpu:
        ck, cv = sort_rows_plain(keys.cpu(), vals.cpu())
        same = same and torch.equal(bits[0].cpu(), ck.view(torch.int32)) and torch.equal(
            bits[2].cpu(), cv.view(torch.int32))
    num = torch.isfinite(pk)  # NaN and inf keys count by their bits above
    err = max(float((ks[num].double() - pk[num].double()).abs().nan_to_num(float("inf")).max()),
              float((vs.double() - pv.double()).abs().max()))
    lib_same = "not compared (NaN keys)" if nan else torch.equal(ks, lib)
    log(f"gate K6 {name}: equal to plain {same}{' (card and CPU)' if on_cpu else ''}, keys equal to "
        f"torch.sort {lib_same}, max_abs_err {err!r}")
    if not (same and lib_same is not False):
        raise AssertionError(f"gate K6 {name}: differs")
    return err


def phase_gate_unstructured(mesh_a, random8):
    errs = [gate_ell(f"K5 {MESH_SIDE}^2 mesh step float64", ell_from_csmat(mesh_a),
                     rhs_block(mesh_a.cols, 1, torch.float64, 83)[:, 0].contiguous())]
    errs.append(gate_ell(f"K5 random8 n={RANDOM8_N} float32", random8[1], random8[2]))
    errs += [gate_ell(f"K5 {label}", ell, x) for label, ell, x in small_ells()]
    for label, ell, x in (e for e in small_ells() if "random" in e[0]):  # ELLs with pad slots
        for bad in (float("nan"), float("inf")):
            xb = x.clone()
            xb[0] = bad
            errs.append(gate_ell_nonfinite(f"K5 {label} x[0] = {bad}", ell, xb))
    errs.append(gate_grad_ell())
    sort_errs = [
        gate_sort("65 rows int32", *sort_case(65, "int32", 84)),
        gate_sort("65 rows int32 keys in [0, 8)", *sort_case(65, "ties", 85)),
        gate_sort("10 rows float32", *sort_case(10, "float32", 86)),
        gate_sort("33 rows float32 keys +-0.0 and ties", *sort_case(33, "zeros", 93), on_cpu=True),
        gate_sort("1 row float32", *sort_case(1, "float32", 94), on_cpu=True),
        gate_sort("1 row int32 keys in [0, 8)", *sort_case(1, "ties", 95), on_cpu=True),
        gate_sort("40 rows float32 keys with NaN and inf bit patterns", *sort_case(40, "nan", 96),
                  on_cpu=True),
        gate_sort(f"{SORT_ROWS} rows int32", *sort_case(SORT_ROWS, "int32", 87)),
        gate_sort(f"{SORT_ROWS} rows float32", *sort_case(SORT_ROWS, "float32", 88)),
    ]
    return {"ell_spmv": max(errs), "sort_rows": max(sort_errs)}


def timing_ell(label, mat, ell, x, reps):
    ms = time_ms(lambda: ell_spmv_kernel(ell, x), reps)
    dev_ms = device_ms(lambda: ell_spmv_kernel(ell, x), "ell_spmv", reps)
    plain_ms = time_ms(lambda: ell_spmv_plain(ell, x), max(reps // 5, 3))
    csr = csr_twin(mat)
    lib_err = float((torch.mv(csr, x) - ell_spmv_plain(ell, x)).abs().max())
    library_ms = time_ms(lambda: torch.mv(csr, x), reps)
    size = ell.data.element_size()
    # as utils/profile.py::ell_spmv_bytes counts them
    nbytes = ell.rows_pad * ell.width * (4 + size) + (ell.cols + ell.rows_pad) * size
    flops = 2 * ell.rows_pad * ell.width
    # a diagnostic beside the bound, not the bound: each gather of x (pad
    # slots included) reads one 32-byte L2 sector
    sectors = ell.rows * ell.width * 32
    return timing_row(label, ms, plain_ms, library_ms, nbytes, flops, PEAK_FLOPS[ell.dtype],
                      kernel="ell_spmv", device_ms=dev_ms, library="torch.mv (CSR)",
                      library_max_abs_err=lib_err, width=ell.width, gather_l2_sector_bytes=sectors)


def timing_sort(keys, vals, reps):
    def library():
        s, order = torch.sort(keys, dim=1, stable=True)
        return s, torch.gather(vals, 1, order)

    ms = time_ms(lambda: sort_rows_kernel(keys, vals), reps)
    dev_ms = device_ms(lambda: sort_rows_kernel(keys, vals), "sort_rows", reps)
    plain_ms = time_ms(lambda: sort_rows_plain(keys, vals), 3)
    library_ms = time_ms(library, reps)
    nbytes = 2 * keys.numel() * (keys.element_size() + vals.element_size())
    flops = 28 * keys.numel()  # one comparison per element per stage
    return timing_row(f"{keys.shape[0]}x128 {keys.dtype} keys, {vals.dtype} vals", ms, plain_ms,
                      library_ms, nbytes, flops, PEAK_FLOPS[torch.float32], kernel="sort_rows",
                      device_ms=dev_ms, library="torch.sort(dim=1, stable) + torch.gather")


def phase_timing_unstructured(mesh_a, random8):
    """K5's row in the kernels line is its main path's, the mesh step;
    random8's goes beside it."""
    rows = {"ell_spmv": timing_ell(f"{MESH_SIDE}^2 mesh step float64", mesh_a, ell_from_csmat(mesh_a),
                                   rhs_block(mesh_a.cols, 1, torch.float64, 89)[:, 0].contiguous(),
                                   reps=200)}
    rows["ell_spmv"]["other_shapes"] = [timing_ell(f"random8 n={RANDOM8_N} float32", *random8, reps=50)]
    rows["sort_rows"] = timing_sort(*sort_case(SORT_ROWS, "int32", 90), reps=50)
    rows["sort_rows"]["other_shapes"] = [timing_sort(*sort_case(SORT_ROWS, "float32", 92), reps=50)]
    return rows


ROUTE_OF = {"DiaTiledMat": "dia", "EllMat": "ell", "CsMat": "csr"}


def phase_main_mesh():
    """The implicit heat step on the permuted mesh (see the module note).
    Returns K5's launches over the CG solve."""
    n, tri, centre = permuted_mesh(MESH_SIDE)
    lap, a, setup = mesh_step(n, tri)
    ref_lap, ref_a = scipy_mesh_step(n, tri)
    check_against_scipy(f"L {MESH_SIDE}^2 mesh", lap, ref_lap)
    check_against_scipy(f"A = I + {MESH_TAU}L", a, ref_a)
    del ref_lap, ref_a
    t0 = time.perf_counter()
    fn, prepared = prepare_spmv(a)
    sync()
    setup["prepare_spmv_s"] = time.perf_counter() - t0
    route = ROUTE_OF[type(prepared).__name__]
    log(f"mesh {MESH_SIDE}^2 set-up {json.dumps(setup)}: route {route}, width {getattr(prepared, 'width', None)}")
    if route != "ell" or prepared.width != 7:
        raise AssertionError(f"mesh step routed to {route}, expected ell of width 7")
    b = torch.zeros(n, dtype=torch.float64, device=DEVICE)
    b[centre] = 1.0

    reset_counts()
    t0 = time.perf_counter()
    res = cg(a, b, tol=SOLVE_TOL, max_iter=MAX_ITER)
    sync()
    wall = time.perf_counter() - t0
    launches, plain_calls = ell_spmv_kernel.launches, ell_spmv_plain.calls

    true_res = float(torch.linalg.vector_norm(b - ell_spmv_plain(prepared, res.x)))
    ref = cg(lambda v: ell_spmv_plain(prepared, v), b, tol=SOLVE_TOL, max_iter=MAX_ITER)
    sync()
    rel = float((res.x - ref.x).abs().max() / ref.x.abs().max())
    log(f"cg mesh {MESH_SIDE}^2 step float64: iterations {res.iterations} converged {res.converged} "
        f"wall {wall!r} s (prepare_spmv included), {wall / max(res.iterations, 1) * 1e3!r} ms per "
        f"iteration, true residual {true_res!r} (limit {SOLVE_TOL!r}), K5 launches {launches} "
        f"(expected {res.iterations + 2}), plain calls {plain_calls}; vs the plain CG "
        f"({ref.iterations} iterations): rel {rel!r} (limit 1e-6)")
    if not (res.converged and true_res <= SOLVE_TOL * float(torch.linalg.vector_norm(b))):
        raise AssertionError(f"cg mesh: converged {res.converged}, true residual {true_res}")
    if launches != res.iterations + 2 or plain_calls != 0:
        raise AssertionError(f"cg mesh: {launches} K5 launches, {plain_calls} plain calls")
    if res.x.shape != b.shape or not bool(torch.isfinite(res.x).all()) or not rel <= 1e-6:
        raise AssertionError(f"cg mesh: rel {rel} against the plain CG")
    profile_window(
        f"cg {MESH_SIDE}^2 mesh step float64, whole solve",
        lambda: cg(lambda v: fn(prepared, v), b, tol=SOLVE_TOL, max_iter=MAX_ITER),
        "ell_spmv",
    )
    return launches


def phase_main_sort():
    """K6 through its own entry point: 43,750 rows with tied keys, each
    value the key's column, so the result shows the permutation."""
    keys, _ = sort_case(SORT_ROWS, "ties", 91)
    cols = torch.arange(128, dtype=torch.int32, device=DEVICE).expand(SORT_ROWS, -1).contiguous()
    sync()
    reset_counts()
    t0 = time.perf_counter()
    ks, vs = sort_rows_kernel(keys, cols)
    sync()
    wall = time.perf_counter() - t0
    launches = sort_rows_kernel.launches
    log(f"sort_rows main path {SORT_ROWS}x128: wall {wall!r} s, K6 launches {launches}, "
        f"plain calls {sort_rows_plain.calls}")
    if launches != 1 or sort_rows_plain.calls != 0:
        raise AssertionError("sort_rows: launch counts")
    idx = vs.to(torch.int64)
    if not (torch.equal(ks, torch.sort(keys, dim=1).values) and torch.equal(ks, keys.gather(1, idx))
            and torch.equal(idx.sort(dim=1).values, cols.to(torch.int64))):
        raise AssertionError("sort_rows: not a sorted permutation of each row")
    return launches


def check_small_mesh():
    """CG on the 16² permuted mesh step on the card against a dense solve
    of the same A.  The step's condition number is at most 1 + 12τ = 121,
    so a residual of 1e-8·‖b‖ leaves x within about 1.2e-6 of max|x|: the
    limit is 1e-5."""
    n, tri, centre = permuted_mesh(MESH_SMALL_SIDE)
    _, a, _ = mesh_step(n, tri)
    route = ROUTE_OF[type(prepare_spmv(a)[1]).__name__]
    b = torch.zeros(n, dtype=torch.float64, device=DEVICE)
    b[centre] = 1.0
    ell_spmv_kernel.launches = 0
    res = cg(a, b, tol=SOLVE_TOL, max_iter=MAX_ITER)
    launches = ell_spmv_kernel.launches
    ref = torch.linalg.solve(a.to_dense(), b)
    rel = float((res.x - ref).abs().max() / ref.abs().max())
    log(f"small cg {MESH_SMALL_SIDE}^2 mesh step vs dense solve: route {route}, iterations "
        f"{res.iterations}, rel err {rel!r}, K5 launches {launches}")
    if not (route == "ell" and res.converged and rel <= 1e-5 and launches == res.iterations + 2):
        raise AssertionError(f"small cg mesh: route {route}, rel err {rel}, launches {launches}")


# ---------------------------------------------------------------------------
# the sparse-ops slice: SpGEMM, the biharmonic step, the dense-route chain
# ---------------------------------------------------------------------------


def median_ms(fn, reps):
    """Median of ``reps`` CUDA-event timings of ``fn``, after one call."""
    fn()
    sync()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        sync()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def peak_bytes(fn):
    """(result of ``fn``, the device memory it allocated at its peak above
    what was allocated before)."""
    sync()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    sync()
    return out, torch.cuda.max_memory_allocated() - base


def top_device_ops(fn, n=8):
    """The profiler's ``n`` largest device operations over one call of
    ``fn``: [name, count, ms]."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        sync()
    ops = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    ops.sort(key=lambda e: -e.self_device_time_total)
    return [[e.key[:70], e.count, e.self_device_time_total / 1e3] for e in ops[:n]]


def check_spgemm_against_scipy(label, c, ref):
    """C's indptr and indices equal scipy's after ``sort_indices``, its data
    within the JAX bench's rtol / atol."""
    ref.sort_indices()
    nnz = c.nnz
    same = (c.cap == nnz and np.array_equal(c.indptr.cpu().numpy(), ref.indptr)
            and np.array_equal(c.indices[:nnz].cpu().numpy(), ref.indices))
    data = c.data[:nnz].cpu().numpy()
    err = float(np.abs(data - ref.data).max()) if nnz else 0.0
    close = bool(np.allclose(data, ref.data, rtol=SPGEMM_RTOL, atol=SPGEMM_ATOL))
    log(f"spgemm {label} vs scipy: nnz {nnz}, indptr and indices equal {same}, data max_abs_err "
        f"{err!r} within rtol {SPGEMM_RTOL} / atol {SPGEMM_ATOL}: {close}")
    if not (same and close):
        raise AssertionError(f"spgemm {label}: differs from scipy")


def spgemm_point(shape_a, shape_b, density):
    """The timing row of one bench point (phase 4) and its check against
    scipy (phase 5f); returns (row, a, b, C)."""
    label = f"{shape_a[0]}x{shape_a[1]} @ {shape_b[0]}x{shape_b[1]} d={density:g} float32"
    t0 = time.perf_counter()
    a = rand_csr(shape_a, density, seed=0, dtype=np.float32, device=DEVICE)
    b = rand_csr(shape_b, density, seed=1, dtype=np.float32, device=DEVICE)
    sync()
    setup_s = time.perf_counter() - t0
    prods = _exact_prod_count(a, b)
    c, peak = peak_bytes(lambda: spgemm(a, b))
    ms = median_ms(lambda: spgemm(a, b), SPGEMM_REPS)
    expand_ms = median_ms(lambda: _expand_products(a, b, prods), 3)
    rows, cols, vals, _ = _expand_products(a, b, prods)
    compress_ms = median_ms(lambda: compress_coo(rows, cols, (vals,), prods, a.rows, b.cols, prods), 3)
    del rows, cols, vals
    top = top_device_ops(lambda: spgemm(a, b))
    ta, tb = csr_twin(a), csr_twin(b)
    lib = torch.sparse.mm(ta, tb)
    lib_nnz = int(lib._nnz())
    del lib
    library_ms = median_ms(lambda: torch.sparse.mm(ta, tb), SPGEMM_REPS)
    del ta, tb
    a_sp, b_sp = a.to_scipy(), b.to_scipy()
    scipy_s = []
    for _ in range(1 if prods > 5e7 else 3):
        t0 = time.perf_counter()
        ref = a_sp @ b_sp
        scipy_s.append(time.perf_counter() - t0)
    row = {
        "shape": label,
        "nnz_a": a.nnz,
        "nnz_b": b.nnz,
        "products": prods,
        "nnz_c": c.nnz,
        "ms": ms,
        "expand_ms": expand_ms,
        "sort_compress_ms": compress_ms,
        "esc_products_per_s": prods / (ms / 1e3),
        "peak_bytes": peak,
        "peak_bytes_per_product": peak / max(prods, 1),
        "library_ms": library_ms,
        "library": "torch.sparse.mm (CSR @ CSR)",
        "library_nnz": lib_nnz,
        "scipy_ms": float(np.median(scipy_s)) * 1e3,
        "operands_setup_s": setup_s,
        "top_device_ops": top,
    }
    check_spgemm_against_scipy(label, c, ref)
    return row, a, b, c


def phase_spgemm():
    """Phase 4's SpGEMM rows and phase 5f's SpGEMM checks at the JAX
    bench's points; at the densest one the forced-chunk run, the dense
    route with the break-even it gives, and the chain C_bsr @ X through
    K3.  Returns (rows, K3's 3xTF32 launches on the chain)."""
    rows = []
    for shape_a, shape_b, density in SPGEMM_POINTS[:-1]:
        row, *_ = spgemm_point(shape_a, shape_b, density)
        log(f"timing spgemm {json.dumps(row)}")
        rows.append(row)
    row, a, b, c = spgemm_point(*SPGEMM_POINTS[-1])

    # the same product in at least SPGEMM_MIN_CHUNKS row chunks
    budget = -(-row["products"] // SPGEMM_MIN_CHUNKS)
    n_chunks = len(chunk_bounds(a, b, budget))
    t0 = time.perf_counter()
    chunked = _spgemm_chunked(a, b, budget)
    sync()
    chunked_s = time.perf_counter() - t0
    same = chunked.cap == c.cap and all(
        torch.equal(x, y) for x, y in ((chunked.indptr, c.indptr), (chunked.indices, c.indices),
                                       (chunked.data, c.data)))
    log(f"spgemm {row['shape']} in {n_chunks} chunks of at most {budget} products: {chunked_s!r} s, "
        f"arrays equal to the one-shot result {same}")
    if n_chunks < SPGEMM_MIN_CHUNKS or not same:
        raise AssertionError(f"spgemm chunked: {n_chunks} chunks, equal {same}")
    del chunked
    row["chunked_s"], row["chunks"] = chunked_s, n_chunks

    # the dense route and the break-even products / multiply-add
    m, k = a.shape
    n = b.cols
    macs = m * k * n
    c_bsr, dense_peak = peak_bytes(lambda: spgemm(a, b, method="dense", out_format="bsr"))
    dense_ms = median_ms(lambda: spgemm(a, b, method="dense", out_format="bsr"), SPGEMM_REPS)
    ad, bd = a.to_dense(), b.to_dense()
    with _matmul_precision("highest"):
        matmul_ms = median_ms(lambda: torch.matmul(ad, bd), SPGEMM_REPS)
    del ad, bd
    row.update({
        "dense_bsr_ms": dense_ms,
        "dense_peak_bytes": dense_peak,
        "dense_peak_per_byte": dense_peak / ((m * k + k * n + m * n) * 4),
        "dense_matmul_ms": matmul_ms,
        "dense_mac_per_s": macs / (matmul_ms / 1e3),
        "products_per_mac_break_even": (dense_ms / macs) / (row["ms"] / row["products"]),
        # the budgets spgemm takes from the card's free memory now
        "free_bytes": _free_bytes(a.device),
        "chunk_product_budget": chunk_product_budget(a.device),
        "dense_bytes_budget": dense_bytes_budget(a.device),
    })
    log(f"timing spgemm {json.dumps(row)}")
    rows.append(row)
    launches = phase_main_dense_chain(c_bsr, c)
    return rows, launches


def phase_main_dense_chain(c_bsr, c_esc):
    """C_bsr (the dense route's block result, bs 128, 15000 rows: a
    partial last block row) times X of CHAIN_K float32 columns through
    ``matmul``: K3's 3xTF32 variant, one launch; Y against the plain
    version (K3's 1e-5 gate) and C_bsr against the ESC result."""
    if c_bsr.block_size != 128 or c_bsr.rows % 128 == 0:
        raise AssertionError(f"dense chain: block size {c_bsr.block_size}, rows {c_bsr.rows}")
    x = rhs_block(c_bsr.cols, CHAIN_K, torch.float32, 95)
    sync()
    reset_counts()
    t0 = time.perf_counter()
    y = c_bsr @ x
    sync()
    wall = time.perf_counter() - t0
    launches = bsr_spmm_kernel.launches_tf32x3
    others = bsr_spmm_kernel.launches_tc + bsr_spmm_plain.calls
    ref = bsr_spmm_plain(c_bsr, x)
    err = float((y - ref).abs().max())
    rel = err / float(ref.abs().max())
    close = bool(torch.allclose(c_bsr.to_dense(), c_esc.to_dense(), rtol=SPGEMM_RTOL, atol=SPGEMM_ATOL))
    log(f"dense chain C_bsr ({c_bsr.n_blocks} blocks of 128) @ X {c_bsr.cols}x{CHAIN_K} float32: "
        f"wall {wall!r} s, K3 3xTF32 launches {launches}, other launches and plain calls {others}, "
        f"vs plain rel {rel!r} (limit 1e-5); C_bsr within rtol {SPGEMM_RTOL} / atol {SPGEMM_ATOL} "
        f"of the ESC product: {close}")
    if launches != 1 or others != 0:
        raise AssertionError(f"dense chain: {launches} tf32x3 launches, {others} others")
    if y.shape != (c_bsr.rows, CHAIN_K) or not rel <= 1e-5 or not close:
        raise AssertionError(f"dense chain: rel {rel}, C_bsr close {close}")
    GATE_ERRS.setdefault("bsr_spmm_tf32x3", []).append(err)
    return launches


def check_exact_against_scipy(name, mat, ref):
    ref.sort_indices()
    nnz = mat.nnz
    same = (mat.cap == nnz and np.array_equal(mat.indptr.cpu().numpy(), ref.indptr)
            and np.array_equal(mat.indices[:nnz].cpu().numpy(), ref.indices)
            and np.array_equal(mat.data[:nnz].cpu().numpy(), ref.data))
    log(f"{name} vs scipy: nnz {nnz}, indptr, indices and data equal {same}")
    if not same:
        raise AssertionError(f"{name}: differs from scipy")


def gmres_launch_count(res):
    """The products GMRES makes: one for A·x0, then per cycle one per
    Arnoldi step and one residual."""
    return 1 + (res.iterations // GMRES_RESTART) * (GMRES_RESTART + 1)


def phase_main_biharmonic():
    """Phase 5f's biharmonic step (see the module note).  Returns the
    launches of K5 (permuted step) and K1 (the step itself)."""
    import scipy.sparse as sp

    side = BIHARM_SIDE
    n = side * side
    sync()
    t0 = time.perf_counter()
    t = diags([-1.0, 2.0, -1.0], [-1, 0, 1], (side, side), device=DEVICE)
    i = eye(side, torch.float64, device=DEVICE)
    lap = kronecker_product(i, t) + kronecker_product(t, i)
    sync()
    t1 = time.perf_counter()
    lap2 = lap @ lap
    sync()
    t2 = time.perf_counter()
    a = eye(n, torch.float64, device=DEVICE) + 1.0 * lap2
    sync()
    t3 = time.perf_counter()
    ref_lap = dirichlet_laplacian((side, side), device=DEVICE)
    same = lap.cap == ref_lap.cap and all(torch.equal(x, y) for x, y in (
        (lap.indptr, ref_lap.indptr), (lap.indices, ref_lap.indices), (lap.data, ref_lap.data)))
    log(f"biharmonic {side}^2: kron(I,T) + kron(T,I) {t1 - t0!r} s, equal to dirichlet_laplacian "
        f"{same}; L @ L {t2 - t1!r} s ({lap2.nnz} entries); I + L@L {t3 - t2!r} s")
    if not same:
        raise AssertionError("biharmonic: the Kronecker sum differs from dirichlet_laplacian")
    del ref_lap, lap2
    ls = lap.to_scipy()
    ref_a = (sp.identity(n, format="csr") + ls @ ls).tocsr()
    check_exact_against_scipy(f"biharmonic A = I + L@L {side}^2", a, ref_a)
    del ls, ref_a

    perm = Permutation.from_array(np.random.default_rng(96).permutation(n), device=DEVICE)
    t0 = time.perf_counter()
    ap = transform_mat_papt(a, perm)
    sym = is_symmetric(ap)
    sync()
    log(f"biharmonic P·A·Pᵀ: {time.perf_counter() - t0!r} s (symmetry check included), symmetric {sym}")
    if not sym:
        raise AssertionError("biharmonic: P·A·Pᵀ is not symmetric")
    b = torch.from_numpy(np.random.default_rng(97).standard_normal(n)).to(DEVICE)
    bp = perm @ b  # A x = b  <=>  (P·A·Pᵀ)(P x) = P b
    b_norm = float(torch.linalg.vector_norm(b))

    fn, prepared = prepare_spmv(ap)
    route = ROUTE_OF[type(prepared).__name__]
    if route != "ell" or prepared.width != 13:
        raise AssertionError(f"biharmonic P·A·Pᵀ routed to {route}, width {getattr(prepared, 'width', None)}")
    if ROUTE_OF[type(prepare_spmv(a)[1]).__name__] != "dia":
        raise AssertionError("biharmonic A does not route to dia")
    sync()
    out = {}
    for label, mat, rhs, kernel, plain in (
        ("permuted, ELL (K5)", ap, bp, ell_spmv_kernel, ell_spmv_plain),
        ("unpermuted, DIA (K1)", a, b, dia_spmv_kernel, dia_spmv_plain),
    ):
        reset_counts()
        t0 = time.perf_counter()
        res = gmres(mat, rhs, tol=SOLVE_TOL, restart=GMRES_RESTART, max_iter=GMRES_MAX_ITER)
        sync()
        wall = time.perf_counter() - t0
        launches, plain_calls = kernel.launches, plain.calls
        # the same solve over an operator prepared beforehand: the loop's
        # own time, without the host routing that gmres(mat) runs first
        mv, op = prepare_spmv(mat)
        sync()
        t0 = time.perf_counter()
        gmres(lambda v: mv(op, v), rhs, tol=SOLVE_TOL, restart=GMRES_RESTART, max_iter=GMRES_MAX_ITER)
        sync()
        loop_ms = (time.perf_counter() - t0) / max(res.iterations, 1) * 1e3
        true_res = float(torch.linalg.vector_norm(rhs - spmv(mat, res.x)))
        expected = gmres_launch_count(res)
        log(f"gmres({GMRES_RESTART}) biharmonic {side}^2 {label}: iterations {res.iterations} converged "
            f"{res.converged} wall {wall!r} s (prepare_spmv included), {loop_ms!r} ms per iteration "
            f"over the prepared operator, true residual {true_res!r} "
            f"(limit {SOLVE_TOL * b_norm!r}), launches {launches} (expected {expected}), plain calls "
            f"{plain_calls}")
        if not (res.converged and true_res <= SOLVE_TOL * b_norm and bool(torch.isfinite(res.x).all())):
            raise AssertionError(f"gmres biharmonic {label}: converged {res.converged}, residual {true_res}")
        if launches != expected or plain_calls != 0:
            raise AssertionError(f"gmres biharmonic {label}: {launches} launches, {plain_calls} plain calls")
        out[label] = (res, launches)
    res_p, k5 = out["permuted, ELL (K5)"]
    res_a, k1 = out["unpermuted, DIA (K1)"]
    ref = gmres(lambda v: ell_spmv_plain(prepared, v), bp, tol=SOLVE_TOL, restart=GMRES_RESTART,
                max_iter=GMRES_MAX_ITER)
    scale = float(res_p.x.abs().max())
    rel_plain = float((res_p.x - ref.x).abs().max()) / scale
    rel_carried = float((res_p.x - perm @ res_a.x).abs().max()) / scale
    log(f"gmres biharmonic permuted x vs the GMRES over ell_spmv_plain ({ref.iterations} iterations): "
        f"rel {rel_plain!r}; vs the unpermuted solution carried through p: rel {rel_carried!r} "
        f"(limits 1e-6)")
    if not (rel_plain <= 1e-6 and rel_carried <= 1e-6):
        raise AssertionError(f"gmres biharmonic: rel {rel_plain}, {rel_carried}")
    return k5, k1


def check_small_sparse_ops():
    """Phase 6's sparse-ops checks on the card, each against a dense
    equivalent: GMRES on a convection–diffusion operator (32²), LSQR on a
    Tikhonov system (32²), the sparse-iterate BiCGSTAB from a point source
    (16²), and the stacks and permutations."""
    def conv_diff(side):
        i = eye(side, torch.float64, device=DEVICE)
        d = diags([1.0, -1.0], [0, -1], (side, side), device=DEVICE)
        return dirichlet_laplacian((side, side), device=DEVICE) + (
            kronecker_product(i, d) + kronecker_product(d, i)) * 0.4

    rng = np.random.default_rng(98)
    k = conv_diff(32)
    b = torch.from_numpy(rng.standard_normal(k.rows)).to(DEVICE)
    res = gmres(k, b, tol=SOLVE_TOL, restart=GMRES_RESTART, max_iter=GMRES_MAX_ITER)
    ref = torch.linalg.solve(k.to_dense(), b)
    rel = float((res.x - ref).abs().max() / ref.abs().max())
    log(f"small gmres 32^2 convection-diffusion vs dense solve: iterations {res.iterations}, rel err {rel!r}")
    if not (res.converged and rel <= 1e-5):
        raise AssertionError(f"small gmres: rel {rel}")

    lam = 0.5
    lap = dirichlet_laplacian((32, 32), device=DEVICE)
    tik = vstack([lap, eye(lap.rows, torch.float64, device=DEVICE) * math.sqrt(lam)])
    bt = torch.from_numpy(rng.standard_normal(tik.rows)).to(DEVICE)
    res = lsqr(tik, bt, tol=SOLVE_TOL)
    ref = torch.linalg.lstsq(tik.to_dense(), bt[:, None]).solution[:, 0]
    rel = float((res.x - ref).abs().max() / ref.abs().max())
    log(f"small lsqr Tikhonov [L; sqrt({lam}) I] 32^2 vs torch.linalg.lstsq: iterations {res.iterations}, "
        f"rel err {rel!r}")
    if not (res.converged and rel <= 1e-6):
        raise AssertionError(f"small lsqr: rel {rel}")

    # rectangular operators through prepare_spmv, as LSQR binds A and Aᵀ:
    # a tall and a wide one on each of the DIA (K1) and ELL (K5) routes
    lp = transform_mat_papt(lap, Permutation.from_array(rng.permutation(lap.rows), device=DEVICE))
    tall_ell = vstack([lp, lp])
    for name, mat, route, kernel in (
        ("tall DIA", tik, "dia", dia_spmv_kernel), ("wide DIA", tik.T.to_csr(), "dia", dia_spmv_kernel),
        ("tall ELL", tall_ell, "ell", ell_spmv_kernel), ("wide ELL", tall_ell.T.to_csr(), "ell", ell_spmv_kernel),
    ):
        fn, prepared = prepare_spmv(mat)
        x = torch.from_numpy(rng.standard_normal(mat.cols)).to(DEVICE)
        reset_counts()
        y = fn(prepared, x)
        sync()
        launches, plain_calls = kernel.launches, dia_spmv_plain.calls + ell_spmv_plain.calls
        ref = mat.to_dense() @ x
        rel = float((y - ref).abs().max() / ref.abs().max())
        got = ROUTE_OF[type(prepared).__name__]
        log(f"small rectangular {name} {mat.shape}: route {got}, launches {launches}, plain calls "
            f"{plain_calls}, rel err {rel!r} against the dense product")
        if got != route or launches != 1 or plain_calls != 0 or y.shape != (mat.rows,) or not rel <= 1e-12:
            raise AssertionError(f"small rectangular {name}: route {got}, launches {launches}, rel {rel}")

    k16 = conv_diff(16)
    src = 8 * 16 + 8
    res = bicgstab_sparse(k16, csvec(k16.rows, [src], [1.0], device=DEVICE), tol=SOLVE_TOL, max_iter=500)
    e = torch.zeros(k16.rows, dtype=torch.float64, device=DEVICE)
    e[src] = 1.0
    ref = torch.linalg.solve(k16.to_dense(), e)
    rel = float((res.x.to_dense() - ref).abs().max() / ref.abs().max())
    log(f"small bicgstab_sparse 16^2 point source vs dense solve: iterations {res.iterations}, "
        f"support {res.x.nnz}, rel err {rel!r}")
    if not (res.converged and rel <= 1e-5):
        raise AssertionError(f"small bicgstab_sparse: rel {rel}")

    blocks = [rand_csr(shape, 0.3, seed=s, device=DEVICE) for s, shape in
              enumerate(((20, 15), (20, 9), (11, 15), (11, 9)))]
    d = [m.to_dense() for m in blocks]
    p = Permutation.from_array(rng.permutation(20), device=DEVICE)
    q = Permutation.from_array(rng.permutation(15), device=DEVICE)
    pi, qi = p.perm.long(), q.perm.long()
    z = torch.zeros_like(d[1])
    for name, got, want in (
        ("bmat", bmat([[blocks[0], None], [blocks[2], blocks[3]]]),
         torch.cat([torch.cat([d[0], z], 1), torch.cat([d[2], d[3]], 1)])),
        ("block_diag", block_diag([blocks[0], blocks[3]]), torch.block_diag(d[0], d[3])),
        ("hstack", hstack([blocks[0], blocks[1]]), torch.cat([d[0], d[1]], 1)),
        ("permute_rows", permute_rows(blocks[0], p), d[0][pi]),
        ("permute_cols", permute_cols(blocks[0], q), d[0][:, qi]),
        ("transform_mat_paq", transform_mat_paq(blocks[0], p, q), d[0][pi][:, qi]),
    ):
        same = torch.equal(got.to_dense(), want)
        log(f"small {name} vs its dense equivalent: equal {same}")
        if not same:
            raise AssertionError(f"small {name} differs from its dense equivalent")


# name in the kernels line -> (source, TPU kernel it replaces)
KERNELS = {
    "dia_spmv": ("sprs_tpu_torch/csrc/dia_spmv.cu", "sprs_tpu/ops/pallas/dia_spmv.py:232"),
    "dia_spmm_vector": ("sprs_tpu_torch/csrc/dia_spmm.cu", "sprs_tpu/ops/pallas/dia_spmm.py:93"),
    "dia_spmm_scalar": ("sprs_tpu_torch/csrc/dia_spmm.cu", "sprs_tpu/ops/pallas/dia_spmm.py:93"),
    "bsr_spmm_tc": ("sprs_tpu_torch/csrc/bsr_spmm.cu", "sprs_tpu/ops/pallas/bsr_spmm.py:69"),
    "bsr_spmm_tf32x3": ("sprs_tpu_torch/csrc/bsr_spmm.cu", "sprs_tpu/ops/pallas/bsr_spmm.py:69"),
    "bsr_spmm_grouped": ("sprs_tpu_torch/csrc/bsr_spmm.cu", "sprs_tpu/ops/pallas/bsr_spmm.py:258"),
    "ell_spmv": ("sprs_tpu_torch/csrc/ell_spmv.cu", "sprs_tpu/ops/pallas/spmv.py:72"),
    "sort_rows": ("sprs_tpu_torch/csrc/sort_rows.cu", "sprs_tpu/ops/pallas/sort.py:97"),
}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    torch.cuda.set_device(0)
    name, count, smi = phase_device()
    phase_build()

    t0 = time.perf_counter()
    lap_spmv = grid_laplacian((SPMV_SIDE,) * 2, torch.float32, device=DEVICE)
    spmv_operand = laplacian_operand(lap_spmv, 0)
    log(f"setup: {SPMV_SIDE}^2 grid Laplacian and DIA in {time.perf_counter() - t0:.3f} s")
    errs = phase_gate(spmv_operand)
    timing = phase_timing(lap_spmv, spmv_operand)
    del lap_spmv, spmv_operand
    t0 = time.perf_counter()
    mesh_a = mesh_step(*permuted_mesh(MESH_SIDE)[:2])[1]
    random8 = random8_operand()
    log(f"setup: {MESH_SIDE}^2 mesh step and random8 in {time.perf_counter() - t0:.3f} s")
    errs.update(phase_gate_unstructured(mesh_a, random8))
    timing.update(phase_timing_unstructured(mesh_a, random8))
    del mesh_a, random8

    check_small_against_dense()
    check_small_mesh()
    launches = {}
    launches["dia_spmv"], lap, rhs = phase_main_spmv()
    phase_profile_bicgstab(lap, rhs)
    del lap, rhs
    launches.update(phase_main_block())
    launches.update(phase_main_bsr())
    launches["ell_spmv"] = phase_main_mesh()
    launches["sort_rows"] = phase_main_sort()
    phase_eigen_checks()
    spgemm_rows, chain_launches = phase_spgemm()
    k5, k1 = phase_main_biharmonic()
    check_small_sparse_ops()
    for kname, n in (("bsr_spmm_tf32x3", chain_launches), ("ell_spmv", k5), ("dia_spmv", k1)):
        if n == 0:
            raise AssertionError(f"the SpGEMM path launched no {kname} kernel")
        launches[kname] += n
    errs["bsr_spmm_tf32x3"] = max(GATE_ERRS["bsr_spmm_tf32x3"])
    for kname, n in launches.items():
        if n == 0:
            raise AssertionError(f"the main path launched no {kname} kernel")

    kernels = []
    for kname, (source, replaces) in KERNELS.items():
        row = timing[kname]
        kernels.append({
            "name": kname,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": launches[kname],
            "max_abs_err": errs[kname],
            "ms": row["ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
            "device_ms": row.get("device_ms"),
            "ok": True,
            "shape": row["shape"],
            "card": smi,
        })
        if "other_shapes" in row:
            kernels[-1]["other_shapes"] = [
                {key: other[key] for key in ("shape", "ms", "device_ms", "plain_ms", "bound_ms", "library_ms")}
                for other in row["other_shapes"]
            ]
    print(json.dumps({"spgemm": spgemm_rows, "card": smi}))
    print(json.dumps({"kernels": kernels}))
    print(
        json.dumps(
            {"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
