#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``sprs_tpu_torch``) on one GPU.

Phases, each of which raises on failure (the script then exits non-zero
and prints no result):

1. device: the card's name and count, and ``nvidia-smi``'s name and
   power limit;
2. build: every CUDA source of the port, compiled from ``csrc/`` (one
   ``nvcc`` per source, all started together), and the port's native
   host library (``csrc/sprs_host.cpp``, g++), with its seconds; ptxas'
   registers and spills of every K2 instantiation, none of the tma
   variant's allowed to spill;
3. gate: each kernel against its plain torch version on the card —
   K1 (banded SpMV) and K2 (banded SpMM) on grid Laplacians and a random
   band in float32 and float64, K2 also on the 1024² Dirichlet Laplacian
   and the band's transpose, at every RHS width the block main paths and
   correctness solves give it (4 to 256) and at 1, 48 and 130, each
   width also on an X that starts off a 16-byte boundary (K2's tma
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
   torch's autograd of the plain version on the CPU; and the bfloat16
   forms of K1, K2 and K5, (bf16, bf16) -> bf16 and (bf16, f32) -> f32
   with float32 sums: K1 and K2 on the grid Laplacians (K1 also the 4096²
   grid) and the random band (K2 also its transpose) at every RHS width
   above, aligned and misaligned, (bf16, bf16) bit-equal to the plain
   version and (bf16, f32) within 1e-5 of max|y|; K5 on the mesh step,
   random8 and the small odd ELLs rounded to bfloat16, within one
   bfloat16 step (2⁻⁷ of max|y|) or 1e-6; the backwards of K1 (bf16,
   f32), K2 (bf16, bf16) and K5 (bf16, f32) against torch's autograd of
   the plain versions on the CPU; and the twelve other (data, x) forms
   of float16, bfloat16, float32 and float64 (output promote(data, x)):
   K1 on the random band and the 1024² grid Laplacian, K2 on both at 3
   (scalar variant), 8, 24 and 128 RHS and on a misaligned X, K5 on the
   small odd ELLs and random8, each bit-equal to its plain version where
   the output is 16-bit (K5: one 16-bit step), else within 1e-6 (float32)
   or 1e-13 (float64) of max|y|, each checking its own form's counter;
   and K3 and K4 in the thirteen other (blocks, X) forms, Y in
   promote(blocks, X): at block sizes 16 and 128 the 1000×900 shape at
   k = 201, 256 and 1, an X off a 16-byte boundary, a sliced and
   unsorted operand, an empty block row, the K4 repack at group 4 and
   block magnitudes 2⁻²⁰ to 2²⁰ (float16 blocks 2⁻²⁴ to 2⁸); inf and NaN
   in the blocks and in X, where the plain version puts them; the
   backward against ``bsr_vjp`` on the CPU (dblocks in the blocks' type,
   dX in X's); within 1e-5 of max|Y| (2⁻⁷ for a bfloat16 Y, 2⁻¹⁰ for
   float16), each checking the variant the rule picks (wgmma for
   (f16, f16) on aligned X at bs 128), the form that launched and its
   TF32 passes; and K2's tma variant in all sixteen forms on the shapes
   that stress its slab plan and TMA boxes: rows not a multiple of its
   tile rows, offsets at or past the row count (boxes wholly outside X),
   unsorted offsets, k = 8, 24, 128 and 256, and a misaligned X, which
   must take the scalar variant; and K1 through a prepared operand's
   plan (the direct launch) in all sixteen forms on the 4096², 1024²
   and 64² grid bands, a wide band (offsets ±rows/2), rows != cols, more
   columns than rows, offsets at or past the row count, k = 1, k = 64
   sorted and shuffled, an odd rows_pad and an x off a 16-byte boundary,
   each bit-equal to the same kernel through the autograd Function on a
   bare DiaMat (a plan built per call) and to the plain version where
   both operands are 16-bit, else within FORM_GATE_LIMIT of it; and
   inf/NaN coefficients where x is read outside [0, cols), slots the
   kernel skips (the rows stay finite where the plain version's are
   NaN); and K7 (the merge-path CSR SpMV) in all sixteen forms on a
   power-law operand (a hub row over 40 tiles, empty rows leading,
   trailing and in a run, padding slots) and on GAP's kron graph at
   scale 23 in (f32, f32) and (bf16, f32), each row within its rounding
   bound of the plain version over float64 copies (``k7_limit``), one
   launch of its form counted per call, two runs bit-equal; and K8
   (BiCGSTAB's six fused passes) through ``linalg.bicgstab`` on the heat
   operator at 64², 1024² and 4096² (the benchmark cell's grid) in
   float32 and float64, 10 iterations
   against the masked loop (``_plain``) on the card, x within
   ``K8_LIMIT``, six launches an iteration and no plain iteration, two
   solves bit-equal;
4. timing, with CUDA events, beside each kernel's bound, its plain
   version and one library call (each also with the profiler's device
   time per launch, ``device_ms``): K1 at the 4096×4096-grid SpMV in
   float32 and float64, the 1024² float64 solve size and 64² float64,
   each with ``host_ms`` = ms - device_ms and the same two times of the
   per-call path (the autograd Function on a bare DiaMat, a plan built
   per call, as every call went before the plan) taken in turns (direct,
   per call, per call, direct); K2 at the 2048×1024 grid with 128
   RHS (float32) and at 1024² float64 with 24, 48 and 256 RHS (tma
   variant) and 3 RHS (scalar variant); K3 at n = 4096, k = 512,
   bs = 128, block densities 0.125/0.25/0.5 (bfloat16, wgmma) and in
   float32 and float64 (3xTF32), and at n = 16384 (bfloat16, float32); K4
   at the first of those; K5
   at the 1024² mesh step (float64, its main path) and "random8"
   (n = 2,097,152, 8 uniform slots per row, float32), with the L2 sectors
   its gathers read, and on HPCG's 27-point stencil at 128³ (float64)
   under a random numbering, as given and renumbered by the Cuthill–McKee
   levels of ``ops/renumber.py`` (its gather pass and scattering store;
   y bit-equal, one launch counted a product, the renumbered one in
   ``launches_renumbered``); K6 at 43,750 × 128 (int32 and float32 keys); SpGEMM
   (not a kernel) at the JAX bench's three points; the bfloat16 forms of
   K1 at the 4096² grid, K2 at the 2048×1024 grid with 128 RHS and K5 at
   random8, each beside its bytes bound and ``torch.mv`` / ``torch.sparse.mm``
   on the bfloat16 CSR tensor (the row says so where torch refuses the
   types); the same three rows for each of the twelve other forms, y's
   bytes in promote(data, x); K3 and K4 (group 8) in the thirteen other
   forms at n = 4096, k = 512, bs = 128, density 0.125, each bound by
   bytes or by operations at 989 TFLOP/s (wgmma) or 495/p for p TF32
   passes, beside dense ``torch.matmul`` in promote(blocks, X) and
   torch's BSR ``@`` (or its refusal); K7 at the kron23 PageRank
   operator (8,388,608 rows, 258.7M entries, float32; its two kernels'
   device time), beside its bytes bound, the plain version and
   ``torch.mv`` on the CSR tensor; K8's six passes of one iteration at
   the heat operator's 4096² grid in float64 on fixed products, beside
   their bytes bound (20 vectors), each pass's device time, and the
   masked loop's and K8's update work per iteration of a 50-iteration
   solve (device time of every op but K1's) with device ops an
   iteration;
5. main paths, each with the launch counts set to 0 just before and read
   just after:
   a. BiCGSTAB and CG at 1024² float64 through ``prepare_spmv`` and K1
      (3·iters+2 and iters+2 launches; BiCGSTAB through K8, 6·iters
      launches, no plain iteration), then a profiler window of 50
      BiCGSTAB iterations through K8 and one through the masked loop;
   b. the block solvers through ``prepare_spmm`` and K2: heat diffusion
      from 256 point sources, ``expm_multiply`` on the 1024² grid
      Laplacian (float64), held against the same call over the plain
      version (K2's tma variant), and the same from 3 sources (its
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
      through K5 (iters+2 launches, the plain version's calls 0; x of
      8 MB sits in the L2, so ``prepare_spmv`` does not renumber it and
      no product takes the renumbered path), held against the same CG
      over the plain version, then a profiler window; then the ELL arm's
      renumbering through ``prepare_spmv`` where x outgrows the L2
      (float64): HPCG's 27-point stencil at 224³ under a random numbering
      comes back renumbered, K5 on it bit-equal to K5 on the operand as
      given and within 1e-12 of max|y| of the plain version (launches /
      renumbered / plain calls (2, 1, 0)), and a random graph of 8 slots
      a row at 2**24 rows is ordered and the ordering dropped; both with
      ``prepare_spmv``'s time beside ``ell_from_csmat``'s;
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
   g. the direct-solver path on the 256² Dirichlet Laplacian (65,536
      rows, f64): the nd, camd and rcm symbolics (seconds, lnz, levels;
      nd's lnz equal to the CPU run's); LDLᵀ with nd (host numeric, then
      ``solve`` on the card by its ``auto`` method and by the other one,
      ms per solve, ‖Ax − b‖ ≤ 1e-10·‖b‖, x within 1e-10 of scipy's
      ``spsolve``, an (n, 8) right-hand side column for column); an f32
      factor refined by ``refine_solve`` (forward error below 1e-8, one
      K1 launch per backward error); CG against IC(0)-PCG (K1 iters+2, x
      within 1e-8 of LDLᵀ, ms per IC(0) application, a profiler window)
      and BiCGSTAB against ILU(0)-BiCGSTAB on a convection–diffusion
      operator built by ``kronecker_product`` (K1 3·iters+2, true
      residual ≤ 1e-8·‖b‖); ``splu`` with camd columns against scipy's;
      at 32² ``solve``'s choice (LU / LDLᵀ), its gradients in b and in
      the values against the dense formula and ``det`` against
      ``slogdet``; the row-scan device numeric at 16² against the host
      numeric;
   h. the panel LDLᵀ numerics on the same operand: the nd and camd
      supernodal and multifrontal plans and round schedules (equal to the
      CPU build's, nd's to the JAX package's integers); the mf-batched and
      super-batched factors in f64 and f32 and mf-batched camd in f64 (s
      per factor beside phase 5g's host numeric; f64 within rtol = atol
      1e-9 of the host numeric, every repeat bit-equal, no NaN); the
      supernodal and multifrontal numerics at 64² (rtol 1e-10);
      ``solve(method="super")`` after each 256² factor by both branches
      of the round-batched solve's gate (ms per solve; ‖Ax − b‖ ≤
      1e-10·‖b‖, x within 1e-10 of ``spsolve`` and the level solve, an
      (n, 8) right-hand side column for column); ``refine_solve`` from the
      f32 mf-batched factor through K1 (one launch per residual, forward
      error below 1e-8); ``BatchedLdl`` at 128² over 8 value sets against
      8 single factors and solves, and ``batch_spmv``, ``batch_spmm`` and
      ``batch_spgemm`` at 256² over 4 against member loops; one profiled
      factor (device launches per round, idle share, top device ops);
   i. IO and profile on the 1024² Dirichlet Laplacian (f64): written by
      ``write_matrix_market_sym`` and read back onto the card by
      ``read_matrix_market_csr`` (bit-equal; seconds and seconds per
      million entries), CG on the read-back operand through K1 (iters+2
      launches, x bit-equal to the CG on the in-memory operand); ``save_npz``
      / ``load_npz`` of it and of phase 5d's mesh step, CG on the loaded
      mesh step through K5 (iters+2, x bit-equal to phase 5d's); a
      checkpoint of {A, its DiaMat, the mesh step's EllMat, x} restored
      onto the card leaf for leaf; ``audit_spmv`` on phase 4's 4096² f32
      grid Laplacian (K1, 51 launches; its share of the measured copy
      rate, at most 1, beside phase 4's share of the HBM peak);
   j. the distributed layer on a mesh of 4 slots on the card, 1024²
      Laplacian in f64: ``dist_spmv`` (replicated and ``x_sharded``,
      ``balance="nnz"``), ``prepare_dist_spmv`` (the Laplacian routes
      "halo", the permuted mesh step "allgather"; both run),
      ``dist_spmv_halo`` and ``dist_spmv_2d`` on a (2, 2) mesh, each within
      1e-12 of the single-device ``spmv``; ``dist_spgemm``,
      ``dist_spgemm_bshard`` and ``dist_spgemm_bgather`` for L @ L, equal
      to phase 5f's pattern, data within 1e-12; ``dist_cg`` with Jacobi at
      1024² and with Jacobi and block-Jacobi LDLᵀ (4 blocks of 16,384
      rows) at 256², each by name and with its preconditioner built
      beforehand (set-up seconds, ms per iteration and ms per
      preconditioner apply apart; true residual ≤ 1e-8·‖b‖; block LDLᵀ
      in fewer iterations); ``dryrun_multichip(4)``; one profiled
      ``dist_spmv``;
   k. float32 solvers over bfloat16-stored operators (run after 5e): CG
      at 1024², tol 1e-5, on the Dirichlet Laplacian stored in bfloat16
      and in float32 (``prepare_spmv`` → K1 (bf16, f32) and K1 (f32):
      iters+2 launches each, the plain version's calls 0, iterations and
      x bit-equal; s, ms per iteration, a profiled window each);
      ``expm_multiply`` from 256 float32 sources over the 1024² grid
      Laplacian stored both ways (K2 (bf16, f32), tma variant), bit-
      equal, one launch per SpMM; CG on phase 5d's mesh step rounded to
      bfloat16 through the ELL arm and K5 (bf16, f32) (converged, true
      residual in float64 within 1e-4·‖b‖, iters+2 launches, iterations
      within 10 % of the float32-stored CG); one (bf16, bf16) product on
      each route (the 4096² SpMV, the 128-RHS SpMM, random8) against its
      plain version; then the determinism check: ``ops/prod.py``'s CSR
      ``spmv`` (K7) and ``spmm``, ``batch_spmv``, ``dist_spmv`` with its
      per-shard products and ``assemble``, the level and flat
      ``lsolve``, ``CsMat.sum`` by rows and by columns and ``norm(1)`` /
      ``norm(inf)`` on phase 5d's mesh pattern with normal values, K5's
      backward dx on the mesh step, and K3's backward dX and
      ``bsr_spmm_plain`` on the float32 K3 cell, each run twice on one
      input, bits compared (a difference fails the run: the index-summed
      products sum in one fixed order, an accumulating ``index_put_`` on
      the card, and K7 in its own); and each of ``index_sum_``'s cases of
      ``CsMat.sum(0)`` (64 entries a column, f32, f64), a CSR-routed
      ``spmv`` (about 100 entries a row, through K7 on the card; f64,
      (bf16, bf16), (f16, f16)) and ``compress_coo``
      (40 duplicates a slot) on the card against the same call on the
      CPU, bits compared and the differing entries recorded;
   l. float64 solvers over float32-stored and float32 solvers over
      float16-stored operators: CG at 1024² on the Dirichlet Laplacian
      (tol 5e-9 in f64, 1e-5 in f32) stored both ways, in turns, through
      K1 (f32, f64) / (f16, f32) and K1 (f64) / (f32), iterations and x
      bit-equal (the entries are exact), iters+2 launches each, profiled;
      ``expm_multiply`` from 256 sources over the same operator through
      K2 (f32, f64) / (f16, f32), bit-equal, one launch per SpMM; CG on
      phase 5d's mesh step stored in float32 (f64 b) and in float16 (f32
      b) through K5 (converged, true residual in float64 against the
      rounded operator within 1e-8 / 1e-4 of ‖b‖, iters+2 launches,
      iterations within 10 % of the wider-stored CG); one product per
      remaining form on each route (the 4096² SpMV, the 128-RHS SpMM,
      random8) against its plain version; the phase's seconds beside its
      90 s budget;
   m. block-sparse products in the production mixes (run after 5f, whose
      C_bsr it takes): (a) the K3 cell's operator stored in bfloat16
      times float32 X through ``@`` (K3 (bf16, f32), two TF32 passes),
      within 1e-5 of max|Y| of the dense product of the same rounded
      blocks, timed beside the float32-stored product, then one backward
      through ``@`` (dblocks in bfloat16, dX in float32, against the
      dense formulas); (b) phase 5f's C_bsr stored in bfloat16 times
      float32 X of 256 columns; (c) the float32 C_bsr times float64 X,
      ``@`` in float32 (the JAX ``@``'s type) and ``bsr_spmm_kernel`` in
      float64 (the Pallas type), equal in value; (d) the K3 cell in
      (f16, f16) through ``@`` (the wgmma variant), timed; (e) one
      product per remaining form through ``@`` and K4 in every form;
      launches by form exact, the plain version's calls 0; the phase's
      seconds beside its 60 s budget;
   n. the measurement programs (run last), each ``benches/torch_*.py``
      called in this process through its ``main``: the SpMV roofline
      bench at its default (K1 on the 4096² grid against the measured
      copy rate and the stream twin, after its gate of K1, K2, K3 and
      K5: the gate passed, K1 the best kernel, both shares in (0, 1.05],
      the twin under the HBM peak), the block-sparse bench in
      bfloat16 and float32 (K3), the LDLᵀ bench at ``--grid 256 --fill
      nd --scan-grid 32 --skip-seq`` (every factor's backward error
      gated), the SpGEMM bench's quick sweep with one scipy call per
      point (C equal to scipy's pattern at every point; the native
      library not timed) and the micro bench; their K1, K2, K3 and K5 launches join
      the kernels line, and the phase's seconds are printed beside its
      150 s budget;
   o. the last three measurement programs (after 5n), each called in
      this process through its ``main`` at its full size: the primitives
      bench (N = 5.6M; then each primitive once on the card against its
      definition computed by numpy on a CPU copy: sorted rows and array,
      the gather, the int32 scatter-add over two chained steps, the
      wrapped int32 cumsum, and the two float32 scatter-adds,
      ``index_add_`` and ``index_sum_``, within 1e-6 of the counts and
      of each other), the weak-scaling bench of ``dist_spmv`` at 1, 2, 4
      and 8 slots on the card (each schedule's product within 1e-6 of
      max|y| of ``spmv``) and ``torch_ldl_big.py`` at 512² nd (the panel
      solve's backward error under its 2e-3 bar, the round-batched solve
      within 1e-3 of max|y| of the sequential one, the f64 host
      cross-check); their paths launch none of the port's kernels; the
      phase's seconds are printed beside its budget;
   p. K7's main path (after 5o): GAP's kron graph at scale 23 through
      ``prepare_spmv``'s CSR arm (the matrix itself, ``spmv``), 20
      personalized PageRank steps from 1,024 teleport vertices as the
      kron23 PageRank cell runs them (one K7 (f32, f32) launch a step,
      the plain version's calls 0; the K7 count of the kernels line),
      the scores within the cell's 1e-4 of a float64 ``index_add_``
      reference;
6. correctness solves: BiCGSTAB and CG at 32² and CG on the 16² mesh
   step against a dense solve;
   LOBPCG at 128² Dirichlet (8 eigenpairs against the closed form,
   2·iters+2 K2 launches), plain and with IC(0) as its preconditioner
   (fewer iterations; a main path: its K2 launches count), and ``svds(k=4)`` on the random band against
   ``torch.linalg.svdvals`` (4·iters+5 K2 launches); GMRES on a
   convection–diffusion operator at 32², LSQR on a Tikhonov system at 32²
   and the sparse-iterate BiCGSTAB at 16² against dense solves, and the
   stacks and permutations against their dense equivalents;
7. the SpGEMM line (phase 4's SpGEMM rows: the port at the JAX bench's
   three points beside ``torch.sparse.mm`` and scipy, the split of its
   device time, its peak memory per product, and at the densest point
   the dense route and the break-even that sets
   ``AUTO_DENSE_PRODUCTS_PER_MAC``), the direct_panel line (phase 5h's
   numbers), the io and distributed lines (phases 5i and 5j), the
   bf16_solvers and forms_solvers lines (phases 5k and 5l), the
   bsr_forms line (phase 5m), the determinism line, one bench line per
   record of phase 5n and the benches line (its seconds and launches),
   one bench line per record of phase 5o and the last_benches line (its
   seconds, launches and the primitives' errors), the pagerank line
   (phase 5p: launches, ms a step, the scores' error), the kernels line
   (each form other than float32 and float64 under its kernel's entry,
   in ``forms``: its time, device time, bound and share, plain and
   library times or the library's refusal, main-path launches and gate
   error; K3's and K4's also their variant, TF32 passes and torch's BSR
   ``@`` time or refusal), then the last line
   ``{"ok": true, "device": {"platform": "gpu", ...}}``.

Run from the repository root: ``python3 chip_smoke.py``.
"""

from __future__ import annotations

import dataclasses
import importlib
import itertools
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from sprs_tpu_torch.formats.bsr import BsrMat, bsr_from_dense, bsr_random, bsr_spmm_plain
from sprs_tpu_torch.formats.csmat import diags, eye, from_dense
from sprs_tpu_torch.formats.csvec import csvec
from sprs_tpu_torch.formats.dia import DiaMat, dia_to_csmat
from sprs_tpu_torch.formats.ell import EllMat, ell_from_csmat
from sprs_tpu_torch.formats.triplet import coo_to_csmat
from sprs_tpu_torch.formats.util import compress_coo, round_up, row_ids_from_indptr
from sprs_tpu_torch.interop import from_arrays
from sprs_tpu_torch import native
from sprs_tpu_torch.linalg import (
    Ldl,
    bicgstab,
    bicgstab_sparse,
    cg,
    expm_multiply,
    gmres,
    ic0,
    ilu0,
    lobpcg,
    lsqr,
    refine_solve,
    solve,
    splu,
    svds,
)
from sprs_tpu_torch.linalg import ldl_batched as lb
from sprs_tpu_torch.linalg.solve import resolve_method
from sprs_tpu_torch.ops import (
    BatchedLdl,
    Permutation,
    batch_spgemm,
    batch_spmm,
    batch_spmv,
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
    spmm,
    spmv,
    transform_mat_papt,
    transform_mat_paq,
    vstack,
)
from sprs_tpu_torch.ops.cuda import build, krylov, launch
from sprs_tpu_torch.ops.cuda import bsr_spmm as k3
from sprs_tpu_torch.ops.cuda import dia_spmm as k2
from sprs_tpu_torch.ops.cuda.csr_spmv import TILE, csr_spmv_kernel, csr_spmv_plain
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
from sprs_tpu_torch.ops.cuda.forms import FORMS
from sprs_tpu_torch.ops.cuda.sort import sort_rows_kernel, sort_rows_plain
from sprs_tpu_torch.ops.renumber import cuthill_mckee_levels, inverse, mean_gather
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
from sprs_tpu_torch.utils.profile import device_launches, torch_ops

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
# K3/K4 vs plain, by Y's type: both take products and sums in float32 for
# every form (as the JAX package does), in another order; a 16-bit output
# may round to a neighbouring value: one step at the largest magnitude.
BSR_GATE_LIMIT = {torch.float32: 1e-5, torch.float64: 1e-5, torch.bfloat16: 2.0**-7,
                  torch.float16: 2.0**-10}
# One bfloat16 step at the largest magnitude: K5's bfloat16 outputs
# against their plain versions (its lane tree sums in another order) and
# the bfloat16 gradients; FORM_GATE_LIMIT holds every form's outputs.
BF16_GATE_LIMIT = 2.0**-7
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
# the K3/K4 forms gated in every form: one block size on the 16-byte
# staging (and the wgmma variant for (f16, f16)), one off it
K3_FORM_BLOCK_SIZES = (16, 128)
# the wide-magnitude gate's exponents: 2^-20..2^20, and for float16
# blocks 2^-24..2^8 (its subnormals, and sums an f16 Y holds)
WIDE_EXPONENTS = {torch.float16: (-24, 8)}
K3_FORMS_PHASE_BUDGET_S = 60.0  # phase 5m's share of the script's time, recorded beside its seconds
K3_MAIN_REPS = 20  # CUDA-event reps of phase 5m's timed products
# The unstructured path: a 1024² vertex mesh, labels permuted, step
# I + τL with τ = 10 (scipy's CG took 85 iterations to 1e-8 at this size).
MESH_SIDE = 1024
MESH_TAU = 10.0
MESH_SMALL_SIDE = 16
# The JAX package's ELL timing shape (benches/r4/r4_format_spmv.py:84-99):
# 8 uniform column draws per row, duplicates summed.
RANDOM8_N = 2**21
RANDOM8_SLOTS = 8
# K5 on a renumbered operand: HPCG's 27-point stencil on a side³ grid
# under a random numbering (x of 16.8 MB in f64).
RENUMBER_SIDE = 128
# The ELL arm's rule through prepare_spmv on the card, float64: the
# randomly numbered stencil at this side³ (x of 90 MB; its mean gather of
# about n/3 entries, doubled, is 60 MB, past the 50 MiB L2, so the rule
# orders it; at 192³ it would be 38 MB and the rule would not), and a
# random graph of 8 slots a row at 2**24 rows, which the rule orders and
# drops.
RENUMBER_MAIN_SIDE = 224
RANDOM_FAR_N = 2**24
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
# the direct-solver path (phase 5g): the JAX package's LDL bench default,
# benches/ldl_bench.py --grid 256 (65,536 rows)
DIRECT_SIDE = 256
DIRECT_FILLS = ("nd", "camd", "rcm")
DIRECT_RHS_K = 8
DIRECT_SOLVE_REPS = 5
REFINE_STEPS = 3
KRYLOV_TOL = 1e-12  # CG/BiCGSTAB stop; x is held to 1e-8 of the LDL solution
CONVECTION = 0.5
PRECOND_REPS = 10
PRECOND_PROFILE_ITERS = 5  # each IC(0) application is ~4,000 launches to trace
SMALL_DIRECT_SIDE = 32
ROWSCAN_SIDE = 16
# phase 5h: the panel numerics at DIRECT_SIDE, the sequential ones at
# PANEL_SMALL_SIDE, BatchedLdl at PANEL_BATCH_SIDE over PANEL_BATCH_N value
# sets, the batched products over PANEL_PRODUCT_N
PANEL_FILLS = ("nd", "camd")
PANEL_RTOL = 1e-9  # the JAX package's 256² gate (tests/test_ldl_batched.py)
PANEL_SMALL_RTOL = 1e-10  # the sequential numerics at PANEL_SMALL_SIDE
PANEL_SMALL_SIDE = 64
PANEL_BATCH_SIDE = 128
PANEL_BATCH_N = 8
PANEL_PRODUCT_N = 4
PANEL_REFINE_STEPS = 5
# the JAX package's host plans at 256², nd (its LDL bench's grid)
EXPECTED_ND_PLANS = {256: {"S": 1991, "W": 128, "MR": 536, "P": 15467008, "super_T": 7167,
                           "super_R": 29, "mf_T": 4384, "mf_R": 26}}
# phase 5i (IO and profile) and 5j (the distributed layer)
IO_SIDE = 1024  # 1,048,576 rows, 5,238,784 nnz: a matrix users load from disk
AUDIT_ITERS = 50
AUDIT_SHARE_LIMIT = 1.0  # a share above 1 of the measured copy rate is a timing fault
DIST_SIDE = 1024
DIST_SMALL_SIDE = 256  # block-Jacobi LDLᵀ: 4 blocks of 16,384 rows
DIST_SLOTS = 4
DIST_TOL = 1e-12  # products against the single-device spmv (the sums run in another order)
DIST_SPMV_REPS = 20  # CUDA-event timing of dist_spmv after one warm-up call
PRECOND_REPS = 5
# the recursive residual's stop in phases 5i and 5j: at 1024² with a
# random b, CG's true residual drifts to within 1% of tol·‖b‖ on the
# H100, and the gates hold the true residual to SOLVE_TOL
CG_TOL = SOLVE_TOL / 2


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
    """The CUDA sources, and the port's native host library (g++), which
    the direct-solver path needs: its AMD ordering has no numpy stand-in
    at 65,536 rows, so a failed build fails the phase."""
    t0 = time.perf_counter()
    infos = build.build()
    log(f"build: {len(infos)} source(s) in {time.perf_counter() - t0:.3f} s")
    for info in infos.values():
        log(f"  {info.name}: {info.seconds:.3f} s -> {info.path.name}")
        for line in info.log.splitlines():
            log(f"    {line}")
    k2_ptxas(infos["dia_spmm"].log)
    seconds = native.build()
    native.load()
    if not native.available():
        raise AssertionError("the native host library did not load")
    log(f"build: native host library {native.LIB_PATH.name} in {seconds:.3f} s of g++")


def k2_ptxas(nvcc_log):
    """One line per K2 instantiation: ptxas' registers and spills; a
    spill in the tma variant fails the phase (its design holds only
    accumulators in registers)."""
    report = build.ptxas_report(nvcc_log)
    if not report:
        log("ptxas dia_spmm: no report (the library was built before this run)")
        return
    for fn, regs, stores, loads in report:
        log(f"ptxas dia_spmm: {fn}: {regs} registers, {stores} bytes spill stores, {loads} bytes spill loads")
    spilled = [fn for fn, _, stores, loads in report if "tma" in fn and stores + loads > 0]
    if spilled or not any("tma" in fn for fn, *_ in report):
        raise AssertionError(f"K2's tma instantiations spill or are missing: {spilled}")


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
    kind = k2.variant_for(dia, x)
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


def bsr_kind(bsr, x):
    """The K3 variant the wrapper's rule picks for ``bsr @ x``."""
    return k3.variant(bsr.dtype, bsr.block_size, x.shape[1], x.data_ptr(), bsr.blocks.data_ptr(),
                      x.dtype)


def bsr_launched(name, counter, kind, form, before):
    """Raise unless ``counter``'s ``kind`` variant and ``form`` counts moved
    by one since ``before`` (their values then)."""
    now = (getattr(counter, f"launches_{kind}"), getattr(counter, f"launches_{form}"))
    if now != (before[0] + 1, before[1] + 1):
        raise AssertionError(f"gate {name}: the {kind} variant did not launch in its {form} form")


def gate_bsr(name, fn, bsr, x, counter=bsr_spmm_kernel, expect=None):
    """K3 (or K4, ``counter`` = its wrapper) against the plain version,
    Y in promote(blocks, X); the variant and the form the wrapper's rule
    picks must be the ones that launched, and the variant ``expect`` when
    given.  A form of NEW_K3_FORMS files its error under FORM_ERRS."""
    kind = bsr_kind(bsr, x)
    form = FORMS[(bsr.dtype, x.dtype)]
    out = torch.promote_types(bsr.dtype, x.dtype)
    if expect is not None and kind != expect:
        raise AssertionError(f"gate {name}: the rule picks {kind}, expected {expect}")
    before = (getattr(counter, f"launches_{kind}"), getattr(counter, f"launches_{form}"))
    y = fn(bsr, x)
    ref = bsr_spmm_plain(bsr, x)
    sync()
    bsr_launched(name, counter, kind, form, before)
    if y.shape != (bsr.rows, x.shape[1]) or y.dtype != out or not bool(torch.isfinite(y).all()):
        raise AssertionError(f"gate {name}: bad output {tuple(y.shape)} {y.dtype}")
    err = float((y.float() - ref.float()).abs().max())
    err = check_rel(f"{name} ({kind}, {form})", err, float(ref.float().abs().max()), BSR_GATE_LIMIT[out])
    key = "bsr_spmm_grouped" if counter is bsr_spmm_grouped_kernel else f"bsr_spmm_{kind}"
    if (bsr.dtype, x.dtype) in NEW_K3_FORMS:
        FORM_ERRS.setdefault((key, form), []).append(err)
    else:
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
    GATE_ERRS["dia_spmm_tma"].append(errs["K2"])

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
    WIDE_EXPONENTS' range for its type ([-20, 20] unless named)."""
    rng = np.random.default_rng(seed)
    shape = tuple(bsr.blocks.shape)
    lo, hi = WIDE_EXPONENTS.get(bsr.dtype, (-20, 20))
    vals = rng.choice([-1.0, 1.0], shape) * 2.0 ** rng.uniform(lo, hi, shape)
    blocks = torch.from_numpy(vals).to(DEVICE, bsr.dtype)
    return BsrMat(bsr.brows, bsr.bcols, blocks, bsr.shape, bsr.n_blocks)


def gate_nonfinite(dtype, x_dtype=None, in_x=False):
    """K3 on blocks (X where ``in_x``) holding +inf, -inf and NaN, against
    the other operand of small integers with zeros among them (exact in
    TF32, so their lo is 0: inf·0 must stay out of the cross terms), at
    k = 256 (the 16-byte staging and its finite check): NaN and ±inf where
    the plain version puts them, the finite entries within the form's
    limit of their max.  ``x_dtype``: X's type, the blocks' where not
    given."""
    x_dtype = dtype if x_dtype is None else x_dtype
    rng = np.random.default_rng(91)
    ints = lambda shape: torch.from_numpy(rng.integers(-3, 4, shape).astype(np.float64))  # noqa: E731
    bsr = bsr_random(90, (1000, 900), 128, 0.3, torch.float32, device=DEVICE)
    blocks = (ints(tuple(bsr.blocks.shape)).to(DEVICE) * (bsr.blocks != 0) if in_x else bsr.blocks).to(dtype)
    x = ints((900, 256)).to(DEVICE, x_dtype)
    if in_x:
        x[3, 5], x[7, 2], x[0, 0] = float("inf"), float("-inf"), float("nan")
    else:
        blocks[0, 3, 5], blocks[1, 7, 2], blocks[2, 0, 0] = float("inf"), float("-inf"), float("nan")
    bsr = BsrMat(bsr.brows, bsr.bcols, blocks, bsr.shape, bsr.n_blocks)
    form = FORMS[(dtype, x_dtype)]
    kind = bsr_kind(bsr, x)
    name = f"K3 bs128 inf/NaN in {'X' if in_x else 'blocks'} {FORM_LABEL[form]}"
    before = (getattr(bsr_spmm_kernel, f"launches_{kind}"), getattr(bsr_spmm_kernel, f"launches_{form}"))
    y = bsr_spmm_kernel(bsr, x)
    ref = bsr_spmm_plain(bsr, x)
    sync()
    bsr_launched(name, bsr_spmm_kernel, kind, form, before)
    for mask in (torch.isnan, torch.isposinf, torch.isneginf):
        if not torch.equal(mask(y), mask(ref)):
            raise AssertionError(f"gate {name}: {mask.__name__} differs from the plain version")
    fin = torch.isfinite(ref)
    if not (bool(torch.isnan(ref).any()) and bool(torch.isinf(ref).any())):
        raise AssertionError(f"gate {name}: the fixture gives no NaN or no inf")
    err = float((y.float() - ref.float())[fin].abs().max())
    err = check_rel(f"{name} ({kind}, finite entries)", err, float(ref.float()[fin].abs().max()),
                    BSR_GATE_LIMIT[torch.promote_types(dtype, x_dtype)])
    if (dtype, x_dtype) in NEW_K3_FORMS:
        FORM_ERRS.setdefault((f"bsr_spmm_{kind}", form), []).append(err)
    else:
        GATE_ERRS["bsr_spmm_tf32x3"].append(err)


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


def peak_of(data_dtype, x_dtype):
    """The CUDA-core peak of K1's, K2's and K5's accumulator type,
    promote(out, float32), out = promote(data, x)."""
    return PEAK_FLOPS[torch.promote_types(torch.promote_types(data_dtype, x_dtype), torch.float32)]


def out_size(data, x):
    """The element size of K1's, K2's and K5's output, promote(data, x)."""
    return torch.promote_types(data.dtype, x.dtype).itemsize


def library_time(fn, ref, reps):
    """(ms, max_abs_err, error) of one PyTorch call that computes the
    kernel's function; where torch refuses the types (its CUDA sparse path
    does not take every type or mix), no time and its message."""
    try:
        err = float((fn().float() - ref.float()).abs().max())
    except (RuntimeError, TypeError, NotImplementedError) as e:
        return None, None, f"{type(e).__name__}: {str(e).splitlines()[0][:160]}"
    return time_ms(fn, reps), err, None


def timing_spmv(label, mat, dia, x, reps):
    """K1's row on a prepared operand: the direct launch through its plan
    and the per-call path (the same kernel through the autograd Function
    on a bare DiaMat, its plan built per call), each timed by CUDA events
    over ``reps`` back-to-back calls in turns (direct, per call, per call,
    direct: ms is the mean of its two turns, both in ``ms_turns``) and by
    the profiler's device time per launch; ``host_ms`` = ms - device_ms,
    what the call adds to its kernel.  Beside them the bytes bound, the
    plain version and ``torch.mv`` on the CSR tensor of the data's type."""
    bare = DiaMat(dia.data, dia.offsets, dia.shape)
    run = lambda: dia_spmv_kernel(dia, x)  # noqa: E731
    per_call = lambda: dia_spmv_kernel(bare, x)  # noqa: E731
    turns = [time_ms(run, reps), time_ms(per_call, reps), time_ms(per_call, reps), time_ms(run, reps)]
    ms, per_call_ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
    dev_ms = device_ms(run, "dia_spmv", min(reps, 50))
    per_call_dev_ms = device_ms(per_call, "dia_spmv", min(reps, 50))
    plain_ms = time_ms(lambda: dia_spmv_plain(dia, x), max(reps // 5, 3))
    csr = csr_twin(mat)
    library_ms, lib_err, lib_error = library_time(lambda: torch.mv(csr, x), dia_spmv_plain(dia, x), reps)
    nbytes = (dia.data.numel() * dia.data.element_size() + x.numel() * x.element_size()
              + dia.rows * out_size(dia.data, x))
    flops = 2 * dia.n_diags * dia.rows
    return timing_row(label, ms, plain_ms, library_ms, nbytes, flops, peak_of(dia.dtype, x.dtype),
                      kernel="dia_spmv", device_ms=dev_ms, host_ms=ms - dev_ms,
                      ms_turns=[turns[0], turns[3]], per_call_ms=per_call_ms,
                      per_call_ms_turns=[turns[1], turns[2]], per_call_device_ms=per_call_dev_ms,
                      per_call_host_ms=per_call_ms - per_call_dev_ms, library="torch.mv (CSR)",
                      library_max_abs_err=lib_err, library_error=lib_error)


def timing_spmm(label, mat, dia, x, reps):
    ms = time_ms(lambda: dia_spmm_kernel(dia, x), reps)
    dev_ms = device_ms(lambda: dia_spmm_kernel(dia, x), "dia_spmm", reps)
    plain_ms = time_ms(lambda: dia_spmm_plain(dia, x), max(reps // 5, 3))
    csr = csr_twin(mat)
    library_ms, lib_err, lib_error = library_time(lambda: torch.sparse.mm(csr, x),
                                                  dia_spmm_kernel(dia, x), reps)
    k = x.shape[1]
    nbytes = (dia.data.numel() * dia.data.element_size() + x.numel() * x.element_size()
              + dia.rows * k * out_size(dia.data, x))
    flops = 2 * dia.n_diags * dia.rows * k
    kind = k2.variant_for(dia, x)
    return timing_row(label, ms, plain_ms, library_ms, nbytes, flops, peak_of(dia.dtype, x.dtype),
                      kernel=f"dia_spmm_{kind}", device_ms=dev_ms, library="torch.sparse.mm (CSR)",
                      library_max_abs_err=lib_err, library_error=lib_error)


def torch_bsr_twin(bsr):
    row_ptr, order = bsr.row_order
    idx = order.to(torch.int64)
    return torch.sparse_bsr_tensor(
        row_ptr, bsr.bcols[idx], bsr.blocks[idx], size=bsr.shape
    )


def bsr_peak(kind, dtype, x_dtype):
    """The operation rate K3's bound takes: the 16-bit tensor cores
    (989 TFLOP/s, bf16 and f16 alike) for the wgmma variant; for the TF32
    variant the TF32 tensor cores over the form's passes (495/p)."""
    if kind == "tc":
        return BF16_TC_FLOPS
    return TF32_TC_FLOPS / k3.tf32_passes(dtype, x_dtype)


def timing_bsr(label, name, fn, bsr, x, reps, product=None):
    """``product``: the matrix whose product ``fn`` computes, where
    ``bsr`` is a repack of it with zero padding blocks; the bound counts
    the product's blocks, not the padding.  Bytes: the blocks in their
    type, X in its own, Y in promote(blocks, X).  The library call is
    dense ``torch.matmul`` in that type, and torch's BSR ``@`` where it
    takes the pair."""
    kind = bsr_kind(bsr, x)
    out = torch.promote_types(bsr.dtype, x.dtype)
    ms = time_ms(lambda: fn(bsr, x), reps)
    dev_ms = device_ms(lambda: fn(bsr, x), f"bsr_spmm_{kind}_kernel", reps)
    plain_ms = time_ms(lambda: bsr_spmm_plain(bsr, x), max(reps // 5, 3))
    dense, x_out = bsr.to_dense().to(out), x.to(out)
    library_ms = time_ms(lambda: torch.matmul(dense, x_out), reps)
    del dense, x_out
    try:
        twin = torch_bsr_twin(bsr)
        lib_bsr_err = float((twin @ x - fn(bsr, x)).float().abs().max())
        lib_bsr_ms = time_ms(lambda: twin @ x, reps)
        lib_bsr = None
    except Exception as e:  # torch's own BSR product: not every type runs
        lib_bsr_err = lib_bsr_ms = None
        lib_bsr = f"{type(e).__name__}: {str(e).splitlines()[0][:160]}"
    k = x.shape[1]
    bs = bsr.block_size
    n_blocks = (bsr if product is None else product).n_blocks
    nbytes = (n_blocks * bs * bs * bsr.blocks.element_size() + bsr.cols * k * x.element_size()
              + bsr.rows * k * out.itemsize)
    flops = 2 * n_blocks * bs * bs * k
    return timing_row(label, ms, plain_ms, library_ms, nbytes, flops, bsr_peak(kind, bsr.dtype, x.dtype),
                      kernel=name, variant=kind, device_ms=dev_ms,
                      passes=None if kind == "tc" else k3.tf32_passes(bsr.dtype, x.dtype),
                      library=f"torch.matmul (dense A, {str(out)[6:]})", library_error=None,
                      torch_bsr_ms=lib_bsr_ms, torch_bsr_max_abs_err=lib_bsr_err,
                      torch_bsr_error=lib_bsr, n_blocks=bsr.n_blocks,
                      block_density=bsr.block_density)


def phase_timing(lap_spmv, spmv_operand):
    rows = {}
    rows["dia_spmv"] = timing_spmv(f"{SPMV_SIDE}^2 grid float32", lap_spmv, *spmv_operand, reps=50)
    lap_solve = grid_laplacian((SOLVE_SIDE,) * 2, device=DEVICE)
    lap_small = grid_laplacian((64, 64), device=DEVICE)
    # the main path's solve size and a small one, where the call's host
    # time counts as much as its kernel
    rows["dia_spmv"]["other_shapes"] = [
        timing_spmv(f"{SOLVE_SIDE}^2 grid float64", lap_solve, *laplacian_operand(lap_solve, 4), reps=200),
        timing_spmv("64^2 grid float64", lap_small, *laplacian_operand(lap_small, 5), reps=2000),
    ]
    # the sixteenth form at 4096² (phases 4's bf16 and forms rows hold the
    # other fourteen, phase 4's float32 row above the first)
    lap64 = lap_spmv.astype(torch.float64)
    rows["dia_spmv"]["other_shapes"].append(
        timing_spmv(f"{SPMV_SIDE}^2 grid float64", lap64, *laplacian_operand(lap64, 0), reps=50))
    del lap64

    lap2 = grid_laplacian(SPMM_GRID, torch.float32, device=DEVICE)
    dia2 = dia_tile(lap2.to_dia())
    rows["dia_spmm_tma"] = timing_spmm(
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
    krylov.COUNTS.zero()
    t0 = time.perf_counter()
    res_b = bicgstab(lap, rhs, tol=SOLVE_TOL, max_iter=MAX_ITER)
    sync()
    wall_b = time.perf_counter() - t0
    launches_b = dia_spmv_kernel.launches
    k8 = dataclasses.asdict(krylov.COUNTS)
    t0 = time.perf_counter()
    res_c = cg(spd, b, tol=SOLVE_TOL, max_iter=MAX_ITER)
    sync()
    wall_c = time.perf_counter() - t0
    launches = dia_spmv_kernel.launches

    log(f"bicgstab {side}^2 float64: wall {wall_b!r} s (prepare_spmv included); K8 {json.dumps(k8)}")
    check_solution("bicgstab", res_b, lap_dia, rhs, launches_b, 3 * res_b.iterations + 2)
    if (k8["launches"], k8["fused_iterations"], k8["plain_iterations"]) != (
            6 * res_b.iterations, res_b.iterations, 0):
        raise AssertionError(f"bicgstab: K8 counts {k8} for {res_b.iterations} iterations")
    log(f"cg {side}^2 float64: wall {wall_c!r} s (prepare_spmv included)")
    check_solution("cg", res_c, spd_dia, b, launches - launches_b, res_c.iterations + 2)
    if launches == 0:
        raise AssertionError("the SpMV main path launched no K1 kernel")
    return launches, k8["launches"], lap, rhs


def device_events(prof):
    """The device ops of a profile, by name: its CUDA events without the
    port's ``sprs.*`` ranges, which the profiler also lists on the device
    with the time of the ops inside them."""
    from torch.autograd import DeviceType

    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and not e.key.startswith("sprs.")]


def profile_window(label, run, kernel_key):
    """Device busy share of ``run`` (set-up excluded): torch.profiler over
    one run, the same run timed untraced beside it."""
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
    kernels = device_events(prof)
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
    """The 1024² loop, led by the host: through K8 (about 10 device ops an
    iteration) and through the masked loop (about 80)."""
    fn, prepared = prepare_spmv(lap)
    a = lambda v: fn(prepared, v)
    profile_window(
        f"bicgstab {SOLVE_SIDE}^2 float64, {PROFILE_ITERS} iterations",
        lambda: bicgstab(a, rhs, tol=SOLVE_TOL, max_iter=PROFILE_ITERS),
        "dia_spmv",
    )
    profile_window(
        f"bicgstab {SOLVE_SIDE}^2 float64, {PROFILE_ITERS} iterations of the masked loop",
        lambda: plain_bicgstab(a, rhs, SOLVE_TOL, PROFILE_ITERS),
        "dia_spmv",
    )


def reset_counts():
    for fn in (dia_spmv_kernel, dia_spmm_kernel, ell_spmv_kernel, bsr_spmm_kernel,
               bsr_spmm_grouped_kernel, csr_spmv_kernel, sort_rows_kernel):
        launch.zero(fn)
    for fn in (dia_spmv_plain, dia_spmm_plain, bsr_spmm_plain, ell_spmv_plain, sort_rows_plain,
               csr_spmv_plain):
        fn.calls = 0
    krylov.COUNTS.zero()


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
    variants = {"dia_spmm_tma": dia_spmm_kernel.launches_tma,
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
    if variants != {"dia_spmm_tma": launches, "dia_spmm_scalar": few_launches}:
        raise AssertionError(f"K2 variants: {variants}, expected {launches} tma and "
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
    """LOBPCG, plain and IC(0)-preconditioned, against the closed-form
    Dirichlet eigenvalues and svds against torch.linalg.svdvals, with
    exact K2 launch counts.  Returns the K2 launches of the
    IC(0)-preconditioned LOBPCG by variant (a main path of this slice)."""
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

    # the same eigenproblem with IC(0) as the preconditioner (M⁻¹ on the
    # (n, m) residual block: two level-scheduled solves per iteration)
    ic, ic_s = timed(lambda: ic0(spd))
    reset_counts()
    pre, wall = timed(lambda: lobpcg(spd, x0, tol=1e-6, max_iter=EIG_MAX_ITER, precond=ic))
    err = float(np.abs(pre.eigenvalues.cpu().numpy() - np.array(closed)).max())
    launches = dia_spmm_kernel.launches
    variants = {"dia_spmm_tma": dia_spmm_kernel.launches_tma,
                "dia_spmm_scalar": dia_spmm_kernel.launches_scalar}
    log(f"ic0-lobpcg {side}^2 m={LOBPCG_M} tol 1e-6: iterations {pre.iterations} (plain "
        f"{res.iterations}) converged {pre.converged} wall {wall!r} s (ic0 host factor {ic_s!r} s), "
        f"max eigenvalue error {err!r} (limit 1e-6), K2 launches {launches} (expected "
        f"{2 * pre.iterations + 2}) by variant {variants}, plain calls {dia_spmm_plain.calls}")
    if not (pre.converged and err <= 1e-6 and launches == 2 * pre.iterations + 2
            and dia_spmm_plain.calls == 0 and pre.iterations < res.iterations):
        raise AssertionError("ic0-preconditioned lobpcg failed")

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
    return variants


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
    library_ms, lib_err, lib_error = library_time(lambda: torch.mv(csr, x), ell_spmv_plain(ell, x), reps)
    # as utils/profile.py::ell_spmv_bytes counts them, padded rows of y
    # included, y in promote(data, x)
    nbytes = (ell.rows_pad * ell.width * (4 + ell.data.element_size()) + ell.cols * x.element_size()
              + ell.rows_pad * out_size(ell.data, x))
    flops = 2 * ell.rows_pad * ell.width
    # a diagnostic beside the bound, not the bound: each gather of x (pad
    # slots included) reads one 32-byte L2 sector, whatever x's type
    sectors = ell.rows * ell.width * 32
    return timing_row(label, ms, plain_ms, library_ms, nbytes, flops, peak_of(ell.dtype, x.dtype),
                      kernel="ell_spmv", device_ms=dev_ms, library="torch.mv (CSR)",
                      library_max_abs_err=lib_err, library_error=lib_error, width=ell.width,
                      gather_l2_sector_bytes=sectors)


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


def stencil27_random(side, seed):
    """HPCG's 27-point operator (26 on the diagonal, -1 per in-grid
    neighbour) on a side³ grid as CSR on the card, its unknowns numbered
    in the order ``default_rng(seed)`` draws."""
    n = side**3
    idx = torch.arange(n, device=DEVICE)
    ix, iy, iz = idx % side, (idx // side) % side, idx // (side * side)
    rows, cols = [], []
    for dz, dy, dx in itertools.product((-1, 0, 1), repeat=3):
        ok = ((ix + dx >= 0) & (ix + dx < side) & (iy + dy >= 0) & (iy + dy < side)
              & (iz + dz >= 0) & (iz + dz < side))
        rows.append(idx[ok])
        cols.append(idx[ok] + (dz * side + dy) * side + dx)
    rows, cols = torch.cat(rows), torch.cat(cols)
    vals = torch.where(rows == cols, 26.0, -1.0).to(torch.float64)
    perm = torch.from_numpy(np.random.default_rng(seed).permutation(n)).to(DEVICE)
    return coo_to_csmat(perm[rows].to(torch.int32), perm[cols].to(torch.int32), vals, (n, n),
                        device=DEVICE)


def phase_renumbered():
    """K5 on a renumbered operand: the randomly numbered 27-point stencil
    at RENUMBER_SIDE³ as given and renumbered by its Cuthill–McKee levels
    (built here, whatever the L2 rule of ``prepare_spmv`` says at this
    size).  Gates y bit-equal, the launches (one a product,
    ``launches_renumbered`` one) and the plain version's calls (0), and
    returns the two timing rows, the renumbered one's ``device_ms``
    holding the gather pass and K5."""
    side = RENUMBER_SIDE
    mat = stencil27_random(side, 98)
    sync()
    t0 = time.perf_counter()
    order = cuthill_mckee_levels(mat)
    sync()
    order_s = time.perf_counter() - t0
    plain, ren = ell_from_csmat(mat), ell_from_csmat(mat, order=order.to(torch.int32))
    gather = [mean_gather(mat) * 8, mean_gather(mat, inverse(order)) * 8]
    x = rhs_block(mat.cols, 1, torch.float64, 99)[:, 0].contiguous()
    reset_counts()
    y, y_ren = ell_spmv_kernel(plain, x), ell_spmv_kernel(ren, x)
    sync()
    counts = (ell_spmv_kernel.launches, ell_spmv_kernel.launches_renumbered, ell_spmv_plain.calls)
    equal = bits_equal(y, y_ren)
    log(f"K5 renumbered {side}^3 stencil float64: ordering {order_s!r} s, mean gather bytes "
        f"{gather[0]!r} -> {gather[1]!r}, y bit-equal {equal}, launches / renumbered / plain calls "
        f"{counts} (expected (2, 1, 0))")
    if not equal or counts != (2, 1, 0):
        raise AssertionError(f"K5 renumbered: bit-equal {equal}, counts {counts}")
    label = f"{side}^3 27-point stencil float64, random numbering"
    rows = [timing_ell(label, mat, plain, x, reps=50),
            timing_ell(f"{label}, renumbered", mat, ren, x, reps=50)]
    gather_ms = device_ms(lambda: ell_spmv_kernel(ren, x), "ell_gather", 50)
    rows[1]["gather_device_ms"] = gather_ms
    rows[1]["device_ms"] += gather_ms
    log(f"timing K5 renumbered: gather pass {gather_ms!r} ms, K5 and gather {rows[1]['device_ms']!r} "
        f"ms [device] against {rows[0]['device_ms']!r} as given")
    return rows


def phase_main_renumbered():
    """The ELL arm's renumbering through ``prepare_spmv`` where x outgrows
    the L2.  The randomly numbered stencil at RENUMBER_MAIN_SIDE³ comes
    back renumbered, its K5 product bit-equal to K5 on the operand as
    given and within 1e-12 of max|y| of the plain version, with one launch
    a product, the renumbered one counted, no plain call.  The random
    graph at RANDOM_FAR_N rows, whose ordering cannot bring its gathers
    near, comes back as given.  Returns the set-up times of both, against
    ``ell_from_csmat`` alone."""
    out = {}
    rng = np.random.default_rng(100)
    rows = torch.arange(RANDOM_FAR_N, device=DEVICE).repeat_interleave(RANDOM8_SLOTS)
    cols = torch.from_numpy(rng.integers(0, RANDOM_FAR_N, rows.numel())).to(DEVICE)
    vals = torch.from_numpy(rng.random(rows.numel())).to(DEVICE)
    cases = (("stencil", stencil27_random(RENUMBER_MAIN_SIDE, 101), True),
             ("random8", coo_to_csmat(rows.to(torch.int32), cols.to(torch.int32), vals,
                                      (RANDOM_FAR_N,) * 2, device=DEVICE), False))
    del rows, cols, vals
    for label, mat, renumbers in cases:
        sync()
        t0 = time.perf_counter()
        fn, prepared = prepare_spmv(mat)
        sync()
        prepare_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        plain = ell_from_csmat(mat)
        sync()
        ell_s = time.perf_counter() - t0
        gather = mean_gather(mat.to_csr()) * 8
        if prepared.renumbered:
            gather = [gather, mean_gather(mat.to_csr(), inverse(prepared.order)) * 8]
        out[label] = {"n": mat.rows, "nnz": mat.nnz, "renumbered": prepared.renumbered,
                      "prepare_spmv_s": prepare_s, "ell_from_csmat_s": ell_s, "mean_gather_bytes": gather}
        log(f"prepare_spmv {label} n={mat.rows} float64: renumbered {prepared.renumbered}, "
            f"{prepare_s!r} s against ell_from_csmat {ell_s!r} s, mean gather bytes {gather}")
        if ROUTE_OF[type(prepared).__name__] != "ell" or prepared.renumbered != renumbers:
            raise AssertionError(f"prepare_spmv {label}: route {type(prepared).__name__}, "
                                 f"renumbered {getattr(prepared, 'renumbered', None)}, expected {renumbers}")
        if not renumbers:
            continue
        x = rhs_block(mat.cols, 1, torch.float64, 102)[:, 0].contiguous()
        reset_counts()
        y_ren, y = fn(prepared, x), ell_spmv_kernel(plain, x)
        sync()
        counts = (ell_spmv_kernel.launches, ell_spmv_kernel.launches_renumbered, ell_spmv_plain.calls)
        ref = ell_spmv_plain(plain, x)
        err = float((y_ren - ref).abs().max()) / float(ref.abs().max())
        equal = bits_equal(y_ren, y)
        out[label].update(bit_equal=equal, plain_rel_err=err, counts=counts)
        log(f"K5 via prepare_spmv {label}: bit-equal to K5 as given {equal}, against the plain version "
            f"{err!r} of max|y|, launches / renumbered / plain calls {counts} (expected (2, 1, 0))")
        if not equal or err > 1e-12 or counts != (2, 1, 0):
            raise AssertionError(f"K5 via prepare_spmv {label}: bit-equal {equal}, err {err}, counts {counts}")
    return out


ROUTE_OF = {"DiaTiledMat": "dia", "EllMat": "ell", "CsMat": "csr"}


def phase_main_mesh():
    """The implicit heat step on the permuted mesh (see the module note).
    Returns K5's launches over the CG solve, and the operator, right-hand
    side and solution for phases 5i and 5j."""
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
    if route != "ell" or prepared.width != 7 or prepared.renumbered:
        raise AssertionError(f"mesh step routed to {route}, width {getattr(prepared, 'width', None)}, "
                             f"renumbered {getattr(prepared, 'renumbered', None)}: expected ell of width 7 "
                             "in the caller's order")
    b = torch.zeros(n, dtype=torch.float64, device=DEVICE)
    b[centre] = 1.0

    reset_counts()
    t0 = time.perf_counter()
    res = cg(a, b, tol=SOLVE_TOL, max_iter=MAX_ITER)
    sync()
    wall = time.perf_counter() - t0
    launches, plain_calls = ell_spmv_kernel.launches, ell_spmv_plain.calls
    if ell_spmv_kernel.launches_renumbered:
        raise AssertionError(f"cg mesh: {ell_spmv_kernel.launches_renumbered} renumbered K5 products")

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
    return launches, {"a": a, "b": b, "x": res.x}


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
# the type forms of K1, K2 and K5 (bfloat16 first, phase 5k), and the
# solvers over operators stored in a narrower type
# ---------------------------------------------------------------------------

BF16 = torch.bfloat16
F16 = torch.float16
# the forms' errors against their plain versions, by (kernel line name, form)
FORM_ERRS = {}
FORM_LABEL = {
    form: f"({str(d)[6:]}, {str(x)[6:]}) -> {str(torch.promote_types(d, x))[6:]}"
    for (d, x), form in FORMS.items()
}
# a form's output against its plain version's, relative to max|y|, where
# the two may add in other orders (K5's shuffle tree; FMA contraction in
# K1 and K2): one step of a 16-bit output at max|y|, else a few roundings
FORM_GATE_LIMIT = {BF16: BF16_GATE_LIMIT, F16: 2.0**-10, torch.float32: 1e-6, torch.float64: 1e-13}
# the forms phase 3 gated first: float32, float64 and PR 11's bfloat16 ones
BASE_FORMS = ("f32", "f64", "bf16", "bf16_f32")
NEW_FORMS = tuple(pair for pair, form in FORMS.items() if form not in BASE_FORMS)
# the K3/K4 forms other than float32, float64 and bfloat16 (those that
# phases 3, 4 and 5c held first): thirteen (blocks, X) pairs
NEW_K3_FORMS = tuple(pair for pair, form in FORMS.items() if form not in ("f32", "f64", "bf16"))
# CG's stop in phase 5k: in float32 at 1024² the recursive residual
# reaches about 1e-6·‖b‖
BF16_CG_TOL = 1e-5
# the mesh step's CG over its bf16-rounded values: the true residual,
# taken in float64 against that operator, within this share of ‖b‖, and
# the iterations within this share of the float32-stored CG's
BF16_MESH_RESIDUAL = 1e-4
BF16_MESH_ITERS_SLACK = 0.10


def check_form(name, kname, kernel, y, ref, data_dtype, x_dtype, before):
    """A form's output (type promote(data, x)) against its plain
    version's: K1 and K2 bit-equal where the output is 16-bit (the same
    order of additions, exact or rounded products), else within
    FORM_GATE_LIMIT; the form's launch counter must have moved by one."""
    form = FORMS[(data_dtype, x_dtype)]
    out = torch.promote_types(data_dtype, x_dtype)
    if getattr(kernel, f"launches_{form}") != before + 1:
        raise AssertionError(f"gate {name}: the {form} form did not launch")
    if y.dtype != out or ref.dtype != out or y.shape != ref.shape or not bool(
            torch.isfinite(y).all()):
        raise AssertionError(f"gate {name}: bad output {tuple(y.shape)} {y.dtype}")
    err = float((y.double() - ref.double()).abs().max())
    ref_max = float(ref.double().abs().max())
    if out.itemsize == 2 and kname != "ell_spmv":
        same = bits_equal(y, ref)
        log(f"gate {name} [{form}]: bit-equal to plain {same}, max_abs_err {err!r}")
        if not same:
            raise AssertionError(f"gate {name}: {FORM_LABEL[form]} differs from the plain version")
    else:
        check_rel(f"{name} [{form}]", err, ref_max, FORM_GATE_LIMIT[out])
    FORM_ERRS.setdefault((kname, form), []).append(err)
    return err


def gate_spmv_form(name, dia, x):
    before = getattr(dia_spmv_kernel, f"launches_{FORMS[(dia.dtype, x.dtype)]}")
    y = dia_spmv_kernel(dia, x)
    ref = dia_spmv_plain(dia, x)
    sync()
    return check_form(name, "dia_spmv", dia_spmv_kernel, y, ref, dia.dtype, x.dtype, before)


def gate_spmm_form(name, dia, x):
    """K2's form against its plain version; the variant the wrapper's
    rule picks for X (by X's element size) must be the one that ran."""
    kind = k2.variant_for(dia, x)
    before_kind = getattr(dia_spmm_kernel, f"launches_{kind}")
    before = getattr(dia_spmm_kernel, f"launches_{FORMS[(dia.dtype, x.dtype)]}")
    y = dia_spmm_kernel(dia, x)
    ref = dia_spmm_plain(dia, x)
    sync()
    if getattr(dia_spmm_kernel, f"launches_{kind}") != before_kind + 1:
        raise AssertionError(f"gate {name}: the {kind} variant did not launch")
    return check_form(f"{name} ({kind})", f"dia_spmm_{kind}", dia_spmm_kernel, y, ref, dia.dtype,
                      x.dtype, before)


def gate_ell_form(name, ell, x):
    before = getattr(ell_spmv_kernel, f"launches_{FORMS[(ell.dtype, x.dtype)]}")
    y = ell_spmv_kernel(ell, x)
    ref = ell_spmv_plain(ell, x)
    sync()
    return check_form(name, "ell_spmv", ell_spmv_kernel, y, ref, ell.dtype, x.dtype, before)


def form_op(op, dtype):
    """``op`` (a prepared DIA operand or an EllMat) with its values in
    ``dtype``."""
    if isinstance(op, EllMat):
        return EllMat(op.indices, op.data.to(dtype), op.shape)
    return dia_tile(type(op)(op.data.to(dtype), op.offsets, op.shape))


def gate_grads_bf16():
    """The backwards of K1 (bf16, f32), K2 (bf16, bf16) and K5 (bf16, f32)
    on small bfloat16 operands against torch's autograd of the plain
    versions on the CPU: ddata in bfloat16, dx in x's type, within one
    bfloat16 step or 1e-5 of their max."""
    dia = form_op(laplacian_operand(grid_laplacian((64, 64), device=DEVICE), 7)[0], BF16)
    ell = form_op(small_ells()[1][1], BF16)
    cases = (
        ("K1", dia_spmv_kernel, dia_spmv_plain, dia, rhs_block(dia.cols, 1, torch.float32, 130)[:, 0]),
        ("K2", dia_spmm_kernel, dia_spmm_plain, dia, rhs_block(dia.cols, 24, BF16, 131)),
        ("K5", ell_spmv_kernel, ell_spmv_plain, ell, rhs_block(ell.cols, 1, torch.float32, 132)[:, 0]),
    )
    errs = {}
    for label, fn, plain, op, x in cases:
        def make(data):
            if isinstance(op, EllMat):
                return EllMat(op.indices.to(data.device), data, op.shape)
            return type(op)(data, op.offsets, op.shape)

        g = torch.from_numpy(np.random.default_rng(133).standard_normal(
            (op.rows,) + tuple(x.shape[1:]))).to(DEVICE, x.dtype)
        data = op.data.clone().requires_grad_(True)
        xg = x.clone().requires_grad_(True)
        dd, dx = torch.autograd.grad(fn(make(data), xg), (data, xg), g)
        data_c = op.data.cpu().requires_grad_(True)
        x_c = x.cpu().requires_grad_(True)
        dd_c, dx_c = torch.autograd.grad(plain(make(data_c), x_c), (data_c, x_c), g.cpu())
        if dd.dtype != BF16 or dx.dtype != x.dtype:
            raise AssertionError(f"gate grad {label} bf16: ddata {dd.dtype}, dx {dx.dtype}")
        errs[label] = max(
            check_rel(f"grad {label} bf16 {part}", float((a.cpu().float() - b.float()).abs().max()),
                      float(b.float().abs().max()),
                      BF16_GATE_LIMIT if a.dtype == BF16 else GATE_LIMIT[torch.float32])
            for part, a, b in (("ddata", dd, dd_c), ("dx", dx, dx_c)))
    return errs


def phase_gate_bf16(lap_spmv, mesh_a, random8):
    """Phase 3's bfloat16 gates: K1 and K2 in (bf16, bf16) and (bf16, f32)
    on the grid Laplacians and the random band at every RHS width phase 3
    uses (aligned and misaligned X), K5 in both forms on the small odd
    ELLs, the mesh step and random8 rounded to bfloat16, and the
    backwards."""
    band = form_op(band_dia(5000, 4803, BAND_OFFSETS, np.float32, 3), BF16)
    lap64 = grid_laplacian((64, 64), BF16, device=DEVICE)
    ops = (
        ("64x64 grid", dia_tile(lap64.to_dia())),
        (f"{SOLVE_SIDE}^2 grid", dia_tile(grid_laplacian((SOLVE_SIDE,) * 2, BF16, device=DEVICE).to_dia())),
        (f"{SOLVE_SIDE}^2 dirichlet",
         dia_tile(dirichlet_laplacian((SOLVE_SIDE,) * 2, BF16, device=DEVICE).to_dia())),
        (f"band 5000x4803 {BAND_OFFSETS}", band),
        ("band transposed", dia_tile(dia_to_csmat(band).T.to_csr().to_dia())),
    )
    big = dia_tile(lap_spmv.astype(BF16).to_dia())
    ells = [(f"{MESH_SIDE}^2 mesh step", ell_from_csmat(mesh_a.astype(BF16))),
            (f"random8 n={RANDOM8_N}", form_op(random8[1], BF16))]
    ells += [(label.replace(" torch.float32", ""), form_op(ell, BF16)) for label, ell, _ in small_ells()
             if ell.dtype == torch.float32]
    for xdt in (BF16, torch.float32):
        for label, dia in ops[:4] + ((f"{SPMV_SIDE}^2 grid", big),):
            x = rhs_block(dia.cols, 1, torch.float32, 134)[:, 0].to(xdt)
            gate_spmv_form(f"K1 {label} bfloat16 x {xdt}", dia, x)
    for label, dia in ops:
        # one block of the widest RHS, drawn on the card, whose leading
        # columns give every width (host draws of the 1024²-row blocks
        # would take most of the phase)
        gen = torch.Generator(device=DEVICE).manual_seed(137)
        block = torch.randn((dia.cols, max(SPMM_WIDTHS)), generator=gen, device=DEVICE)
        for xdt in (BF16, torch.float32):
            for k in SPMM_WIDTHS:
                x = block[:, :k].to(xdt).contiguous()
                gate_spmm_form(f"K2 {label} bfloat16 k={k} x {xdt}", dia, x)
                gate_spmm_form(f"K2 {label} bfloat16 k={k} x {xdt} misaligned X", dia, misaligned_copy(x))
        del block
    for xdt in (BF16, torch.float32):
        for label, ell in ells:
            x = rhs_block(ell.cols, 1, torch.float32, 135)[:, 0].to(xdt)
            gate_ell_form(f"K5 {label} bfloat16 x {xdt}", ell, x)
    grads = gate_grads_bf16()
    FORM_ERRS[("dia_spmv", "bf16_f32")].append(grads["K1"])
    FORM_ERRS[("dia_spmm_tma", "bf16")].append(grads["K2"])
    FORM_ERRS[("ell_spmv", "bf16_f32")].append(grads["K5"])


def phase_timing_bf16(lap_spmv, random8):
    """Phase 4's bfloat16 rows, both forms, beside the float32 rows: K1 at
    the 4096² grid, K2 at the 2048×1024 grid with 128 RHS, K5 at random8
    rounded to bfloat16.  Returns {(kernel line name, form): row}."""
    rows = {}
    lap = lap_spmv.astype(BF16)
    dia = dia_tile(lap.to_dia())
    # phase 4's float32 x (laplacian_operand's), and the same rounded
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(dia.cols)).to(DEVICE, torch.float32)
    for xdt in (BF16, torch.float32):
        rows[("dia_spmv", FORMS[(BF16, xdt)])] = timing_spmv(
            f"{SPMV_SIDE}^2 grid bfloat16, x {str(xdt)[6:]}", lap, dia, x.to(xdt), reps=50)
    del lap, dia, x
    lap2 = grid_laplacian(SPMM_GRID, BF16, device=DEVICE)
    dia2 = dia_tile(lap2.to_dia())
    X = rhs_block(dia2.cols, 128, torch.float32, 30)
    for xdt in (BF16, torch.float32):
        rows[("dia_spmm_tma", FORMS[(BF16, xdt)])] = timing_spmm(
            f"{SPMM_GRID[0]}x{SPMM_GRID[1]} grid bfloat16 k=128, X {str(xdt)[6:]}", lap2, dia2, X.to(xdt), reps=20)
    del lap2, dia2, X
    mat = random8[0].astype(BF16)
    ell = form_op(random8[1], BF16)
    for xdt in (BF16, torch.float32):
        rows[("ell_spmv", FORMS[(BF16, xdt)])] = timing_ell(
            f"random8 n={RANDOM8_N} bfloat16, x {str(xdt)[6:]}", mat, ell, random8[2].to(xdt), reps=50)
    return rows


def bits_equal(a, b):
    as_int = {2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a.view(as_int), b.view(as_int))


def form_counts(kernel, form, plain):
    """(all launches, the form's launches, the plain version's calls)."""
    return kernel.launches, getattr(kernel, f"launches_{form}"), plain.calls


def cg_stored_both(tag, make, b, tol, ref_dtype, dtype):
    """CG on ``b`` over the operator ``make(t)`` stored in ``ref_dtype``
    and in ``dtype``, in turns (ref, new, new, ref: the second of each is
    reported, with a profiled window), each through ``prepare_spmv`` and
    K1 in its form (iters+2 launches of it, the plain version's calls 0).
    The operator's entries are exact in ``dtype``, so the two must agree
    bit for bit, x and iteration count.  Returns (row, the new form's
    launches)."""
    side = SOLVE_SIDE
    row, runs, launches = {}, {}, 0
    for stored in (ref_dtype, dtype, dtype, ref_dtype):
        label, form = str(stored)[6:], FORMS[(stored, b.dtype)]
        mat = make(stored)
        sync()
        t0 = time.perf_counter()
        fn, prepared = prepare_spmv(mat)
        sync()
        prep_s = time.perf_counter() - t0
        reset_counts()
        t0 = time.perf_counter()
        res = cg(mat, b, tol=tol, max_iter=MAX_ITER)
        sync()
        wall = time.perf_counter() - t0
        total, mine, plain = form_counts(dia_spmv_kernel, form, dia_spmv_plain)
        if stored == dtype:
            launches += mine
        if label in runs:
            prof = profile_window(f"cg {side}^2 dirichlet stored in {label}, {str(b.dtype)[6:]} b, "
                                  f"{PROFILE_ITERS} iterations",
                                  lambda: cg(lambda v: fn(prepared, v), b, tol=tol, max_iter=PROFILE_ITERS),
                                  "dia_spmv")
            if not (res.iterations == runs[label].iterations and bits_equal(res.x, runs[label].x)):
                raise AssertionError(f"{tag} cg {label}: two runs differ")
            row[f"cg_{label}"] = {"iterations": res.iterations, "s": wall, "first_s": row.pop(label),
                                  "prepare_spmv_s": prep_s,
                                  "ms_per_iteration": wall / max(res.iterations, 1) * 1e3,
                                  "device_idle_share": prof["device_idle_share"], "launches": total}
        else:
            row[label] = wall
        runs[label] = res
        log(f"{tag} cg {side}^2 dirichlet stored in {label}, {str(b.dtype)[6:]} b, tol {tol}: iterations "
            f"{res.iterations} converged {res.converged} wall {wall!r} s "
            f"({wall / max(res.iterations, 1) * 1e3!r} ms per iteration; prepare_spmv {prep_s!r} s), "
            f"K1 launches {total} ({form} {mine}, expected {res.iterations + 2}), plain calls {plain}")
        if not res.converged or not (total == mine == res.iterations + 2) or plain != 0:
            raise AssertionError(f"{tag} cg {label}: converged {res.converged}, launches {total}/{mine}, "
                                 f"plain {plain}")
        if res.x.dtype != b.dtype:
            raise AssertionError(f"{tag} cg {label}: x is {res.x.dtype}, b {b.dtype}")
        del mat, prepared
    ref, new = runs[str(ref_dtype)[6:]], runs[str(dtype)[6:]]
    same = ref.iterations == new.iterations and bits_equal(ref.x, new.x)
    log(f"{tag} cg: {str(dtype)[6:]}-stored iterations and x bit-equal to the {str(ref_dtype)[6:]}-stored "
        f"run: {same}")
    if not same:
        raise AssertionError(f"{tag} cg: the {dtype}-stored run differs from the {ref_dtype}-stored one")
    return row, launches


def expm_stored_both(tag, make, B, ref_dtype, dtype):
    """``expm_multiply(A, B, t=-1)`` over ``make(t)`` stored in
    ``ref_dtype`` and in ``dtype`` through ``prepare_spmm`` and K2's
    tma variant: bit-equal (the entries are exact in ``dtype``), one
    launch per SpMM (counted by a callable that computes the CsMat path's
    substeps, 2A with t/2, term for term), the plain version's calls 0,
    column sums in (0, 1].  Returns (row, the new form's launches)."""
    row, ys = {}, {}
    for stored in (ref_dtype, dtype):
        label, form = str(stored)[6:], FORMS[(stored, B.dtype)]
        lap = make(stored)
        sync()
        reset_counts()
        t0 = time.perf_counter()
        ys[label] = expm_multiply(lap, B, t=-1.0)
        sync()
        wall = time.perf_counter() - t0
        total, mine, plain = form_counts(dia_spmm_kernel, form, dia_spmm_plain)
        tma = dia_spmm_kernel.launches_tma
        if stored == dtype:
            launches = mine
            fn, prepared = prepare_spmm(lap)
            spmms = [0]

            def op(v):
                spmms[0] += 1
                return 2.0 * fn(prepared, v)

            same_ref = bits_equal(expm_multiply(op, B, t=-0.5), ys[label])
        row[f"expm_{label}"] = {"s": wall, "launches": total}
        log(f"{tag} expm_multiply {SOLVE_SIDE}^2 stored in {label}, {B.shape[1]} {str(B.dtype)[6:]} "
            f"sources: wall {wall!r} s, K2 launches {total} ({form} {mine}, tma {tma}), plain calls "
            f"{plain}")
        if not (total == mine == tma > 0) or plain != 0:
            raise AssertionError(f"{tag} expm {label}: launches {total}/{mine}/{tma}, plain {plain}")
        del lap
    new = ys[str(dtype)[6:]]
    col_sums = new.sum(0)
    same = bits_equal(ys[str(ref_dtype)[6:]], new)
    log(f"{tag} expm: {str(dtype)[6:]}-stored bit-equal to the {str(ref_dtype)[6:]}-stored call {same}; "
        f"SpMMs by a counting callable {spmms[0]} (bit-equal {same_ref}) against {launches} K2 launches")
    if not (same and same_ref and spmms[0] == launches):
        raise AssertionError(f"{tag} expm: not bit-equal, or not one launch per SpMM")
    if not bool(((col_sums > 0) & (col_sums <= 1.0 + 1e-6)).all()):
        raise AssertionError(f"{tag} expm: column sums outside (0, 1]")
    return row, launches


def mesh_cg_stored(tag, mesh, dtype, ref_dtype, b_dtype, tol, residual):
    """CG on phase 5d's mesh step stored in ``dtype`` (its values rounded)
    with ``b`` in ``b_dtype``, through the ELL arm of ``prepare_spmv``
    and K5 in that form: converged, iters+2 launches, the plain version's
    calls 0, the true residual (in float64, against the rounded operator)
    within ``residual``·‖b‖, and the iterations within
    BF16_MESH_ITERS_SLACK of the same CG over the step stored in
    ``ref_dtype``.  Returns (row, launches)."""
    form = FORMS[(dtype, b_dtype)]
    a = mesh["a"].astype(dtype)
    b = mesh["b"].to(b_dtype)
    sync()
    t0 = time.perf_counter()
    fn, prepared = prepare_spmv(a)
    sync()
    prep_s = time.perf_counter() - t0
    if ROUTE_OF[type(prepared).__name__] != "ell" or prepared.width != 7:
        raise AssertionError(f"{tag} mesh step routed to {type(prepared).__name__}")
    reset_counts()
    t0 = time.perf_counter()
    res = cg(a, b, tol=tol, max_iter=MAX_ITER)
    sync()
    wall = time.perf_counter() - t0
    total, mine, plain = form_counts(ell_spmv_kernel, form, ell_spmv_plain)
    b_norm = float(torch.linalg.vector_norm(b.double()))
    true_res = float(torch.linalg.vector_norm(b.double() - spmv(a.astype(torch.float64), res.x.double())))
    ref = cg(mesh["a"].astype(ref_dtype), b, tol=tol, max_iter=MAX_ITER)
    row = {"iterations": res.iterations, f"{str(ref_dtype)[6:]}_stored_iterations": ref.iterations,
           "s": wall, "prepare_spmv_s": prep_s, "true_residual_rel": true_res / b_norm}
    log(f"{tag} cg mesh {MESH_SIDE}^2 step stored in {str(dtype)[6:]}, {str(b_dtype)[6:]} b: iterations "
        f"{res.iterations} converged {res.converged} wall {wall!r} s (prepare_spmv {prep_s!r} s), true "
        f"residual {true_res / b_norm!r} of ||b|| (limit {residual}), K5 launches {total} ({form} {mine}, "
        f"expected {res.iterations + 2}), plain calls {plain}; {str(ref_dtype)[6:]}-stored CG "
        f"{ref.iterations} iterations")
    if not (res.converged and true_res <= residual * b_norm) or res.x.dtype != b_dtype:
        raise AssertionError(f"{tag} cg mesh: converged {res.converged}, true residual {true_res}")
    if not (total == mine == res.iterations + 2) or plain != 0:
        raise AssertionError(f"{tag} cg mesh: launches {total}/{mine}, plain {plain}")
    if abs(res.iterations - ref.iterations) > BF16_MESH_ITERS_SLACK * ref.iterations:
        raise AssertionError(f"{tag} cg mesh: {res.iterations} iterations against {ref.iterations}")
    return row, mine


def route_products(tag, pairs, lap_spmv, random8):
    """One product per (data, x) pair in ``pairs`` on each route at phase
    4's full shapes, through ``prepare_spmv`` / ``prepare_spmm``: the
    4096² SpMV (K1), the 128-RHS SpMM on the 2048×1024 grid (K2's tma
    variant) and random8 (K5), each against its plain version.  Returns
    {(kernel line name, form): launches}."""
    launches = {}
    for kname, kernel, plain_fn, make, route in (
        ("dia_spmv", dia_spmv_kernel, dia_spmv_plain, lambda t: lap_spmv.astype(t), "spmv"),
        ("dia_spmm_tma", dia_spmm_kernel, dia_spmm_plain,
         lambda t: grid_laplacian(SPMM_GRID, t, device=DEVICE), "spmm"),
        ("ell_spmv", ell_spmv_kernel, ell_spmv_plain, lambda t: random8[0].astype(t), "spmv"),
    ):
        for data_dtype in dict.fromkeys(d for d, _ in pairs):
            mat = make(data_dtype)
            fn, prepared = (prepare_spmv if route == "spmv" else prepare_spmm)(mat)
            gen = torch.Generator(device=DEVICE).manual_seed(136)
            x64 = torch.randn((mat.cols, 128) if route == "spmm" else (mat.cols,), generator=gen,
                              device=DEVICE, dtype=torch.float64)
            for x_dtype in (x for d, x in pairs if d == data_dtype):
                form = FORMS[(data_dtype, x_dtype)]
                x = x64.to(x_dtype)
                sync()
                reset_counts()
                y = fn(prepared, x)
                sync()
                total, mine, plain = form_counts(kernel, form, plain_fn)
                launches[(kname, form)] = mine
                if not (total == mine == 1) or plain != 0:
                    raise AssertionError(f"{tag} {kname} {form}: launches {total}/{mine}, plain {plain}")
                check_form(f"{tag} {kname} {type(prepared).__name__} {tuple(mat.shape)}", kname, kernel, y,
                           plain_fn(prepared, x), data_dtype, x_dtype, mine - 1)
            del mat, prepared, x64
    return launches


def phase_main_bf16(mesh, lap_spmv, random8):
    """Phase 5k (see the module note).  Returns {(kernel line name, form):
    launches} and the bf16_solvers line."""
    t_phase = time.perf_counter()
    n = SOLVE_SIDE * SOLVE_SIDE
    row = {"card_tol": BF16_CG_TOL}
    # a. CG over the Dirichlet Laplacian stored in bf16 and in f32
    b = torch.from_numpy(np.random.default_rng(120).standard_normal(n).astype(np.float32)).to(DEVICE)
    cg_row, k1 = cg_stored_both("5k", lambda t: dirichlet_laplacian((SOLVE_SIDE,) * 2, t, device=DEVICE),
                                b, BF16_CG_TOL, torch.float32, BF16)
    row.update(cg_row)
    launches = {("dia_spmv", "bf16_f32"): k1}
    # b. expm_multiply from EXPM_SOURCES sources over the grid Laplacian
    src = np.random.default_rng(50).choice(n, EXPM_SOURCES, replace=False)
    B = torch.zeros((n, EXPM_SOURCES), dtype=torch.float32, device=DEVICE)
    B[torch.from_numpy(src).to(DEVICE), torch.arange(EXPM_SOURCES, device=DEVICE)] = 1.0
    expm_row, launches[("dia_spmm_tma", "bf16_f32")] = expm_stored_both(
        "5k", lambda t: grid_laplacian((SOLVE_SIDE,) * 2, t, device=DEVICE), B, torch.float32, BF16)
    row.update(expm_row)
    # c. CG on the mesh step rounded to bf16, through the ELL arm and K5
    row["cg_mesh"], launches[("ell_spmv", "bf16_f32")] = mesh_cg_stored(
        "5k", mesh, BF16, torch.float32, torch.float32, BF16_CG_TOL, BF16_MESH_RESIDUAL)
    # d. one (bf16, bf16) product on each route
    launches.update(route_products("5k", [(BF16, BF16)], lap_spmv, random8))
    row["phase_s"] = time.perf_counter() - t_phase
    log(f"5k: {row['phase_s']!r} s")
    return launches, row


# ---------------------------------------------------------------------------
# every other (data, x) pair of f16, bf16, f32 and f64 through K1, K2 and
# K5, and f64 solvers over f32-stored, f32 solvers over f16-stored
# operators (phase 5l)
# ---------------------------------------------------------------------------

# f64 CG over an f32-stored operator stops where phases 5i and 5j do;
# f32 CG over an f16-stored one where phase 5k does
FORMS_CG_TOL = {torch.float64: CG_TOL, torch.float32: BF16_CG_TOL}
FORMS_MESH_RESIDUAL = {torch.float64: SOLVE_TOL, torch.float32: BF16_MESH_RESIDUAL}
FORMS_PHASE_BUDGET_S = 90.0  # phase 5l's share of the script's time, recorded beside its seconds


def phase_gate_forms(random8):
    """Phase 3's gates of the twelve forms of NEW_FORMS, each against its
    plain version: K1 on the random band and the 1024² grid Laplacian; K2
    on both at RHS widths 3 (scalar variant), 8, 24 and 128 (tma), and
    at 24 on an X off a 16-byte boundary (scalar); K5 on the small odd
    ELLs and random8.  Each gate checks its own form's counter."""
    t0 = time.perf_counter()
    band = band_dia(5000, 4803, BAND_OFFSETS, np.float64, 3)
    grid = dia_tile(grid_laplacian((SOLVE_SIDE,) * 2, device=DEVICE).to_dia())
    ells = [(f"random8 n={RANDOM8_N}", random8[1])]
    ells += [(label.replace(" torch.float32", ""), ell) for label, ell, _ in small_ells()
             if ell.dtype == torch.float32]
    gen = torch.Generator(device=DEVICE).manual_seed(138)
    # one block of the widest RHS per operand, drawn on the card, whose
    # leading columns give every width
    ops = [(label, dia, torch.randn((dia.cols, 128), generator=gen, device=DEVICE, dtype=torch.float64))
           for label, dia in ((f"band 5000x4803 {BAND_OFFSETS}", band), (f"{SOLVE_SIDE}^2 grid", grid))]
    for data_dtype, x_dtype in NEW_FORMS:
        for label, dia, block in ops:
            op = form_op(dia, data_dtype)
            gate_spmv_form(f"K1 {label}", op, block[:, 0].to(x_dtype).contiguous())
            for k in (3, 8, 24, 128):
                gate_spmm_form(f"K2 {label} k={k}", op, block[:, :k].to(x_dtype).contiguous())
        gate_spmm_form(f"K2 {label} k=24 misaligned X", op,
                       misaligned_copy(block[:, :24].to(x_dtype).contiguous()))
        for label, ell in ells:
            x = torch.randn(ell.cols, generator=gen, device=DEVICE, dtype=torch.float64).to(x_dtype)
            gate_ell_form(f"K5 {label}", form_op(ell, data_dtype), x)
    log(f"gate forms: {len(NEW_FORMS)} forms in {time.perf_counter() - t0!r} s")


# K2's tma variant against its plain version on the shapes that stress
# its slab plan and TMA boxes: (label, rows, cols, offsets).  1000 rows
# are not a multiple of the tile rows (16 at 128 RHS, 80 at 24); offsets
# at or past the row count make boxes wholly outside X (-400, 2500) or
# partly so; the third holds its offsets out of order (slabs merge only
# diagonals consecutive in storage)
K2_TMA_OPERANDS = (
    ("band 1000x1100", 1000, 1100, (-70, -3, -1, 0, 2, 65)),
    ("band 300x2000 |off| >= rows", 300, 2000, (-400, -300, -1, 0, 1, 300, 1500, 2500)),
    ("band 777x777 unsorted", 777, 777, (2, -1, 0, 65, -70, 1, -3)),
)
K2_TMA_WIDTHS = (8, 24, 128, 256)


def phase_gate_k2_tma():
    """Phase 3's gates of K2's tma variant in all sixteen forms of FORMS
    on K2_TMA_OPERANDS at K2_TMA_WIDTHS, and at 24 on an X off a 16-byte
    boundary (the scalar variant); bit-equal to the plain version where Y
    is 16-bit.  Returns the number of gates."""
    t0 = time.perf_counter()
    gen = torch.Generator(device=DEVICE).manual_seed(139)
    n = 0
    for seed, (label, rows, cols, offsets) in enumerate(K2_TMA_OPERANDS):
        band = band_dia(rows, cols, offsets, np.float64, 140 + seed)
        block = torch.randn((cols, max(K2_TMA_WIDTHS)), generator=gen, device=DEVICE, dtype=torch.float64)
        for (data_dtype, x_dtype), form in FORMS.items():
            op = form_op(band, data_dtype)
            for k in K2_TMA_WIDTHS:
                x = block[:, :k].to(x_dtype).contiguous()
                if k2.variant_for(op, x) != "tma":
                    raise AssertionError(f"gate K2 {label} k={k} [{form}]: the rule does not pick tma")
                gate_spmm_form(f"K2 tma {label} k={k}", op, x)
            x = misaligned_copy(block[:, :24].to(x_dtype).contiguous())
            if k2.variant_for(op, x) != "scalar":
                raise AssertionError(f"gate K2 {label} misaligned [{form}]: the rule does not pick scalar")
            gate_spmm_form(f"K2 tma {label} k=24 misaligned X", op, x)
            n += len(K2_TMA_WIDTHS) + 1
    log(f"gate K2 tma: {n} gates in {time.perf_counter() - t0!r} s")
    return n


# K1 through a prepared operand's plan in all sixteen forms of FORMS:
# (label, rows, cols, offsets, rows_pad).  The main path's three sizes with
# the grid Laplacians' offsets; a wide band (offsets ±rows/2); rows != cols
# with rows_pad > rows; more columns than rows; offsets at or past the row
# count; k = 1; k = 64 in storage order and shuffled; and an odd rows_pad.
K1_GATE_OPERANDS = (
    (f"{SPMV_SIDE}^2 grid band", SPMV_SIDE**2, SPMV_SIDE**2, (-SPMV_SIDE, -1, 0, 1, SPMV_SIDE), None),
    (f"{SOLVE_SIDE}^2 grid band", SOLVE_SIDE**2, SOLVE_SIDE**2, (-SOLVE_SIDE, -1, 0, 1, SOLVE_SIDE), None),
    ("64^2 grid band", 64**2, 64**2, (-64, -1, 0, 1, 64), None),
    ("wide band 3000x3000 +-rows/2", 3000, 3000, (-1500, -1, 0, 1, 1499), None),
    ("band 5001x4803", 5001, 4803, BAND_OFFSETS, None),
    ("band 3000x7000", 3000, 7000, (-5, 0, 4000, 6500), None),
    ("band 300x2000 |off| >= rows", 300, 2000, (-400, -300, -1, 0, 1, 300, 1500, 2500), None),
    ("k=1 2000x2000", 2000, 2000, (3,), None),
    ("k=64 3000x3000 sorted", 3000, 3000, tuple(range(-32, 32)), None),
    ("k=64 3000x3000 shuffled", 3000, 3000,
     tuple(int(o) for o in np.random.default_rng(150).permutation(np.arange(-40, 24))), None),
    ("band 37x29", 37, 29, (-3, -1, 0, 1, 3), None),
    ("band 1001x1001 rows_pad 1001", 1001, 1001, (-7, -1, 0, 1, 7), 1001),
)
# the operands whose x is also gated off a 16-byte boundary
K1_MISALIGNED = (f"{SOLVE_SIDE}^2 grid band", "band 5001x4803", "band 37x29")
SIXTEEN_BIT = (F16, BF16)


def band_on_card(rows, cols, offsets, seed, rows_pad=None):
    """A float64 DIA operand of normal values drawn on the card, zero
    where a diagonal leaves the matrix (a host draw at 4096² would take
    most of the phase); rows padded to 8 unless ``rows_pad`` is given."""
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    rows_pad = round_up(rows, 8) if rows_pad is None else rows_pad
    data = torch.randn((len(offsets), rows_pad), generator=gen, device=DEVICE, dtype=torch.float64)
    i = torch.arange(rows_pad, device=DEVICE)
    for d, off in enumerate(offsets):
        data[d, (i >= rows) | (i + off < 0) | (i + off >= cols)] = 0.0
    return DiaMat(data, tuple(offsets), (rows, cols))


def k1_agrees(name, y, ref):
    """K1's output against the plain version's: bit for bit where both
    operands are 16-bit (their products are exact in f32, or rounded
    before the add in (f16, f16), so a fused multiply-add rounds as the
    plain version's separate add does), else within FORM_GATE_LIMIT of
    max|y| (the kernel contracts each product and its sum).  Returns the
    max abs error."""
    err = float((y.double() - ref.double()).abs().max())
    if bits_equal(y, ref):
        return err
    rel = err / max(float(ref.double().abs().max()), 1e-300)
    if rel > FORM_GATE_LIMIT[y.dtype]:
        raise AssertionError(f"gate {name}: max_abs_err {err!r} rel {rel!r} "
                             f"(limit {FORM_GATE_LIMIT[y.dtype]})")
    return err


def gate_k1(name, op, x):
    """K1 on a prepared operand (the direct launch) against the same kernel
    through the autograd Function on a bare DiaMat, bit for bit, and
    against its plain version on the card (:func:`k1_agrees`; bit for bit
    where both operands are 16-bit), with one launch of the form counted
    for each.  Files the error under FORM_ERRS for the forms other than
    f32 and f64."""
    form = FORMS[(op.dtype, x.dtype)]

    def counts():
        return dia_spmv_kernel.launches, getattr(dia_spmv_kernel, f"launches_{form}")

    before = counts()
    y = dia_spmv_kernel(op, x)
    y_bare = dia_spmv_kernel(DiaMat(op.data, op.offsets, op.shape), x)
    ref = dia_spmv_plain(op, x)
    sync()
    moved = tuple(a - b for a, b in zip(counts(), before))
    if moved != (2, 2):
        raise AssertionError(f"gate {name} [{form}]: launches moved by {moved} (all, form)")
    out = torch.promote_types(op.dtype, x.dtype)
    if y.dtype != out or y.shape != (op.rows,):
        raise AssertionError(f"gate {name} [{form}]: bad output {tuple(y.shape)} {y.dtype}")
    if not bits_equal(y, y_bare):
        raise AssertionError(f"gate {name} [{form}]: the direct launch differs from the per-call path")
    if op.dtype in SIXTEEN_BIT and x.dtype in SIXTEEN_BIT and not bits_equal(y, ref):
        raise AssertionError(f"gate {name} [{form}]: not bit-equal to the plain version")
    err = k1_agrees(f"{name} [{form}]", y, ref)
    if form not in ("f32", "f64"):
        FORM_ERRS.setdefault(("dia_spmv", form), []).append(err)
    return err


def gate_k1_nonfinite():
    """inf and NaN coefficients at slots whose x index lies outside [0,
    cols): the kernel skips those slots, so its rows 3 and 4790 stay
    finite where the plain version's zero-padded x gives NaN; every other
    row agrees with the plain version (:func:`k1_agrees`)."""
    band = band_on_card(5001, 4803, BAND_OFFSETS, 151)
    band.data[0, 3] = float("inf")  # offset -70: x[3 - 70] is outside
    band.data[5, 4790] = float("nan")  # offset 65: x[4855] is outside
    rest = torch.ones(band.rows, dtype=torch.bool, device=DEVICE)
    rest[[3, 4790]] = False
    for dt, xdt in ((torch.float32, torch.float32), (F16, F16), (torch.float64, BF16)):
        op = dia_tile(DiaMat(band.data.to(dt), band.offsets, band.shape))
        x = torch.randn(band.cols, generator=torch.Generator(device=DEVICE).manual_seed(152),
                        device=DEVICE, dtype=torch.float64).to(xdt)
        y, ref = dia_spmv_kernel(op, x), dia_spmv_plain(op, x)
        sync()
        form = FORMS[(dt, xdt)]
        if not (bool(torch.isfinite(y[[3, 4790]]).all()) and bool(torch.isnan(ref[[3, 4790]]).all())):
            raise AssertionError(f"gate K1 non-finite [{form}]: rows 3, 4790 kernel {y[[3, 4790]].tolist()}, "
                                 f"plain {ref[[3, 4790]].tolist()}")
        k1_agrees(f"K1 non-finite [{form}] other rows", y[rest], ref[rest])
        log(f"gate K1 non-finite [{form}]: rows 3 and 4790 finite (plain NaN), the others agree")


def phase_gate_k1():
    """Phase 3's gates of K1 through the plan: every operand of
    K1_GATE_OPERANDS in all sixteen forms (x drawn once in float64 on the
    card and rounded to each x type), those of K1_MISALIGNED also on an x
    off a 16-byte boundary, and the non-finite slots.  Returns the number
    of gates."""
    t0 = time.perf_counter()
    gen = torch.Generator(device=DEVICE).manual_seed(153)
    n = 0
    for seed, (label, rows, cols, offsets, rows_pad) in enumerate(K1_GATE_OPERANDS):
        band = band_on_card(rows, cols, offsets, 160 + seed, rows_pad)
        x64 = torch.randn(cols, generator=gen, device=DEVICE, dtype=torch.float64)
        for data_dtype in (F16, BF16, torch.float32, torch.float64):
            op = dia_tile(DiaMat(band.data.to(data_dtype), band.offsets, band.shape))
            for x_dtype in (F16, BF16, torch.float32, torch.float64):
                x = x64.to(x_dtype)
                gate_k1(f"K1 {label}", op, x)
                n += 1
                if label in K1_MISALIGNED:
                    gate_k1(f"K1 {label} misaligned x", op, misaligned_copy(x))
                    n += 1
            del op
        del band, x64
    gate_k1_nonfinite()
    log(f"gate K1: {n} gates, each bit-equal to the per-call path and agreeing with the plain version, "
        f"in {time.perf_counter() - t0!r} s")
    return n


# K7, the merge-path CSR product: the power-law gate's rows take Zipf
# lengths (at most 2,000), one hub row spans 40 tiles, and runs of rows
# are empty; the kron gate and timing take GAP's kron graph at scale 23
# (8,388,608 rows, 258,669,824 stored entries once its duplicates are
# summed), the kron23 PageRank cell's operator shape
K7_GATE_ROWS = 200_000
K7_GATE_COLS = 1 << 20
K7_HUB = 40 * TILE + 17
K7_KRON_SCALE = 23
K7_REPS = 20
# phase 5p: the kron23 PageRank cell's traffic (benchmark/traffic/ppr20.json)
PAGERANK_STEPS = 20
PAGERANK_DAMPING = 0.85
PAGERANK_SOURCES = 1024
# the cell's limit on max|x - x_ref| / max|x_ref| (benchmark/harness)
PAGERANK_LIMIT = 1e-4
# unit roundoffs, and half float16's subnormal spacing (below 2^-14 a
# rounding to float16 errs by up to 2^-25, absolute)
UNIT = {F16: 2.0**-11, BF16: 2.0**-8, torch.float32: 2.0**-24, torch.float64: 2.0**-53}
F16_SUBNORMAL = 2.0**-25


def k7_limit(mat, x, ref):
    """Each row's bound on |K7 - exact| (tests/test_torch_csr_spmv.py
    states it): (length + 1) roundings of promote(out, float32) over the
    row's sum of |terms|, the float16 product of (f16, f16), and one
    rounding to a 16-bit output."""
    out = torch.promote_types(mat.data.dtype, x.dtype)
    acc = torch.promote_types(out, torch.float32)
    mag = csr_spmv_plain(mat.with_data(mat.data.abs().double()), x.abs().double())
    lengths = (mat.indptr[1:] - mat.indptr[:-1]).double()
    bound = (lengths + 1) * UNIT[acc] * mag
    if mat.data.dtype == x.dtype == F16:
        bound = bound + UNIT[F16] * mag + lengths * F16_SUBNORMAL
    bound = 1.01 * bound
    if out.itemsize < 4:
        bound = bound + UNIT[out] * (ref.abs() + bound) + F16_SUBNORMAL * (out == F16)
    return bound


def gate_k7(name, mat, x):
    """K7 against the plain version over float64 copies, each row within
    ``k7_limit``; the launch and its form counted once.  Returns the
    largest error relative to max|ref|."""
    form = FORMS[(mat.data.dtype, x.dtype)]
    before, before_form = csr_spmv_kernel.launches, getattr(csr_spmv_kernel, f"launches_{form}")
    y = csr_spmv_kernel(mat, x)
    sync()
    if (csr_spmv_kernel.launches, getattr(csr_spmv_kernel, f"launches_{form}")) != (before + 1, before_form + 1):
        raise AssertionError(f"gate {name}: K7 did not count one launch of its {form} form")
    ref = csr_spmv_plain(mat.astype(torch.float64), x.double())
    err = (y.double() - ref).abs()
    excess = float((err - k7_limit(mat, x, ref)).max())
    rel = float(err.max() / ref.abs().max())
    log(f"gate {name}: max rel err {rel!r}, largest excess over the row bound {excess!r} (at most 0)")
    if not excess <= 0:
        raise AssertionError(f"gate {name}: a row exceeds its bound by {excess}")
    FORM_ERRS.setdefault(("csr_spmv", form), []).append(rel)
    return rel


def power_law_csr(seed):
    """K7's odd gate operand on the card: Zipf row lengths, a hub row over
    40 tiles, empty rows leading, trailing and in a run, random sorted
    columns (repeats kept) and 1,000 padding slots."""
    rng = np.random.default_rng(seed)
    n = np.minimum(rng.zipf(1.8, K7_GATE_ROWS) - 1, 2000)
    n[:5] = n[-5:] = 0
    n[K7_GATE_ROWS // 2: K7_GATE_ROWS // 2 + 500] = 0
    n[K7_GATE_ROWS // 3] = K7_HUB
    indptr = np.concatenate([[0], np.cumsum(n)]).astype(np.int32)
    cols = rng.integers(0, K7_GATE_COLS, int(indptr[-1]))
    cols = cols[np.lexsort((cols, np.repeat(np.arange(K7_GATE_ROWS), n)))]  # sorted in each row
    pad = 1000
    indices = np.concatenate([cols, np.zeros(pad, np.int64)]).astype(np.int32)
    data = np.concatenate([rng.standard_normal(int(indptr[-1])), np.zeros(pad)])
    mat = from_arrays("csmat", (K7_GATE_ROWS, K7_GATE_COLS), (indptr, indices, data), device=DEVICE)
    return mat, torch.from_numpy(rng.standard_normal(K7_GATE_COLS)).to(DEVICE)


def kron_csr(scale, seed):
    """GAP's kron graph (Graph500 generator, A 0.57, B 0.19, C 0.19, edge
    factor 16), symmetrized without self-loops, assembled on the card by
    ``coo_to_csmat`` (duplicates summed) with float32 values 1/deg of
    the column: the PageRank operator's shape and pattern."""
    n, m = 1 << scale, 16 << scale
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    src = torch.zeros(m, dtype=torch.int64, device=DEVICE)
    dst = torch.zeros(m, dtype=torch.int64, device=DEVICE)
    for _ in range(scale):
        u = torch.rand(m, generator=gen, device=DEVICE)
        right = u >= 0.76
        src = src * 2 + right.to(torch.int64)
        dst = dst * 2 + torch.where(right, u >= 0.95, u >= 0.57).to(torch.int64)
    del u, right
    perm = torch.randperm(n, generator=gen, device=DEVICE)
    src, dst = perm[src], perm[dst]
    keep = src != dst
    rows = torch.cat([src[keep], dst[keep]]).to(torch.int32)
    cols = torch.cat([dst[keep], src[keep]]).to(torch.int32)
    del src, dst, keep, perm
    deg = torch.bincount(rows.to(torch.int64), minlength=n)
    vals = (1.0 / deg[cols.to(torch.int64)].to(torch.float64)).to(torch.float32)
    mat = coo_to_csmat(rows, cols, vals, (n, n), device=DEVICE)
    del rows, cols, vals, deg
    return mat


def phase_k7():
    """Phase 3's gates of K7 and its phase 4 row: every form on the
    power-law operand (x drawn once in float64 and rounded to each x
    type), then the kron23 operator in (f32, f32) and (bf16, f32), two
    runs bit-equal; the kron23 product timed by CUDA events and the
    profiler beside its bytes bound, the plain version and ``torch.mv``
    on the CSR tensor (the yardstick: the port never calls it).  Returns
    (max error, timing row)."""
    t0 = time.perf_counter()
    mat, x64 = power_law_csr(190)
    errs = [gate_k7(f"K7 power law {FORM_LABEL[form]}", mat.astype(d), x64.to(xd))
            for (d, xd), form in FORMS.items()]
    del mat, x64
    big = kron_csr(K7_KRON_SCALE, 191)
    x = torch.rand(big.cols, generator=torch.Generator(device=DEVICE).manual_seed(192), device=DEVICE)
    errs.append(gate_k7("K7 kron23 (float32, float32)", big, x))
    errs.append(gate_k7("K7 kron23 (bfloat16, float32)", big.astype(BF16), x))
    first, second = csr_spmv_kernel(big, x), csr_spmv_kernel(big, x)
    sync()
    if not torch.equal(first.view(torch.int32), second.view(torch.int32)):
        raise AssertionError("K7: two runs of the kron23 product differ")
    ms = time_ms(lambda: csr_spmv_kernel(big, x), K7_REPS)
    dev_ms = (device_ms(lambda: csr_spmv_kernel(big, x), "csr_spmv_tiles", K7_REPS)
              + device_ms(lambda: csr_spmv_kernel(big, x), "csr_spmv_carries", K7_REPS))
    plain_ms = time_ms(lambda: csr_spmv_plain(big, x), 3)
    library_ms, lib_err, lib_error = library_time(lambda: torch.mv(csr_twin(big), x), first, K7_REPS)
    nnz = big.nnz
    # values and column indices once, the row pointers, x and y once
    nbytes = nnz * (4 + 4) + (big.rows + 1) * 4 + big.cols * 4 + big.rows * 4
    row = timing_row(f"kron23 PageRank operator float32 (rows {big.rows}, nnz {nnz})", ms, plain_ms,
                     library_ms, nbytes, 2 * nnz, PEAK_FLOPS[torch.float32], kernel="csr_spmv",
                     device_ms=dev_ms, library="torch.mv (CSR)", library_max_abs_err=lib_err,
                     library_error=lib_error, gather_l2_sector_bytes=nnz * 32)
    del big, x, first, second
    log(f"K7: {len(errs)} gates and the kron23 row in {time.perf_counter() - t0!r} s")
    return max(errs), row


K8_GATE_SIDES = (64, 1024, 4096)
K8_GATE_ITERS = 10
K8_SIDE = 4096
K8_REPS = 50
K8_SOLVE_ITERS = 50
# x of K8 against the masked loop on the card after K8_GATE_ITERS
# iterations, relative to max|x|: the two sum in other orders (K8 float32
# sums in float64), which BiCGSTAB on the heat operator grows about 10^4.5
# times in 10 iterations; measured 1e-15 (f64) and 2e-6 (f32)
K8_LIMIT = {torch.float64: 1e-9, torch.float32: 1e-4}
bicgstab_loops = importlib.import_module("sprs_tpu_torch.linalg.bicgstab")


def plain_bicgstab(a, b, tol, iters):
    """The masked loop from x = 0, as ``linalg.bicgstab`` runs it where K8
    does not take the solve."""
    x = torch.zeros_like(b)
    return bicgstab_loops._plain(a, None, b, x, b - a(x), tol, iters, 1e-30)


def heat_solve(side, dtype, seed):
    """(matvec, b) of the heat operator at side² through ``prepare_spmv``
    (K1), b uniform in [−1, 1) drawn in float64 from ``seed``."""
    fn, prepared = prepare_spmv(grid_laplacian((side, side), dtype, device=DEVICE))
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    b = torch.rand(side * side, generator=g, device=DEVICE, dtype=torch.float64) * 2.0 - 1.0
    return (lambda v: fn(prepared, v)), b.to(dtype)


def gate_k8(side, dtype):
    a, b = heat_solve(side, dtype, side)
    krylov.COUNTS.zero()
    fused = bicgstab(a, b, tol=0.0, max_iter=K8_GATE_ITERS)
    counts = dataclasses.asdict(krylov.COUNTS)
    again = bicgstab(a, b, tol=0.0, max_iter=K8_GATE_ITERS)
    plain = plain_bicgstab(a, b, 0.0, K8_GATE_ITERS)
    err = float((fused.x - plain.x).abs().max() / plain.x.abs().max())
    log(f"gate K8 heat {side}^2 {dtype}: x against the masked loop {err!r} "
        f"(limit {K8_LIMIT[dtype]!r}); counts {json.dumps(counts)}")
    if counts["launches"] != 6 * K8_GATE_ITERS or counts["plain_iterations"] != 0:
        raise AssertionError(f"K8 {side}^2 {dtype}: counts {counts}")
    if not torch.equal(fused.x, again.x) or fused.residual_norm != again.residual_norm:
        raise AssertionError(f"K8 {side}^2 {dtype}: two solves differ")
    if not err <= K8_LIMIT[dtype]:
        raise AssertionError(f"K8 {side}^2 {dtype}: x {err} from the masked loop")
    return err


def update_device(run, iters):
    """Device ms per iteration of a BiCGSTAB solve's ops other than K1's,
    K8's share of them, and device ops per iteration, from one traced
    solve of ``iters`` iterations (the set-up's few ops included)."""
    from torch.profiler import ProfilerActivity, profile

    run()
    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        sync()
    events = device_events(prof)
    other = [e for e in events if "dia_spmv" not in e.key]
    return (sum(e.self_device_time_total for e in other) / 1e3 / iters,
            sum(e.self_device_time_total for e in other if "k8_" in e.key) / 1e3 / iters,
            sum(e.count for e in events) / iters)


def phase_k8():
    """Phase 3's gates of K8 and its phase 4 row.  The row times the six
    passes of one iteration at the 4096² grid in float64 on fixed
    products (the state moves on; at tolerance 0 no restart fires),
    by CUDA events and by the profiler, pass by pass, beside the bytes of
    20 vectors; and the update work per iteration of a 50-iteration
    solve, K8's and the masked loop's.  Returns (max error, timing row)."""
    t0 = time.perf_counter()
    errs = [gate_k8(side, dtype) for side in K8_GATE_SIDES for dtype in (torch.float64, torch.float32)]
    a, b = heat_solve(K8_SIDE, torch.float64, 4096)
    n = b.numel()
    x = torch.zeros_like(b)
    r = b - a(x)
    rhat, p, s = r.clone(), r.clone(), torch.empty_like(r)
    v, t, ax = a(p), a(r), a(b)
    zero = b.new_zeros(())
    w = krylov.workspace(b, torch.dot(r, r), zero, zero.bool(), 1e-30, zero)

    def passes():
        krylov.rhat_dot_v(rhat, v, w)
        krylov.s_update(r, v, s, w)
        krylov.t_sums(t, s, w)
        krylov.xr_update(x, p, s, s, t, r, rhat, w)
        krylov.true_residual(b, ax, w)
        krylov.p_update(b, ax, r, rhat, p, v, w)

    from torch.profiler import ProfilerActivity, profile

    ms = time_ms(passes, K8_REPS)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(K8_REPS):
            passes()
        sync()
    per_pass = {re.search(r"k8_([a-z]+)", e.key).group(1): e.self_device_time_total / 1e3 / K8_REPS
                for e in device_events(prof) if "k8_" in e.key}
    if set(per_pass) != {"rv", "s", "tt", "xr", "true", "p"}:
        raise AssertionError(f"K8: the profiler saw the passes {sorted(per_pass)}")
    # bytes: r̂,v | r,v,s | t,s | x,x,p,s,t,r,r̂ | b,Ax | r,p,v,p
    passes_bytes = {"rv": 2, "s": 3, "tt": 2, "xr": 7, "true": 2, "p": 4}
    shares = {k: passes_bytes[k] * n * 8 / HBM_BYTES_PER_S * 1e3 / per_pass[k] for k in per_pass}
    del x, r, rhat, p, s, v, t, ax, w
    krylov.COUNTS.zero()
    fused_ms, k8_ms, fused_ops = update_device(
        lambda: bicgstab(a, b, tol=0.0, max_iter=K8_SOLVE_ITERS), K8_SOLVE_ITERS)
    launches = krylov.COUNTS.launches / 2 / K8_SOLVE_ITERS
    plain_ms, _, plain_ops = update_device(
        lambda: plain_bicgstab(a, b, 0.0, K8_SOLVE_ITERS), K8_SOLVE_ITERS)
    row = timing_row(f"BiCGSTAB iteration's updates, heat operator {K8_SIDE}^2 float64 (n {n})",
                     ms, plain_ms, None, 20 * n * 8, 27 * n, PEAK_FLOPS[torch.float64],
                     kernel="krylov", device_ms=sum(per_pass.values()), pass_device_ms=per_pass,
                     pass_roofline_share=shares, solve_k8_ms_per_iter=k8_ms,
                     solve_update_ms_per_iter=fused_ms, solve_device_ops_per_iter=fused_ops,
                     plain_device_ops_per_iter=plain_ops, k8_launches_per_iter=launches,
                     plain="the masked loop's update ops per iteration (device ms)")
    if launches != 6:
        raise AssertionError(f"K8: {launches} launches an iteration")
    log(f"K8: {len(errs)} gates and the 4096^2 row in {time.perf_counter() - t0!r} s")
    return max(errs), row


def phase_timing_forms(lap_spmv, random8):
    """Phase 4's rows of the twelve forms of NEW_FORMS beside the float32
    and bfloat16 rows: K1 at the 4096² grid, K2 at the 2048×1024 grid with
    128 RHS, K5 at random8, each with its bytes bound and the library
    call on the CSR tensor of the data's type (or the message where torch
    refuses the types).  Returns {(kernel line name, form): row}."""
    t0 = time.perf_counter()
    rows = {}
    data_dtypes = dict.fromkeys(d for d, _ in NEW_FORMS)
    # phase 4's float32 x (laplacian_operand's), in each x type
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(lap_spmv.cols)).to(DEVICE)
    for data_dtype in data_dtypes:
        lap = lap_spmv.astype(data_dtype)
        dia = dia_tile(lap.to_dia())
        for d, xdt in NEW_FORMS:
            if d == data_dtype:
                rows[("dia_spmv", FORMS[(d, xdt)])] = timing_spmv(
                    f"{SPMV_SIDE}^2 grid {FORM_LABEL[FORMS[(d, xdt)]]}", lap, dia, x.to(xdt), reps=50)
        del lap, dia
    del x
    gen = torch.Generator(device=DEVICE).manual_seed(30)
    X = torch.randn((SPMM_GRID[0] * SPMM_GRID[1], 128), generator=gen, device=DEVICE, dtype=torch.float64)
    for data_dtype in data_dtypes:
        lap2 = grid_laplacian(SPMM_GRID, data_dtype, device=DEVICE)
        dia2 = dia_tile(lap2.to_dia())
        for d, xdt in NEW_FORMS:
            if d == data_dtype:
                rows[("dia_spmm_tma", FORMS[(d, xdt)])] = timing_spmm(
                    f"{SPMM_GRID[0]}x{SPMM_GRID[1]} grid k=128 {FORM_LABEL[FORMS[(d, xdt)]]}", lap2, dia2,
                    X.to(xdt), reps=20)
        del lap2, dia2
    del X
    for data_dtype in data_dtypes:
        mat = random8[0].astype(data_dtype)
        ell = form_op(random8[1], data_dtype)
        for d, xdt in NEW_FORMS:
            if d == data_dtype:
                rows[("ell_spmv", FORMS[(d, xdt)])] = timing_ell(
                    f"random8 n={RANDOM8_N} {FORM_LABEL[FORMS[(d, xdt)]]}", mat, ell, random8[2].to(xdt),
                    reps=50)
        del mat, ell
    log(f"timing forms: {len(rows)} rows in {time.perf_counter() - t0!r} s")
    return rows


def phase_main_forms(mesh, lap_spmv, random8):
    """Phase 5l (see the module note).  Returns {(kernel line name, form):
    launches} and the forms_solvers line."""
    t_phase = time.perf_counter()
    n = SOLVE_SIDE * SOLVE_SIDE
    dirichlet = lambda t: dirichlet_laplacian((SOLVE_SIDE,) * 2, t, device=DEVICE)  # noqa: E731
    row = {"card_tol": {str(t)[6:]: tol for t, tol in FORMS_CG_TOL.items()}}
    launches = {}
    src = np.random.default_rng(51).choice(n, EXPM_SOURCES, replace=False)
    B = torch.zeros((n, EXPM_SOURCES), dtype=torch.float64, device=DEVICE)
    B[torch.from_numpy(src).to(DEVICE), torch.arange(EXPM_SOURCES, device=DEVICE)] = 1.0
    # a-c: float64 vectors over float32 storage; d: float32 over float16
    for tag, vec, ref_dtype, dtype, seed in (("5l f64/f32", torch.float64, torch.float64, torch.float32, 140),
                                             ("5l f32/f16", torch.float32, torch.float32, F16, 141)):
        form = FORMS[(dtype, vec)]
        b = torch.from_numpy(np.random.default_rng(seed).standard_normal(n)).to(DEVICE, vec)
        part = {}
        cg_row, launches[("dia_spmv", form)] = cg_stored_both(tag, dirichlet, b, FORMS_CG_TOL[vec],
                                                              ref_dtype, dtype)
        part.update(cg_row)
        expm_row, launches[("dia_spmm_tma", form)] = expm_stored_both(tag, dirichlet, B.to(vec),
                                                                         ref_dtype, dtype)
        part.update(expm_row)
        part["cg_mesh"], launches[("ell_spmv", form)] = mesh_cg_stored(
            tag, mesh, dtype, ref_dtype, vec, FORMS_CG_TOL[vec], FORMS_MESH_RESIDUAL[vec])
        row[f"{str(vec)[6:]}_over_{str(dtype)[6:]}"] = part
    # e. one product per remaining pair on each route
    rest = [pair for pair in NEW_FORMS if FORMS[pair] not in ("f32_f64", "f16_f32")]
    launches.update(route_products("5l", rest, lap_spmv, random8))
    row["phase_s"] = time.perf_counter() - t_phase
    row["phase_budget_s"] = FORMS_PHASE_BUDGET_S
    log(f"5l: {row['phase_s']!r} s (budget {FORMS_PHASE_BUDGET_S} s)")
    return launches, row

# ---------------------------------------------------------------------------
# K3 and K4 in every form (phases 3, 4 and 5m)
# ---------------------------------------------------------------------------


def form_bsr(bsr, dtype):
    """``bsr`` with its blocks rounded to ``dtype``."""
    return BsrMat(bsr.brows, bsr.bcols, bsr.blocks.to(dtype), bsr.shape, bsr.n_blocks)


def k3_launches(form):
    """{(kernel line name, form): launches} of K3 and K4 in ``form`` since
    the counts were set to 0: K3 under its variant's name (the rule gives
    one variant per form at the shapes phase 5m runs), K4 under its own."""
    kind = "tc" if form == FORMS[(F16, F16)] else "tf32x3"
    return {(f"bsr_spmm_{kind}", form): getattr(bsr_spmm_kernel, f"launches_{form}"),
            ("bsr_spmm_grouped", form): getattr(bsr_spmm_grouped_kernel, f"launches_{form}")}


def gate_grad_bsr_form(data_dtype, x_dtype):
    """The backward of K3 in one form on the card against ``bsr_vjp`` on
    the CPU: dblocks in the blocks' type and dX in X's, each within the
    limit of its type."""
    bsr = form_bsr(bsr_random(11, (300, 260), 8, 0.3, torch.float32, device=DEVICE), data_dtype)
    x = rhs_block(260, 20, x_dtype, 12)
    g = rhs_block(300, 20, torch.promote_types(data_dtype, x_dtype), 13)
    blocks = bsr.blocks.clone().requires_grad_(True)
    xg = x.clone().requires_grad_(True)
    y = bsr_spmm_kernel(BsrMat(bsr.brows, bsr.bcols, blocks, bsr.shape, bsr.n_blocks), xg)
    db, dx = torch.autograd.grad(y, (blocks, xg), g)
    cpu = BsrMat(bsr.brows.cpu(), bsr.bcols.cpu(), bsr.blocks.cpu(), bsr.shape, bsr.n_blocks)
    db_c, dx_c = k3.bsr_vjp(cpu, cpu.blocks, x.cpu(), g.cpu())
    if (db.dtype, dx.dtype) != (data_dtype, x_dtype) or (db_c.dtype, dx_c.dtype) != (data_dtype, x_dtype):
        raise AssertionError(f"grad K3 {FORMS[(data_dtype, x_dtype)]}: dblocks {db.dtype}, dX {dx.dtype}")
    return max(
        check_rel(f"grad K3 {label} (bs 8, {FORM_LABEL[FORMS[(data_dtype, x_dtype)]]})",
                  float((a.cpu().double() - b.double()).abs().max()), float(b.double().abs().max()),
                  BSR_GATE_LIMIT[a.dtype])
        for label, a, b in (("dblocks", db, db_c), ("dX", dx, dx_c)))


def phase_gate_k3_forms():
    """Phase 3's gates of K3 and K4 in the thirteen forms of NEW_K3_FORMS,
    each against the plain version, at block sizes 16 and 128: the
    1000×900 shape at k = 201, 256 and 1, an X off a 16-byte boundary, a
    sliced and unsorted operand, an empty block row, the K4 repack at
    group 4, and block magnitudes over WIDE_EXPONENTS; inf and NaN in the
    blocks and in X; the backward against ``bsr_vjp`` on the CPU.  Each
    gate checks the variant the rule picks (the wgmma one for (f16, f16)
    on aligned X at bs 128), the form that launched, and the form's TF32
    passes (1 + its operands wider than 16 bits)."""
    t0 = time.perf_counter()
    for data_dtype, x_dtype in NEW_K3_FORMS:
        form = FORMS[(data_dtype, x_dtype)]
        passes = k3.tf32_passes(data_dtype, x_dtype)
        if passes != 1 + (data_dtype.itemsize > 2) + (x_dtype.itemsize > 2):
            raise AssertionError(f"gate {form}: the rule takes {passes} TF32 passes")
        for bs in K3_FORM_BLOCK_SIZES:
            big = form_bsr(bsr_random(80 + bs, (1000, 900), bs, 0.3, torch.float32, device=DEVICE),
                           data_dtype)
            x = rhs_block(900, 256, x_dtype, 81)

            def expect(xx):
                tc = (data_dtype == x_dtype and bs in TC_BLOCK_SIZES and xx.shape[1] % 8 == 0
                      and xx.data_ptr() % 16 == 0)
                return "tc" if tc else "tf32x3"

            label = f"bs{bs} {FORM_LABEL[form]} ({passes} TF32 passes off wgmma)"
            for k in (201, 256, 1):
                xk = x[:, :k].contiguous()
                gate_bsr(f"K3 {label} 1000x900 k={k}", bsr_spmm_kernel, big, xk, expect=expect(xk))
            mis = misaligned_copy(x)
            gate_bsr(f"K3 {label} misaligned X", bsr_spmm_kernel, big, mis, expect=expect(mis))
            gate_bsr(f"K3 {label} sliced+unsorted", bsr_spmm_kernel, unsorted_slice(big, 82), x,
                     expect=expect(x))
            gate_bsr(f"K3 {label} empty block row", bsr_spmm_kernel, without_row_one(big), x,
                     expect=expect(x))
            gate_bsr(f"K4 {label} group 4", lambda b, v: bsr_spmm_grouped_kernel(b, v, 4),
                     bsr_group(big, 4), x, counter=bsr_spmm_grouped_kernel, expect=expect(x))
            lo, hi = WIDE_EXPONENTS.get(data_dtype, (-20, 20))
            gate_bsr(f"K3 {label} magnitudes 2^{lo}..2^{hi}", bsr_spmm_kernel,
                     wide_magnitude(big, 86), x, expect=expect(x))
        gate_nonfinite(data_dtype, x_dtype)
        gate_nonfinite(data_dtype, x_dtype, in_x=True)
        key = ("bsr_spmm_tf32x3", form)
        FORM_ERRS[key].append(gate_grad_bsr_form(data_dtype, x_dtype))
    log(f"gate K3/K4 forms: {len(NEW_K3_FORMS)} forms in {time.perf_counter() - t0!r} s")


def phase_timing_k3_forms():
    """Phase 4's rows of K3 and K4 in the thirteen forms of NEW_K3_FORMS
    at the K3 cell (n = 4096, k = 512, bs = 128, density 0.125: phase 4's
    float32 operand and X rounded to each form's types), K4 on its
    ``bsr_group`` repack at group 8.  Returns {(kernel line name, form):
    row}."""
    t0 = time.perf_counter()
    rows = {}
    bsr32 = bsr_random(40, (BSR_N, BSR_N), BSR_BS, BSR_DENSITIES[0], torch.float32, device=DEVICE)
    x64 = rhs_block(BSR_N, BSR_K, torch.float64, 41)
    for data_dtype in dict.fromkeys(d for d, _ in NEW_K3_FORMS):
        bsr = form_bsr(bsr32, data_dtype)
        grouped = bsr_group(bsr, BSR_GROUP)
        for d, x_dtype in NEW_K3_FORMS:
            if d != data_dtype:
                continue
            form = FORMS[(d, x_dtype)]
            x = x64.to(x_dtype)
            shape = f"n={BSR_N} k={BSR_K} bs={BSR_BS} density {BSR_DENSITIES[0]} {FORM_LABEL[form]}"
            row = timing_bsr(shape, "bsr_spmm", bsr_spmm_kernel, bsr, x, reps=20)
            rows[(f"bsr_spmm_{row['variant']}", form)] = row
            rows[("bsr_spmm_grouped", form)] = timing_bsr(
                f"{shape} group {BSR_GROUP}", "bsr_spmm_grouped",
                lambda b, v: bsr_spmm_grouped_kernel(b, v, BSR_GROUP), grouped, x, reps=20, product=bsr)
    log(f"timing K3/K4 forms: {len(rows)} rows in {time.perf_counter() - t0!r} s")
    return rows


def check_close(name, y, ref, dtype, limit):
    """``y`` of type ``dtype`` and the shape of ``ref``, finite, within
    ``limit`` of max|ref|."""
    if y.dtype != dtype or y.shape != ref.shape or not bool(torch.isfinite(y).all()):
        raise AssertionError(f"{name}: bad output {tuple(y.shape)} {y.dtype}")
    return check_rel(name, float((y.double() - ref.double()).abs().max()), float(ref.double().abs().max()),
                     limit)


def phase_main_bsr_forms(c_bsr):
    """Phase 5m (see the module note): block-sparse products in the
    production mixes at full width.  Returns {(kernel line name, form):
    launches}, the float32 launches of K3 that (a) times beside them,
    and the bsr_forms line."""
    t_phase = time.perf_counter()
    row = {}
    bsr32 = bsr_random(64, (BSR_N, BSR_N), BSR_BS, BSR_DENSITIES[0], torch.float32, device=DEVICE)
    x32 = rhs_block(BSR_N, BSR_K, torch.float32, 65)
    bsr_bf = form_bsr(bsr32, BF16)
    dense_bf = bsr_bf.to_dense().float()
    want = dense_bf @ x32
    g = rhs_block(BSR_N, BSR_K, torch.float32, 66)
    chain_x = rhs_block(c_bsr.cols, CHAIN_K, torch.float32, 95)
    chain_bf = form_bsr(c_bsr, BF16)
    chain_x64 = chain_x.double()
    bsr16 = form_bsr(bsr32, F16)
    x16 = x32.to(F16)
    want16 = bsr16.to_dense().float() @ x16.float()
    rest = [pair for pair in NEW_K3_FORMS if FORMS[pair] not in ("bf16_f32", "f32_f64", "f16")]
    rest_ops = {d: form_bsr(bsr32, d) for d in dict.fromkeys(d for d, _ in NEW_K3_FORMS)}
    grouped = {d: bsr_group(op, BSR_GROUP) for d, op in rest_ops.items()}
    sync()
    reset_counts()
    # a. bf16-stored blocks, f32 inputs (K3 (bf16, f32), 2 passes), timed
    #    beside the f32-stored product, then one backward through @
    y = bsr_bf @ x32
    ms_bf = time_ms(lambda: bsr_bf @ x32, K3_MAIN_REPS)
    ms_32 = time_ms(lambda: bsr32 @ x32, K3_MAIN_REPS)
    blocks = bsr_bf.blocks.clone().requires_grad_(True)
    xg = x32.clone().requires_grad_(True)
    db, dx = torch.autograd.grad(BsrMat(bsr_bf.brows, bsr_bf.bcols, blocks, bsr_bf.shape,
                                        bsr_bf.n_blocks) @ xg, (blocks, xg), g)
    # b. the dense chain's C_bsr stored in bf16, f32 X
    y_chain = chain_bf @ chain_x
    # c. f32-stored C_bsr, f64 X: the @ (XLA type f32) and the kernel (Pallas type f64)
    y_at = c_bsr @ chain_x64
    y_k = bsr_spmm_kernel(c_bsr, chain_x64)
    # d. (f16, f16) through the wgmma variant, timed
    y16 = bsr16 @ x16
    ms_16 = time_ms(lambda: bsr16 @ x16, K3_MAIN_REPS)
    # e. one product per remaining form through @, and K4 in every form
    ys = {pair: rest_ops[pair[0]] @ x32.to(pair[1]) for pair in rest}
    ys4 = {pair: bsr_spmm_grouped_kernel(grouped[pair[0]], x32.to(pair[1]), group=BSR_GROUP)
           for pair in NEW_K3_FORMS}
    sync()
    wall = time.perf_counter() - t_phase
    launches = {}
    for form in (FORMS[pair] for pair in NEW_K3_FORMS):
        launches.update(k3_launches(form))
    f32_launches = bsr_spmm_kernel.launches_f32
    plain = bsr_spmm_plain.calls
    timed = 1 + 3 + K3_MAIN_REPS  # the checked call, time_ms' warm-up and its reps
    expected = {key: 1 for key in launches}
    expected[("bsr_spmm_tf32x3", "bf16_f32")] = timed + 1 + 1  # + the backward's forward, the chain
    expected[("bsr_spmm_tf32x3", "f32_f64")] = 2
    expected[("bsr_spmm_tc", "f16")] = timed
    log(f"5m: launches {json.dumps({f'{k}/{f}': n for (k, f), n in launches.items()})}, "
        f"f32-stored {f32_launches}, plain calls {plain}")
    if launches != expected or f32_launches != 3 + K3_MAIN_REPS or plain != 0:
        raise AssertionError(f"5m: launches {launches}, expected {expected}; f32 {f32_launches}; "
                             f"plain calls {plain}")
    if bsr_spmm_kernel.launches_tc != expected[("bsr_spmm_tc", "f16")]:
        raise AssertionError(f"5m: {bsr_spmm_kernel.launches_tc} wgmma launches")

    errs = {}
    errs["a"] = check_close("5m a: bf16 blocks @ f32 X", y, want, torch.float32, 1e-5)
    dx_ref = dense_bf.T @ g
    full = g @ x32.T  # every block's G[brow] @ X[bcol]ᵀ, as a dense (n, n)
    db_ref = full.reshape(BSR_N // BSR_BS, BSR_BS, BSR_N // BSR_BS, BSR_BS).transpose(1, 2)[
        bsr_bf.brows.long(), bsr_bf.bcols.long()]
    errs["a_dX"] = check_close("5m a: dX (f32)", dx, dx_ref, torch.float32, 1e-5)
    errs["a_dblocks"] = check_close("5m a: dblocks (bf16)", db, db_ref, BF16, 2.0**-7)
    del dense_bf, full, db_ref
    errs["b"] = check_close("5m b: bf16 C_bsr @ f32 X", y_chain, bsr_spmm_plain(chain_bf, chain_x),
                            torch.float32, 1e-5)
    same = y_k.dtype == torch.float64 and torch.equal(y_at.double(), y_k)
    errs["c"] = check_close("5m c: f32 C_bsr @ f64 X (the @'s float32)", y_at,
                            bsr_spmm_plain(c_bsr, chain_x64), torch.float32, 1e-5)
    log(f"5m c: the kernel's {y_k.dtype} equal in value to the @'s {y_at.dtype}: {same}")
    if not same:
        raise AssertionError("5m c: @ and bsr_spmm_kernel differ in value")
    errs["d"] = check_close("5m d: (f16, f16) @ (wgmma)", y16, want16, F16, 2.0**-10)
    # e: @ gives float32 for a mixed pair (the JAX @'s type), K4 promote(blocks, X)
    for tag, (d, xd), yy in [("@", pair, yy) for pair, yy in ys.items()] + [
            ("K4", pair, yy) for pair, yy in ys4.items()]:
        out = torch.promote_types(d, xd) if tag == "K4" else torch.float32
        errs[f"e {tag} {FORMS[(d, xd)]}"] = check_close(
            f"5m e: {tag} ({str(d)[6:]}, {str(xd)[6:]}) -> {str(out)[6:]}", yy,
            bsr_spmm_plain(rest_ops[d], x32.to(xd)), out, BSR_GATE_LIMIT[out])
    del ys, ys4, y_chain, y_at, y_k
    row.update({
        "shape": f"n={BSR_N} k={BSR_K} bs={BSR_BS} density {BSR_DENSITIES[0]}; C_bsr {c_bsr.rows}^2 "
                 f"bs {c_bsr.block_size} ({c_bsr.n_blocks} blocks) @ X k={CHAIN_K}",
        "bf16_f32_ms": ms_bf, "f32_ms": ms_32, "f16_tc_ms": ms_16, "c_equal": same,
        "launches": {f"{k}/{f}": n for (k, f), n in launches.items()}, "f32_launches": f32_launches,
        "max_abs_err": errs, "wall_s": wall,
    })
    row["phase_s"] = time.perf_counter() - t_phase
    row["phase_budget_s"] = K3_FORMS_PHASE_BUDGET_S
    log(f"5m: (bf16, f32) @ {ms_bf!r} ms against f32-stored {ms_32!r} ms, (f16, f16) {ms_16!r} ms; "
        f"{row['phase_s']!r} s (budget {K3_FORMS_PHASE_BUDGET_S} s)")
    return launches, f32_launches, row


# Queue 3's check of formats/util.py::index_sum_ on the card: each case
# computed on the card and on the CPU from the same arrays, bits compared
INDEX_SUM_N = 4096  # columns of the sum(0) cases, 64 entries each
INDEX_SUM_CSR_N = 20_000  # rows of the CSR spmv cases, about 100 entries each


def random_csr(rows, cols, lengths, seed, device):
    """A CSR CsMat with ``lengths[r]`` distinct random columns in row r and
    normal values, built on ``device`` from one host draw."""
    rng = np.random.default_rng(seed)
    indptr = np.concatenate([[0], np.cumsum(lengths)])
    indices = np.concatenate([np.sort(rng.choice(cols, n, replace=False)) for n in lengths])
    data = rng.standard_normal(indices.size)
    return from_arrays("csmat", (rows, cols), (indptr.astype(np.int32), indices.astype(np.int32), data),
                       device=device)


def phase_index_sums_vs_cpu():
    """Queue 3 item 2: does ``index_sum_`` add in the CPU's (and the JAX
    package's) order on the card?  Each case runs on the card and on the
    CPU from the same arrays; the line records the entries whose bits
    differ (a difference is a finding, not a failure: the two-run
    determinism check stands apart): ``CsMat.sum(0)`` with 64 entries per
    column (f32, f64), the CSR-routed ``spmv`` with about 100 entries per
    row (f64, and in (bf16, bf16) and (f16, f16); on the card K7, which
    sums in its own order and, for 16-bit operands, in float32), and
    ``compress_coo`` with 40 duplicates per slot (f32)."""
    rng = np.random.default_rng(170)
    cases = {}
    t0 = time.perf_counter()
    n = INDEX_SUM_N
    col_major = [random_csr(n, n, [64] * n, 171, dev).T.to_csr() for dev in ("cpu", DEVICE)]
    for dt in (torch.float32, torch.float64):
        cases[f"CsMat.sum(0) 64 entries per column {str(dt)[6:]}"] = [
            lambda m=m, dt=dt: m.astype(dt).sum(0) for m in col_major]
    # about 100 entries a row; every hundredth row of 250 makes the ELL
    # padding 1.5, so prepare_spmv routes the operand to CSR
    lengths = rng.integers(50, 151, INDEX_SUM_CSR_N)
    lengths[::100] = 250
    csr = [random_csr(INDEX_SUM_CSR_N, INDEX_SUM_CSR_N, lengths, 172, dev) for dev in ("cpu", DEVICE)]
    if prepare_spmv(csr[1])[0] is not spmv:
        raise AssertionError("index sums: the spmv case does not route to CSR")
    x = rng.standard_normal(INDEX_SUM_CSR_N)
    for dt in (torch.float64, BF16, F16):
        cases[f"spmv CSR about 100 entries per row ({str(dt)[6:]}, {str(dt)[6:]})"] = [
            lambda m=m, dev=dev, dt=dt: spmv(m.astype(dt), torch.from_numpy(x).to(dev, dt))
            for m, dev in zip(csr, ("cpu", DEVICE))]
    slots = 50_000
    rows_ = np.repeat(np.arange(slots) // 250, 40)
    cols_ = np.repeat(np.arange(slots) % 250, 40)
    perm = rng.permutation(rows_.size)
    vals = rng.standard_normal(rows_.size).astype(np.float32)
    coo = [tuple(torch.from_numpy(a[perm]).to(dev) for a in (rows_.astype(np.int32), cols_.astype(np.int32),
                                                               vals)) for dev in ("cpu", DEVICE)]
    cases["compress_coo 40 duplicates per slot float32"] = [
        lambda r=r, c=c, v=v: compress_coo(r, c, (v,), r.numel(), slots // 250, 250, slots).values[0]
        for r, c, v in coo]
    out = {}
    for label, (on_cpu, on_card) in cases.items():
        a, b = on_cpu(), on_card()
        sync()
        b = b.cpu()
        bits = {8: torch.int64, 4: torch.int32, 2: torch.int16}[a.element_size()]
        differ = int((a.view(bits) != b.view(bits)).sum())
        rel = float((a.double() - b.double()).abs().max() / a.double().abs().max())
        out[label] = {"bit_equal": differ == 0, "entries_differing": differ, "of": a.numel(),
                      "max_rel_diff": rel}
        log(f"index sums card vs CPU {label}: {differ} of {a.numel()} entries differ (max rel {rel!r})")
    log(f"index sums card vs CPU: {len(out)} cases in {time.perf_counter() - t0!r} s")
    return out


def phase_determinism(mesh):
    """Sums by index on the card: each product run twice on one input,
    bits compared (ops/prod.py's CSR spmv, which runs K7, and spmm, ops/batch.py's batched
    product, one parallel/dist.py product with its per-shard products and
    assemble, trisolve's level and flat solves; ``CsMat.sum`` by rows and
    by columns and ``norm(1)`` / ``norm(inf)`` on the 1024² mesh step's
    pattern with normal values, K5's backward dx on the mesh step, K3's
    backward dX and the plain block product on the float32 K3 cell).  With ``index_add_``, whose atomics add in no
    fixed order, the first four differed, and of the last seven all but
    the two norms (whose maxima came out the same); they now sum through
    ``formats/util.py::index_sum_`` (an accumulating ``index_put_`` on the
    card), and any difference fails the run.  Returns the determinism
    line."""
    from sprs_tpu_torch.linalg import lsolve
    from sprs_tpu_torch.ops.cuda.bsr_spmm import bsr_vjp
    from sprs_tpu_torch.ops.cuda.ell_spmv import ell_vjp
    from sprs_tpu_torch.parallel import Mesh, dist_spmv, shard_csr_rows

    a = mesh["a"]
    n = a.rows
    rng = np.random.default_rng(140)
    x = torch.from_numpy(rng.standard_normal(n)).to(DEVICE)
    X = torch.from_numpy(rng.standard_normal((n, 8))).to(DEVICE)
    vals = torch.stack([a.data, 2.0 * a.data])
    xb = torch.from_numpy(rng.standard_normal((2, n))).to(DEVICE)
    slots = Mesh(np.array([torch.device(DEVICE)] * DIST_SLOTS, dtype=object), ("shards",))
    dm = shard_csr_rows(a, DIST_SLOTS, balance="nnz", device=slots)
    low = dirichlet_laplacian((DIRECT_SIDE, DIRECT_SIDE), device=DEVICE).tril()
    bl = torch.from_numpy(rng.standard_normal(low.rows)).to(DEVICE)
    ell = ell_from_csmat(a)
    g = torch.from_numpy(rng.standard_normal(n)).to(DEVICE)
    # the mesh step's pattern with normal values: its own entries are
    # integers, whose sums are exact in any order
    vals = torch.from_numpy(rng.standard_normal(a.cap)).to(DEVICE)
    ar = dataclasses.replace(a, data=torch.where(a.live_mask(), vals, torch.zeros_like(vals)))
    bsr = bsr_random(62, (BSR_N, BSR_N), BSR_BS, BSR_DENSITIES[0], torch.float32, device=DEVICE)
    xk, gk = rhs_block(BSR_N, BSR_K, torch.float32, 63), rhs_block(BSR_N, BSR_K, torch.float32, 64)
    cases = {
        "ops/prod.py spmv (CSR)": lambda: spmv(a, x),
        "ops/prod.py spmm (CSR, 8 columns)": lambda: spmm(a, X),
        "ops/batch.py batch_spmv (2 value sets)": lambda: batch_spmv(a, vals, xb),
        f"parallel/dist.py dist_spmv + assemble ({DIST_SLOTS} slots)":
            lambda: dm.assemble(dist_spmv(dm, x, slots)),
        f"linalg/trisolve.py lsolve levels ({DIRECT_SIDE}^2)": lambda: lsolve(low, bl, method="levels"),
        f"linalg/trisolve.py lsolve flat ({DIRECT_SIDE}^2)": lambda: lsolve(low, bl, method="flat"),
        "formats/csmat.py sum(axis=0) (mesh pattern, normal values)": lambda: ar.sum(0),
        "formats/csmat.py sum(axis=1) (mesh pattern, normal values)": lambda: ar.sum(1),
        "formats/csmat.py norm(1) (mesh pattern, normal values)": lambda: ar.norm(1),
        "formats/csmat.py norm(inf) (mesh pattern, normal values)": lambda: ar.norm(np.inf),
        "ops/cuda/ell_spmv.py ell_vjp dx (K5 backward, mesh step)": lambda: ell_vjp(ell, mesh["x"], g)[1],
        f"ops/cuda/bsr_spmm.py bsr_vjp dX (K3 backward, n {BSR_N}, k {BSR_K}, float32)":
            lambda: bsr_vjp(bsr, bsr.blocks, xk, gk)[1],
        f"formats/bsr.py bsr_spmm_plain (n {BSR_N}, k {BSR_K}, float32)": lambda: bsr_spmm_plain(bsr, xk),
    }
    out = {}
    for label, fn in cases.items():
        first = fn()
        second = fn()
        sync()
        bits = {8: torch.int64, 4: torch.int32}[first.element_size()]
        same = torch.equal(first.view(bits), second.view(bits))
        differ = int((first.view(bits) != second.view(bits)).sum())
        out[label] = {"bit_equal": same, "entries_differing": differ, "of": first.numel()}
        log(f"determinism {label}: two runs bit-equal {same} ({differ} of {first.numel()} entries differ)")
    if not all(v["bit_equal"] for v in out.values()):
        raise AssertionError("determinism: a product differs between two runs")
    out["card_vs_cpu"] = phase_index_sums_vs_cpu()
    return out


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
    K3.  Returns (rows, K3's 3xTF32 launches on the chain, C_bsr)."""
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
    return rows, launches, c_bsr


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
    launches of K5 (permuted step) and K1 (the step itself), and L @ L
    for phase 5j."""
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
    del ref_lap
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
    log(f"biharmonic P·A·Pᵀ: prepare_spmv renumbered {prepared.renumbered}, mean gather bytes "
        f"{mean_gather(ap.to_csr()) * ap.dtype.itemsize!r}")
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
        renumbered = ell_spmv_kernel.launches_renumbered
        if renumbered != (launches if kernel is ell_spmv_kernel and prepared.renumbered else 0):
            raise AssertionError(f"gmres biharmonic {label}: {renumbered} renumbered K5 products")
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
    return k5, k1, lap2


# ---------------------------------------------------------------------------
# the direct-solver path (phase 5g): orderings, LDLᵀ, mixed precision,
# preconditioned Krylov solves, LU and solve, the row-scan numeric
# ---------------------------------------------------------------------------


def convection_diffusion(side):
    """C = L + 0.5·(upwind first difference along the grid's fast index),
    built on the card with ``kronecker_product``: nonsymmetric, five
    diagonals."""
    i = eye(side, torch.float64, device=DEVICE)
    d = diags([1.0, -1.0], [0, -1], (side, side), device=DEVICE)
    return dirichlet_laplacian((side, side), device=DEVICE) + kronecker_product(i, d) * CONVECTION


def rel_max(x, ref):
    return float((x - ref).abs().max() / ref.abs().max())


def gate(name, value, limit):
    log(f"gate {name}: {value!r} (limit {limit!r})")
    if not value <= limit:
        raise AssertionError(f"gate {name}: {value} > {limit}")


def timed(fn):
    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    return out, time.perf_counter() - t0


def solve_ms(fn, reps):
    """CUDA-event ms per call of ``fn`` over ``reps`` calls after one
    warm-up call."""
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


def k1_counts():
    return dia_spmv_kernel.launches, dia_spmv_plain.calls


def phase_direct():
    """Phase 5g on the 256² Dirichlet Laplacian (65,536 rows, f64) on the
    card.  Returns the K1 launches of its main-path solves and what phase
    5h reuses: the matrix, right-hand side, symbolics, the host factor
    with its seconds, and the reference solutions."""
    side = DIRECT_SIDE
    n = side * side
    a = dirichlet_laplacian((side, side), device=DEVICE)
    a_sp = a.to_scipy().tocsc()
    rng = np.random.default_rng(90)
    b = torch.from_numpy(rng.standard_normal(n)).to(DEVICE)
    b_np = b.cpu().numpy()
    k1 = 0
    t_start = time.perf_counter()

    def stamp(step):
        log(f"direct step {step} done at {time.perf_counter() - t_start!r} s")

    # 1. orderings: symbolic seconds, lnz and level counts
    syms = {}
    for fill in DIRECT_FILLS:
        sym, secs = timed(lambda: Ldl().fill_in_reduction(fill).symbolic(a))
        syms[fill] = sym
        log(f"direct {side}^2 {fill}: symbolic {secs!r} s, lnz {sym.nnz}, levels L "
            f"{sym.sched_lower.n_levels} Lt {sym.sched_upper.n_levels}")
    cpu_sym = Ldl().fill_in_reduction("nd").symbolic(dirichlet_laplacian((side, side), device="cpu"))
    if cpu_sym.nnz != syms["nd"].nnz:
        raise AssertionError(f"nd lnz {syms['nd'].nnz} on the card, {cpu_sym.nnz} on the CPU")

    stamp(1)

    # 2. LDLᵀ with nd: host numeric, solves on the card
    sym = syms["nd"]
    num, secs = timed(lambda: sym.factor(a, backend="host"))
    host_s = secs
    method = num.solve_method("auto")
    _, plan_s = timed(lambda: num.solve(b))
    ms = solve_ms(lambda: num.solve(b), DIRECT_SOLVE_REPS)
    other = "levels" if method == "flat" else "flat"
    _, other_plan_s = timed(lambda: num.solve(b, method=other))
    other_ms = solve_ms(lambda: num.solve(b, method=other), DIRECT_SOLVE_REPS)
    log(f"direct ldl nd: host numeric {secs!r} s, solve method {method}, levels "
        f"{sym.sched_lower.n_levels}+{sym.sched_upper.n_levels}, first solve (plans built) "
        f"{plan_s!r} s, {ms!r} ms per solve (CUDA events, {DIRECT_SOLVE_REPS} solves); "
        f"method {other}: first solve {other_plan_s!r} s, {other_ms!r} ms per solve")
    x = num.solve(b)
    gate(f"ldl nd {other} vs {method} (rel max)", rel_max(num.solve(b, method=other), x), 1e-12)
    fn, prepared = prepare_spmv(a)
    before = k1_counts()[0]
    res = float(torch.linalg.vector_norm(fn(prepared, x) - b) / torch.linalg.vector_norm(b))
    k1 += k1_counts()[0] - before
    gate("ldl nd relative residual (on the card)", res, 1e-10)
    import scipy.sparse.linalg as spla

    x_ref, secs = timed(lambda: spla.spsolve(a_sp, b_np))
    log(f"scipy spsolve {side}^2: {secs!r} s")
    gate("ldl nd x vs scipy spsolve (rel max)", rel_max(x.cpu(), torch.from_numpy(x_ref)), 1e-10)
    B = rhs_block(n, DIRECT_RHS_K, torch.float64, 91)
    X = num.solve(B)
    ms_block = solve_ms(lambda: num.solve(B), DIRECT_SOLVE_REPS)
    col_err = max(rel_max(X[:, j], num.solve(B[:, j].contiguous())) for j in range(DIRECT_RHS_K))
    log(f"direct ldl nd (n, {DIRECT_RHS_K}) rhs: {ms_block!r} ms per solve")
    gate(f"ldl nd (n, {DIRECT_RHS_K}) columns vs single solves (rel max)", col_err, 1e-13)

    stamp(2)

    # 3. mixed precision: f32 factor, f64 residuals through K1
    num32, secs = timed(lambda: sym.factor(a.astype(torch.float32), backend="host"))
    host32_s = secs
    x32 = num32.solve(b)
    fwd0 = rel_max(x32, x)
    dia_spmv_kernel.launches = dia_spmv_plain.calls = 0
    (x_ref32, info), ref_s = timed(lambda: refine_solve(a, num32, b, steps=REFINE_STEPS))
    launches, plain = k1_counts()
    k1 += launches
    fwd = rel_max(x_ref32, x)
    errs = info["backward_errors"]
    log(f"direct mixed precision: f32 host numeric {secs!r} s, forward error vs the f64 solve "
        f"{fwd0!r} before and {fwd!r} after {REFINE_STEPS} steps ({ref_s!r} s), backward errors "
        f"{errs}, K1 launches {launches} (expected {len(errs)}), plain calls {plain}")
    if launches != len(errs) or plain != 0:
        raise AssertionError(f"refine_solve: {launches} K1 launches, {plain} plain calls")
    gate("refined forward error", fwd, 1e-8)

    stamp(3)

    # 4. preconditioned Krylov solves through K1
    ic, ic_s = timed(lambda: ic0(a))
    results = {}
    for label, pre in (("plain", None), ("ic0", ic)):
        dia_spmv_kernel.launches = dia_spmv_plain.calls = 0
        r, secs = timed(lambda: cg(a, b, tol=KRYLOV_TOL, max_iter=MAX_ITER, precond=pre))
        launches, plain = k1_counts()
        k1 += launches
        results[label] = r
        log(f"direct cg {label}: iterations {r.iterations} converged {r.converged} wall {secs!r} s "
            f"({secs / max(r.iterations, 1) * 1e3!r} ms per iteration), K1 launches {launches} "
            f"(expected {r.iterations + 2}), plain calls {plain}")
        if not r.converged or launches != r.iterations + 2 or plain != 0:
            raise AssertionError(f"cg {label}: {r.iterations} iterations, {launches} K1 launches")
        gate(f"cg {label} x vs ldl (rel max)", rel_max(r.x, x), 1e-8)
    log(f"direct ic0 host factor {ic_s!r} s; iterations plain {results['plain'].iterations}, "
        f"ic0 {results['ic0'].iterations}")
    if not results["ic0"].iterations < results["plain"].iterations:
        raise AssertionError("ic0 did not cut cg's iterations")
    r = rhs_block(n, 1, torch.float64, 92)[:, 0]
    ms_ic = solve_ms(lambda: ic(r), PRECOND_REPS)
    ms_spmv = solve_ms(lambda: fn(prepared, r), 50)
    log(f"direct ic0 application: {ms_ic!r} ms (levels {ic.l_schedule.n_levels}+"
        f"{ic.lt_schedule.n_levels}), K1 spmv {ms_spmv!r} ms, ratio {ms_ic / ms_spmv!r}")
    profile_window(f"ic0-pcg {side}^2, {PRECOND_PROFILE_ITERS} iterations",
                   lambda: cg(lambda v: fn(prepared, v), b, tol=0.0,
                              max_iter=PRECOND_PROFILE_ITERS, precond=ic),
                   "dia_spmv")

    c = convection_diffusion(side)
    if type(prepare_spmv(c)[1]).__name__ != "DiaTiledMat":
        raise AssertionError("the convection-diffusion operator is not routed to DIA")
    ilu, ilu_s = timed(lambda: ilu0(c))
    for label, pre in (("plain", None), ("ilu0", ilu)):
        dia_spmv_kernel.launches = dia_spmv_plain.calls = 0
        r, secs = timed(lambda: bicgstab(c, b, tol=KRYLOV_TOL, max_iter=MAX_ITER, precond=pre))
        launches, plain = k1_counts()
        k1 += launches
        true_res = float(torch.linalg.vector_norm(b - spmv(c, r.x)) / torch.linalg.vector_norm(b))
        log(f"direct bicgstab {label}: iterations {r.iterations} converged {r.converged} wall "
            f"{secs!r} s, K1 launches {launches} (expected {3 * r.iterations + 2}), plain "
            f"calls {plain}")
        if not r.converged or launches != 3 * r.iterations + 2 or plain != 0:
            raise AssertionError(f"bicgstab {label}: {launches} K1 launches")
        gate(f"bicgstab {label} true relative residual", true_res, 1e-8)
        results[label + "_b"] = r
    ms_ilu = solve_ms(lambda: ilu(r.x), PRECOND_REPS)
    log(f"direct ilu0 host factor {ilu_s!r} s; bicgstab iterations plain "
        f"{results['plain_b'].iterations}, ilu0 {results['ilu0_b'].iterations}; ilu0 application "
        f"{ms_ilu!r} ms (levels {ilu.l_schedule.n_levels}+{ilu.u_schedule.n_levels})")

    stamp(4)

    # 5. LU (native, camd columns) and solve
    lu, secs = timed(lambda: splu(c, col_perm="min_degree"))
    xl = lu.solve(b)
    ms_lu = solve_ms(lambda: lu.solve(b), DIRECT_SOLVE_REPS)
    lu_ref, ref_s = timed(lambda: spla.splu(c.to_scipy().tocsc()).solve(b_np))
    log(f"direct splu camd: host factor {secs!r} s, lu_nnz {lu.lu_nnz()}, levels L "
        f"{lu._l_sched.n_levels} U {lu._u_sched.n_levels}, {ms_lu!r} ms per solve; scipy splu "
        f"{ref_s!r} s")
    gate("splu x vs scipy splu (rel max)", rel_max(xl.cpu(), torch.from_numpy(lu_ref)), 1e-10)
    check_small_direct()

    stamp(5)

    # 6. the row-scan device numeric
    small = dirichlet_laplacian((ROWSCAN_SIDE, ROWSCAN_SIDE), device=DEVICE)
    sym_s = Ldl().fill_in_reduction("nd").symbolic(small)
    host = sym_s.factor(small, backend="host")
    dev, secs = timed(lambda: sym_s.factor(small, backend="device"))
    err = max(float((dev.l_data - host.l_data).abs().max()), float((dev.d - host.d).abs().max()))
    log(f"direct row-scan device numeric {ROWSCAN_SIDE}^2: {secs!r} s for {sym_s.nnz} entries")
    gate("row-scan numeric vs host numeric (max abs)", err, 1e-12)
    stamp(6)
    return k1, {"a": a, "b": b, "syms": syms, "num": num, "host_s": host_s, "host32_s": host32_s,
                "x": x, "x_ref": torch.from_numpy(x_ref).to(DEVICE)}


def plans_equal(label, got, want):
    """Every field of two plans or round schedules equal: ints, arrays and
    per-class / per-bucket tuples of arrays."""
    for f in dataclasses.fields(got):
        x, y = getattr(got, f.name), getattr(want, f.name)
        if isinstance(x, tuple):
            same = len(x) == len(y) and all(np.array_equal(u, v) for u, v in zip(x, y))
        else:
            same = np.array_equal(x, y)
        if not same:
            raise AssertionError(f"{label}: field {f.name} differs from the CPU build")


def build_plans(sym):
    """(super plan, its schedule, mf plan, its schedule) of ``sym``, with
    the seconds of each build."""
    out, secs = [], []
    for build in (sym.super_plan, sym.mf_plan):
        plan, s1 = timed(build)
        sched, s2 = timed(lambda: sym.round_schedule(plan))
        out += [plan, sched]
        secs += [s1, s2]
    return out, secs


def factor_gap(num, host, rtol):
    """(excess of |l − l_host| over rtol·|l_host|, relative to max|l_host|;
    max relative error of d; max relative error of l): the JAX 256²
    gate's form, atol = rtol·max|l_host|, passes when the first two are
    at most rtol."""
    lh, dh = host.l_data.to(torch.float64), host.d.to(torch.float64)
    diff = (num.l_data.to(torch.float64) - lh).abs()
    scale = float(lh.abs().max())
    l_err = float((diff - rtol * lh.abs()).max()) / scale
    return l_err, float(((num.d.to(torch.float64) - dh).abs() / dh.abs()).max()), float(diff.max()) / scale


def panel_solves(label, num, a, b, refs, gated, block=None):
    """``solve(method="super")`` by both branches of the round-batched
    solve's gate, forced through the port's CUDA constant: first solve s,
    ms per solve (CUDA events), and on an f64 factor the gates."""
    out = {}
    default = lb.SOLVE_BATCHED_MIN_S_CUDA
    try:
        for branch, min_s in (("sequential", 1 << 40), ("batched", 1)):
            lb.SOLVE_BATCHED_MIN_S_CUDA = min_s
            x, first_s = timed(lambda: num.solve(b, method="super"))
            ms = solve_ms(lambda: num.solve(b, method="super"), DIRECT_SOLVE_REPS)
            row = {"first_s": first_s, "ms": ms}
            res = float(torch.linalg.vector_norm(spmv(a, x) - b) / torch.linalg.vector_norm(b))
            row["residual"] = res
            row.update({f"vs_{k}": rel_max(x, v) for k, v in refs.items()})
            if gated:
                gate(f"panel {label} {branch} relative residual", res, 1e-10)
                for k in refs:
                    gate(f"panel {label} {branch} x vs {k} (rel max)", row[f"vs_{k}"], 1e-10)
            if block is not None and branch == "batched":
                X = num.solve(block, method="super")
                row["block_ms"] = solve_ms(lambda: num.solve(block, method="super"),
                                           DIRECT_SOLVE_REPS)
                row["block_col_err"] = max(
                    rel_max(X[:, j], num.solve(block[:, j].contiguous(), method="super"))
                    for j in range(block.shape[1]))
                gate(f"panel {label} {branch} (n, {block.shape[1]}) columns vs single solves",
                     row["block_col_err"], 1e-13)
            log(f"panel solve {label} {branch}: {json.dumps(row)}")
            out[branch] = row
    finally:
        lb.SOLVE_BATCHED_MIN_S_CUDA = default
    return out


def phase_direct_panel(direct):
    """Phase 5h: the panel LDLᵀ numerics and the batch API on the card.
    Returns the direct_panel line and the K1 launches of refinement."""
    side = DIRECT_SIDE
    a, b = direct["a"], direct["b"]
    refs = {"spsolve": direct["x_ref"], "levels": direct["num"].solve(b, method="levels")}
    host = direct["num"]
    row = {"side": side, "host_numeric_s": {"f64": direct["host_s"], "f32": direct["host32_s"]}}
    t_start = time.perf_counter()

    def stamp(step):
        log(f"panel step {step} done at {time.perf_counter() - t_start!r} s")

    # 1. plans on the card's host, equal to the CPU build's
    syms, plans = {}, {}
    for fill in PANEL_FILLS:
        sym = direct["syms"][fill]
        (sp, ss, mp, ms), secs = build_plans(sym)
        syms[fill] = sym
        plans[fill] = {"S": sp.S, "W": sp.W, "MR": sp.MR, "P": sp.P, "super_T": sp.n_tasks,
                       "super_R": ss.R, "mf_T": mp.n_tasks, "mf_R": ms.R, "mf_F": mp.F,
                       "classes": list(ss.upd_mr), "seconds": secs}
        cpu_sym = Ldl().fill_in_reduction(fill).symbolic(
            dirichlet_laplacian((side, side), device="cpu"))
        for label, got, want in zip(("super plan", "super schedule", "mf plan", "mf schedule"),
                                    (sp, ss, mp, ms), build_plans(cpu_sym)[0]):
            plans_equal(f"{fill} {label}", got, want)
        log(f"panel plans {side}^2 {fill}: {json.dumps(plans[fill])}")
    want = EXPECTED_ND_PLANS.get(side)
    if want and any(plans["nd"][k] != v for k, v in want.items()):
        raise AssertionError(f"nd plans {plans['nd']} differ from {want}")
    row["plans"] = plans
    stamp(1)

    # 2. batched factors at 256² against the host numeric
    hosts = {("nd", "f64"): host}
    hosts[("camd", "f64")], secs = timed(lambda: syms["camd"].factor(a, backend="host"))
    row["host_numeric_s"]["camd_f64"] = secs
    a32 = a.astype(torch.float32)
    factors, row["factors"] = {}, {}
    for fill, backend, prec in (("nd", "mf-batched", "f64"), ("nd", "super-batched", "f64"),
                                ("nd", "mf-batched", "f32"), ("nd", "super-batched", "f32"),
                                ("camd", "mf-batched", "f64")):
        # a symbolic of its own per plan kind: solve("super") prefers a
        # cached mf plan
        sym = syms[fill] if backend == "mf-batched" else dataclasses.replace(syms[fill])
        mat = a if prec == "f64" else a32
        sym.factor(mat, backend=backend)  # warm-up: plans, schedules, tables
        num, secs = timed(lambda: sym.factor(mat, backend=backend))
        again = sym.factor(mat, backend=backend)
        bit_equal = torch.equal(num.l_data, again.l_data) and torch.equal(num.d, again.d)
        finite = bool(torch.isfinite(num.l_data).all() and torch.isfinite(num.d).all())
        l_gap, d_err, l_err = factor_gap(num, hosts[(fill, "f64")], PANEL_RTOL)
        key = f"{fill} {backend} {prec}"
        entry = {"s": secs, "bit_equal": bit_equal, "finite": finite, "l_gap": l_gap,
                 "l_rel_max": l_err, "d_rel_max": d_err}
        log(f"panel factor {side}^2 {key}: {json.dumps(entry)}")
        if not (bit_equal and finite):
            raise AssertionError(f"panel factor {key}: bit_equal {bit_equal}, finite {finite}")
        if prec == "f64":
            gate(f"panel factor {key} l vs host (rtol = atol)", l_gap, PANEL_RTOL)
            gate(f"panel factor {key} d vs host (rel max)", d_err, PANEL_RTOL)
        factors[key] = num
        row["factors"][key] = entry
    stamp(2)

    # 3. the sequential numerics at 64²
    small = dirichlet_laplacian((PANEL_SMALL_SIDE,) * 2, device=DEVICE)
    sym_s = Ldl().fill_in_reduction("nd").symbolic(small)
    host_s = sym_s.factor(small, backend="host")
    row["sequential"] = {}
    for backend in ("supernodal", "mf", "mf-batched"):
        sym_s.factor(small, backend=backend)
        num, secs = timed(lambda: sym_s.factor(small, backend=backend))
        l_gap, d_err, _ = factor_gap(num, host_s, PANEL_SMALL_RTOL)
        entry = {"s": secs, "torch_ops": torch_ops(lambda: sym_s.factor(small, backend=backend))}
        log(f"panel factor {PANEL_SMALL_SIDE}^2 nd {backend}: {json.dumps(entry)}")
        gate(f"panel factor {PANEL_SMALL_SIDE}^2 {backend} l vs host", l_gap, PANEL_SMALL_RTOL)
        gate(f"panel factor {PANEL_SMALL_SIDE}^2 {backend} d vs host", d_err, PANEL_SMALL_RTOL)
        row["sequential"][backend] = entry
    b_s = b[: small.shape[0]].contiguous()
    x_s = host_s.solve(b_s, method="levels")
    row["sequential"]["solves"] = panel_solves(
        f"{PANEL_SMALL_SIDE}^2 nd mf-batched", num, small, b_s, {"levels": x_s}, gated=True)
    plan_s = sym_s.mf_plan()
    row["sequential"]["S"], row["sequential"]["R"] = plan_s.S, sym_s.round_schedule(plan_s).R
    stamp(3)

    # 4. panel solves after each 256² factor, by both branches
    block = rhs_block(side * side, DIRECT_RHS_K, torch.float64, 91)
    row["solves"] = {}
    for key, num in factors.items():
        gated = key.endswith("f64")
        row["solves"][key] = panel_solves(key, num, a, b, refs, gated,
                                          block=block if key == "nd mf-batched f64" else None)
    stamp(4)

    # 5. mixed precision: the f32 mf-batched factor, f64 residuals through K1
    num32 = factors["nd mf-batched f32"]
    dia_spmv_kernel.launches = dia_spmv_plain.calls = 0
    (x_r, info), secs = timed(lambda: refine_solve(a, num32, b, steps=PANEL_REFINE_STEPS))
    k1, plain = k1_counts()
    errs = info["backward_errors"]
    fwd = rel_max(x_r, direct["x"])
    row["refine"] = {"s": secs, "forward_error": fwd, "backward_errors": errs,
                     "forward_error_before": rel_max(num32.solve(b).to(torch.float64),
                                                     direct["x"]),
                     "k1_launches": k1, "plain_calls": plain}
    log(f"panel mixed precision: {json.dumps(row['refine'])}")
    if k1 != len(errs) or plain != 0:
        raise AssertionError(f"refine_solve: {k1} K1 launches for {len(errs)} residuals, "
                             f"{plain} plain calls")
    gate("panel refined forward error", fwd, 1e-8)
    stamp(5)

    # 6. the batch API
    row["batch"] = phase_batch_api(a)
    stamp(6)

    # 7. one 256² nd mf-batched factor under the profiler
    rounds = syms["nd"].round_schedule(syms["nd"].mf_plan()).R
    factor = lambda: syms["nd"].factor(a, backend="mf-batched")  # noqa: E731
    launches, busy, wall, top = device_launches(factor)
    row["profile"] = {"device_launches": launches, "launches_per_round": launches / rounds,
                      "torch_ops": torch_ops(factor), "rounds": rounds, "device_busy_ms": busy,
                      "traced_ms": wall, "device_idle_share": 1.0 - busy / wall,
                      "top_device_ops": top}
    log(f"panel profile {side}^2 nd mf-batched f64: {json.dumps(row['profile'])}")
    stamp(7)
    return row, k1


def phase_batch_api(a):
    """BatchedLdl over N value sets against N single factors and solves;
    the batched products on ``a`` against member loops."""
    out = {}
    side = PANEL_BATCH_SIDE
    ab = dirichlet_laplacian((side, side), device=DEVICE)
    sym = Ldl().fill_in_reduction("nd").symbolic(ab)
    bl = BatchedLdl(sym, kind="mf")
    N = PANEL_BATCH_N
    data = torch.stack([ab.data * (i + 1) for i in range(N)])
    rhs = rhs_block(N, ab.shape[0], torch.float64, 94)[:, sym.perm.perm.to(torch.int64)]
    bl.solve(*bl.factor(data), rhs)  # warm-up
    (lx, d), f_s = timed(lambda: bl.factor(data))
    x, s_s = timed(lambda: bl.solve(lx, d, rhs))

    def singles():
        return [bl.solve(*bl.factor(data[i]), rhs[i]) for i in range(N)]

    xs, single_s = timed(singles)
    err = max(rel_max(x[i], xs[i]) for i in range(N))
    out["ldl"] = {"side": side, "N": N, "factor_s": f_s, "solve_s": s_s,
                  "single_factors_and_solves_s": single_s, "member_vs_single": err}
    log(f"panel batch ldl: {json.dumps(out['ldl'])}")
    gate("batched ldl members vs single solves (rel max)", err, 1e-10)

    N = PANEL_PRODUCT_N
    data = torch.stack([a.data * (1.0 + 0.25 * i) for i in range(N)])
    xv = rhs_block(N, a.shape[0], torch.float64, 95)
    xm = rhs_block(N, a.shape[0] * DIRECT_RHS_K, torch.float64, 96).view(N, a.shape[0],
                                                                         DIRECT_RHS_K)
    products = {}
    y, secs = timed(lambda: batch_spmv(a, data, xv))
    products["spmv"] = (secs, max(rel_max(y[i], spmv(a.with_data(data[i]), xv[i]))
                                  for i in range(N)))
    y, secs = timed(lambda: batch_spmm(a, data, xm))
    products["spmm"] = (secs, max(rel_max(y[i], spmm(a.with_data(data[i]), xm[i]))
                                  for i in range(N)))
    c, secs = timed(lambda: batch_spgemm(a, a, data, data))
    errs = []
    for i in range(N):
        one = spgemm(a.with_data(data[i]), a.with_data(data[i]))
        nnz = int(one.indptr[-1])
        if not (torch.equal(one.indptr, c.indptr) and torch.equal(one.indices[:nnz],
                                                                  c.indices[:nnz])):
            raise AssertionError(f"batch_spgemm member {i}: pattern differs from the loop's")
        errs.append(rel_max(c.data[i, :nnz], one.data[:nnz]))
    products["spgemm"] = (secs, max(errs))
    for name, (secs, err) in products.items():
        out[name] = {"N": N, "s": secs, "member_vs_loop": err}
        gate(f"batch_{name} members vs loop (rel max)", err, 1e-12)
    log(f"panel batch products: {json.dumps({k: out[k] for k in products})}")
    return out


def check_small_direct():
    """At 32²: ``solve`` picks LU for C and LDLᵀ for A, ``det`` against
    numpy's ``slogdet`` (of C/4, whose determinant f64 holds), and the
    gradients of ``solve`` in b and in the values against the dense
    formula ∂b = λ, ∂a_ij = −λ_i·x_j with λ = A⁻ᵀ·w for the loss w·x."""
    side = SMALL_DIRECT_SIDE
    n = side * side
    rng = np.random.default_rng(93)
    for name, mat, want in (("C", convection_diffusion(side), "lu"),
                            ("A", dirichlet_laplacian((side, side), device=DEVICE), "ldl")):
        got = resolve_method(mat)
        log(f"small direct solve {side}^2 {name}: picks {got}")
        if got != want:
            raise AssertionError(f"solve picks {got} for {name}, expected {want}")
        dense = mat.to_dense().cpu().numpy()
        b = rng.standard_normal(n)
        w = rng.standard_normal(n)
        data = mat.data.clone().requires_grad_(True)
        bt = torch.from_numpy(b).to(DEVICE).requires_grad_(True)
        x = solve(mat.with_data(data), bt)
        (x * torch.from_numpy(w).to(DEVICE)).sum().backward()
        x_ref = np.linalg.solve(dense, b)
        lam = np.linalg.solve(dense.T, w)
        rows, cols, _ = mat.coo_arrays()
        nnz = mat.nnz
        g_ref = -lam[rows[:nnz].cpu().numpy()] * x_ref[cols[:nnz].cpu().numpy()]
        gate(f"small solve {name} x vs dense (rel max)",
             float(np.abs(x.detach().cpu().numpy() - x_ref).max() / np.abs(x_ref).max()), 1e-10)
        gate(f"small solve {name} grad b vs dense (rel max)",
             float(np.abs(bt.grad.cpu().numpy() - lam).max() / np.abs(lam).max()), 1e-10)
        gate(f"small solve {name} grad data vs dense (rel max)",
             float(np.abs(data.grad[:nnz].cpu().numpy() - g_ref).max() / np.abs(g_ref).max()), 1e-10)
    c4 = convection_diffusion(side) * 0.25
    sign, logdet = np.linalg.slogdet(c4.to_dense().cpu().numpy())
    det = float(splu(c4).det())
    gate("small splu det vs slogdet (rel)", abs(det - sign * math.exp(logdet)) / math.exp(logdet),
         1e-10)


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


# ---------------------------------------------------------------------------
# phase 5i: IO and profile; phase 5j: the distributed layer
# ---------------------------------------------------------------------------


def arrays_equal(a, b):
    """Two CsMats (or formats) hold the same arrays bit for bit."""
    fields = [f.name for f in dataclasses.fields(a)]
    return type(a) is type(b) and all(
        torch.equal(getattr(a, f), getattr(b, f)) if isinstance(getattr(a, f), torch.Tensor)
        else getattr(a, f) == getattr(b, f) for f in fields)


def check_cg(name, res, a, b, launches, kernel_launches, plain_calls):
    true_res = float(torch.linalg.vector_norm(b - spmv(a, res.x)))
    b_norm = float(torch.linalg.vector_norm(b))
    log(f"{name}: iterations {res.iterations} converged {res.converged} true residual "
        f"{true_res!r} (limit {SOLVE_TOL * b_norm!r}), launches {kernel_launches} "
        f"(expected {launches}), plain calls {plain_calls}")
    if not (res.converged and true_res <= SOLVE_TOL * b_norm and bool(torch.isfinite(res.x).all())):
        raise AssertionError(f"{name}: converged {res.converged}, true residual {true_res}")
    if kernel_launches != launches or plain_calls != 0:
        raise AssertionError(f"{name}: {kernel_launches} launches, {plain_calls} plain calls")


def phase_io(mesh, lap_audit, k1_share):
    """Phase 5i: Matrix Market, npz and checkpoint round trips on the card
    at 1024², the solves that follow them, and ``audit_spmv``.  Returns
    the io line and the K1 and K5 launches of its main path."""
    from sprs_tpu_torch.io import (
        load_checkpoint,
        load_npz,
        read_matrix_market_csr,
        save_checkpoint,
        save_npz,
        write_matrix_market_sym,
    )
    from sprs_tpu_torch.utils import audit_spmv

    side = IO_SIDE
    a = dirichlet_laplacian((side, side), device=DEVICE)
    n = a.rows
    row = {"side": side, "rows": n, "nnz": a.nnz}
    launches = {}
    with tempfile.TemporaryDirectory(prefix="sprs_tpu_torch_io_") as tmp:
        path = f"{tmp}/lap.mtx"
        _, row["mm_write_s"] = timed(lambda: write_matrix_market_sym(path, a))
        with open(path) as f:
            f.readline(), f.readline()
            entries = int(f.readline().split()[2])
        back, row["mm_read_s"] = timed(lambda: read_matrix_market_csr(path, device=DEVICE))
        row["mm_file_bytes"] = os.path.getsize(path)
        row["mm_entries"] = entries
        row["mm_write_s_per_million"] = row["mm_write_s"] / entries * 1e6
        row["mm_read_s_per_million"] = row["mm_read_s"] / entries * 1e6
        same = back.cap == a.cap and arrays_equal(back, a)
        log(f"io matrix market {side}^2: {entries} stored entries, write {row['mm_write_s']!r} s, "
            f"read {row['mm_read_s']!r} s onto the card, equal to the original bit for bit {same}")
        if not same or back.device != a.device:
            raise AssertionError("the Matrix Market read-back differs from the original")

        # CG on the read-back operand through prepare_spmv -> DIA -> K1
        b = torch.from_numpy(np.random.default_rng(100).standard_normal(n)).to(DEVICE)
        reset_counts()
        res, row["cg_read_back_s"] = timed(lambda: cg(back, b, tol=CG_TOL, max_iter=MAX_ITER))
        launches["dia_spmv"] = dia_spmv_kernel.launches
        check_cg(f"io cg {side}^2 on the read-back operand (K1)", res, back, b,
                 res.iterations + 2, dia_spmv_kernel.launches, dia_spmv_plain.calls)
        ref = cg(a, b, tol=CG_TOL, max_iter=MAX_ITER)
        row["cg_iterations"] = res.iterations
        log(f"io cg: x bit-equal to the same CG on the in-memory operand {torch.equal(res.x, ref.x)}")
        if not torch.equal(res.x, ref.x):
            raise AssertionError("io cg: x differs from the CG on the in-memory operand")

        # npz of the Laplacian and of the permuted mesh step (phase 5d)
        for label, mat in (("laplacian", a), ("mesh step", mesh["a"])):
            p = f"{tmp}/{label.replace(' ', '_')}.npz"
            _, save_s = timed(lambda: save_npz(p, mat))
            got, load_s = timed(lambda: load_npz(p, device=DEVICE))
            same = got.cap == mat.cap and arrays_equal(got, mat)
            row[f"npz_{label.replace(' ', '_')}_s"] = [save_s, load_s]
            log(f"io npz {label}: save {save_s!r} s, load {load_s!r} s, equal {same}")
            if not same:
                raise AssertionError(f"io npz {label}: the loaded matrix differs")
        loaded = got
        fn, prepared = prepare_spmv(loaded)
        if ROUTE_OF[type(prepared).__name__] != "ell" or prepared.width != 7:
            raise AssertionError("the loaded mesh step does not route to ELL of width 7")
        reset_counts()
        res, row["cg_mesh_s"] = timed(lambda: cg(loaded, mesh["b"], tol=SOLVE_TOL, max_iter=MAX_ITER))
        launches["ell_spmv"] = ell_spmv_kernel.launches
        check_cg("io cg on the npz-loaded mesh step (K5)", res, loaded, mesh["b"],
                 res.iterations + 2, ell_spmv_kernel.launches, ell_spmv_plain.calls)
        same = torch.equal(res.x, mesh["x"])
        log(f"io cg mesh step: x bit-equal to phase 5d's {same}")
        if not same:
            raise AssertionError("io cg mesh step: x differs from phase 5d's")

        # a checkpoint of {A, its DiaMat, the mesh step's EllMat, x}
        tree = {"A": a, "dia": a.to_dia(), "ell": prepared, "x": res.x}
        _, save_s = timed(lambda: save_checkpoint(f"{tmp}/ck", tree))
        got, load_s = timed(lambda: load_checkpoint(f"{tmp}/ck", device=DEVICE))
        same = (list(got) == list(tree) and all(arrays_equal(got[k], tree[k]) for k in ("A", "dia", "ell"))
                and torch.equal(got["x"], tree["x"]) and got["x"].device == a.device)
        row["checkpoint_s"] = [save_s, load_s]
        log(f"io checkpoint: save {save_s!r} s, load {load_s!r} s onto the card, every leaf "
            f"bit-equal {same}")
        if not same:
            raise AssertionError("io checkpoint: a restored leaf differs")

    # audit_spmv on the 4096² f32 grid Laplacian: K1 against the measured copy rate
    reset_counts()
    rep, row["audit_s"] = timed(lambda: audit_spmv(lap_audit, iters=AUDIT_ITERS))
    launches["dia_spmv"] += dia_spmv_kernel.launches
    row["audit"] = rep
    row["phase4_k1_share_of_hbm_peak"] = k1_share
    log(f"io audit_spmv {json.dumps(rep)}; K1 share of the measured copy rate "
        f"{rep['roofline_fraction']!r} beside phase 4's share of the 3.35 TB/s peak {k1_share!r}; "
        f"K1 launches {dia_spmv_kernel.launches} (expected {AUDIT_ITERS + 1})")
    label = "cuda_dia_spmv" if torch.device(DEVICE).type == "cuda" else "torch_dia_spmv"
    if rep["kernel"] != label or dia_spmv_kernel.launches != AUDIT_ITERS + 1:
        raise AssertionError(f"audit_spmv ran {rep['kernel']} with {dia_spmv_kernel.launches} launches")
    if not 0 < rep["roofline_fraction"] <= AUDIT_SHARE_LIMIT:
        raise AssertionError(f"audit_spmv share {rep['roofline_fraction']} past {AUDIT_SHARE_LIMIT}")
    return row, launches


def dist_gate(name, got, want):
    err = float((got - want).abs().max() / want.abs().max())
    log(f"dist gate {name}: rel max err {err!r} (limit {DIST_TOL})")
    if not (got.shape == want.shape and got.device == want.device and err <= DIST_TOL):
        raise AssertionError(f"dist {name}: rel err {err}, shape {tuple(got.shape)}")


def dist_product_equal(name, c, want):
    """A distributed SpGEMM gathered to one CsMat against phase 5f's."""
    nnz = want.nnz
    same = (c.nnz == nnz and torch.equal(c.indptr, want.indptr)
            and torch.equal(c.indices[:nnz], want.indices[:nnz]))
    err = float((c.data[:nnz] - want.data[:nnz]).abs().max() / want.data[:nnz].abs().max())
    log(f"dist {name}: {c.nnz} entries, pattern equal to phase 5f's {same}, data rel max err "
        f"{err!r} (limit {DIST_TOL})")
    if not (same and err <= DIST_TOL):
        raise AssertionError(f"dist {name}: pattern equal {same}, rel err {err}")


def phase_distributed(mesh, lap2):
    """Phase 5j: the distributed layer on a mesh of DIST_SLOTS slots on
    the card.  Returns the distributed line."""
    from sprs_tpu_torch.entry import dryrun_multichip
    from sprs_tpu_torch.parallel import (
        Mesh,
        block_jacobi_ldl,
        dist_cg,
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

    dev = torch.device(DEVICE)
    slots = np.array([dev] * DIST_SLOTS, dtype=object)
    mesh1 = Mesh(slots, ("shards",))
    mesh2 = Mesh(slots.reshape(2, DIST_SLOTS // 2), ("r", "c"))
    side = DIST_SIDE
    lap = dirichlet_laplacian((side, side), device=DEVICE)
    n = lap.rows
    x = torch.from_numpy(np.random.default_rng(110).standard_normal(n)).to(DEVICE)
    want = spmv(lap, x)
    row = {"side": side, "slots": DIST_SLOTS, "devices": sorted({str(d) for d in slots})}

    dm, row["shard_nnz_s"] = timed(lambda: shard_csr_rows(lap, DIST_SLOTS, balance="nnz", device=mesh1))
    for key, label, sharded in (("dist_spmv_ms", "replicated x, nnz-balanced", False),
                                ("dist_spmv_sharded_ms", "x_sharded", True)):
        run = lambda: dm.assemble(dist_spmv(dm, x, mesh1, x_sharded=sharded))  # noqa: E731
        dist_gate(f"dist_spmv {label}", run(), want)
        row[key] = solve_ms(run, DIST_SPMV_REPS)

    prep, row["prepare_halo_s"] = timed(lambda: prepare_dist_spmv(lap, DIST_SLOTS, device=mesh1))
    prep_m, row["prepare_mesh_s"] = timed(lambda: prepare_dist_spmv(mesh["a"], DIST_SLOTS, device=mesh1))
    log(f"dist prepare_dist_spmv: the {side}^2 Laplacian routes {prep.kind!r} (halo "
        f"{prep.dmat.halo}), the permuted mesh step routes {prep_m.kind!r}")
    if prep.kind != "halo" or prep_m.kind != "allgather":
        raise AssertionError(f"dist routes {prep.kind}, {prep_m.kind}")
    dist_gate("halo route (overlapped)", prep(x, mesh1)[:n], want)
    xm = mesh["b"] + 1.0
    dist_gate("all-gather route, mesh step", prep_m.dmat.assemble(prep_m(xm, mesh1)), spmv(mesh["a"], xm))
    h = shard_csr_rows_halo(lap, DIST_SLOTS, device=mesh1)
    dist_gate("dist_spmv_halo", dist_spmv_halo(h, x, mesh1)[:n], want)
    d2, cp = shard_csr_2d(lap, (2, DIST_SLOTS // 2), device=mesh2)
    dist_gate("dist_spmv_2d (2, 2), sum over the column axis", dist_spmv_2d(d2, cp, x, mesh2)[:n], want)

    # L @ L three ways against phase 5f's spgemm
    dr = shard_csr_rows(lap, DIST_SLOTS, device=mesh1)
    plan = plan_b_gather(dr, dr)
    row["bgather_plan"] = {"rounds": plan.rounds, "comm_blocks": plan.comm_blocks,
                           "full_blocks": plan.full_blocks}
    for label, fn in (("dist_spgemm", lambda: dist_spgemm(dm, lap, mesh1)),
                      ("dist_spgemm_bshard", lambda: dist_spgemm_bshard(dr, dr, mesh1)),
                      ("dist_spgemm_bgather", lambda: dist_spgemm_bgather(dr, dr, mesh1, plan=plan))):
        c, secs = timed(fn)
        row[f"{label}_s"] = secs
        dist_product_equal(label, c.to_csmat(), lap2)

    # distributed CG: Jacobi at 1024², Jacobi and block-Jacobi LDLᵀ at
    # 256²; each by name (set-up inside dist_cg) and with the same
    # preconditioner built beforehand, so set-up and iterations time apart
    def build_precond(d, pc, dev):
        if pc == "jacobi":
            diag = d.to_csmat().diag().to(dev)
            return lambda r: r / diag
        return block_jacobi_ldl(d.to_csmat(), d.n_shards).precond

    row["cg"] = {}
    small = dirichlet_laplacian((DIST_SMALL_SIDE, DIST_SMALL_SIDE), device=DEVICE)
    ds = shard_csr_rows(small, DIST_SLOTS, device=mesh1)
    for label, d, a, pc in ((f"{side}^2 jacobi", dm, lap, "jacobi"),
                            (f"{DIST_SMALL_SIDE}^2 jacobi", ds, small, "jacobi"),
                            (f"{DIST_SMALL_SIDE}^2 block_ldl", ds, small, "block_ldl")):
        b = torch.from_numpy(np.random.default_rng(111).standard_normal(a.rows)).to(DEVICE)
        b_norm = float(torch.linalg.vector_norm(b))
        m_inv, setup_s = timed(lambda: build_precond(d, pc, b.device))
        entry = {"setup_s": setup_s, "precond_ms": solve_ms(lambda: m_inv(b), PRECOND_REPS)}
        for form, given in (("named", pc), ("built", m_inv)):
            res, secs = timed(lambda: dist_cg(d, b, mesh1, precond=given, tol=CG_TOL, max_iter=MAX_ITER))
            true_res = float(torch.linalg.vector_norm(b - spmv(a, res.x)))
            entry[form] = {"iterations": res.iterations, "s": secs, "true_residual": true_res}
            if not (res.converged and true_res <= SOLVE_TOL * b_norm and res.x.device == b.device):
                raise AssertionError(f"dist cg {label} ({form}): converged {res.converged}, "
                                     f"residual {true_res}")
        entry["iterations"] = entry["built"]["iterations"]
        entry["ms_per_iteration"] = entry["built"]["s"] / max(entry["iterations"], 1) * 1e3
        row["cg"][label] = entry
        log(f"dist cg {label}: {json.dumps(entry)} (limit {SOLVE_TOL * b_norm!r})")
    blk = row["cg"][f"{DIST_SMALL_SIDE}^2 block_ldl"]["iterations"]
    jac = row["cg"][f"{DIST_SMALL_SIDE}^2 jacobi"]["iterations"]
    if not blk < jac:
        raise AssertionError(f"block-Jacobi LDLᵀ took {blk} iterations against Jacobi's {jac}")

    _, row["dryrun_s"] = timed(lambda: dryrun_multichip(DIST_SLOTS, device=DEVICE))
    row["dist_spmv_profile"] = profile_window(
        f"one dist_spmv {side}^2 on {DIST_SLOTS} slots", lambda: dm.assemble(dist_spmv(dm, x, mesh1)),
        "index")
    return row


# ---------------------------------------------------------------------------
# phase 5n: the measurement programs, benches/torch_*.py
# ---------------------------------------------------------------------------

BENCHES_PHASE_BUDGET_S = 150.0  # phase 5n's share of the script's time, recorded beside its seconds
# (record name, bench file, arguments)
BENCH_RUNS = (
    ("spmv", "torch_spmv_bench.py", []),
    ("bsr_bf16", "torch_bsr_bench.py", ["--dtype", "bfloat16"]),
    ("bsr_f32", "torch_bsr_bench.py", ["--dtype", "float32"]),
    # nd, the direct-solver path's ordering: with the bench's default rcm
    # a 256² factor runs 519 sequential rounds (5.7 s on the H100) and a
    # flat solve takes 9.6 s, 434 s for the whole bench
    ("ldl", "torch_ldl_bench.py", ["--grid", "256", "--fill", "nd", "--scan-grid", "32", "--skip-seq"]),
    # one call of scipy per point (its product is also the reference) and
    # none of the native library: at 140.6M products they take 3.2-3.5 and
    # 7.9-10.0 s a call on the H100's host, and phase 5n ran 162.5-167.8 s
    ("spgemm", "torch_spgemm_bench.py", ["--quick", "--scipy-reps", "0"]),
    ("micro", "torch_micro_bench.py", []),
)


def load_bench(filename):
    """The module of ``benches/<filename>``, loaded by path."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "benches", filename)
    spec = importlib.util.spec_from_file_location(filename[:-3], path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def check_spmv_bench(rec):
    """The spmv bench's record: its gate passed, K1 was the best kernel,
    both shares lie in (0, 1.05] (a share above 1.05 of the stream twin
    would mean the twin made more than one pass) and the twin is under
    the HBM peak.  The twin reads W + 1 streams for each one it writes,
    so it may outrun the copy, which reads one for each one it writes."""
    d = rec["detail"]
    ok = (d["kernel_gate"]["ok"] is True and d["kernel"] == "cuda_dia_tiled"
          and 0 < rec["value"] <= 1.05 and 0 < d["frac_vs_stream_twin"] <= 1.05
          and d["stream_twin_GBps"] * 1e9 <= HBM_BYTES_PER_S)
    log(f"bench spmv: value {rec['value']!r}, kernel {d['kernel']}, frac_vs_stream_twin "
        f"{d['frac_vs_stream_twin']!r}, twin {d['stream_twin_GBps']!r} GB/s against copy "
        f"{d['copy_peak_GBps']!r} GB/s (ratio {d['stream_twin_GBps'] / d['copy_peak_GBps']!r}) and "
        f"HBM {HBM_BYTES_PER_S / 1e9} GB/s, gate ok {d['kernel_gate']['ok']}: {ok}")
    if not ok:
        raise AssertionError("the spmv bench's record fails its checks")


def counted_launches() -> dict:
    """K1, K2, K3 and K5 launches since the counts were last set to 0, by
    the kernels line's names."""
    return {
        "dia_spmv": dia_spmv_kernel.launches,
        "dia_spmm_tma": dia_spmm_kernel.launches_tma,
        "dia_spmm_scalar": dia_spmm_kernel.launches_scalar,
        "bsr_spmm_tc": bsr_spmm_kernel.launches_tc,
        "bsr_spmm_tf32x3": bsr_spmm_kernel.launches_tf32x3,
        "ell_spmv": ell_spmv_kernel.launches,
    }


def phase_benches():
    """Phase 5n: each ``benches/torch_*.py`` called in this process through
    its ``main``, the launch counts set to 0 just before and read just
    after.  Returns ({record name: record}, K1/K2/K3/K5 launches, row of
    the phase's seconds)."""
    records, seconds = {}, {}
    sync()
    reset_counts()
    t_phase = time.perf_counter()
    for name, filename, argv in BENCH_RUNS:
        t0 = time.perf_counter()
        records[name] = load_bench(filename).main(argv)
        sync()
        seconds[name] = time.perf_counter() - t0
        log(f"5n: bench {name} {' '.join(argv)} in {seconds[name]!r} s")
    launches = counted_launches()
    row = {"phase_s": time.perf_counter() - t_phase, "phase_budget_s": BENCHES_PHASE_BUDGET_S,
           "bench_s": seconds, "launches": launches}
    log(f"5n: {row['phase_s']!r} s (budget {BENCHES_PHASE_BUDGET_S} s), launches {launches}")
    check_spmv_bench(records["spmv"])
    for kname in ("dia_spmv", "bsr_spmm_tc", "bsr_spmm_tf32x3", "ell_spmv"):
        if launches[kname] == 0:
            raise AssertionError(f"the benches launched no {kname} kernel")
    if launches["dia_spmm_tma"] + launches["dia_spmm_scalar"] == 0:
        raise AssertionError("the benches launched no dia_spmm kernel")
    return records, launches, row


# ---------------------------------------------------------------------------
# phase 5o: the last three measurement programs
# ---------------------------------------------------------------------------

# phase 5o's share of the script's time, recorded beside its seconds and
# never a gate: 87.9 and 120.3 s on two H100 machines (torch_ldl_big.py
# 85.8 and 118.8 s of it, its f64 host factor 31.6 and 36.9 s), runs that
# logged budgets of 180 and 120 s before this value was set; torch_ldl_big.py's
# --profile (the profiler over one 512² factor's 127,735 launches) is left
# to the standalone run, which took 163.3-192.9 s with it
LAST_BENCHES_PHASE_BUDGET_S = 150.0
# (record name, bench file, arguments), each at its full size
LAST_BENCH_RUNS = (
    ("prim", "torch_prim_bench.py", []),
    ("scaling", "torch_scaling_bench.py", []),
    ("ldl_big", "torch_ldl_big.py", ["--grid", "512", "--fill", "nd"]),
)
SCALING_GATE = 1e-6  # each schedule's product against spmv of the whole Laplacian, of max|y|
LDL_BIG_SOLVE_GATE = 1e-3  # the round-batched panel solve against the sequential one, of max|y|
# ldl_big's gates beside the bench's own 2e-3 backward-error bar, each
# 7-70x over the 512² nd readings of seven runs on an H100 (residual_rel
# 2.39e-7, flat against panel 4.6-5.3e-6, fwd_err_rel 1.33e-4 against
# splu, d and l within 1.5e-6 of the f64 host factor)
LDL_BIG_RESIDUAL_GATE = 1e-5
LDL_BIG_FLAT_GATE = 1e-4
LDL_BIG_FWD_GATE = 1e-3
LDL_BIG_FACTOR_GATE = 1e-4


def _wrap_int32(a):
    """int64 values wrapped to int32, as an int32 sum wraps."""
    return ((a + (1 << 31)) % (1 << 32) - (1 << 31)).astype(np.int32)


def check_prim_bench(mod):
    """Each primitive of ``torch_prim_bench.py`` once on its full-size
    inputs on the card, held against its definition computed by numpy on
    a CPU copy: rows and the whole array sorted, the gather exact, the
    int32 scatter-add's counts (two chained steps, the second dropping
    indices past N) and the wrapped int32 cumsum; the two float32
    scatter-adds against the counts and each other, within 1e-6 of the
    largest."""
    n = mod.N
    k2, _, k1, idx = mod.inputs(n, DEVICE)
    prims = mod.primitives(n, idx, k2, k1)
    k2h, k1h, ih = k2.cpu().numpy(), k1.cpu().numpy(), idx.cpu().numpy()

    def run(name, x=None):
        f, x0 = prims[name]
        return f(x0 if x is None else x)

    counts = np.bincount(ih, minlength=n)
    step1 = counts.astype(np.int32) + ih
    kept = step1[step1 < n]
    step2 = np.bincount(kept, minlength=n).astype(np.int32) + step1
    want = {
        "sort_batched_dim1": (run("sort_batched_dim1"), np.sort(k2h, axis=1)),
        "sort_1d_global": (run("sort_1d_global"), np.sort(k1h)),
        "gather": (run("gather"), ih[ih]),
        "scatter_add": (run("scatter_add"), step1),
        "scatter_add two steps": (run("scatter_add", run("scatter_add")), step2),
        "cumsum": (run("cumsum"), np.mod(_wrap_int32(np.cumsum(ih, dtype=np.int64)), n).astype(np.int32)),
    }
    wraps = bool(np.cumsum(ih, dtype=np.int64).max() > np.iinfo(np.int32).max)
    for name, (got, ref) in want.items():
        got = got.cpu().numpy()
        if got.dtype != np.int32 or not np.array_equal(got, ref):
            raise AssertionError(f"prim bench: {name} differs from its definition "
                                 f"({int((got != ref).sum())} of {ref.size} entries)")
    add = run("scatter_add_f32_index_add").cpu().numpy()
    put = run("scatter_add_f32_index_sum").cpu().numpy()
    scale = float(counts.max())
    errs = {"index_add_vs_counts": float(np.abs(add - counts).max()) / scale,
            "index_sum_vs_counts": float(np.abs(put - counts).max()) / scale,
            "index_sum_vs_index_add": float(np.abs(put - add).max()) / scale}
    log(f"5o: prim bench primitives equal their definitions on the card (cumsum wraps: {wraps}), "
        f"float scatter-adds {json.dumps(errs)}")
    if not wraps or max(errs.values()) > 1e-6:
        raise AssertionError(f"prim bench: float scatter-adds {errs}, cumsum wraps {wraps}")
    return errs


def check_scaling_bench(rec):
    """Every slot count's halo and gather products against ``spmv`` of
    the whole Laplacian, within SCALING_GATE of max|y|."""
    diffs = {r["n_slots"]: (r["halo_rel_diff"], r["gather_rel_diff"]) for r in rec["rows"]}
    log(f"5o: scaling bench (halo, gather) products against spmv by slots: {diffs}")
    if not diffs or max(max(d) for d in diffs.values()) > SCALING_GATE:
        raise AssertionError(f"scaling bench: products off spmv by {diffs}")


def check_ldl_big(rec):
    """Every stage of the ldl_big record ran (no ``<stage>_error``, the
    flat solve and the f64 host cross-check among them), the panel
    solve's backward error under the bench's own bar (2e-3) and under
    LDL_BIG_RESIDUAL_GATE, the round-batched solve within
    LDL_BIG_SOLVE_GATE of max|y| of the sequential one, the flat solve
    within LDL_BIG_FLAT_GATE of the panel solve, the forward error
    against scipy's splu under LDL_BIG_FWD_GATE, and the card's d and l
    within LDL_BIG_FACTOR_GATE of the f64 host factor's."""
    errors = {k: v for k, v in rec.items() if k.endswith("_error")}
    want = ("residual_rel", "solve_batched_max_diff", "flat_vs_panel_rel", "fwd_err_rel", "d_rel_err",
            "l_rel_err")
    missing = [k for k in want if rec.get(k) is None]
    ok = (not errors and not missing
          and rec["residual_ok"] is True and rec["residual_rel"] <= LDL_BIG_RESIDUAL_GATE
          and rec["solve_batched_max_diff"] <= LDL_BIG_SOLVE_GATE * rec["solve_y_inf"]
          and rec["flat_vs_panel_rel"] <= LDL_BIG_FLAT_GATE
          and rec["fwd_err_rel"] <= LDL_BIG_FWD_GATE
          and rec["factor_ok"] is True
          and max(rec["d_rel_err"], rec["l_rel_err"]) <= LDL_BIG_FACTOR_GATE)
    log(f"5o: ldl_big {rec['grid']}^2 {rec['fill']}: residual_rel {rec.get('residual_rel')!r}, "
        f"solve_batched_max_diff {rec.get('solve_batched_max_diff')!r} of max|y| {rec.get('solve_y_inf')!r}, "
        f"flat_vs_panel_rel {rec.get('flat_vs_panel_rel')!r}, fwd_err_rel {rec.get('fwd_err_rel')!r}, "
        f"d/l rel err {rec.get('d_rel_err')!r} / {rec.get('l_rel_err')!r}, factor_ok {rec.get('factor_ok')}, "
        f"errors {errors}, missing {missing}: {ok}")
    if not ok:
        raise AssertionError(f"the ldl_big record fails its checks (errors {errors}, missing {missing})")


def phase_last_benches():
    """Phase 5o: ``torch_prim_bench.py``, ``torch_scaling_bench.py`` and
    ``torch_ldl_big.py`` called in this process through their ``main``,
    the launch counts set to 0 just before and read just after (their
    paths run no kernel of the port: XLA-style primitives, the per-shard
    CSR products, the panel numerics in torch ops), then each record
    gated.  Returns ({record name: record}, launches, row of the phase's
    seconds)."""
    records, seconds, mods = {}, {}, {}
    sync()
    reset_counts()
    t_phase = time.perf_counter()
    for name, filename, argv in LAST_BENCH_RUNS:
        t0 = time.perf_counter()
        mods[name] = load_bench(filename)
        records[name] = mods[name].main(argv)
        sync()
        seconds[name] = time.perf_counter() - t0
        log(f"5o: bench {name} {' '.join(argv)} in {seconds[name]!r} s")
    launches = counted_launches()
    row = {"phase_s": time.perf_counter() - t_phase, "phase_budget_s": LAST_BENCHES_PHASE_BUDGET_S,
           "bench_s": seconds, "launches": launches}
    log(f"5o: {row['phase_s']!r} s (budget {LAST_BENCHES_PHASE_BUDGET_S} s), launches {launches}")
    t0 = time.perf_counter()
    row["prim_check"] = check_prim_bench(mods["prim"])
    check_scaling_bench(records["scaling"])
    check_ldl_big(records["ldl_big"])
    row["check_s"] = time.perf_counter() - t0
    return records, launches, row


def phase_main_pagerank():
    """Phase 5p: K7's main path, the kron23 PageRank cell's: GAP's kron
    graph at scale 23 assembled on the card, ``prepare_spmv``'s CSR arm
    (``(spmv, mat)``), then 20 personalized PageRank steps from 1,024
    teleport vertices through its ``fn``, the step's L1 change read back
    each step as the cell's loop does, the launch counts set to 0 just
    before and read just after: one K7 (f32, f32) launch a step, no call
    of the plain version.  The scores against the same steps in float64
    by a gather and ``index_add_`` (the benchmark's reference), within the
    cell's limit.  Returns (K7 launches, row)."""
    t0 = time.perf_counter()
    big = kron_csr(K7_KRON_SCALE, 193)
    n = big.rows
    fn, prepared = prepare_spmv(big)
    if fn is not spmv or prepared is not big:
        raise AssertionError("5p: prepare_spmv did not keep the kron23 CsMat on its CSR arm")
    gen = torch.Generator(device=DEVICE).manual_seed(194)
    sources = torch.randint(0, n, (PAGERANK_SOURCES,), generator=gen, device=DEVICE)
    v = torch.zeros(n, dtype=torch.float32, device=DEVICE).index_add_(
        0, sources, torch.full((PAGERANK_SOURCES,), 1.0 / PAGERANK_SOURCES, device=DEVICE))
    d = PAGERANK_DAMPING
    sync()
    reset_counts()
    t_loop = time.perf_counter()
    x = v.clone()
    for _ in range(PAGERANK_STEPS):
        x_new = (1.0 - d) * v + d * fn(prepared, x)
        err = float((x_new - x).abs().sum())
        x = x_new
    sync()
    ms_per_step = (time.perf_counter() - t_loop) * 1e3 / PAGERANK_STEPS
    launches, form_launches = csr_spmv_kernel.launches, csr_spmv_kernel.launches_f32
    plain_calls = csr_spmv_plain.calls
    if (launches, form_launches, plain_calls) != (PAGERANK_STEPS, PAGERANK_STEPS, 0):
        raise AssertionError(f"5p: {launches} K7 launches ({form_launches} f32) and {plain_calls} "
                             f"plain calls in {PAGERANK_STEPS} steps, expected one K7 a step")
    rows = row_ids_from_indptr(big.indptr, big.cap).to(torch.int64)
    live = rows < n
    rows, cols = rows[live], big.indices.to(torch.int64)[live]
    vals = big.data.to(torch.float64)[live]
    del big, prepared, live
    v64 = v.double()
    xr = v64.clone()
    for _ in range(PAGERANK_STEPS):
        xr = (1.0 - d) * v64 + d * torch.zeros(n, dtype=torch.float64, device=DEVICE).index_add_(
            0, rows, vals * xr[cols])
    score_err = float((x.double() - xr).abs().max() / xr.abs().max())
    del rows, cols, vals, xr
    row = {"steps": PAGERANK_STEPS, "k7_launches": launches, "plain_calls": plain_calls,
           "ms_per_step": ms_per_step, "last_l1_change": err, "score_err": score_err,
           "limit": PAGERANK_LIMIT, "phase_s": time.perf_counter() - t0}
    log(f"5p: kron23 PageRank through prepare_spmv's CSR arm: {json.dumps(row)}")
    if not score_err <= PAGERANK_LIMIT:
        raise AssertionError(f"5p: PageRank scores {score_err} from the float64 reference")
    return launches, row


# name in the kernels line -> (source, TPU kernel it replaces)
KERNELS = {
    "dia_spmv": ("sprs_tpu_torch/csrc/dia_spmv.cu", "sprs_tpu/ops/pallas/dia_spmv.py:232"),
    "dia_spmm_tma": ("sprs_tpu_torch/csrc/dia_spmm.cu", "sprs_tpu/ops/pallas/dia_spmm.py:93"),
    "dia_spmm_scalar": ("sprs_tpu_torch/csrc/dia_spmm.cu", "sprs_tpu/ops/pallas/dia_spmm.py:93"),
    "bsr_spmm_tc": ("sprs_tpu_torch/csrc/bsr_spmm.cu", "sprs_tpu/ops/pallas/bsr_spmm.py:69"),
    "bsr_spmm_tf32x3": ("sprs_tpu_torch/csrc/bsr_spmm.cu", "sprs_tpu/ops/pallas/bsr_spmm.py:69"),
    "bsr_spmm_grouped": ("sprs_tpu_torch/csrc/bsr_spmm.cu", "sprs_tpu/ops/pallas/bsr_spmm.py:258"),
    "ell_spmv": ("sprs_tpu_torch/csrc/ell_spmv.cu", "sprs_tpu/ops/pallas/spmv.py:72"),
    "sort_rows": ("sprs_tpu_torch/csrc/sort_rows.cu", "sprs_tpu/ops/pallas/sort.py:97"),
    "csr_spmv": ("sprs_tpu_torch/csrc/csr_spmv.cu",
                 "none: the JAX package's CSR product is XLA's segment_sum (sprs_tpu/ops/prod.py)"),
    "krylov": ("sprs_tpu_torch/csrc/krylov.cu",
               "none: the JAX BiCGSTAB is a lax.while_loop that XLA fuses (sprs_tpu/linalg/bicgstab.py)"),
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
    del spmv_operand  # lap_spmv stays for phase 5i's audit_spmv
    t0 = time.perf_counter()
    mesh_a = mesh_step(*permuted_mesh(MESH_SIDE)[:2])[1]
    random8 = random8_operand()
    log(f"setup: {MESH_SIDE}^2 mesh step and random8 in {time.perf_counter() - t0:.3f} s")
    errs.update(phase_gate_unstructured(mesh_a, random8))
    timing.update(phase_timing_unstructured(mesh_a, random8))
    timing["ell_spmv"]["other_shapes"] += phase_renumbered()
    phase_gate_bf16(lap_spmv, mesh_a, random8)
    phase_gate_forms(random8)
    phase_gate_k2_tma()
    phase_gate_k1()
    errs["csr_spmv"], timing["csr_spmv"] = phase_k7()
    errs["krylov"], timing["krylov"] = phase_k8()
    phase_gate_k3_forms()
    form_rows = phase_timing_bf16(lap_spmv, random8)
    form_rows.update(phase_timing_forms(lap_spmv, random8))
    form_rows.update(phase_timing_k3_forms())
    del mesh_a  # random8 stays for phase 5k

    check_small_against_dense()
    check_small_mesh()
    launches = {}
    launches["dia_spmv"], launches["krylov"], lap, rhs = phase_main_spmv()
    phase_profile_bicgstab(lap, rhs)
    del lap, rhs
    launches.update(phase_main_block())
    launches.update(phase_main_bsr())
    launches["ell_spmv"], mesh = phase_main_mesh()
    renumbered_row = phase_main_renumbered()
    launches["sort_rows"] = phase_main_sort()
    form_launches, bf16_row = phase_main_bf16(mesh, lap_spmv, random8)
    bf16_row["card"] = smi
    more, forms_row = phase_main_forms(mesh, lap_spmv, random8)
    forms_row["card"] = smi
    form_launches.update(more)
    del random8
    for (kname, form), n in form_launches.items():
        if n == 0:
            raise AssertionError(f"phases 5k-5l launched no {kname} kernel in its {form} form")
        launches[kname] += n
    determinism = phase_determinism(mesh)
    for kname, n in phase_eigen_checks().items():
        launches[kname] += n
    spgemm_rows, chain_launches, c_bsr = phase_spgemm()
    k3_more, f32_launches, bsr_forms_row = phase_main_bsr_forms(c_bsr)
    bsr_forms_row["card"] = smi
    del c_bsr
    launches["bsr_spmm_tf32x3"] += f32_launches
    for (kname, form), n in k3_more.items():
        if n == 0:
            raise AssertionError(f"phase 5m launched no {kname} kernel in its {form} form")
        launches[kname] += n
    form_launches.update(k3_more)
    k5, k1, lap2 = phase_main_biharmonic()
    check_small_sparse_ops()
    for kname, n in (("bsr_spmm_tf32x3", chain_launches), ("ell_spmv", k5), ("dia_spmv", k1)):
        if n == 0:
            raise AssertionError(f"the SpGEMM path launched no {kname} kernel")
        launches[kname] += n
    k1, direct = phase_direct()
    if k1 == 0:
        raise AssertionError("the direct-solver path launched no dia_spmv kernel")
    launches["dia_spmv"] += k1
    panel_row, k1 = phase_direct_panel(direct)
    del direct
    if k1 == 0:
        raise AssertionError("the panel path launched no dia_spmv kernel")
    launches["dia_spmv"] += k1
    panel_row["card"] = smi
    t0 = time.perf_counter()
    io_row, io_launches = phase_io(mesh, lap_spmv, timing["dia_spmv"]["roofline_share"])
    io_row["phase_s"] = time.perf_counter() - t0
    del lap_spmv
    for kname, n in io_launches.items():
        if n == 0:
            raise AssertionError(f"the IO path launched no {kname} kernel")
        launches[kname] += n
    t0 = time.perf_counter()
    dist_row = phase_distributed(mesh, lap2)
    dist_row["phase_s"] = time.perf_counter() - t0
    del mesh, lap2
    io_row["card"] = dist_row["card"] = smi
    bench_records, bench_launches, benches_row = phase_benches()
    for kname, n in bench_launches.items():
        launches[kname] += n
    last_records, last_launches, last_row = phase_last_benches()
    for kname, n in last_launches.items():
        launches[kname] += n
    launches["csr_spmv"], pagerank_row = phase_main_pagerank()
    pagerank_row["card"] = smi
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
                {key: other[key] for key in ("shape", "ms", "device_ms", "plain_ms", "bound_ms", "library_ms",
                                             "host_ms", "per_call_ms", "per_call_device_ms",
                                             "gather_device_ms") if key in other}
                for other in row["other_shapes"]
            ]
        for key in ("host_ms", "per_call_ms", "per_call_device_ms", "per_call_host_ms"):
            if key in row:
                kernels[-1][key] = row[key]
        forms = [
            {"form": FORM_LABEL[form], "launches": form_launches[(kname, form)],
             "max_abs_err": max(FORM_ERRS[(kname, form)]),
             **{key: frow[key] for key in ("shape", "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                                           "roofline_share", "library_ms", "library_error")},
             **{key: frow[key] for key in ("variant", "passes", "torch_bsr_ms", "torch_bsr_error",
                                           "per_call_ms", "per_call_device_ms") if key in frow}}
            for (k, form), frow in form_rows.items() if k == kname
        ]
        if forms:
            kernels[-1]["forms"] = forms
    print(json.dumps({"spgemm": spgemm_rows, "card": smi}))
    print(json.dumps({"direct_panel": panel_row}))
    print(json.dumps({"io": io_row}))
    print(json.dumps({"distributed": dist_row}))
    print(json.dumps({"bf16_solvers": bf16_row}))
    print(json.dumps({"forms_solvers": forms_row}))
    print(json.dumps({"bsr_forms": bsr_forms_row}))
    print(json.dumps({"determinism": determinism, "card": smi}))
    print(json.dumps({"renumbered": renumbered_row, "card": smi}))
    for bench, record in bench_records.items():
        print(json.dumps({"bench": bench, "record": record, "card": smi}))
    print(json.dumps({"benches": benches_row, "card": smi}))
    for bench, record in last_records.items():
        print(json.dumps({"bench": bench, "record": record, "card": smi}))
    print(json.dumps({"last_benches": last_row, "card": smi}))
    print(json.dumps({"pagerank": pagerank_row}))
    print(json.dumps({"kernels": kernels}))
    print(
        json.dumps(
            {"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
