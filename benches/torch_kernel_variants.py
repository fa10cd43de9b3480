"""A/B of design variants of kernels K1, K2, K3, K5 and K6 on one card.

Each variant is a CUDA source with a few constants or lines replaced:
the committed source in ``sprs_tpu_torch/csrc/``, the source of an
earlier tree (``--baseline DIR``, a ``csrc`` directory unpacked with
``git archive <commit> sprs_tpu_torch/csrc``), or K5's candidate (b) held
here (``ELL_ROW_SOURCE``: one thread per row).  All are built with the
package's nvcc flags into ``sprs_tpu_torch/_build/variants/`` (ptxas'
registers and spills printed; with ``--sass``, each variant's SASS
opcodes counted by ``cuobjdump``) and timed in one process, in two
rounds, by the profiler's device time per launch over 30 calls, after a
check against the plain version (K6: bit for bit).  A candidate that
does not build is reported and left out; the committed source or the
baseline failing to build stops the run.  K1 runs in the forms of
float32 and of 16-bit storage at the 4096² grid (``ops/cuda/forms.py``:
(f32, f32), and (t, t), (t, f32) for t bf16 and f16) and in float64 at
the 1024² and 64² grids, as committed (through its C plan) and an
earlier tree's kernel (``--baseline``, through the per-form entries it
had before the plan); K2 in all sixteen forms at
chip_smoke.py's 2048×1024 grid with 128 RHS and at the 1024² float64
grid with 24, 48 and 256 (and 3, the scalar variant against the
baseline's), each case's bytes bound, plain-version time and
``torch.sparse.mm`` time printed first ("yardstick" lines): the tma
variant as committed against an earlier tree's vector variant
(``--baseline``), against its neighbours (tile size, consumer warps, ring
depth) and two diagnostic cuts (no Y stores; the centre slab alone); K5
in f32 and 16-bit storage, in all sixteen forms at random8, and its
gather probe: the committed kernel with the same launch and indices
summing x[idx[i, s]] without ``data``, at random8 with x in f16, f32 and
f64 (the gathers' ceiling, unchecked).  A source without a form's entry
point (an earlier tree, the inline candidate) skips that form.  K3's design
variants run its bf16, f32 and f64 cases; its thirteen other forms run
as committed and with every form in three TF32 passes (the pass rule's
cost on the same bytes).  Each build prints
ptxas' registers and spills per kernel instantiation, every form's
("ptxas ..." lines).

Run from the repository root on a machine with one H100:
``python3 benches/torch_kernel_variants.py [--kernels k1 k2 k3 k5 k6]
[--baseline DIR] [--sass] [--variants WORD ...] [--only WORD ...]``
(``--variants``: the variants whose names hold one of the words;
``--only``: the cases whose labels end in one of them, e.g. ``f32
f64_f16 k=24``).
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import functools
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402
from sprs_tpu_torch.formats.bsr import bsr_random, bsr_spmm_plain  # noqa: E402
from sprs_tpu_torch.formats.ell import ell_from_csmat  # noqa: E402
from sprs_tpu_torch.ops.cuda import bsr_spmm as k3  # noqa: E402
from sprs_tpu_torch.ops.cuda import build  # noqa: E402
from sprs_tpu_torch.ops.cuda import dia_spmm as k2  # noqa: E402
from sprs_tpu_torch.ops.cuda import ell_spmv as k5  # noqa: E402
from sprs_tpu_torch.ops.cuda import dia_spmv as k1  # noqa: E402
from sprs_tpu_torch.ops.cuda import sort as k6  # noqa: E402
from sprs_tpu_torch.ops.cuda.dia_spmv import dia_tile  # noqa: E402
from sprs_tpu_torch.ops.cuda.forms import FORMS  # noqa: E402
from sprs_tpu_torch.utils import grid_laplacian  # noqa: E402

OUT = build.BUILD_DIR / "variants"

# K3 (wgmma variant): keep one wgmma group in flight and release the
# previous stage
K3_PIPELINED = (
    '''    asm volatile("wgmma.wait_group.sync.aligned 0;\\n" ::: "memory");
    if (lane == 0) mbar_arrive(&empty[s]);
  }
''',
    '''    asm volatile("wgmma.wait_group.sync.aligned 1;\\n" ::: "memory");
    if (it > 0 && lane == 0) mbar_arrive(&empty[(it + kTcStages - 1) % kTcStages]);
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\\n" ::: "memory");
''',
)


def stages(n):
    return ("constexpr int kTcStages = 4;", f"constexpr int kTcStages = {n};")


# K3 (3xTF32 variant): columns per CTA and ring depth
def tf32_tile(n):
    return ("constexpr int kTf32TileN = 128;", f"constexpr int kTf32TileN = {n};")


def tf32_stages(n):
    return ("constexpr int kTf32Stages = 3;", f"constexpr int kTf32Stages = {n};")


def tf32_threads(n):
    return ("constexpr int kTf32Threads = 512;", f"constexpr int kTf32Threads = {n};")


def tf32_min_blocks(n):
    return ("constexpr int kTf32MinBlocks = 1;", f"constexpr int kTf32MinBlocks = {n};")


# Diagnostics of the 3xTF32 kernel's time (their sums are wrong and are
# not checked): the split cut out (every part is the raw bits: three MMAs,
# no split arithmetic), and float32 taken in one pass (one MMA per
# fragment pair, no split).
TF32_NO_SPLIT = ("""  if (!kSplit) {
    hi = __float_as_uint(v);
    hx = kSafe && (hi & 0x7F800000u) == 0x7F800000u ? 0u : hi;
    return;
  }""", """  hi = hx = lo = __float_as_uint(v);
  return;""")
TF32_ONE_PASS = ("SPRS_BSR_SPMM_TF32_ENTRY(sprs_bsr_spmm_tf32x3_f32, float, float, float, 3)",
                 "SPRS_BSR_SPMM_TF32_ENTRY(sprs_bsr_spmm_tf32x3_f32, float, float, float, 1)")
# The forms with a 16-bit operand in three passes, as the float32 form
# takes them (the 16-bit side's lo is 0, so the sums are the same): the
# pass rule's cost on the same bytes.  Each entry line of the source,
# rebuilt from the rule, must be found as it stands.
C_TYPE = {torch.float16: "F16", torch.bfloat16: "BF16", torch.float32: "float",
          torch.float64: "double"}


def tf32_entry(pair, passes):
    return (f"SPRS_BSR_SPMM_TF32_ENTRY(sprs_bsr_spmm_tf32x3_{FORMS[pair]}, {C_TYPE[pair[0]]}, "
            f"{C_TYPE[pair[1]]}, {C_TYPE[torch.promote_types(*pair)]}, {passes})")


TF32_THREE_PASSES = [(tf32_entry(pair, k3.tf32_passes(*pair)), tf32_entry(pair, 3))
                     for pair in FORMS if k3.tf32_passes(*pair) < 3]
# Candidates: no per-slice finite check (every slice through the split
# with the non-finite rule); the k8 loop with its runtime exit on every
# slice; both together, at 8 warps, are the design of PR 6's variants
# runs 2 and 3.
# With them, the split without its non-finite rule (right on finite data
# only), and every MMA into the row's accumulator with no 32-deep partial
# sums (its error is reported, not gated).
TF32_NO_CHECK = (
    "    const bool mine_finite = fast && PASSES > 1 && fast_stage.finite(stage_a(it), stage_x(it), bs);",
    "    const bool mine_finite = false;")
TF32_RUNTIME_DEPTH = [("mma_slice<TA, TX, PASSES, true, true>", "mma_slice<TA, TX, PASSES, true, false>"),
                      ("mma_slice<TA, TX, PASSES, false, true>", "mma_slice<TA, TX, PASSES, false, false>")]
TF32_FINITE_ONLY = ("  const bool finite = r == r;", "  const bool finite = true;")
TF32_NO_FLUSH = [
    ("  if (first) {\n    asm(", "  if (false) {\n    asm("),
    ("    float part[2][kNTiles][4];\n", "    float (&part)[2][kNTiles][4] = acc;\n"),
    ("for (int j = 0; j < 4; ++j) acc[mt][nt][j] += part[mt][nt][j];", "for (int j = 0; j < 4; ++j) {}"),
]


# K2's tma variant: pairs per consumer thread (the tile's size), consumer
# warps, ring depth; and two cuts that are not K2's function (unchecked): no Y
# stores, and the centre slab alone (the far diagonals' slabs skipped by
# producer and consumers)
def tma_pairs(n):
    return ("constexpr int kPairs = sizeof(Acc) == 8 ? 2 : 4;", f"constexpr int kPairs = {n};")


def tma_warps(n):
    return ("constexpr int kTmaConsumerWarps = 16;", f"constexpr int kTmaConsumerWarps = {n};")


def tma_ctas(n):
    return ("constexpr int kTmaCtasPerSm = 1;", f"constexpr int kTmaCtasPerSm = {n};")


def tma_stages(n):
    return ("constexpr int kMaxStages = 16;", f"constexpr int kMaxStages = {n};")


TMA_NO_STORES = ("          dst[t] = out;", "          if (row < 0) dst[t] = out;")
TMA_CENTRE_ONLY = ("for (int sl = 0; sl < plan.n_slabs; ++sl) {",
                   "for (int sl = 0; sl < plan.n_slabs; ++sl) {\n      if ((plan.packed[sl] >> 16) == 0) continue;")


# K5's gather ceiling: the committed kernel with the same launch and the
# same indices, summing x[idx[i, s]] without reading ``data`` (its output
# is not K5's function and is not checked)
K5_GATHERS_ONLY = (
    """        acc += mul<TD, TX, Acc>((Acc)Cvt<TD>::in(__ldg(&data[base + j])),
                                (Acc)Cvt<TX>::in(__ldg(&x[c])));""",
    """        acc += (Acc)Cvt<TX>::in(__ldg(&x[c]));""")


def per_lane(n):
    return ("constexpr int kPerLane = 8;", f"constexpr int kPerLane = {n};")


def k6_min_blocks(n):
    return ("constexpr int kMinBlocks = 4;", f"constexpr int kMinBlocks = {n};")


# K5 with L2 cache policies: indices and data loaded with L1 no-allocate
# and evict-first, x with evict-last, so that the streamed operands do not
# push x out of L2
K5_CACHE_POLICIES = [
    ("constexpr int kThreads = 256;\n", """constexpr int kThreads = 256;

__device__ __forceinline__ unsigned long long l2_policy(bool last) {
  unsigned long long p;
  if (last) asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(p));
  else asm("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(p));
  return p;
}
__device__ __forceinline__ int ld_once(const int* p, unsigned long long pol) {
  int v;
  asm("ld.global.nc.L1::no_allocate.L2::cache_hint.s32 %0, [%1], %2;" : "=r"(v) : "l"(p), "l"(pol));
  return v;
}
__device__ __forceinline__ float ld_once(const float* p, unsigned long long pol) {
  float v;
  asm("ld.global.nc.L1::no_allocate.L2::cache_hint.f32 %0, [%1], %2;" : "=f"(v) : "l"(p), "l"(pol));
  return v;
}
__device__ __forceinline__ double ld_once(const double* p, unsigned long long pol) {
  double v;
  asm("ld.global.nc.L1::no_allocate.L2::cache_hint.f64 %0, [%1], %2;" : "=d"(v) : "l"(p), "l"(pol));
  return v;
}
__device__ __forceinline__ float ld_keep(const float* p, unsigned long long pol) {
  float v;
  asm("ld.global.nc.L2::cache_hint.f32 %0, [%1], %2;" : "=f"(v) : "l"(p), "l"(pol));
  return v;
}
__device__ __forceinline__ double ld_keep(const double* p, unsigned long long pol) {
  double v;
  asm("ld.global.nc.L2::cache_hint.f64 %0, [%1], %2;" : "=d"(v) : "l"(p), "l"(pol));
  return v;
}
__device__ __forceinline__ __nv_bfloat16 ld_once(const __nv_bfloat16* p, unsigned long long pol) {
  unsigned short v;
  asm("ld.global.nc.L1::no_allocate.L2::cache_hint.b16 %0, [%1], %2;" : "=h"(v) : "l"(p), "l"(pol));
  return __ushort_as_bfloat16(v);
}
__device__ __forceinline__ __nv_bfloat16 ld_keep(const __nv_bfloat16* p, unsigned long long pol) {
  unsigned short v;
  asm("ld.global.nc.L2::cache_hint.b16 %0, [%1], %2;" : "=h"(v) : "l"(p), "l"(pol));
  return __ushort_as_bfloat16(v);
}
__device__ __forceinline__ __half ld_once(const __half* p, unsigned long long pol) {
  unsigned short v;
  asm("ld.global.nc.L1::no_allocate.L2::cache_hint.b16 %0, [%1], %2;" : "=h"(v) : "l"(p), "l"(pol));
  return __ushort_as_half(v);
}
__device__ __forceinline__ __half ld_keep(const __half* p, unsigned long long pol) {
  unsigned short v;
  asm("ld.global.nc.L2::cache_hint.b16 %0, [%1], %2;" : "=h"(v) : "l"(p), "l"(pol));
  return __ushort_as_half(v);
}
"""),
    ("  const long long n_groups = (long long)gridDim.x * blockDim.x / G;\n",
     "  const long long n_groups = (long long)gridDim.x * blockDim.x / G;\n"
     "  const unsigned long long once = l2_policy(false), keep = l2_policy(true);\n"),
    ("__ldg(&indices[base + j])", "ld_once(&indices[base + j], once)"),
    ("__ldg(&data[base + j])", "ld_once(&data[base + j], once)"),
    ("__ldg(&x[c])", "ld_keep(&x[c], keep)"),
]

# K5 candidate (b): one thread per row, the width a template parameter for
# widths 1-16 (a generic loop beyond); all of a row's indices and data are
# loaded (16 bytes at a time where the row fills whole vectors) before any
# gather, streamed with __ldcs, x loaded with an L2 evict-last policy.  The
# committed kernel's C interface (`lanes` unused).
ELL_ROW_SOURCE = r"""
#include <cuda_runtime.h>
#include <cstring>

namespace {

__device__ __forceinline__ unsigned long long evict_last() {
  unsigned long long p;
  asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(p));
  return p;
}

__device__ __forceinline__ float ld_keep(const float* p, unsigned long long pol) {
  float v;
  asm("ld.global.nc.L2::cache_hint.f32 %0, [%1], %2;" : "=f"(v) : "l"(p), "l"(pol));
  return v;
}

__device__ __forceinline__ double ld_keep(const double* p, unsigned long long pol) {
  double v;
  asm("ld.global.nc.L2::cache_hint.f64 %0, [%1], %2;" : "=d"(v) : "l"(p), "l"(pol));
  return v;
}

template <typename T, int W>
__device__ __forceinline__ void load_row(const T* p, T (&out)[W]) {
  constexpr int kV = 16 / sizeof(T);
  if constexpr (W % kV == 0) {
#pragma unroll
    for (int v = 0; v < W / kV; ++v) {
      const int4 q = __ldcs(reinterpret_cast<const int4*>(p) + v);
      memcpy(&out[kV * v], &q, 16);
    }
  } else {
#pragma unroll
    for (int j = 0; j < W; ++j) out[j] = __ldcs(p + j);
  }
}

template <typename T, int W>
__global__ void __launch_bounds__(256)
ell_spmv_row_kernel(const int* __restrict__ indices, const T* __restrict__ data,
                    const T* __restrict__ x, T* __restrict__ y, long long rows,
                    long long cols, int width) {
  const unsigned long long keep = evict_last();
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x; r < rows;
       r += stride) {
    T acc = 0;
    if constexpr (W > 0) {
      int c[W];
      T d[W], v[W];
      load_row<int, W>(indices + r * W, c);
      load_row<T, W>(data + r * W, d);
#pragma unroll
      for (int j = 0; j < W; ++j)
        v[j] = ld_keep(x + (c[j] < 0 ? 0 : (c[j] >= cols ? cols - 1 : (long long)c[j])), keep);
#pragma unroll
      for (int j = 0; j < W; ++j) acc += d[j] * v[j];
    } else {
      const long long base = r * width;
      for (int j = 0; j < width; ++j) {
        long long k = __ldcs(indices + base + j);
        k = k < 0 ? 0 : (k >= cols ? cols - 1 : k);
        acc += __ldcs(data + base + j) * ld_keep(x + k, keep);
      }
    }
    y[r] = acc;
  }
}

template <typename T>
int launch(const void* indices, const void* data, const void* x, void* y,
           long long rows, long long cols, int width, int grid, int block,
           void* stream) {
  if (width < 0 || cols < 1) return (int)cudaErrorInvalidValue;
  auto* s = (cudaStream_t)stream;
  const int* i = (const int*)indices;
  const T* d = (const T*)data;
  const T* v = (const T*)x;
  T* out = (T*)y;
#define ROW_CASE(W) case W: ell_spmv_row_kernel<T, W><<<grid, block, 0, s>>>(i, d, v, out, rows, cols, width); break;
  switch (width) {
    ROW_CASE(1) ROW_CASE(2) ROW_CASE(3) ROW_CASE(4) ROW_CASE(5) ROW_CASE(6) ROW_CASE(7) ROW_CASE(8)
    ROW_CASE(9) ROW_CASE(10) ROW_CASE(11) ROW_CASE(12) ROW_CASE(13) ROW_CASE(14) ROW_CASE(15) ROW_CASE(16)
    default: ell_spmv_row_kernel<T, 0><<<grid, block, 0, s>>>(i, d, v, out, rows, cols, width);
  }
#undef ROW_CASE
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int sprs_ell_spmv_f32(const void* indices, const void* data, const void* x, void* y,
                                 long long rows, long long cols, int width, int lanes, int grid,
                                 int block, void* stream) {
  return launch<float>(indices, data, x, y, rows, cols, width, grid, block, stream);
}

extern "C" int sprs_ell_spmv_f64(const void* indices, const void* data, const void* x, void* y,
                                 long long rows, long long cols, int width, int lanes, int grid,
                                 int block, void* stream) {
  return launch<double>(indices, data, x, y, rows, cols, width, grid, block, stream);
}
"""

# name -> (kernel, source, replacements, params).  Source: a csrc name,
# "baseline:<name>" (from --baseline) or "inline:<name>" (held here).
# Params: K3 (kind: "tc", "tf32x3" or "cuda_core"; columns per CTA; the
# check against the plain version: "gate" raises past the gate, "report"
# prints the error, None skips it; the case sets it runs on: "base", the
# bf16, f32 and f64 shapes, and "forms", the thirteen other forms); K2
# (kind: "tma" or "baseline" (an earlier tree's vector variant, PR 4's
# design); the tma tile's 16-byte vectors of X (None: the committed rule,
# "half": half of it); CTAs per SM; "unchecked" for a diagnostic cut); K5
# (layout: "baseline", the earlier C interface
# without `lanes` and a thread per row, "row", a thread per row, or
# "group", a group of lanes per row; CTAs per SM; the case sets it runs:
# "base", the mesh step and random8 in f32 and 16-bit storage, "forms",
# random8 in all sixteen forms, "probe", random8 with x in f16, f32 and
# f64); K6 (rows per CTA, CTAs per SM).
VARIANTS = {
    "k1 as committed (thread per row, through its plan)": ("k1", "dia_spmv", [], ("plan",)),
    "k1 baseline (an earlier tree's kernel)": ("k1", "baseline:dia_spmv", [], ("baseline",)),
    "k3 wgmma as committed (4 stages, 1 CTA/SM)": ("k3", "bsr_spmm", [], ("tc", 128, "gate", ("base", "forms"))),
    "k3 wgmma pipelined": ("k3", "bsr_spmm", [K3_PIPELINED], ("tc", 128, "gate", ("base",))),
    "k3 wgmma pipelined, 3 stages (2 CTAs/SM)": (
        "k3", "bsr_spmm", [K3_PIPELINED, stages(3)], ("tc", 128, "gate", ("base",))),
    "k3 wgmma pipelined, 6 stages": ("k3", "bsr_spmm", [K3_PIPELINED, stages(6)], ("tc", 128, "gate", ("base",))),
    "k3 baseline (CUDA cores)": ("k3", "baseline:bsr_spmm", [], ("cuda_core", 64, "gate", ("base",))),
    "k3 3xTF32 as committed (16 warps, 128 columns, 3 stages)": (
        "k3", "bsr_spmm", [], ("tf32x3", 128, "gate", ("base", "forms"))),
    "k3 TF32, the 16-bit forms in 3 passes": (
        "k3", "bsr_spmm", TF32_THREE_PASSES, ("tf32x3", 128, "gate", ("forms",))),
    "k3 3xTF32 8 warps": ("k3", "bsr_spmm", [tf32_threads(256)], ("tf32x3", 128, "gate", ("base",))),
    "k3 3xTF32 64 columns": ("k3", "bsr_spmm", [tf32_tile(64)], ("tf32x3", 64, "gate", ("base",))),
    "k3 3xTF32 8 warps, 64 columns, 2 CTAs/SM": (
        "k3", "bsr_spmm", [tf32_threads(256), tf32_tile(64), tf32_min_blocks(2)], ("tf32x3", 64, "gate", ("base",))),
    "k3 3xTF32 2 stages": ("k3", "bsr_spmm", [tf32_stages(2)], ("tf32x3", 128, "gate", ("base",))),
    "k3 3xTF32 diagnostic: no split": ("k3", "bsr_spmm", [TF32_NO_SPLIT], ("tf32x3", 128, None, ("base",))),
    "k3 3xTF32 diagnostic: one pass": ("k3", "bsr_spmm", [TF32_ONE_PASS], ("tf32x3", 128, None, ("base",))),
    "k3 3xTF32 no finite check": ("k3", "bsr_spmm", [TF32_NO_CHECK], ("tf32x3", 128, "gate", ("base",))),
    "k3 3xTF32 runtime depth": ("k3", "bsr_spmm", TF32_RUNTIME_DEPTH, ("tf32x3", 128, "gate", ("base",))),
    "k3 3xTF32 8 warps, no finite check, runtime depth": (
        "k3", "bsr_spmm", [tf32_threads(256), TF32_NO_CHECK] + TF32_RUNTIME_DEPTH, ("tf32x3", 128, "gate", ("base",))),
    "k3 3xTF32 8 warps, finite-only split": (
        "k3", "bsr_spmm", [tf32_threads(256), TF32_NO_CHECK, TF32_FINITE_ONLY] + TF32_RUNTIME_DEPTH,
        ("tf32x3", 128, "gate", ("base",))),
    "k3 3xTF32 no partial sums": ("k3", "bsr_spmm", TF32_NO_FLUSH, ("tf32x3", 128, "report", ("base",))),
    "k2 tma as committed": ("k2", "dia_spmm", [], ("tma", None, 1)),
    "k2 baseline (vector and scalar)": ("k2", "baseline:dia_spmm", [], ("baseline", 0, 3)),
    "k2 scalar as committed": ("k2", "dia_spmm", [], ("scalar", 0, 3)),
    "k2 baseline scalar": ("k2", "baseline:dia_spmm", [], ("baseline scalar", 0, 3)),
    "k2 tma 16 KB tiles in every form": ("k2", "dia_spmm", [tma_pairs(2)], ("tma", 1024, 1)),
    "k2 tma 32 KB tiles in every form": ("k2", "dia_spmm", [tma_pairs(4)], ("tma", 2048, 1)),
    "k2 tma 8 consumer warps": ("k2", "dia_spmm", [tma_warps(8)], ("tma", "half", 1)),
    "k2 tma 8 stages": ("k2", "dia_spmm", [tma_stages(8)], ("tma", None, 1)),
    "k2 tma diagnostic: no Y stores": ("k2", "dia_spmm", [TMA_NO_STORES], ("tma", None, 1, "unchecked")),
    "k2 tma diagnostic: centre slab only": ("k2", "dia_spmm", [TMA_CENTRE_ONLY], ("tma", None, 1, "unchecked")),
    "k5 baseline (thread per row)": ("k5", "baseline:ell_spmv", [], ("baseline", 8, ("base",))),
    "k5 as committed (lane group per row)": ("k5", "ell_spmv", [], ("group", k5.BLOCKS_PER_SM, ("base", "forms"))),
    "k5 probe: gathers of x only, no data": (
        "k5", "ell_spmv", [K5_GATHERS_ONLY], ("group", k5.BLOCKS_PER_SM, ("probe",))),
    "k5 lane group per row, L2 cache policies": ("k5", "ell_spmv", K5_CACHE_POLICIES, ("group", 8, ("base",))),
    "k5 (b) thread per row, width template": ("k5", "inline:ell_row", [], ("row", 8, ("base",))),
    "k6 baseline (4 per lane, a warp per row)": ("k6", "baseline:sort_rows", [], (8, 8)),
    "k6 as committed (8 per lane, 2 rows per warp)": (
        "k6", "sort_rows", [], (k6.BLOCK // 32 * k6.ROWS_PER_WARP, k6.BLOCKS_PER_SM)),
    "k6 4 per lane": ("k6", "sort_rows", [per_lane(4)], (8, k6.BLOCKS_PER_SM)),
    "k6 16 per lane, min 3 CTAs/SM": ("k6", "sort_rows", [per_lane(16), k6_min_blocks(3)], (32, 3)),
}


def source_text(name, src, reps, baseline):
    if src.startswith("inline:"):
        text = {"ell_row": ELL_ROW_SOURCE}[src.split(":", 1)[1]]
    elif src.startswith("baseline:"):
        text = (Path(baseline) / f"{src.split(':', 1)[1]}.cu").read_text()
    else:
        text = (build.CSRC_DIR / f"{src}.cu").read_text()
    for old, new in reps:
        if old not in text:
            raise RuntimeError(f"variant {name!r}: the source no longer holds {old!r}")
        text = text.replace(old, new)
    return text


def build_variants(names, baseline, sass=False):
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, name in enumerate(VARIANTS):
        if name not in names:
            continue
        _, src, reps, _ = VARIANTS[name]
        path = OUT / f"v{i}.cu"
        path.write_text(source_text(name, src, reps, baseline))
        cmd = build.nvcc_command(path, OUT / f"libv{i}.so")
        procs[name] = (i, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (i, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            _, src, reps, _ = VARIANTS[name]
            if not reps and not src.startswith("inline:"):  # the committed source or the baseline
                raise RuntimeError(f"nvcc failed for {name}:\n{log}")
            print(f"nvcc failed for {name}, left out:\n{log}", flush=True)
            continue
        print(f"built {name}", flush=True)
        for fn, regs, stores, loads in build.ptxas_report(log):
            print(f"ptxas {name}: {fn}: {regs} registers, {stores} bytes spill stores, "
                  f"{loads} bytes spill loads", flush=True)
        libs[name] = ctypes.CDLL(str(OUT / f"libv{i}.so"))
        if sass:
            print(f"sass {name}: {sass_opcodes(OUT / f'libv{i}.so')}", flush=True)
    return libs


def sass_opcodes(lib):
    """Opcode counts of each kernel in ``lib`` (``cuobjdump -sass``), the
    most frequent first; a count is of instructions in the code, not of
    instructions run."""
    cuobjdump = Path(build._nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True, text=True).stdout
    out = {}
    for fn in text.split("Function : ")[1:]:
        name = fn.split(None, 1)[0]
        ops = collections.Counter(
            m.group(1).split(".")[0]
            for m in re.finditer(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]\s+)?([A-Z][A-Z0-9_.]*)", fn))
        out[name] = dict(ops.most_common(12), total=sum(ops.values()))
    return out


LL, VP, I = ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int


# K3's kinds: the types each runs in the base cases, and its profiler key;
# in the "forms" cases "tf32x3" runs every form and "tc" its two
K3_DTYPES = {"tc": (torch.bfloat16,), "tf32x3": (torch.float32, torch.float64),
             "cuda_core": (torch.float32, torch.float64)}
TC_PAIRS = ((torch.bfloat16, torch.bfloat16), (torch.float16, torch.float16))
K3_KEYS = {"tc": "bsr_spmm_tc_kernel", "tf32x3": "bsr_spmm_tf32x3_kernel",
           "cuda_core": "bsr_spmm_kernel<"}


def k3_call(lib, bsr, x, kind, tile_n, _check, _sets):
    """One launch of a K3 kind: "tc" (wgmma), "tf32x3", or "cuda_core"
    (PR 5's CUDA-core kernel, in a baseline tree), ``tile_n`` columns
    per CTA, in the form of (blocks, X); Y in promote(blocks, X)."""
    tc = kind == "tc"
    prefix = {"tc": "sprs_bsr_spmm_tc_", "tf32x3": "sprs_bsr_spmm_tf32x3_",
              "cuda_core": "sprs_bsr_spmm_"}[kind]
    fn = getattr(lib, prefix + FORMS[(bsr.dtype, x.dtype)])
    fn.argtypes = [VP, VP, VP, VP, VP, VP, LL, LL, LL, I] + ([LL] if tc else []) + [I, I, VP]
    k = x.shape[1]
    y = torch.empty((bsr.rows, k), dtype=out_dtype(bsr.blocks, x), device=x.device)
    row_ptr, order = bsr.row_order
    gx, gy = max(bsr.n_block_rows, 1), max(-(-k // tile_n), 1)
    err = fn(bsr.blocks.data_ptr(), bsr.bcols.data_ptr(), row_ptr.data_ptr(), order.data_ptr(),
             x.data_ptr(), y.data_ptr(), bsr.rows, bsr.cols, k, bsr.block_size,
             *([bsr.cap] if tc else []), gx, gy, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"launch failed: {err}")
    return y


def entry(lib, kernel, data, x):
    """The form's entry point of ``kernel`` in ``lib``, None where the
    source has no such form."""
    return getattr(lib, f"sprs_{kernel}_{FORMS[(data.dtype, x.dtype)]}", None)


def out_dtype(data, x):
    return torch.promote_types(data.dtype, x.dtype)


# plans of the committed source's K1 entries, by (library, operand, x
# type); kept for the process (the operands live as long)
K1_PLANS = {}


def k1_call(lib, dia, x, kind):
    """One launch of K1: "plan" through a plan of the library's
    ``sprs_dia_spmv_plan_<form>`` entry, or "baseline", an earlier tree's
    per-form entry (grid and block from ``launch_config``, passed per
    call)."""
    y = torch.empty(dia.rows, dtype=out_dtype(dia.data, x), device=x.device)
    n_sm = torch.cuda.get_device_properties(x.device).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream
    n = dia.n_diags
    offsets = (ctypes.c_int * n)(*dia.offsets)
    grid, block = k1.launch_config(dia.rows, n_sm)
    if kind == "baseline":
        fn = entry(lib, "dia_spmv", dia.data, x)
        fn.argtypes = [VP, VP, VP, LL, LL, LL, VP, I, I, I, VP]
        err = fn(dia.data.data_ptr(), x.data_ptr(), y.data_ptr(), dia.rows, dia.cols, dia.rows_pad,
                 offsets, n, grid, block, stream)
    else:
        key = (lib._name, id(dia), x.dtype)
        if key not in K1_PLANS:
            fn = entry(lib, "dia_spmv_plan", dia.data, x)
            fn.argtypes = [VP, LL, LL, LL, VP, I, I, ctypes.POINTER(I)]
            fn.restype = VP
            err = I(0)
            handle = fn(dia.data.data_ptr(), dia.rows, dia.cols, dia.rows_pad, offsets, n, grid,
                        ctypes.byref(err))
            if not handle:
                raise RuntimeError(f"K1 plan failed: {err.value}")
            K1_PLANS[key] = handle
        run = lib.sprs_dia_spmv_run
        run.argtypes = [VP, VP, VP, VP]
        err = run(K1_PLANS[key], x.data_ptr(), y.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"launch failed: {err}")
    return y


def k2_call(lib, dia, x, kind, tile_vectors, ctas_per_sm):
    """One launch of a K2 kind: "tma" (tiles of at most ``tile_vectors``
    16-byte vectors of X: None for the committed rule, "half" for half of
    it; ``ctas_per_sm`` persistent CTAs an SM) or "baseline" (an earlier
    tree's vector variant, PR 4's design, whose entry has no
    ``tile_cols``: ``ctas_per_sm`` CTAs an SM of runs of 4 rows, 2 for
    16-bit X), "scalar" or "baseline scalar" (the scalar variant of the
    committed source or of an earlier tree)."""
    fn = entry(lib, "dia_spmm", dia.data, x)
    k = x.shape[1]
    y = torch.empty((dia.rows, k), dtype=out_dtype(dia.data, x), device=x.device)
    per_vec = k2.VECTOR_BYTES // x.element_size()
    n_sm = torch.cuda.get_device_properties(x.device).multi_processor_count
    if kind == "tma":
        if tile_vectors in (None, "half"):
            vectors = k2.tile_vectors(k2.acc_itemsize(dia.dtype, x.dtype))
            tile_vectors = vectors // 2 if tile_vectors == "half" else vectors
        chunks = -(-k // k2.MAX_TILE_COLS)
        tile_cols = -(-(-(-k // chunks)) // per_vec) * per_vec
        tile_rows = min(k2.MAX_TILE_ROWS, tile_vectors * per_vec // tile_cols) // 8 * 8
        grid = min(-(-dia.rows // tile_rows) * -(-k // tile_cols), n_sm * ctas_per_sm)
        tail = [1, tile_rows, tile_cols]
    elif kind == "baseline":
        runs = max(k2.THREADS // (k // per_vec), 1)
        grid = min(-(-dia.rows // (runs * (2 if per_vec > 4 else 4))), n_sm * ctas_per_sm)
        tail = [1, runs]
    else:  # the scalar variant: runs of 4 rows, one column a thread
        runs = max(k2.THREADS // k, 1)
        grid = min(-(-dia.rows // (runs * k2.RUN)), n_sm * ctas_per_sm)
        tail = [0, runs] + ([1] if kind == "scalar" else [])
    fn.argtypes = [VP, VP, VP, LL, LL, LL, LL, VP, I] + [I] * len(tail) + [I, VP]
    n = dia.n_diags
    err = fn(dia.data.data_ptr(), x.data_ptr(), y.data_ptr(), dia.rows, dia.cols, dia.rows_pad, k,
             (ctypes.c_int * n)(*dia.offsets), n, *tail, grid, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"launch failed: {err}")
    return y


def k5_call(lib, ell, x, layout, blocks_per_sm):
    fn = entry(lib, "ell_spmv", ell.data, x)
    g = k5.group_lanes(ell.width) if layout == "group" else 1
    lanes = [] if layout == "baseline" else [g]
    fn.argtypes = [VP, VP, VP, VP, LL, LL, I] + [I] * len(lanes) + [I, I, VP]
    y = torch.empty(ell.rows, dtype=out_dtype(ell.data, x), device=x.device)
    n_sm = torch.cuda.get_device_properties(x.device).multi_processor_count
    grid = min(-(-ell.rows // (256 // g)), n_sm * blocks_per_sm)
    err = fn(ell.indices.data_ptr(), ell.data.data_ptr(), x.data_ptr(), y.data_ptr(), ell.rows,
             ell.cols, ell.width, *lanes, grid, 256, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"launch failed: {err}")
    return y


def k6_call(lib, keys, vals, rows_per_block, blocks_per_sm):
    fn = getattr(lib, "sprs_sort_rows_i32" if keys.dtype == torch.int32 else "sprs_sort_rows_f32")
    fn.argtypes = [VP, VP, VP, VP, LL, I, I, VP]
    ks, vs = torch.empty_like(keys), torch.empty_like(vals)
    n_sm = torch.cuda.get_device_properties(keys.device).multi_processor_count
    grid = min(-(-keys.shape[0] // rows_per_block), n_sm * blocks_per_sm)
    err = fn(keys.data_ptr(), vals.data_ptr(), ks.data_ptr(), vs.data_ptr(), keys.shape[0], grid, 256,
             torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"launch failed: {err}")
    return ks, vs


def k3_cases():
    """chip_smoke.py's timing shapes: n 4096 and 16384 in bf16 and f32,
    n 4096 in f64 (set "base"); the thirteen other forms at n 4096 (set
    "forms"), the f32 operand and X rounded to each form's types."""
    out = []
    for dtype, ns in ((torch.bfloat16, (cs.BSR_N, cs.BSR_BIG_N)), (torch.float32, (cs.BSR_N, cs.BSR_BIG_N)),
                      (torch.float64, (cs.BSR_N,))):
        for n in ns:
            seed = 40 if n == cs.BSR_N else 42
            bsr = bsr_random(seed, (n, n), 128, 0.125, dtype, device="cuda")
            x = cs.rhs_block(n, cs.BSR_K, dtype, seed + 1)
            out.append((f"n={n} k={cs.BSR_K} bs=128 {FORMS[(dtype, dtype)]}", "base", bsr, x,
                        bsr_spmm_plain(bsr, x).float()))
    bsr = bsr_random(40, (cs.BSR_N,) * 2, 128, 0.125, torch.float32, device="cuda")
    x = cs.rhs_block(cs.BSR_N, cs.BSR_K, torch.float32, 41)
    for d, xd in cs.NEW_K3_FORMS:
        b = cs.form_bsr(bsr, d)
        out.append((f"n={cs.BSR_N} k={cs.BSR_K} bs=128 {FORMS[(d, xd)]}", "forms", b, x.to(xd),
                    bsr_spmm_plain(b, x.to(xd)).float()))
    return out


def half_forms(label, op, x):
    """The float32 case and the forms of 16-bit storage on the same
    operand: (t, t) and (t, f32) for t bf16 and f16."""
    out = [(f"{label} f32", op, x)]
    for t, name in ((torch.bfloat16, "bf16"), (torch.float16, "f16")):
        half = cs.form_op(op, t)
        out += [(f"{label} {name}", half, x.to(t)), (f"{label} {name} data, f32 x", half, x)]
    return out


def k1_cases():
    """The 4096² grid Laplacian in float32 and 16-bit storage, and the
    1024² and 64² float64 grids (the main path's solve size and a small
    one)."""
    lap = grid_laplacian((cs.SPMV_SIDE,) * 2, torch.float32, device="cuda")
    dia = dia_tile(lap.to_dia())
    out = half_forms(f"{cs.SPMV_SIDE}^2 grid", dia, cs.rhs_block(dia.cols, 1, torch.float32, 0)[:, 0])
    for side in (cs.SOLVE_SIDE, 64):
        op = dia_tile(grid_laplacian((side, side), torch.float64, device="cuda").to_dia())
        out.append((f"{side}^2 grid f64", op, cs.rhs_block(op.cols, 1, torch.float64, side)[:, 0]))
    return [(label, d, x, k1.dia_spmv_plain(d, x)) for label, d, x in out]


def k2_cases():
    """chip_smoke.py's K2 shape in all sixteen forms (the 2048×1024 grid
    Laplacian stored in each data type, 128 RHS from one float64 draw
    rounded to each X type) and the 1024² float64 grid at 24, 48 and 256
    RHS (the tma variant) and 3 (the scalar one).  Prints each case's
    yardsticks: the bytes bound, the plain version's time and
    ``torch.sparse.mm``'s on the CSR tensor of the data's type (or why
    torch refuses the types)."""
    types = (torch.float16, torch.bfloat16, torch.float32, torch.float64)
    gen = torch.Generator(device="cuda").manual_seed(30)
    X = torch.randn((cs.SPMM_GRID[0] * cs.SPMM_GRID[1], 128), generator=gen, device="cuda",
                    dtype=torch.float64)
    xs = {t: X.to(t) for t in types}
    del X
    ops = []
    for d in types:
        mat = grid_laplacian(cs.SPMM_GRID, d, device="cuda")
        dia = dia_tile(mat.to_dia())
        ops += [(f"2048x1024 grid k=128 {FORMS[(d, t)]}", mat, dia, xs[t]) for t in types]
    mat = grid_laplacian((cs.SOLVE_SIDE,) * 2, device="cuda")
    dia = dia_tile(mat.to_dia())
    ops += [(f"1024^2 grid f64 k={k}", mat, dia, cs.rhs_block(dia.cols, k, torch.float64, k))
            for k in (24, 48, 256, cs.EXPM_FEW_SOURCES)]
    out = []
    for label, mat, dia, x in ops:
        ref = k2.dia_spmm_plain(dia, x)
        k = x.shape[1]
        nbytes = (dia.data.numel() * dia.data.element_size() + x.numel() * x.element_size()
                  + dia.rows * k * cs.out_size(dia.data, x))
        b_ms, b_by = cs.bound(nbytes, 2 * dia.n_diags * dia.rows * k, cs.peak_of(dia.dtype, x.dtype))
        plain_ms = cs.time_ms(lambda: k2.dia_spmm_plain(dia, x), 3)
        csr = cs.csr_twin(mat)
        lib_ms, _, lib_error = cs.library_time(lambda: torch.sparse.mm(csr, x), ref, 20)
        del csr
        print(f"yardstick k2 {label}: " + json.dumps(
            {"bound_ms": b_ms, "bound_by": b_by, "plain_ms": plain_ms, "library_ms": lib_ms,
             "library_error": lib_error}), flush=True)
        out.append((label, dia, x, ref))
    return out


def k5_cases():
    """(label, set, ell, x, plain output or None): "base", the mesh step
    as chip_smoke.py builds it (f64, width 7) and random8 (f32, width 8)
    in f32 and 16-bit storage; "forms", random8 in all sixteen forms;
    "probe", random8 with x in f16, f32 and f64 (the gathers-only probe,
    whose output is not checked)."""
    mesh_a = cs.mesh_step(*cs.permuted_mesh(cs.MESH_SIDE)[:2])[1]
    ell = ell_from_csmat(mesh_a)
    x = cs.rhs_block(mesh_a.cols, 1, torch.float64, 89)[:, 0].contiguous()
    _, r8, x8 = cs.random8_operand()
    label8 = f"random8 n={cs.RANDOM8_N} width {r8.width}"
    base = [(f"{cs.MESH_SIDE}^2 mesh step f64 width {ell.width}", ell, x)]
    base += half_forms(label8, r8, x8)
    out = [(label, "base", e, v, k5.ell_spmv_plain(e, v)) for label, e, v in base]
    for (d, t), form in FORMS.items():
        e = cs.form_op(r8, d)
        out.append((f"{label8} {form}", "forms", e, x8.to(t), k5.ell_spmv_plain(e, x8.to(t))))
    for t in (torch.float16, torch.float32, torch.float64):
        out.append((f"{label8} gathers only, x {FORMS[(t, t)]}", "probe", r8, x8.to(t), None))
    return out


def k6_cases():
    out = []
    for kind, seed in (("int32", 90), ("float32", 92)):
        keys, vals = cs.sort_case(cs.SORT_ROWS, kind, seed)
        out.append((f"{cs.SORT_ROWS}x128 {kind} keys", keys, vals, k6.sort_rows_plain(keys, vals)))
    return out


def checked(name, label, kernel, call, ref, out_dtype, strict=True):
    """Raise unless the variant's output agrees with the plain version
    (with ``strict`` false, only print the error)."""
    if kernel == "k3":
        rel = float((call().float() - ref).abs().max() / ref.abs().max())
        ok = rel <= cs.BSR_GATE_LIMIT[out_dtype]
        print(f"check {name} {label}: rel {rel!r}", flush=True)
    elif kernel == "k6":
        ks, vs = call()
        ok = torch.equal(ks.view(torch.int32), ref[0].view(torch.int32)) and torch.equal(
            vs.view(torch.int32), ref[1].view(torch.int32))
        rel = 0.0 if ok else float("nan")
    else:
        err = float((call().float() - ref.float()).abs().max())
        rel = err / float(ref.float().abs().max())
        ok = rel <= cs.FORM_GATE_LIMIT[ref.dtype]  # ref: the plain version's output
    if not ok and strict:
        raise AssertionError(f"{name} {label}: rel {rel}")


KEYS = {"k1": "dia_spmv", "k2": "dia_spmm", "k5": "ell_spmv", "k6": "sort_rows"}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernels", nargs="+", default=["k1", "k2", "k3", "k5", "k6"],
                    choices=["k1", "k2", "k3", "k5", "k6"])
    ap.add_argument("--baseline", help="a csrc directory of an earlier tree (the baseline variants)")
    ap.add_argument("--sass", action="store_true", help="count each variant's SASS opcodes")
    ap.add_argument("--variants", nargs="+", help="run only the variants whose names contain one of these")
    ap.add_argument("--only", nargs="+", help="run only the cases whose labels end in one of these words")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    names = [n for n, v in VARIANTS.items() if v[0] in args.kernels
             and (args.baseline or not v[1].startswith("baseline:"))
             and (not args.variants or any(part in n for part in args.variants))]
    libs = build_variants(names, args.baseline, args.sass)
    cases = {"k1": k1_cases, "k2": k2_cases, "k3": k3_cases, "k5": k5_cases, "k6": k6_cases}
    cases = {k: cases[k]() for k in args.kernels}
    for rnd in range(2):
        for name in names:
            if name not in libs:
                continue
            kernel, _, _, params = VARIANTS[name]
            for case in cases[kernel]:
                label, ref = case[0], case[-1]
                key = KEYS.get(kernel)
                out = None
                if kernel == "k3":
                    _, group, bsr, x, _ = case
                    if group not in params[3] or (
                            x.dtype not in K3_DTYPES[params[0]] if group == "base"
                            else params[0] == "tc" and (bsr.dtype, x.dtype) not in TC_PAIRS):
                        continue
                    call = functools.partial(k3_call, libs[name], bsr, x, *params)
                    key = K3_KEYS[params[0]]
                    out = torch.promote_types(bsr.dtype, x.dtype)
                elif kernel in ("k1", "k2", "k5"):
                    src = {"k1": "dia_spmv", "k2": "dia_spmm", "k5": "ell_spmv"}[kernel]
                    op, x = case[-3], case[-2]
                    if kernel == "k5" and case[1] not in params[2]:
                        continue
                    if kernel == "k2" and ("scalar" in params[0]) != (
                            k2.variant(x.shape[1], x.element_size(), x.data_ptr()) == "scalar"):
                        continue  # each variant on the widths the rule gives it
                    form_src = "dia_spmv_plan" if kernel == "k1" and params[0] != "baseline" else src
                    if entry(libs[name], form_src, op.data, x) is None:
                        continue  # a source without this type form
                    fn = {"k1": k1_call, "k2": k2_call, "k5": k5_call}[kernel]
                    call = functools.partial(fn, libs[name], op, x, *params[:2 if kernel == "k5" else 3])
                else:
                    call = functools.partial(k6_call, libs[name], case[1], case[2], *params)
                if args.only and not any(label.endswith(" " + s) for s in args.only):
                    continue
                unchecked = (kernel == "k3" and params[2] is None) or (kernel == "k2" and len(params) > 3)
                if not unchecked and ref is not None:
                    checked(name, label, kernel, call, ref, out,
                            strict=kernel != "k3" or params[2] == "gate")
                ms = cs.device_ms(call, key, 30)
                print(f"round {rnd} {name} {label}: device ms {ms!r}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
