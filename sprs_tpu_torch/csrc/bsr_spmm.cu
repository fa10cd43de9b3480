// Block-sparse (BSR) matrix times dense matrix for Hopper (sm_90a).
//
//     Y[r * bs + i, c] = sum over the blocks b of block row r, in the
//                        order ``order`` lists them, of
//                        sum_j blocks[b, i, j] * X[bcols[b] * bs + j, c],
//
// with X's rows read as 0 at and past ``cols``.  X (cols, k) and Y
// (rows, k) are row-major.  The blocks of block row r are
// order[row_ptr[r] : row_ptr[r + 1]], so the blocks themselves may lie in
// any order.  Every (blocks, X) pair of f16, bf16, f32 and f64 is a form
// (ops/cuda/forms.py::FORMS).  Products and sums are taken in float32 for
// every form, as the JAX package's kernel does
// (preferred_element_type=float32), and Y is written once in
// promote(blocks, X), the Pallas kernel's output type.  A block row with
// no block is written as zeros.
//
// Replaces the TPU kernels of sprs_tpu/ops/pallas/bsr_spmm.py: _pallas_spmm
// (K3: one grid step per stored block, the accumulator zeroed at the first
// visit of a block row and flushed at the last, which needs the blocks
// sorted by row) and bsr_spmm_pallas_grouped (K4: ``group`` blocks of one
// row per step, X resident in VMEM).  A GPU grid has no order to carry an
// accumulator across steps, so here one CTA owns one output tile (a block
// row by a tile of X's columns) and walks the row's blocks through the
// row pointer; K4's grouped layout is one more input of the same kernels.
// Both variants run on the tensor cores; the wrapper's rule
// (ops/cuda/bsr_spmm.py: ``variant``) picks one, each with its own entry
// points:
//
// * bsr_spmm_tc_kernel (bfloat16 or float16 blocks and X of one type, bs
//   64 or 128, k a multiple of 8, X and the blocks 16-byte aligned).  Bound: bytes at the main shape.  One
//   call must read the live blocks once, X once and write Y once, and do
//   2 * n_blocks * bs * bs * k operations (n = 4096, k = 512, bs = 128,
//   density 0.125: 13.3 MB and 2.5 GFLOP, 4.0 us of HBM against 2.5 us of
//   bf16 tensor cores).  Only the tensor cores (wgmma) come near either
//   rate, and only when their operands arrive in shared memory without
//   holding threads.  Design: one CTA per (block row, 128 columns of X);
//   one producer warp walks the row's blocks and, for each 64-deep chunk
//   of a block, has TMA copy the A tile (bs x 64, from the blocks viewed
//   as a (cap * bs, bs) matrix) and the X tile (64 x 128, two 64-column
//   boxes at row bcols[b] * bs + chunk) into a 4-stage ring in 128-byte
//   swizzle, completion on an mbarrier per stage.  TMA's out-of-bounds
//   fill gives X's rows past ``cols`` and columns past k as zeros.  bs / 64
//   consumer warpgroups (one 64-row half of the block row each) run
//   wgmma m64n128k16 (A K-major, X as the transposed, N-major B) on each
//   stage that has arrived, keep the float32 accumulator in registers for
//   the whole row and release the stage through an "empty" mbarrier.  The
//   epilogue rounds to the operand type and stores pairs with a mask on rows >=
//   ``rows`` and columns >= k.  Block rows differ in their block count
//   (0 to about 10 at density 0.125); that imbalance is left as it is.
//   The tensor maps are encoded on the host at every launch (X's address
//   changes per call) and passed as __grid_constant__ parameters;
//   cuTensorMapEncodeTiled is reached through cudaGetDriverEntryPoint, so
//   the library needs no link against libcuda.
//
// * bsr_spmm_tf32x3_kernel (every other case: the forms with a float32
//   or float64 operand, the two 16-bit cross forms, float16 or bfloat16
//   that misses TMA's conditions, any block size that is a multiple of 8
//   up to 128, any k, any alignment).  Bound:
//   operations.  The same call in f32 is 2.5 GFLOP against 26.6 MB; the
//   CUDA cores (67 TFLOP/s) would need 38 us for it.  The tensor cores
//   take TF32, whose 10-bit mantissa alone puts float32 results about
//   1e-3 off.  So each operand element v (converted to float32) is split
//   into hi = v with its low 13 mantissa bits cleared (truncation: hi
//   never rounds up to inf near FLT_MAX) and lo = v - hi (exact in
//   float32), rounded to TF32 with cvt.rna; a * b is then taken as
//   lo_a * hi_b + hi_a * lo_b + hi_a * hi_b, three TF32 MMAs (the scheme
//   CUTLASS calls 3xTF32), small terms first.  The dropped lo_a * lo_b and
//   the rounding of lo leave about 2^-21 of each product, float32's own
//   order, where one pass left 2^-11.  3 x 2.5 GFLOP at the 495 TFLOP/s
//   TF32 peak is 15.2 us.  wgmma takes TF32 only with both operands
//   K-major in shared memory, and X is N-major; so warps run mma.sync
//   m16n8k8, whose fragments are built in registers, and the split is
//   done as each fragment is read from shared memory.  Design: one CTA of
//   16 warps per (block row, 128 columns of X); warps tile the bs x 128
//   output as 4 x 4 tiles of 32 x 32 (two m16 by four n8 MMA tiles; tiles
//   on rows >= bs are skipped; 16 warps of 32 x 32 hid latency better
//   than 8 of 32 x 64, within 128 registers).  The row's block indices are
//   staged in shared memory once.  A 3-stage cp.async ring carries, for each
//   32-deep slice of a block, the raw A slice (bs x 32) and X slice
//   (32 x 128) in the operand type, 16 bytes per copy from offsets each
//   thread fixes at the start (4 or 8 bytes per copy where X or the
//   blocks are not 16-byte aligned or bs is not a multiple of 32; plain
//   loads for such bfloat16), X's rows past ``cols`` and columns past k
//   zero-filled.  Shared rows are padded so that the fragment reads of a
//   warp hit no bank twice, and within each 8-deep step the MMA's k slots
//   t and t + 4 take A's columns 2t and 2t + 1 (X's rows likewise), so
//   A's two slots are one paired read.  The tensor cores truncate when
//   they add into the float32 accumulator: with one accumulator over a
//   whole row (up to 1,280 terms at the main shape) the result drifted to
//   1.3e-5 of max|Y| at n 4096 and 2.3e-5 at n 16384 on the H100, past
//   the 1e-5 gate; so each 32-deep slice is summed into a fresh partial
//   accumulator, which is then added into the row's accumulator with
//   round-to-nearest FADDs (6e-7).  Non-finite operands: lo of +-inf
//   would be inf - inf = NaN, and hi_a * lo_b with a = inf and a
//   TF32-exact b (lo_b = 0) would be inf * 0 = NaN where a * b is inf;
//   so where v is not finite lo = 0 and the hi taken into the cross terms
//   is 0, and hi_a * hi_b carries inf and NaN as IEEE does (v + 0 first
//   makes a NaN the canonical NaN, whose payload survives the dropped
//   bits).  That rule costs three instructions per fragment element, so
//   each thread checks the copies it made of a slice once they land, the
//   slice's barrier ORs the answers, and a slice with no inf or NaN takes
//   the split without it.  On the 16-byte path every slice is 32 deep and
//   the 8-deep steps unroll without a runtime exit.  The kernel is
//   templated on the blocks', X's and Y's types and on the pass count.
//   Each operand is staged in its own type (the 16-bit forms keep half
//   the bytes) and converted to float32 as its fragments are read; a
//   float64 operand is rounded to float32 there, as the Pallas kernel's
//   float32 products take it.  A 16-bit value is exact in TF32, so its
//   lo is 0 and it is not split: with one 16-bit operand two passes
//   (lo_a * hi_b or hi_a * lo_b, then hi_a * hi_b), with two one pass
//   (hi_a * hi_b); the cross term keeps the non-finite rule above on both
//   sides (the 16-bit side's hx is 0 where it is inf or NaN).  The pass
//   count of each form is fixed by its entry point below, mirroring
//   ops/cuda/bsr_spmm.py::tf32_passes.  What holds it back
//   (benches/torch_kernel_variants.py): mma.sync's TF32 rate, about 40 %
//   of wgmma's, three times over; the split; and block rows of unequal
//   length in a single wave of CTAs.
//
// Index math into blocks, X and Y is 64-bit in both.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "tma.cuh"

namespace {

template <typename T>
constexpr bool kHalf = std::is_same_v<T, __half> || std::is_same_v<T, __nv_bfloat16>;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(double v) { return (float)v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ double from_f32<double>(float v) {
  return (double)v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half_rn(v);
}

// ---------------------------------------------------------------------------
// TF32 variant (3 passes with no 16-bit operand, 2 with one, 1 with two)
// ---------------------------------------------------------------------------

constexpr int kTf32Threads = 512;  // 16 warps: 4 along the rows x 4 along the columns
constexpr int kTf32MinBlocks = 1;  // CTAs per SM the registers are sized for
constexpr int kTf32TileN = 128;    // output columns per CTA
constexpr int kTf32Stages = 3;     // depth of the cp.async ring
constexpr int kTf32Depth = 32;     // depth of one staged slice of a block
constexpr int kMaxBs = 128;
constexpr int kWarpRows = 32;  // two m16 tiles
constexpr int kWarpsN = kTf32Threads / 32 / (kMaxBs / kWarpRows);
constexpr int kWarpCols = kTf32TileN / kWarpsN;
constexpr int kNTiles = kWarpCols / 8;
constexpr int kIdxCache = 256;  // a row's first block indices, staged once

// Shared-row padding: 8 elements on A's rows, 16 bytes on X's.  Within
// each 8-deep step the MMA's k slots t and t + 4 (t = lane % 4) are taken
// from columns 2t and 2t + 1 of A and rows 2t and 2t + 1 of X (the same
// permutation of k on both sides, so the product is unchanged): A's two
// slots are then one paired read.  With these strides the reads of a
// warp (g = lane / 4 on A's rows and X's columns) fall on distinct banks,
// within each half warp for 8-byte reads and each quarter warp for
// 16-byte ones.  Each operand has its own type, so its own stride; at
// most (f64, f64) 3 x 74,240 bytes.
template <typename TA, typename TX>
struct Tf32Shape {
  static constexpr int kSA = kTf32Depth + 8;  // A row stride
  static constexpr int kSX = kTf32TileN + 16 / (int)sizeof(TX);  // X row stride
  static constexpr int kABytes = kMaxBs * kSA * (int)sizeof(TA);
  static constexpr int kStageBytes = kABytes + kTf32Depth * kSX * (int)sizeof(TX);
  static constexpr int kSmem = kTf32Stages * kStageBytes;
  static_assert(kSmem <= 232448, "the ring must fit a block's shared memory");
};

// 16 bytes (or ``bytes`` of them, the rest zero-filled) from global to
// shared memory, asynchronously.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

// One element, or a zero where ``ok`` is false.
__device__ __forceinline__ void copy_elem(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void copy_elem(double* dst, const double* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(ok ? 8 : 0)
               : "memory");
}
// 16-bit elements: a plain load (cp.async copies at least 4 bytes).
template <typename T>
__device__ __forceinline__ std::enable_if_t<kHalf<T>> copy_elem(T* dst, const T* src, bool ok) {
  *dst = ok ? *src : from_f32<T>(0.f);
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Two neighbouring elements of shared memory, as float32.
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const double* p) {
  const double2 d = *reinterpret_cast<const double2*>(p);
  return make_float2((float)d.x, (float)d.y);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 load2(const __half* p) {
  return __half22float2(*reinterpret_cast<const __half2*>(p));
}

// Stages slice [kc, kc + depth) of block ``blk`` (all bs rows) and rows
// [xrow, xrow + depth) x columns [c0, c0 + kTf32TileN) of X.
template <typename TA, typename TX>
__device__ __forceinline__ void stage_slice(TA* a_s, TX* x_s, const TA* blk, const TX* x,
                                            long long xrow, long long cols, long long k,
                                            long long c0, int bs, int kc, int depth,
                                            bool vec_a, bool vec_x) {
  using S = Tf32Shape<TA, TX>;
  constexpr int kVA = 16 / sizeof(TA), kVX = 16 / sizeof(TX);  // elements per 16-byte copy
  if (vec_a) {
    const int per_row = depth / kVA;
    for (int e = threadIdx.x; e < bs * per_row; e += kTf32Threads) {
      const int r = e / per_row, v = e - r * per_row;
      cp_async16(a_s + r * S::kSA + v * kVA, blk + (long long)r * bs + kc + v * kVA, 16);
    }
  } else {
    for (int e = threadIdx.x; e < bs * depth; e += kTf32Threads) {
      const int r = e / depth, q = e - r * depth;
      copy_elem(a_s + r * S::kSA + q, blk + (long long)r * bs + kc + q, true);
    }
  }
  if (vec_x) {
    constexpr int per_row = kTf32TileN / kVX;
    for (int e = threadIdx.x; e < depth * per_row; e += kTf32Threads) {
      const int q = e / per_row, v = e % per_row;
      const long long xr = xrow + q, xc = c0 + v * kVX;
      // k is a multiple of kVX here, so a vector lies wholly inside or outside
      const bool ok = xr < cols && xc < k;
      cp_async16(x_s + q * S::kSX + v * kVX, ok ? x + xr * k + xc : x, ok ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < depth * kTf32TileN; e += kTf32Threads) {
      const int q = e / kTf32TileN, cc = e % kTf32TileN;
      const long long xr = xrow + q, xc = c0 + cc;
      const bool ok = xr < cols && xc < k;
      copy_elem(x_s + q * S::kSX + cc, ok ? x + xr * k + xc : x, ok);
    }
  }
}

// The same for the common case (X and the blocks 16-byte aligned, k a
// multiple of 16 bytes, bs a multiple of kTf32Depth): every thread copies
// fixed 16-byte columns of fixed rows, so its offsets are set once.
template <typename TA, typename TX>
struct FastStage {
  static constexpr int kVA = 16 / sizeof(TA), kVX = 16 / sizeof(TX);
  static constexpr int kAVecs = kTf32Depth / kVA;  // copies per A row
  static constexpr int kARows = kTf32Threads / kAVecs;  // A rows per pass
  static constexpr int kXVecs = kTf32TileN / kVX;  // copies per X row
  static constexpr int kXRows = kTf32Threads / kXVecs;  // X rows per pass
  int a_src, a_dst, x_dst;
  long long x_col;

  __device__ FastStage(long long c0, int bs) {
    using S = Tf32Shape<TA, TX>;
    const int ar = threadIdx.x / kAVecs, av = threadIdx.x % kAVecs;
    const int xq = threadIdx.x / kXVecs, xv = threadIdx.x % kXVecs;
    a_src = ar * bs + av * kVA;
    a_dst = ar * S::kSA + av * kVA;
    x_dst = xq * S::kSX + xv * kVX;
    x_col = c0 + xv * kVX;
  }

  __device__ __forceinline__ void operator()(TA* a_s, TX* x_s, const TA* blk, const TX* x,
                                             long long xrow, long long cols, long long k,
                                             int bs) const {
    using S = Tf32Shape<TA, TX>;
    const TA* src = blk + a_src;
    for (int r = threadIdx.x / kAVecs; r < bs; r += kARows, src += (long long)kARows * bs)
      cp_async16(a_s + a_dst + (r - threadIdx.x / kAVecs) * S::kSA, src, 16);
    const long long xr0 = xrow + threadIdx.x / kXVecs;
    const TX* xsrc = x + xr0 * k + x_col;
#pragma unroll
    for (int i = 0; i < kTf32Depth / kXRows; ++i) {
      const bool ok = x_col < k && xr0 + i * kXRows < cols;
      cp_async16(x_s + x_dst + i * kXRows * S::kSX, ok ? xsrc + i * kXRows * k : x, ok ? 16 : 0);
    }
  }

  // Whether this thread's own copies of a slice are finite as float32
  // (zero fill is); cp.async.wait_group has made them visible to it.
  __device__ __forceinline__ bool finite(const TA* a_s, const TX* x_s, int bs) const {
    using S = Tf32Shape<TA, TX>;
    const int ar = threadIdx.x / kAVecs;
    float z = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxBs / kARows; ++i)
      if (ar + i * kARows < bs) z += zeros(a_s + a_dst + i * kARows * S::kSA);
#pragma unroll
    for (int i = 0; i < kTf32Depth / kXRows; ++i) z += zeros(x_s + x_dst + i * kXRows * S::kSX);
    return z == 0.f;
  }

  // The sum of v * 0 over one copy's elements: 0, or NaN where any is
  // +-inf or NaN (summed as a tree, short chains).
  template <typename T>
  __device__ __forceinline__ static float zeros(const T* p) {
    constexpr int kV = 16 / sizeof(T);
    float z[kV / 2];
#pragma unroll
    for (int j = 0; j < kV / 2; ++j) {
      const float2 v = load2(p + 2 * j);
      z[j] = fmaf(v.y, 0.f, v.x * 0.f);
    }
#pragma unroll
    for (int w = 1; w < kV / 2; w *= 2)
#pragma unroll
      for (int j = 0; j + w < kV / 2; j += 2 * w) z[j] += z[j + w];
    return z[0];
  }
};

// The TF32 parts of one operand: hi (low 13 mantissa bits cleared), hx
// (hi, or 0 where v is not finite: the hi taken into the cross terms) and
// lo (v - hi rounded to TF32, 0 where v is not finite).  kSafe false: v is
// known to be finite.  kSplit false (a 16-bit value, exact in TF32, or one
// pass): hi is v itself and lo is not formed.
template <bool kSplit, bool kSafe>
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& hx, uint32_t& lo) {
  if (!kSplit) {
    hi = __float_as_uint(v);
    hx = kSafe && (hi & 0x7F800000u) == 0x7F800000u ? 0u : hi;
    return;
  }
  if (!kSafe) {
    hi = __float_as_uint(v) & 0xFFFFE000u;
    hx = hi;
    asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(v - __uint_as_float(hi)));
    return;
  }
  const float w = v + 0.f;  // a NaN becomes the canonical NaN, whose payload TF32 keeps
  hi = __float_as_uint(w) & 0xFFFFE000u;
  const float r = w - __uint_as_float(hi);  // exact; NaN where v is +-inf or NaN
  const bool finite = r == r;
  hx = finite ? hi : 0u;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(finite ? r : 0.f));
}

// d (+)= a * b, m16n8k8, TF32 in, float32 accumulate; ``first`` starts
// from zero instead of d.
template <bool first>
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  if (first) {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %11, %12, %13};\n"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.f), "f"(0.f),
          "f"(0.f), "f"(0.f));
  } else {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
}

template <typename T>
__device__ __forceinline__ void store_pair(T* __restrict__ y, long long row, long long col,
                                           long long rows, long long k, float v0, float v1) {
  if (row >= rows) return;
  if (col < k) y[row * k + col] = from_f32<T>(v0);
  if (col + 1 < k) y[row * k + col + 1] = from_f32<T>(v1);
}

// The operands a pass count splits: with 3 both, with 2 the one wider
// than 16 bits, with 1 neither.
template <typename T, int PASSES>
constexpr bool kSplits = PASSES == 3 || (PASSES == 2 && !kHalf<T>);

// One 32-deep slice (``depth`` deep where kFull is false) of the warp's
// tile: part = the slice's products, in PASSES passes.  a_s and x_s point
// at the lane's first A row and X column of the slice; m_ok1: the warp's
// second m16 tile lies on rows < bs.
template <typename TA, typename TX, int PASSES, bool kSafe, bool kFull>
__device__ __forceinline__ void mma_slice(const TA* a_s, const TX* x_s, int depth, bool m_ok1,
                                          float (&part)[2][kNTiles][4]) {
  using S = Tf32Shape<TA, TX>;
  constexpr bool kSplitA = kSplits<TA, PASSES>, kSplitX = kSplits<TX, PASSES>;
#pragma unroll
  for (int ks = 0; ks < kTf32Depth / 8; ++ks) {
    if (!kFull && ks * 8 >= depth) break;
    uint32_t ah[2][4], ax[2][4], al[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      if (mt == 1 && !m_ok1) continue;
      // a0, a2: row g, k slots t and t + 4; a1, a3: row g + 8
      const TA* p = a_s + mt * 16 * S::kSA + ks * 8;
      const float2 top = load2(p), bottom = load2(p + 8 * S::kSA);
      split<kSplitA, kSafe>(top.x, ah[mt][0], ax[mt][0], al[mt][0]);
      split<kSplitA, kSafe>(bottom.x, ah[mt][1], ax[mt][1], al[mt][1]);
      split<kSplitA, kSafe>(top.y, ah[mt][2], ax[mt][2], al[mt][2]);
      split<kSplitA, kSafe>(bottom.y, ah[mt][3], ax[mt][3], al[mt][3]);
    }
#pragma unroll
    for (int nt = 0; nt < kNTiles; ++nt) {
      const TX* q = x_s + ks * 8 * S::kSX + nt * 8;
      uint32_t bh0, bx0, bl0, bh1, bx1, bl1;
      split<kSplitX, kSafe>(to_f32(q[0]), bh0, bx0, bl0);  // k slot t: row 2t
      split<kSplitX, kSafe>(to_f32(q[S::kSX]), bh1, bx1, bl1);  // k slot t + 4: row 2t + 1
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        if (mt == 1 && !m_ok1) continue;
        // small terms first: lo_a hx_b, hx_a lo_b, then hi_a hi_b; the
        // first MMA of the slice starts from zero
        if (kSplitA) {
          if (ks == 0)
            mma_tf32<true>(part[mt][nt], al[mt], bx0, bx1);
          else
            mma_tf32<false>(part[mt][nt], al[mt], bx0, bx1);
        }
        if (kSplitX) {
          if (ks == 0 && !kSplitA)
            mma_tf32<true>(part[mt][nt], ax[mt], bl0, bl1);
          else
            mma_tf32<false>(part[mt][nt], ax[mt], bl0, bl1);
        }
        if (ks == 0 && !kSplitA && !kSplitX)
          mma_tf32<true>(part[mt][nt], ah[mt], bh0, bh1);
        else
          mma_tf32<false>(part[mt][nt], ah[mt], bh0, bh1);
      }
    }
  }
}

// PASSES: 3 (lo_a hi_b, hi_a lo_b, hi_a hi_b), 2 (one operand 16-bit: the
// cross term of the other's lo, then hi_a hi_b) or 1 (hi_a hi_b).
template <typename TA, typename TX, typename TY, int PASSES>
__global__ void __launch_bounds__(kTf32Threads, kTf32MinBlocks)
    bsr_spmm_tf32x3_kernel(const TA* __restrict__ blocks, const int* __restrict__ bcols,
                           const int* __restrict__ row_ptr, const int* __restrict__ order,
                           const TX* __restrict__ x, TY* __restrict__ y, long long rows,
                           long long cols, long long k, int bs, bool vec_a, bool vec_x) {
  static_assert(PASSES == 1 || PASSES == 3 || (PASSES == 2 && kHalf<TA> != kHalf<TX>),
                "two passes split the one operand wider than 16 bits");
  using S = Tf32Shape<TA, TX>;
  extern __shared__ __align__(128) unsigned char smem[];
  const bool fast = vec_a && vec_x && bs % kTf32Depth == 0;
  __shared__ int s_blk[kIdxCache];
  __shared__ int s_bcol[kIdxCache];

  const int br = blockIdx.x;
  const long long c0 = (long long)blockIdx.y * kTf32TileN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wrow = (warp / kWarpsN) * kWarpRows;  // the warp's first row in the block row
  const int wcol = (warp % kWarpsN) * kWarpCols;  // and first column in the tile
  const int p0 = row_ptr[br];
  const int nb = row_ptr[br + 1] - p0;
  const int chunks = (bs + kTf32Depth - 1) / kTf32Depth;
  const int n_iters = nb * chunks;

  for (int i = threadIdx.x; i < min(nb, kIdxCache); i += kTf32Threads) {
    const int b = order[p0 + i];
    s_blk[i] = b;
    s_bcol[i] = bcols[b];
  }
  __syncthreads();

  auto stage_a = [&](int it) {
    return reinterpret_cast<TA*>(smem + (it % kTf32Stages) * S::kStageBytes);
  };
  auto stage_x = [&](int it) {
    return reinterpret_cast<TX*>(smem + (it % kTf32Stages) * S::kStageBytes + S::kABytes);
  };
  const FastStage<TA, TX> fast_stage(c0, bs);
  auto issue = [&](int it) {
    const int p = it / chunks;
    const int kc = (it - p * chunks) * kTf32Depth;
    int b, bc;
    if (p < kIdxCache) {
      b = s_blk[p];
      bc = s_bcol[p];
    } else {
      b = order[p0 + p];
      bc = bcols[b];
    }
    const TA* blk = blocks + (long long)b * bs * bs;
    if (fast)
      fast_stage(stage_a(it), stage_x(it), blk + kc, x, (long long)bc * bs + kc, cols, k, bs);
    else
      stage_slice<TA, TX>(stage_a(it), stage_x(it), blk, x, (long long)bc * bs + kc, cols, k, c0, bs,
                     kc, min(kTf32Depth, bs - kc), vec_a, vec_x);
  };

  const bool m_ok[2] = {wrow < bs, wrow + 16 < bs};
  float acc[2][kNTiles][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNTiles; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mt][nt][j] = 0.f;

#pragma unroll
  for (int s = 0; s < kTf32Stages - 1; ++s) {
    if (s < n_iters) issue(s);
    cp_async_commit();
  }
  for (int it = 0; it < n_iters; ++it) {
    cp_async_wait<kTf32Stages - 2>();
    // Slice ``it`` has landed and slice it - 1 is no longer read.  A slice
    // with no inf or NaN (each thread checks its own copies) takes the
    // plain split; the generic staging always takes the full one.
    const bool mine_finite = fast && PASSES > 1 && fast_stage.finite(stage_a(it), stage_x(it), bs);
    const bool safe = __syncthreads_or(!mine_finite);
    if (it + kTf32Stages - 1 < n_iters) issue(it + kTf32Stages - 1);
    cp_async_commit();
    if (!m_ok[0]) continue;  // a warp wholly on rows >= bs
    const int depth = min(kTf32Depth, bs - (it % chunks) * kTf32Depth);
    const TA* a_s = stage_a(it) + (wrow + g) * S::kSA + 2 * t;
    const TX* x_s = stage_x(it) + 2 * t * S::kSX + wcol + g;
    float part[2][kNTiles][4];
    if (!fast)
      mma_slice<TA, TX, PASSES, true, false>(a_s, x_s, depth, m_ok[1], part);
    else if (PASSES == 1 || safe)
      mma_slice<TA, TX, PASSES, true, true>(a_s, x_s, depth, m_ok[1], part);
    else
      mma_slice<TA, TX, PASSES, false, true>(a_s, x_s, depth, m_ok[1], part);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      if (!m_ok[mt]) continue;
#pragma unroll
      for (int nt = 0; nt < kNTiles; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[mt][nt][j] += part[mt][nt][j];
    }
  }

  // accumulator j of tile (mt, nt): row wrow + 16 mt + g (+ 8 for j >= 2),
  // column wcol + 8 nt + 2 t (+ 1 for odd j)
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int r = wrow + mt * 16 + g;
    if (!m_ok[mt]) continue;
#pragma unroll
    for (int nt = 0; nt < kNTiles; ++nt) {
      const long long col = c0 + wcol + nt * 8 + 2 * t;
      if (r < bs)
        store_pair<TY>(y, (long long)br * bs + r, col, rows, k, acc[mt][nt][0], acc[mt][nt][1]);
      if (r + 8 < bs)
        store_pair<TY>(y, (long long)br * bs + r + 8, col, rows, k, acc[mt][nt][2],
                       acc[mt][nt][3]);
    }
  }
}

template <typename TA, typename TX, typename TY, int PASSES>
int launch_tf32(const void* blocks, const int* bcols, const int* row_ptr, const int* order,
                const void* x, void* y, long long rows, long long cols, long long k, int bs,
                int grid_x, int grid_y, void* stream) {
  using S = Tf32Shape<TA, TX>;
  if (bs < 8 || bs > kMaxBs || bs % 8 != 0) return (int)cudaErrorInvalidValue;
  // each operand's 16-byte copies by its own element size
  const bool vec_a = reinterpret_cast<uintptr_t>(blocks) % 16 == 0;
  const bool vec_x = reinterpret_cast<uintptr_t>(x) % 16 == 0 && (k * sizeof(TX)) % 16 == 0;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err =
        cudaFuncSetAttribute(bsr_spmm_tf32x3_kernel<TA, TX, TY, PASSES>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, S::kSmem);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  dim3 grid(grid_x, grid_y);
  bsr_spmm_tf32x3_kernel<TA, TX, TY, PASSES>
      <<<grid, kTf32Threads, S::kSmem, (cudaStream_t)stream>>>(
          (const TA*)blocks, bcols, row_ptr, order, (const TX*)x, (TY*)y, rows, cols, k, bs,
          vec_a, vec_x);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Tensor-core variant (bfloat16 or float16, bs 64 or 128)
// ---------------------------------------------------------------------------

constexpr int kTcTileN = 128;   // output columns per CTA: one wgmma N
constexpr int kTcChunk = 64;    // K depth of one stage: 128 bytes of 16-bit values
constexpr int kTcBoxN = 64;     // X box width: 128 bytes, the swizzle span
constexpr int kTcStages = 4;
constexpr int kTcXBytes = kTcChunk * kTcTileN * 2;  // 16 KB per stage

template <int BS>
struct TcShape {
  static constexpr int kWarpgroups = BS / 64;  // consumers, 64 rows each
  static constexpr int kThreads = kWarpgroups * 128 + 32;  // + producer
  static constexpr int kABytes = BS * kTcChunk * 2;
  static constexpr int kStageBytes = kABytes + kTcXBytes;
  // ring + the 1024-byte alignment that 128-byte swizzle needs + barriers
  static constexpr int kSmem = kTcStages * kStageBytes + 1024 + 256;
};

// wgmma shared-memory descriptor, 128-byte swizzle.  Offsets in bytes.
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo) {
  uint64_t d = (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4);
  d |= (uint64_t)((lbo >> 4) & 0x3FFF) << 16;
  d |= (uint64_t)((sbo >> 4) & 0x3FFF) << 32;
  d |= (uint64_t)1 << 62;
  return d;
}

// D[64 x 128] += A[64 x 16] * B[16 x 128]: A K-major, B N-major
// (transposed), TYPE ("bf16" or "f16") in, f32 accumulate.
#define SPRS_WGMMA_M64N128K16(TYPE)                                          \
  asm volatile(                                                              \
      "{\n"                                                                  \
      ".reg .pred p;\n"                                                      \
      "setp.ne.b32 p, %66, 0;\n"                                             \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TYPE "." TYPE " "       \
      "{%0, %1, %2, %3, %4, %5, %6, %7, "                                    \
      "%8, %9, %10, %11, %12, %13, %14, %15, "                               \
      "%16, %17, %18, %19, %20, %21, %22, %23, "                             \
      "%24, %25, %26, %27, %28, %29, %30, %31, "                             \
      "%32, %33, %34, %35, %36, %37, %38, %39, "                             \
      "%40, %41, %42, %43, %44, %45, %46, %47, "                             \
      "%48, %49, %50, %51, %52, %53, %54, %55, "                             \
      "%56, %57, %58, %59, %60, %61, %62, %63}, "                            \
      "%64, %65, p, 1, 1, 0, 1;\n"                                           \
      "}\n"                                                                  \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),          \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),          \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),     \
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),     \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),     \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),     \
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),     \
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),     \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),     \
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),     \
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),     \
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),     \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])                   \
      : "l"(da), "l"(db), "r"(1))

template <typename T>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db) {
  if constexpr (std::is_same_v<T, __half>)
    SPRS_WGMMA_M64N128K16("f16");
  else
    SPRS_WGMMA_M64N128K16("bf16");
}

// Two neighbouring outputs, rounded to T, in one 4-byte store.
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store2(__half* p, float a, float b) {
  *reinterpret_cast<__half2*>(p) = __floats2half2_rn(a, b);
}

template <int BS, typename T>
__global__ void __launch_bounds__(TcShape<BS>::kThreads)
    bsr_spmm_tc_kernel(const __grid_constant__ CUtensorMap map_a,
                       const __grid_constant__ CUtensorMap map_x,
                       const int* __restrict__ bcols,
                       const int* __restrict__ row_ptr,
                       const int* __restrict__ order,
                       T* __restrict__ y, long long rows,
                       long long k) {
  using S = TcShape<BS>;
  constexpr int kChunks = BS / kTcChunk;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  // stage s: A tile (BS rows of 128 bytes) then the X tile (two boxes of
  // 64 rows x 128 bytes)
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kTcStages * S::kStageBytes);
  uint64_t* empty = full + kTcStages;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int br = blockIdx.x;
  const int c0 = blockIdx.y * kTcTileN;
  const int p0 = row_ptr[br];
  const int n_iters = (row_ptr[br + 1] - p0) * kChunks;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kTcStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], S::kWarpgroups * 4);  // one arrive per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == S::kWarpgroups * 4) {
    // producer
    if (lane == 0) {
      for (int it = 0; it < n_iters; ++it) {
        const int s = it % kTcStages;
        const uint32_t round = it / kTcStages;
        mbar_wait(&empty[s], (round & 1) ^ 1);
        const int b = order[p0 + it / kChunks];
        const int kc = (it % kChunks) * kTcChunk;
        unsigned char* a_dst = smem + s * S::kStageBytes;
        unsigned char* x_dst = a_dst + S::kABytes;
        const int xrow = bcols[b] * BS + kc;
        mbar_expect_tx(&full[s], S::kStageBytes);
        tma_load_2d(a_dst, &map_a, &full[s], kc, b * BS);
        tma_load_2d(x_dst, &map_x, &full[s], c0, xrow);
        tma_load_2d(x_dst + kTcXBytes / 2, &map_x, &full[s], c0 + kTcBoxN, xrow);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows [wg * 64, wg * 64 + 64) of the block row
  const int wg = warp / 4;
  float acc[64];
#pragma unroll
  for (int j = 0; j < 64; ++j) acc[j] = 0.f;

  for (int it = 0; it < n_iters; ++it) {
    const int s = it % kTcStages;
    mbar_wait(&full[s], (it / kTcStages) & 1);
    const unsigned char* a_tile = smem + s * S::kStageBytes + wg * 64 * 128;
    const unsigned char* x_tile = smem + s * S::kStageBytes + S::kABytes;
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < kTcChunk / 16; ++kk) {
      // A: K-major rows of 128 bytes, 8-row atoms 1024 bytes apart; a
      // 16-deep step is 32 bytes along the row.
      const uint64_t da = smem_desc(a_tile + kk * 32, 16, 1024);
      // B: N-major, 8 K-rows of 128 bytes per 1024-byte atom (SBO), the
      // second 64 columns one box further on (LBO); a 16-deep step is 16
      // rows of 128 bytes.
      const uint64_t db = smem_desc(x_tile + kk * 16 * 128, kTcXBytes / 2, 1024);
      wgmma_m64n128k16<T>(acc, da, db);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  // epilogue: accumulator j holds row (warp % 4) * 16 + lane / 4 (+ 8 for
  // j % 4 >= 2), column 8 * (j / 4) + 2 * (lane % 4) (+ 1 for odd j)
  const long long row_base = (long long)br * BS + wg * 64 + (warp % 4) * 16 + lane / 4;
#pragma unroll
  for (int j = 0; j < 64; j += 2) {
    const long long row = row_base + ((j % 4) >= 2 ? 8 : 0);
    const long long col = c0 + 8 * (j / 4) + 2 * (lane % 4);
    if (row < rows && col < k) store2(y + row * k + col, acc[j], acc[j + 1]);
  }
}

// A 2-D tensor map of 16-bit ``type`` over a row-major (outer, inner)
// matrix, boxes of box_outer x 64, 128-byte swizzle, zeros outside the
// matrix.
bool half_map(CUtensorMap* map, CUtensorMapDataType type, const void* base, long long outer,
              long long inner, int box_outer) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  const cuuint64_t strides[1] = {(cuuint64_t)inner * 2};
  const cuuint32_t box[2] = {(cuuint32_t)kTcBoxN, (cuuint32_t)box_outer};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, type, 2, const_cast<void*>(base),
                dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BS, typename T>
int launch_tc(const void* blocks, const int* bcols, const int* row_ptr,
              const int* order, const void* x, void* y, long long rows,
              long long cols, long long k, long long cap, int grid_x,
              int grid_y, void* stream) {
  using S = TcShape<BS>;
  if (k % 8 != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(blocks) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const CUtensorMapDataType type = std::is_same_v<T, __half> ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                                             : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap map_a, map_x;
  if (!half_map(&map_a, type, blocks, cap * BS, BS, BS) ||
      !half_map(&map_x, type, x, cols, k, kTcChunk))
    return (int)cudaErrorInvalidValue;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        bsr_spmm_tc_kernel<BS, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        S::kSmem);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  dim3 grid(grid_x, grid_y);
  bsr_spmm_tc_kernel<BS, T><<<grid, S::kThreads, S::kSmem, (cudaStream_t)stream>>>(
      map_a, map_x, bcols, row_ptr, order, (T*)y, rows, k);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_tc_bs(const void* blocks, const int* bcols, const int* row_ptr, const int* order,
                 const void* x, void* y, long long rows, long long cols, long long k, int bs,
                 long long cap, int grid_x, int grid_y, void* stream) {
  if (bs == 64)
    return launch_tc<64, T>(blocks, bcols, row_ptr, order, x, y, rows, cols, k, cap, grid_x,
                            grid_y, stream);
  if (bs == 128)
    return launch_tc<128, T>(blocks, bcols, row_ptr, order, x, y, rows, cols, k, cap, grid_x,
                             grid_y, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Plain C interface, bound with ctypes.  All pointers are device
// pointers; ``row_ptr`` has grid_x + 1 entries (one per block row).
// Returns cudaGetLastError() after the launch (0 on success).
#define SPRS_BSR_SPMM_TF32_ENTRY(NAME, TA, TX, TY, PASSES)                      \
  extern "C" int NAME(const void* blocks, const int* bcols, const int* row_ptr, \
                      const int* order, const void* x, void* y, long long rows, \
                      long long cols, long long k, int bs, int grid_x,          \
                      int grid_y, void* stream) {                               \
    return launch_tf32<TA, TX, TY, PASSES>(blocks, bcols, row_ptr, order, x, y, \
                                           rows, cols, k, bs, grid_x, grid_y,   \
                                           stream);                             \
  }

// The TF32 variant, one entry per form (blocks, X) -> Y, named
// sprs_bsr_spmm_tf32x3_<blocks>_<x>, or sprs_bsr_spmm_tf32x3_<t> where both
// are t (ops/cuda/forms.py::FORMS); the last argument is the form's pass
// count, 1 + the operands wider than 16 bits (ops/cuda/bsr_spmm.py::tf32_passes).
#define F16 __half
#define BF16 __nv_bfloat16
SPRS_BSR_SPMM_TF32_ENTRY(sprs_bsr_spmm_tf32x3_f16, F16, F16, F16, 1)
SPRS_BSR_SPMM_TF32_ENTRY(sprs_bsr_spmm_tf32x3_f16_bf16, F16, BF16, float, 1)
SPRS_BSR_SPMM_TF32_ENTRY(sprs_bsr_spmm_tf32x3_f16_f32, F16, float, float, 2)
SPRS_BSR_SPMM_TF32_ENTRY(sprs_bsr_spmm_tf32x3_f16_f64, F16, double, double, 2)
SPRS_BSR_SPMM_TF32_ENTRY(sprs_bsr_spmm_tf32x3_bf16_f16, BF16, F16, float, 1)
SPRS_BSR_SPMM_TF32_ENTRY(sprs_bsr_spmm_tf32x3_bf16, BF16, BF16, BF16, 1)
SPRS_BSR_SPMM_TF32_ENTRY(sprs_bsr_spmm_tf32x3_bf16_f32, BF16, float, float, 2)
SPRS_BSR_SPMM_TF32_ENTRY(sprs_bsr_spmm_tf32x3_bf16_f64, BF16, double, double, 2)
SPRS_BSR_SPMM_TF32_ENTRY(sprs_bsr_spmm_tf32x3_f32_f16, float, F16, float, 2)
SPRS_BSR_SPMM_TF32_ENTRY(sprs_bsr_spmm_tf32x3_f32_bf16, float, BF16, float, 2)
SPRS_BSR_SPMM_TF32_ENTRY(sprs_bsr_spmm_tf32x3_f32, float, float, float, 3)
SPRS_BSR_SPMM_TF32_ENTRY(sprs_bsr_spmm_tf32x3_f32_f64, float, double, double, 3)
SPRS_BSR_SPMM_TF32_ENTRY(sprs_bsr_spmm_tf32x3_f64_f16, double, F16, double, 2)
SPRS_BSR_SPMM_TF32_ENTRY(sprs_bsr_spmm_tf32x3_f64_bf16, double, BF16, double, 2)
SPRS_BSR_SPMM_TF32_ENTRY(sprs_bsr_spmm_tf32x3_f64_f32, double, float, double, 3)
SPRS_BSR_SPMM_TF32_ENTRY(sprs_bsr_spmm_tf32x3_f64, double, double, double, 3)

// The tensor-core variant: float16 or bfloat16 blocks and X of one type,
// bs 64 or 128, ``cap`` the number of stored blocks (the blocks are read as
// a (cap * bs, bs) matrix).
#define SPRS_BSR_SPMM_TC_ENTRY(NAME, T)                                          \
  extern "C" int NAME(const void* blocks, const int* bcols, const int* row_ptr, \
                      const int* order, const void* x, void* y, long long rows, \
                      long long cols, long long k, int bs, long long cap,       \
                      int grid_x, int grid_y, void* stream) {                   \
    return launch_tc_bs<T>(blocks, bcols, row_ptr, order, x, y, rows, cols, k,  \
                           bs, cap, grid_x, grid_y, stream);                    \
  }

SPRS_BSR_SPMM_TC_ENTRY(sprs_bsr_spmm_tc_bf16, BF16)
SPRS_BSR_SPMM_TC_ENTRY(sprs_bsr_spmm_tc_f16, F16)
