// Block-sparse (BSR) matrix times dense matrix for Hopper (sm_90a).
//
//     Y[r * bs + i, c] = sum over the blocks b of block row r, in the
//                        order ``order`` lists them, of
//                        sum_j blocks[b, i, j] * X[bcols[b] * bs + j, c],
//
// with X's rows read as 0 at and past ``cols``.  X (cols, k) and Y
// (rows, k) are row-major.  The blocks of block row r are
// order[row_ptr[r] : row_ptr[r + 1]], so the blocks themselves may lie in
// any order.  Products and sums are taken in float32 for every operand
// type (f32, bf16, f64), as the JAX package's kernel and its XLA twin do
// (preferred_element_type=float32); Y is written in the operand type.  A
// block row with no block is written as zeros.
//
// Replaces the TPU kernels of sprs_tpu/ops/pallas/bsr_spmm.py: _pallas_spmm
// (K3: one grid step per stored block, the accumulator zeroed at the first
// visit of a block row and flushed at the last, which needs the blocks
// sorted by row) and bsr_spmm_pallas_grouped (K4: ``group`` blocks of one
// row per step, X resident in VMEM).  A GPU grid has no order to carry an
// accumulator across steps, so here one CTA owns one output tile (a block
// row by a tile of X's columns) and walks the row's blocks through the
// row pointer; K4's grouped layout is one more input of the same kernels.
// Two variants, chosen by the wrapper's rule (ops/cuda/bsr_spmm.py:
// ``variant``), each with its own entry points:
//
// * bsr_spmm_tc_kernel (bfloat16, bs 64 or 128, k a multiple of 8, X and
//   the blocks 16-byte aligned).  Bound: bytes at the main shape.  One
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
//   epilogue rounds to bfloat16 and stores pairs with a mask on rows >=
//   ``rows`` and columns >= k.  Block rows differ in their block count
//   (0 to about 10 at density 0.125); that imbalance is left as it is.
//   The tensor maps are encoded on the host at every launch (X's address
//   changes per call) and passed as __grid_constant__ parameters;
//   cuTensorMapEncodeTiled is reached through cudaGetDriverEntryPoint, so
//   the library needs no link against libcuda.
//
// * bsr_spmm_kernel (every other case: float32 and float64 operands, any
//   block size that is a multiple of 8 up to 128, odd widths k, unaligned
//   X).  It runs on the CUDA cores in float32 (TF32 tensor cores would
//   put float32 results about 1e-3 off), so it is bound by FMA issue and
//   shared-memory traffic, not by bytes: 256 threads as 16 x 16, each
//   holding up to 8 rows x 4 columns of a 64-column tile in registers.
//   For each block it stages an 8-deep slice of the block (transposed,
//   padded against bank conflicts) and of the X tile in shared memory,
//   converting to float32 on the way, then does 32 FMAs per 12
//   shared-memory reads.
//
// Index math into blocks, X and Y is 64-bit in both.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------------------
// CUDA-core variant
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;  // 16 x 16
constexpr int kTileN = 64;     // output columns per CTA
constexpr int kDepth = 8;      // depth of one staged slice; divides bs
constexpr int kMaxBs = 128;
constexpr int kRowsPerThread = kMaxBs / 16;
constexpr int kColsPerThread = kTileN / 16;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(double v) { return (float)v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
    bsr_spmm_kernel(const T* __restrict__ blocks,
                    const int* __restrict__ bcols,
                    const int* __restrict__ row_ptr,
                    const int* __restrict__ order, const T* __restrict__ x,
                    T* __restrict__ y, long long rows, long long cols,
                    long long k, int bs) {
  __shared__ float a_s[kDepth][kMaxBs + 1];
  __shared__ float x_s[kDepth][kTileN];
  const int br = blockIdx.x;
  const long long c0 = (long long)blockIdx.y * kTileN;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  float acc[kRowsPerThread][kColsPerThread];
#pragma unroll
  for (int m = 0; m < kRowsPerThread; ++m)
#pragma unroll
    for (int n = 0; n < kColsPerThread; ++n) acc[m][n] = 0.f;

  const int p_end = row_ptr[br + 1];
  for (int p = row_ptr[br]; p < p_end; ++p) {
    const int b = order[p];
    const T* blk = blocks + (long long)b * bs * bs;
    const long long xrow0 = (long long)bcols[b] * bs;
    for (int kk = 0; kk < bs; kk += kDepth) {
      for (int e = threadIdx.x; e < bs * kDepth; e += kThreads) {
        const int r = e / kDepth, q = e % kDepth;
        a_s[q][r] = to_f32(blk[(long long)r * bs + kk + q]);
      }
      for (int e = threadIdx.x; e < kDepth * kTileN; e += kThreads) {
        const int q = e / kTileN, cc = e % kTileN;
        const long long xr = xrow0 + kk + q, xc = c0 + cc;
        x_s[q][cc] = (xr < cols && xc < k) ? to_f32(x[xr * k + xc]) : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int q = 0; q < kDepth; ++q) {
        float a[kRowsPerThread], xv[kColsPerThread];
#pragma unroll
        for (int m = 0; m < kRowsPerThread; ++m)
          a[m] = (ty + 16 * m < bs) ? a_s[q][ty + 16 * m] : 0.f;
#pragma unroll
        for (int n = 0; n < kColsPerThread; ++n) xv[n] = x_s[q][tx + 16 * n];
#pragma unroll
        for (int m = 0; m < kRowsPerThread; ++m)
#pragma unroll
          for (int n = 0; n < kColsPerThread; ++n) acc[m][n] += a[m] * xv[n];
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int m = 0; m < kRowsPerThread; ++m) {
    const int r = ty + 16 * m;
    const long long row = (long long)br * bs + r;
    if (r >= bs || row >= rows) continue;
#pragma unroll
    for (int n = 0; n < kColsPerThread; ++n) {
      const long long c = c0 + tx + 16 * n;
      if (c < k) y[row * k + c] = from_f32<T>(acc[m][n]);
    }
  }
}

template <typename T>
int launch(const void* blocks, const int* bcols, const int* row_ptr,
           const int* order, const void* x, void* y, long long rows,
           long long cols, long long k, int bs, int grid_x, int grid_y,
           void* stream) {
  if (bs < kDepth || bs > kMaxBs || bs % kDepth != 0)
    return (int)cudaErrorInvalidValue;
  dim3 grid(grid_x, grid_y);
  bsr_spmm_kernel<T><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const T*)blocks, bcols, row_ptr, order, (const T*)x, (T*)y, rows, cols,
      k, bs);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Tensor-core variant (bfloat16, bs 64 or 128)
// ---------------------------------------------------------------------------

constexpr int kTcTileN = 128;   // output columns per CTA: one wgmma N
constexpr int kTcChunk = 64;    // K depth of one stage: 128 bytes of bf16
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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Waits for the completion of the barrier's phase of parity ``parity``.
// A wait that never ends (a fault in the ring's bookkeeping) traps, so
// the launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  for (long long spins = 0;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (spins > (1ll << 28)) __trap();
  }
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

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
// (transposed), bf16 in, f32 accumulate.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

template <int BS>
__global__ void __launch_bounds__(TcShape<BS>::kThreads)
    bsr_spmm_tc_kernel(const __grid_constant__ CUtensorMap map_a,
                       const __grid_constant__ CUtensorMap map_x,
                       const int* __restrict__ bcols,
                       const int* __restrict__ row_ptr,
                       const int* __restrict__ order,
                       __nv_bfloat16* __restrict__ y, long long rows,
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
      wgmma_m64n128k16(acc, da, db);
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
    if (row < rows && col < k) {
      *reinterpret_cast<__nv_bfloat162*>(y + row * k + col) =
          __floats2bfloat162_rn(acc[j], acc[j + 1]);
    }
  }
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A 2-D bf16 tensor map over a row-major (outer, inner) matrix, boxes of
// box_outer x 64, 128-byte swizzle, zeros outside the matrix.
bool bf16_map(CUtensorMap* map, const void* base, long long outer,
              long long inner, int box_outer) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  const cuuint64_t strides[1] = {(cuuint64_t)inner * 2};
  const cuuint32_t box[2] = {(cuuint32_t)kTcBoxN, (cuuint32_t)box_outer};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base),
                dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BS>
int launch_tc(const void* blocks, const int* bcols, const int* row_ptr,
              const int* order, const void* x, void* y, long long rows,
              long long cols, long long k, long long cap, int grid_x,
              int grid_y, void* stream) {
  using S = TcShape<BS>;
  if (k % 8 != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(blocks) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  CUtensorMap map_a, map_x;
  if (!bf16_map(&map_a, blocks, cap * BS, BS, BS) ||
      !bf16_map(&map_x, x, cols, k, kTcChunk))
    return (int)cudaErrorInvalidValue;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        bsr_spmm_tc_kernel<BS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        S::kSmem);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  dim3 grid(grid_x, grid_y);
  bsr_spmm_tc_kernel<BS><<<grid, S::kThreads, S::kSmem, (cudaStream_t)stream>>>(
      map_a, map_x, bcols, row_ptr, order, (__nv_bfloat16*)y, rows, k);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface, bound with ctypes.  All pointers are device
// pointers; ``row_ptr`` has grid_x + 1 entries (one per block row).
// Returns cudaGetLastError() after the launch (0 on success).
#define SPRS_BSR_SPMM_ENTRY(NAME, T)                                        \
  extern "C" int NAME(const void* blocks, const int* bcols,                 \
                      const int* row_ptr, const int* order, const void* x,  \
                      void* y, long long rows, long long cols, long long k, \
                      int bs, int grid_x, int grid_y, void* stream) {       \
    return launch<T>(blocks, bcols, row_ptr, order, x, y, rows, cols, k,    \
                     bs, grid_x, grid_y, stream);                           \
  }

SPRS_BSR_SPMM_ENTRY(sprs_bsr_spmm_f32, float)
SPRS_BSR_SPMM_ENTRY(sprs_bsr_spmm_bf16, __nv_bfloat16)
SPRS_BSR_SPMM_ENTRY(sprs_bsr_spmm_f64, double)

// The tensor-core variant: bf16 only, bs 64 or 128, ``cap`` the number of
// stored blocks (the blocks are read as a (cap * bs, bs) matrix).
extern "C" int sprs_bsr_spmm_tc_bf16(const void* blocks, const int* bcols,
                                     const int* row_ptr, const int* order,
                                     const void* x, void* y, long long rows,
                                     long long cols, long long k, int bs,
                                     long long cap, int grid_x, int grid_y,
                                     void* stream) {
  if (bs == 64)
    return launch_tc<64>(blocks, bcols, row_ptr, order, x, y, rows, cols, k,
                         cap, grid_x, grid_y, stream);
  if (bs == 128)
    return launch_tc<128>(blocks, bcols, row_ptr, order, x, y, rows, cols, k,
                          cap, grid_x, grid_y, stream);
  return (int)cudaErrorInvalidValue;
}
