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
// accumulator across steps, so here one CTA owns one (block row, 64-column
// tile of X) output tile and walks the row's blocks through the row
// pointer; K4's grouped layout is one more input of the same kernel.
//
// Bound: bytes or operations, by shape.  One call must read the live
// blocks once, X once and write Y once, and do 2 * n_blocks * bs * bs * k
// operations (n = 4096, k = 512, bs = 128, density 0.125, bf16: 12.6 MB
// and 2.1 GFLOP, i.e. 3.8 us of HBM against 2.2 us of bf16 tensor cores).
// This first version runs on the CUDA cores in float32 and is far from
// that bound: 256 threads as 16 x 16, each holding up to 8 rows x 4
// columns of the tile in registers.  For each block it stages an 8-deep
// slice of the block (transposed, padded against bank conflicts) and of
// the X tile in shared memory, converting to float32 on the way, then
// does 32 FMAs per 12 shared-memory reads.  wgmma with TMA-fed tiles is
// the later step.  Index math into blocks, X and Y is 64-bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

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
