// Banded (DIA) sparse matrix times dense matrix for Hopper (sm_90a).
//
//     Y[i, c] = sum_d data[d * rows_pad + i] * X[(i + off_d) * k + c],
//               0 <= i < rows, 0 <= c < k,
//
// with X's row j read as 0 outside [0, cols).  X (cols, k) and Y (rows, k)
// are row-major.  The sum runs over the diagonals in storage order, from
// 0, in Acc = promote(T, f32): f32 for f32 input, f64 for f64 input.
//
// Replaces the TPU kernels of sprs_tpu/ops/pallas/dia_spmm.py:
// _dia_spmm_lagflat (the default "lagflat" schedule) and _dia_spmm_pallas
// ("carry").  Both exist to stream X through VMEM once on a grid that runs
// in order (a carried neighbour block, a one-step output lag, flat-tiled
// diagonals) and pad the RHS width to 128 lanes.  A GPU grid carries
// nothing between blocks, so none of that survives; this kernel computes
// the same sum at the RHS width it is given.
//
// Bound: bytes.  One call must move (n_diags * rows_pad + cols * k +
// rows * k) * sizeof(T) bytes (2M rows, 5 diagonals, 128 RHS, f32: 2.2 GB,
// about 0.65 ms at 3.35 TB/s) against 2 * n_diags * rows * k flops.
// Design: one thread per output entry (i, c), flattened with c fastest in
// a grid-stride loop, so a warp reads 32 consecutive entries of each
// shifted row block of X and writes 32 consecutive entries of Y: every
// access to X and Y is coalesced whatever k is; for k < 32 a warp spans
// several rows.  The k threads of one row read the same data[d, i]
// (a broadcast from L1).  X is read n_diags times by the kernel, but the
// grid-stride loop keeps the whole card on one narrow window of rows, so
// the rows a diagonal needs were just brought into L2 by its neighbours
// and device memory sees X about once.  (Giving each block a contiguous
// range of rows instead was measured 1.4x slower at 2M rows, 128 RHS,
// f32: the far diagonals' rows then leave L2 before they are reused.)
// The flat index is split into (i, c) once per thread and then stepped
// with a carry, which avoids a 64-bit division per entry.  Offsets arrive
// by value, at most kMaxDiags of them.  Index math is 64-bit.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxDiags = 64;

struct DiaOffsets {
  int n;
  int off[kMaxDiags];
};

template <typename T, typename Acc>
__global__ void dia_spmm_kernel(const T* __restrict__ data,
                                const T* __restrict__ x, T* __restrict__ y,
                                long long rows, long long cols,
                                long long rows_pad, long long k,
                                DiaOffsets offs) {
  const long long total = rows * k;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long stride_i = stride / k;
  const long long stride_c = stride % k;
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long i = t / k;
  long long c = t % k;
  for (; t < total; t += stride) {
    Acc acc = 0;
    for (int d = 0; d < offs.n; ++d) {
      const long long j = i + offs.off[d];
      if (j >= 0 && j < cols) {
        acc += (Acc)data[(long long)d * rows_pad + i] * (Acc)x[j * k + c];
      }
    }
    y[t] = (T)acc;
    i += stride_i;
    c += stride_c;
    if (c >= k) {
      c -= k;
      ++i;
    }
  }
}

template <typename T, typename Acc>
int launch(const void* data, const void* x, void* y, long long rows,
           long long cols, long long rows_pad, long long k,
           const int* offsets, int n_diags, int grid, int block,
           void* stream) {
  if (n_diags < 1 || n_diags > kMaxDiags || k < 1)
    return (int)cudaErrorInvalidValue;
  DiaOffsets offs;
  offs.n = n_diags;
  for (int d = 0; d < n_diags; ++d) offs.off[d] = offsets[d];
  dia_spmm_kernel<T, Acc><<<grid, block, 0, (cudaStream_t)stream>>>(
      (const T*)data, (const T*)x, (T*)y, rows, cols, rows_pad, k, offs);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface, bound with ctypes.  ``offsets`` is a host array of
// n_diags ints.  Returns cudaGetLastError() after the launch (0 on
// success).
extern "C" int sprs_dia_spmm_f32(const void* data, const void* x, void* y,
                                 long long rows, long long cols,
                                 long long rows_pad, long long k,
                                 const int* offsets, int n_diags, int grid,
                                 int block, void* stream) {
  return launch<float, float>(data, x, y, rows, cols, rows_pad, k, offsets,
                              n_diags, grid, block, stream);
}

extern "C" int sprs_dia_spmm_f64(const void* data, const void* x, void* y,
                                 long long rows, long long cols,
                                 long long rows_pad, long long k,
                                 const int* offsets, int n_diags, int grid,
                                 int block, void* stream) {
  return launch<double, double>(data, x, y, rows, cols, rows_pad, k,
                                offsets, n_diags, grid, block, stream);
}
