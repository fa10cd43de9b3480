// Banded (DIA) sparse matrix-vector product for Hopper (sm_90a).
//
//     y[i] = sum_d data[d * rows_pad + i] * x[i + off_d],  0 <= i < rows,
//
// with x[j] read as 0 outside [0, cols).  The sum runs over the diagonals
// in storage order, from 0, in Acc = promote(T, f32): f32 for f32 input,
// f64 for f64 input.
//
// Replaces the TPU kernel family of sprs_tpu/ops/pallas/dia_spmv.py:
// _dia_spmv_flatg (the prepared path), _dia_spmv_pallas ("lag" and
// "carry"), _dia_spmv_flat and _dia_spmv_manual.  Those five schedules
// manage DMA transfers on a TPU whose grid runs in order: a carried left
// neighbour block, a one-step output lag, flat and grouped tiling, manual
// buffering depth.  A GPU grid has no order and carries nothing, so none
// of that survives; this kernel computes the same sum.
//
// Bound: bytes.  One call must move (k + 2) * n * sizeof(T) bytes: the
// k diagonals once, x once, y once (k = 5, n = 16.8M, f32: 470 MB, about
// 140 us at 3.35 TB/s), against 2 * k * n flops.  Design: one thread per
// row in a grid-stride loop, so a warp reads 32 consecutive entries of
// each diagonal and 32 consecutive entries of x for each offset -- every
// load is coalesced.  x is read k times by the kernel but k - 1 of those
// reads are of lines a neighbouring diagonal has just brought into L1/L2,
// so device memory sees it about once.  No shared-memory window, hence no
// limit on the bandwidth |off|.  Offsets arrive by value in a fixed
// struct (kernel parameter space), at most kMaxDiags of them.  Index math
// is 64-bit: d * rows_pad overflows int32 for large k * n.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxDiags = 64;

struct DiaOffsets {
  int k;
  int off[kMaxDiags];
};

template <typename T, typename Acc>
__global__ void dia_spmv_kernel(const T* __restrict__ data,
                                const T* __restrict__ x, T* __restrict__ y,
                                long long rows, long long cols,
                                long long rows_pad, DiaOffsets offs) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < rows; i += stride) {
    Acc acc = 0;
    for (int d = 0; d < offs.k; ++d) {
      const long long j = i + offs.off[d];
      if (j >= 0 && j < cols) {
        acc += (Acc)data[(long long)d * rows_pad + i] * (Acc)x[j];
      }
    }
    y[i] = (T)acc;
  }
}

template <typename T, typename Acc>
int launch(const void* data, const void* x, void* y, long long rows,
           long long cols, long long rows_pad, const int* offsets, int k,
           int grid, int block, void* stream) {
  if (k < 1 || k > kMaxDiags) return (int)cudaErrorInvalidValue;
  DiaOffsets offs;
  offs.k = k;
  for (int d = 0; d < k; ++d) offs.off[d] = offsets[d];
  dia_spmv_kernel<T, Acc><<<grid, block, 0, (cudaStream_t)stream>>>(
      (const T*)data, (const T*)x, (T*)y, rows, cols, rows_pad, offs);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface, bound with ctypes.  ``offsets`` is a host array of k
// ints.  Returns cudaGetLastError() after the launch (0 on success).
extern "C" int sprs_dia_spmv_f32(const void* data, const void* x, void* y,
                                 long long rows, long long cols,
                                 long long rows_pad, const int* offsets,
                                 int k, int grid, int block, void* stream) {
  return launch<float, float>(data, x, y, rows, cols, rows_pad, offsets, k,
                              grid, block, stream);
}

extern "C" int sprs_dia_spmv_f64(const void* data, const void* x, void* y,
                                 long long rows, long long cols,
                                 long long rows_pad, const int* offsets,
                                 int k, int grid, int block, void* stream) {
  return launch<double, double>(data, x, y, rows, cols, rows_pad, offsets,
                                k, grid, block, stream);
}
