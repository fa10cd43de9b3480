// Banded (DIA) sparse matrix-vector product for Hopper (sm_90a).
//
//     y[i] = sum_d data[d * rows_pad + i] * x[i + off_d],  0 <= i < rows,
//
// with x[j] read as 0 outside [0, cols).  The sum runs over the diagonals
// in storage order, from 0, in Acc = promote(out, f32), and is rounded
// once to the output type out = promote(data, x), as the Pallas kernels
// do.  Four forms (data, x) -> y: (f32, f32) -> f32 and (f64, f64) -> f64;
// (bf16, bf16) -> bf16 and (bf16, f32) -> f32, both with Acc = f32.  A
// product of two bf16 values is exact in f32, so the (bf16, bf16) form
// equals its plain version bit for bit.
//
// Replaces the TPU kernel family of sprs_tpu/ops/pallas/dia_spmv.py:
// _dia_spmv_flatg (the prepared path), _dia_spmv_pallas ("lag" and
// "carry"), _dia_spmv_flat and _dia_spmv_manual.  Those five schedules
// manage DMA transfers on a TPU whose grid runs in order: a carried left
// neighbour block, a one-step output lag, flat and grouped tiling, manual
// buffering depth.  A GPU grid has no order and carries nothing, so none
// of that survives; this kernel computes the same sum.
//
// Bound: bytes.  One call must move k * n * sizeof(data) + n * (sizeof(x)
// + sizeof(y)) bytes: the k diagonals once, x once, y once (k = 5,
// n = 16.8M, f32: 470 MB, about 140 us at 3.35 TB/s; bf16: half that),
// against 2 * k * n flops.  Design: one thread per
// row in a grid-stride loop, so a warp reads 32 consecutive entries of
// each diagonal and 32 consecutive entries of x for each offset -- every
// load is coalesced.  x is read k times by the kernel but k - 1 of those
// reads are of lines a neighbouring diagonal has just brought into L1/L2,
// so device memory sees it about once.  No shared-memory window, hence no
// limit on the bandwidth |off|.  Offsets arrive by value in a fixed
// struct (kernel parameter space), at most kMaxDiags of them.  Index math
// is 64-bit: d * rows_pad overflows int32 for large k * n.  A bf16 form
// loads 2 bytes per thread per diagonal; a __nv_bfloat162 pair per thread
// is the next step if that leaves it far from its bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxDiags = 64;

struct DiaOffsets {
  int k;
  int off[kMaxDiags];
};

// A stored type to and from its accumulator; bf16 by the intrinsics, whose
// rounding (to nearest even) is that of torch's and XLA's casts.
template <typename T>
struct Cvt {
  __device__ static T in(T v) { return v; }
  __device__ static T out(T v) { return v; }
};
template <>
struct Cvt<__nv_bfloat16> {
  __device__ static float in(__nv_bfloat16 v) { return __bfloat162float(v); }
  __device__ static __nv_bfloat16 out(float v) { return __float2bfloat16_rn(v); }
};

template <typename TD, typename TX, typename TY, typename Acc>
__global__ void dia_spmv_kernel(const TD* __restrict__ data,
                                const TX* __restrict__ x, TY* __restrict__ y,
                                long long rows, long long cols,
                                long long rows_pad, DiaOffsets offs) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < rows; i += stride) {
    Acc acc = 0;
    for (int d = 0; d < offs.k; ++d) {
      const long long j = i + offs.off[d];
      if (j >= 0 && j < cols) {
        acc += (Acc)Cvt<TD>::in(data[(long long)d * rows_pad + i]) *
               (Acc)Cvt<TX>::in(x[j]);
      }
    }
    y[i] = Cvt<TY>::out(acc);
  }
}

template <typename TD, typename TX, typename TY, typename Acc>
int launch(const void* data, const void* x, void* y, long long rows,
           long long cols, long long rows_pad, const int* offsets, int k,
           int grid, int block, void* stream) {
  if (k < 1 || k > kMaxDiags) return (int)cudaErrorInvalidValue;
  DiaOffsets offs;
  offs.k = k;
  for (int d = 0; d < k; ++d) offs.off[d] = offsets[d];
  dia_spmv_kernel<TD, TX, TY, Acc><<<grid, block, 0, (cudaStream_t)stream>>>(
      (const TD*)data, (const TX*)x, (TY*)y, rows, cols, rows_pad, offs);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface, bound with ctypes: one entry per form (data, x),
// named by it (f32, f64, bf16 for (bf16, bf16), bf16_f32 for bf16 data
// and f32 x).  ``offsets`` is a host array of k ints.  Returns
// cudaGetLastError() after the launch (0 on success).
#define SPRS_DIA_SPMV_ENTRY(NAME, TD, TX, TY, ACC)                              \
  extern "C" int NAME(const void* data, const void* x, void* y, long long rows, \
                      long long cols, long long rows_pad, const int* offsets,   \
                      int k, int grid, int block, void* stream) {               \
    return launch<TD, TX, TY, ACC>(data, x, y, rows, cols, rows_pad, offsets,   \
                                   k, grid, block, stream);                     \
  }

SPRS_DIA_SPMV_ENTRY(sprs_dia_spmv_f32, float, float, float, float)
SPRS_DIA_SPMV_ENTRY(sprs_dia_spmv_f64, double, double, double, double)
SPRS_DIA_SPMV_ENTRY(sprs_dia_spmv_bf16, __nv_bfloat16, __nv_bfloat16, __nv_bfloat16, float)
SPRS_DIA_SPMV_ENTRY(sprs_dia_spmv_bf16_f32, __nv_bfloat16, float, float, float)
