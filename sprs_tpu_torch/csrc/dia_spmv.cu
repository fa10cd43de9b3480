// Banded (DIA) sparse matrix-vector product for Hopper (sm_90a).
//
//     y[i] = sum_d data[d * rows_pad + i] * x[i + off_d],  0 <= i < rows,
//
// with x[j] read as 0 outside [0, cols).  The sum runs over the diagonals
// in storage order, from 0, in Acc = promote(out, f32), and is rounded
// once to the output type out = promote(data, x), as the Pallas kernels
// do.  Sixteen forms (data, x), every pair of f16, bf16, f32 and f64:
// Acc is f64 where either is f64, else f32.  (f16, f16) alone rounds each
// product to f16 before adding it (Mul), as the Pallas kernels' f16
// products are rounded; a product of two f16 values is exact in f32, so
// that is the correctly rounded f16 product.  A product of two bf16
// values is exact in f32, so the (bf16, bf16) and (f16, f16) forms equal
// their plain versions bit for bit.
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
// against 2 * k * n flops; bytes bound every form.  Design: one thread per
// row in a grid-stride loop, so a warp reads 32 consecutive entries of
// each diagonal and 32 consecutive entries of x for each offset -- every
// load is coalesced.  x is read k times by the kernel but k - 1 of those
// reads are of lines a neighbouring diagonal has just brought into L1/L2,
// so device memory sees it about once.  No shared-memory window, hence no
// limit on the bandwidth |off|.  Offsets arrive by value in a fixed
// struct (kernel parameter space), at most kMaxDiags of them.  Index math
// is 64-bit: d * rows_pad overflows int32 for large k * n.  A 16-bit form
// loads 2 bytes per thread per diagonal; a pair per thread (__half2,
// __nv_bfloat162) is the next step if that leaves it far from its bound.
// A slot whose x index lies outside [0, cols) is skipped, so an inf or
// NaN coefficient there leaves the row finite, where the plain version's
// zero-padded x gives NaN.
//
// A TMA design (persistent CTAs, the diagonals and x staged through a
// ring in shared memory, out-of-range x zero-filled by the copy) was
// built and measured against this kernel and lost to it at 4096^2 f32 and
// 1024^2 f64 (PERF.md); this kernel stays.
//
// The host side is a plan (make_plan), built once per operand and x type:
// the coefficients' address, the shape, the offsets and the grid.  A
// launch then passes only the plan, x, y and the stream, so what a call
// costs on the host is one ctypes call with five arguments.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <new>
#include <type_traits>

namespace {

constexpr int kMaxDiags = 64;
constexpr int kBlock = 256;

struct DiaOffsets {
  int k;
  int off[kMaxDiags];
};

// A stored type to and from its accumulator; bf16 and f16 by the
// intrinsics, whose rounding (to nearest even) is that of torch's and
// XLA's casts.
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
template <>
struct Cvt<__half> {
  __device__ static float in(__half v) { return __half2float(v); }
  __device__ static __half out(float v) { return __float2half_rn(v); }
};

// The product a * b of two values already in Acc, as the form takes it:
// for (f16, f16) rounded to f16 and back, else in Acc.
template <typename TD, typename TX, typename Acc>
__device__ __forceinline__ Acc mul(Acc a, Acc b) {
  if constexpr (std::is_same_v<TD, __half> && std::is_same_v<TX, __half>) {
    return __half2float(__float2half_rn(a * b));
  } else {
    return a * b;
  }
}

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
        acc += mul<TD, TX, Acc>((Acc)Cvt<TD>::in(data[(long long)d * rows_pad + i]),
                                (Acc)Cvt<TX>::in(x[j]));
      }
    }
    y[i] = Cvt<TY>::out(acc);
  }
}

struct Plan;
typedef int (*RunFn)(const Plan*, const void*, void*, void*);

struct Plan {
  const void* data;
  long long rows, cols, rows_pad;
  int grid;
  DiaOffsets offs;
  RunFn run;
};

template <typename TD, typename TX, typename TY, typename Acc>
int run_plan(const Plan* pl, const void* x, void* y, void* stream) {
  dia_spmv_kernel<TD, TX, TY, Acc><<<pl->grid, kBlock, 0, (cudaStream_t)stream>>>(
      (const TD*)pl->data, (const TX*)x, (TY*)y, pl->rows, pl->cols, pl->rows_pad, pl->offs);
  return (int)cudaGetLastError();
}

// The plan of the operand (data, offsets, rows x cols, rows_pad) launched
// on ``grid`` blocks (ops/cuda/dia_spmv.py::launch_config); nullptr on
// failure, the reason in *err.
template <typename TD, typename TX, typename TY, typename Acc>
Plan* make_plan(const void* data, long long rows, long long cols, long long rows_pad,
                const int* offsets, int k, int grid, int* err) {
  *err = (int)cudaErrorInvalidValue;
  if (k < 1 || k > kMaxDiags || rows < 1 || rows_pad < rows || grid < 1) return nullptr;
  Plan* pl = new (std::nothrow) Plan();
  if (pl == nullptr) {
    *err = (int)cudaErrorMemoryAllocation;
    return nullptr;
  }
  pl->data = data;
  pl->rows = rows;
  pl->cols = cols;
  pl->rows_pad = rows_pad;
  pl->grid = grid;
  pl->offs.k = k;
  for (int d = 0; d < k; ++d) pl->offs.off[d] = offsets[d];
  pl->run = &run_plan<TD, TX, TY, Acc>;
  *err = 0;
  return pl;
}

}  // namespace

// Plain C interface, bound with ctypes.
//
// sprs_dia_spmv_plan_<form>: one entry per form (data, x), named by its
// suffix (ops/cuda/forms.py::FORMS): the plan of an operand (``offsets``,
// a host array of k ints, is copied), nullptr on failure with the CUDA
// error in *err.
// sprs_dia_spmv_run: one launch through a plan on ``stream``; returns
// cudaGetLastError() after the launch (0 on success).
// sprs_dia_spmv_plan_free: releases a plan.
extern "C" int sprs_dia_spmv_run(const void* plan, const void* x, void* y, void* stream) {
  const Plan* pl = static_cast<const Plan*>(plan);
  return pl->run(pl, x, y, stream);
}

extern "C" void sprs_dia_spmv_plan_free(void* plan) { delete static_cast<Plan*>(plan); }

#define SPRS_DIA_SPMV_PLAN(SUFFIX, TD, TX, TY, ACC)                                            \
  extern "C" void* sprs_dia_spmv_plan_##SUFFIX(const void* data, long long rows,               \
                                               long long cols, long long rows_pad,             \
                                               const int* offsets, int k, int grid, int* err) { \
    return make_plan<TD, TX, TY, ACC>(data, rows, cols, rows_pad, offsets, k, grid, err);      \
  }

#define F16 __half
#define BF16 __nv_bfloat16
SPRS_DIA_SPMV_PLAN(f16, F16, F16, F16, float)
SPRS_DIA_SPMV_PLAN(f16_bf16, F16, BF16, float, float)
SPRS_DIA_SPMV_PLAN(f16_f32, F16, float, float, float)
SPRS_DIA_SPMV_PLAN(f16_f64, F16, double, double, double)
SPRS_DIA_SPMV_PLAN(bf16_f16, BF16, F16, float, float)
SPRS_DIA_SPMV_PLAN(bf16, BF16, BF16, BF16, float)
SPRS_DIA_SPMV_PLAN(bf16_f32, BF16, float, float, float)
SPRS_DIA_SPMV_PLAN(bf16_f64, BF16, double, double, double)
SPRS_DIA_SPMV_PLAN(f32_f16, float, F16, float, float)
SPRS_DIA_SPMV_PLAN(f32_bf16, float, BF16, float, float)
SPRS_DIA_SPMV_PLAN(f32, float, float, float, float)
SPRS_DIA_SPMV_PLAN(f32_f64, float, double, double, double)
SPRS_DIA_SPMV_PLAN(f64_f16, double, F16, double, double)
SPRS_DIA_SPMV_PLAN(f64_bf16, double, BF16, double, double)
SPRS_DIA_SPMV_PLAN(f64_f32, double, float, double, double)
SPRS_DIA_SPMV_PLAN(f64, double, double, double, double)
