// Banded (DIA) sparse matrix times dense matrix for Hopper (sm_90a).
//
//     Y[i, c] = sum_d data[d * rows_pad + i] * X[(i + off_d) * k + c],
//               0 <= i < rows, 0 <= c < k,
//
// with X's row j read as 0 outside [0, cols).  X (cols, k) and Y (rows, k)
// are row-major.  The sum runs over the diagonals in storage order, from
// 0, in Acc = promote(out, f32), and is rounded once to the output type
// out = promote(data, X), as the Pallas kernels do.  Sixteen forms (data,
// X), every pair of f16, bf16, f32 and f64: Acc is f64 where either is
// f64, else f32; (f16, f16) alone rounds each product to f16 before
// adding it (mul), as the Pallas kernels' f16 products are rounded.  Y's
// type TY may be wider than X's TX (seven forms: (f64, f16), (f64, bf16),
// (f64, f32), (f32, f16), (f32, bf16), (f16, bf16), (bf16, f16)), never
// narrower.  A product of two bf16 values is exact in f32, and the f16
// product is rounded before it is added, so the (bf16, bf16) and (f16,
// f16) forms equal their plain versions bit for bit.
//
// Replaces the TPU kernels of sprs_tpu/ops/pallas/dia_spmm.py:
// _dia_spmm_lagflat (the default "lagflat" schedule) and _dia_spmm_pallas
// ("carry").  Both exist to stream X through VMEM once on a grid that runs
// in order (a carried neighbour block, a one-step output lag, flat-tiled
// diagonals) and pad the RHS width to 128 lanes.  A GPU grid carries
// nothing between blocks, so none of that survives; this kernel computes
// the same sum at the RHS width it is given.
//
// Bound: bytes.  One call must move n_diags * rows_pad * sizeof(data) +
// (cols * k + rows * k) * sizeof(X) bytes (2M rows, 5 diagonals, 128 RHS,
// f32: 2.2 GB, about 0.65 ms at 3.35 TB/s; bf16: half that) against
// 2 * n_diags * rows * k flops.  What
// keeps a kernel from that bound is the bytes it has in flight and the
// L2 traffic: X is needed once per diagonal.
//
// Design: each thread owns a vector of V columns (V = 16 / sizeof(X), one
// 16-byte load of X, stored as V * sizeof(Y) / 16 16-byte stores of Y;
// the "vector" variant) on a run of R = kRun = 4
// consecutive rows.  For every diagonal it loads the run's 4 coefficients
// data[d, i] once and reuses each across its V columns, and it issues the
// run's 4 independent 16-byte loads of X before their FMAs, so a thread
// keeps 64 bytes of X in flight per diagonal where one thread per entry
// kept 4 (f32).  16-bit X has V = 8 columns per vector, and its runs are
// of R = 2 rows (16 accumulators, 32 registers of f64 sums where Y is
// f64): at 4 rows the 32 float accumulators spilled past the
// 80-register cap (314 bytes of spill stores) and the kernel took 2.3 ms
// at 2048 x 1024, 128 RHS, against 0.77 ms at 2 rows, with no spills
// (benches/torch_kernel_variants.py, NVIDIA H100 80GB HBM3, 700 W).  X rows of the diagonals with |off| <= 1 (the grid
// Laplacians' -1, 0, +1) are the run's window rows i0 - 1 .. i0 + 4, loaded
// once into registers and shared by those diagonals, so they cross L2
// once, not three times.  A CTA takes a tile of consecutive runs across
// all k columns, and the tiles go to CTAs in grid-stride order, so the
// whole card works on a narrow window of rows and the far diagonals' X
// rows (+-1024 on the 2048 x 1024 grid) are still in L2 when the
// neighbouring tiles need them (giving each CTA one contiguous range of
// rows instead was measured 1.4x slower: that window is then lost).
// The order of the sum is kept: each output's accumulator starts at 0 and
// adds the diagonals from d = 0 up.  Widths whose rows are not whole
// 16-byte vectors, or an X or Y off 16-byte alignment, take the "scalar"
// variant: the same kernel with V = 1.  The coefficients data[d, i] are
// loaded one at a time in either variant, whatever their type.  Offsets
// arrive by value, at most kMaxDiags of them.  Index math is 64-bit.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kMaxDiags = 64;
constexpr int kThreads = 256;
constexpr int kRun = 4;        // consecutive rows per thread
constexpr int kMinBlocks = 3;  // resident CTAs per SM: at most 80 registers

struct DiaOffsets {
  int n;
  int off[kMaxDiags];
};

template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
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
// for (f16, f16) rounded to f16 and back (exact in f32 before the
// rounding, so the correctly rounded f16 product), else in Acc.
template <typename TD, typename TX, typename Acc>
__device__ __forceinline__ Acc mul(Acc a, Acc b) {
  if constexpr (std::is_same_v<TD, __half> && std::is_same_v<TX, __half>) {
    return __half2float(__float2half_rn(a * b));
  } else {
    return a * b;
  }
}

// TD: the diagonals' type; TX: X's; TY: Y's, promote(TD, TX), at least as
// wide as TX.  A thread's V outputs of a row are NS stores of YV values:
// one 16-byte store per YV in the vector variant, one value in the scalar.
template <typename TD, typename TX, typename TY, typename Acc, int V>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    dia_spmm_kernel(const TD* __restrict__ data, const TX* __restrict__ x,
                    TY* __restrict__ y, long long rows, long long cols,
                    long long rows_pad, long long k, int runs_per_tile,
                    DiaOffsets offs) {
  static_assert(sizeof(TY) >= sizeof(TX), "Y is at least as wide as X");
  using VT = Vec<TX, V>;
  constexpr int YV = V == 1 ? 1 : 16 / (int)sizeof(TY);
  constexpr int NS = V / YV;
  using VY = Vec<TY, YV>;
  constexpr int R = V > 4 ? kRun / 2 : kRun;  // rows per run: 2 for a vector of 8 columns
  const long long kv = k / V;  // vectors per row
  const int slots = kThreads / kv > 0 ? (int)(kThreads / kv) : 1;
  // thread -> (run within the tile, first column vector); a thread whose
  // run lies past the tile's runs has nothing to do
  const int q = (int)(threadIdx.x / (kv < kThreads ? kv : kThreads));
  const long long cv0 = threadIdx.x % (kv < kThreads ? kv : kThreads);
  const long long cv_step = kv < kThreads ? kv : kThreads;
  if (q >= runs_per_tile || q >= slots) return;
  const long long tile_rows = (long long)runs_per_tile * R;
  const long long n_tiles = (rows + tile_rows - 1) / tile_rows;
  const VT* xv = reinterpret_cast<const VT*>(x);
  VY* yv = reinterpret_cast<VY*>(y);

  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long i0 = tile * tile_rows + (long long)q * R;
    if (i0 >= rows) continue;
    for (long long cv = cv0; cv < kv; cv += cv_step) {
      // the run's window of X rows i0 - 1 .. i0 + R, zero outside X
      VT win[R + 2];
#pragma unroll
      for (int w = 0; w < R + 2; ++w) {
        const long long j = i0 - 1 + w;
        if (j >= 0 && j < cols) {
          win[w] = xv[j * kv + cv];
        } else {
#pragma unroll
          for (int e = 0; e < V; ++e) win[w].v[e] = Cvt<TX>::out(0.0f);
        }
      }
      Acc acc[R][V];
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int e = 0; e < V; ++e) acc[r][e] = Acc(0);

      for (int d = 0; d < offs.n; ++d) {
        const int off = offs.off[d];
        Acc a[R];
#pragma unroll
        for (int r = 0; r < R; ++r)
          a[r] = (i0 + r < rows)
                     ? (Acc)Cvt<TD>::in(data[(long long)d * rows_pad + i0 + r])
                     : Acc(0);
        VT xr[R];
        if (off >= -1 && off <= 1) {
#pragma unroll
          for (int r = 0; r < R; ++r)
            xr[r] = off < 0 ? win[r] : (off == 0 ? win[r + 1] : win[r + 2]);
        } else {
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const long long j = i0 + r + off;
            if (j >= 0 && j < cols) {
              xr[r] = xv[j * kv + cv];
            } else {
#pragma unroll
              for (int e = 0; e < V; ++e) xr[r].v[e] = Cvt<TX>::out(0.0f);
            }
          }
        }
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int e = 0; e < V; ++e)
            acc[r][e] += mul<TD, TX, Acc>(a[r], (Acc)Cvt<TX>::in(xr[r].v[e]));
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (i0 + r < rows) {
#pragma unroll
          for (int t = 0; t < NS; ++t) {
            VY out;
#pragma unroll
            for (int e = 0; e < YV; ++e) out.v[e] = Cvt<TY>::out(acc[r][t * YV + e]);
            yv[((i0 + r) * kv + cv) * NS + t] = out;
          }
        }
      }
    }
  }
}

template <typename TD, typename TX, typename TY, typename Acc>
int launch(const void* data, const void* x, void* y, long long rows,
           long long cols, long long rows_pad, long long k,
           const int* offsets, int n_diags, int vector, int runs_per_tile,
           int grid, void* stream) {
  if (n_diags < 1 || n_diags > kMaxDiags || k < 1 || runs_per_tile < 1)
    return (int)cudaErrorInvalidValue;
  DiaOffsets offs;
  offs.n = n_diags;
  for (int d = 0; d < n_diags; ++d) offs.off[d] = offsets[d];
  constexpr int V = 16 / sizeof(TX);
  if (vector) {
    if (k % V != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
        reinterpret_cast<uintptr_t>(y) % 16 != 0)
      return (int)cudaErrorInvalidValue;
    dia_spmm_kernel<TD, TX, TY, Acc, V><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const TD*)data, (const TX*)x, (TY*)y, rows, cols, rows_pad, k,
        runs_per_tile, offs);
  } else {
    dia_spmm_kernel<TD, TX, TY, Acc, 1><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const TD*)data, (const TX*)x, (TY*)y, rows, cols, rows_pad, k,
        runs_per_tile, offs);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface, bound with ctypes: one entry per form (data, X),
// named sprs_dia_spmm_<data>_<x>, or sprs_dia_spmm_<t> where both are t
// (ops/cuda/forms.py::FORMS).  ``offsets`` is a host array of n_diags
// ints; ``vector`` picks the 16-byte variant (1) or the scalar one (0); a
// CTA takes tiles of ``runs_per_tile`` runs.  Returns cudaGetLastError()
// after the launch (0 on success).
#define SPRS_DIA_SPMM_ENTRY(NAME, TD, TX, TY, ACC)                              \
  extern "C" int NAME(const void* data, const void* x, void* y, long long rows, \
                      long long cols, long long rows_pad, long long k,          \
                      const int* offsets, int n_diags, int vector,              \
                      int runs_per_tile, int grid, void* stream) {              \
    return launch<TD, TX, TY, ACC>(data, x, y, rows, cols, rows_pad, k,         \
                                   offsets, n_diags, vector, runs_per_tile,     \
                                   grid, stream);                               \
  }

#define F16 __half
#define BF16 __nv_bfloat16
SPRS_DIA_SPMM_ENTRY(sprs_dia_spmm_f16, F16, F16, F16, float)
SPRS_DIA_SPMM_ENTRY(sprs_dia_spmm_f16_bf16, F16, BF16, float, float)
SPRS_DIA_SPMM_ENTRY(sprs_dia_spmm_f16_f32, F16, float, float, float)
SPRS_DIA_SPMM_ENTRY(sprs_dia_spmm_f16_f64, F16, double, double, double)
SPRS_DIA_SPMM_ENTRY(sprs_dia_spmm_bf16_f16, BF16, F16, float, float)
SPRS_DIA_SPMM_ENTRY(sprs_dia_spmm_bf16, BF16, BF16, BF16, float)
SPRS_DIA_SPMM_ENTRY(sprs_dia_spmm_bf16_f32, BF16, float, float, float)
SPRS_DIA_SPMM_ENTRY(sprs_dia_spmm_bf16_f64, BF16, double, double, double)
SPRS_DIA_SPMM_ENTRY(sprs_dia_spmm_f32_f16, float, F16, float, float)
SPRS_DIA_SPMM_ENTRY(sprs_dia_spmm_f32_bf16, float, BF16, float, float)
SPRS_DIA_SPMM_ENTRY(sprs_dia_spmm_f32, float, float, float, float)
SPRS_DIA_SPMM_ENTRY(sprs_dia_spmm_f32_f64, float, double, double, double)
SPRS_DIA_SPMM_ENTRY(sprs_dia_spmm_f64_f16, double, F16, double, double)
SPRS_DIA_SPMM_ENTRY(sprs_dia_spmm_f64_bf16, double, BF16, double, double)
SPRS_DIA_SPMM_ENTRY(sprs_dia_spmm_f64_f32, double, float, double, double)
SPRS_DIA_SPMM_ENTRY(sprs_dia_spmm_f64, double, double, double, double)
