// Banded (DIA) sparse matrix times dense matrix for Hopper (sm_90a).
//
//     Y[i, c] = sum_d data[d * rows_pad + i] * X[(i + off_d) * k + c],
//               0 <= i < rows, 0 <= c < k,
//
// with X's row j read as 0 outside [0, cols).  X (cols, k) and Y (rows, k)
// are row-major.  The sum runs over the diagonals in storage order, from
// 0, in Acc = promote(out, f32), and is rounded once to the output type
// out = promote(data, X), as the Pallas kernels do.  Four forms (data, X)
// -> Y: (f32, f32) -> f32 and (f64, f64) -> f64; (bf16, bf16) -> bf16
// and (bf16, f32) -> f32, both with Acc = f32.  Y has X's type in every
// form; a product of two bf16 values is exact in f32, so the (bf16, bf16)
// form equals its plain version bit for bit.
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
// 16-byte load or store; the "vector" variant) on a run of R = kRun = 4
// consecutive rows.  For every diagonal it loads the run's 4 coefficients
// data[d, i] once and reuses each across its V columns, and it issues the
// run's 4 independent 16-byte loads of X before their FMAs, so a thread
// keeps 64 bytes of X in flight per diagonal where one thread per entry
// kept 4 (f32).  bf16 X has V = 8 columns per vector, and its runs are of
// R = 2 rows: at 4 rows the 32 float accumulators spilled past the
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
#include <cuda_runtime.h>
#include <stdint.h>

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

// TD: the diagonals' type; T: X's and Y's
template <typename TD, typename T, typename Acc, int V>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    dia_spmm_kernel(const TD* __restrict__ data, const T* __restrict__ x,
                    T* __restrict__ y, long long rows, long long cols,
                    long long rows_pad, long long k, int runs_per_tile,
                    DiaOffsets offs) {
  using VT = Vec<T, V>;
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
  VT* yv = reinterpret_cast<VT*>(y);

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
          for (int e = 0; e < V; ++e) win[w].v[e] = Cvt<T>::out(Acc(0));
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
              for (int e = 0; e < V; ++e) xr[r].v[e] = Cvt<T>::out(Acc(0));
            }
          }
        }
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int e = 0; e < V; ++e)
            acc[r][e] += a[r] * (Acc)Cvt<T>::in(xr[r].v[e]);
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (i0 + r < rows) {
          VT out;
#pragma unroll
          for (int e = 0; e < V; ++e) out.v[e] = Cvt<T>::out(acc[r][e]);
          yv[(i0 + r) * kv + cv] = out;
        }
      }
    }
  }
}

template <typename TD, typename T, typename Acc>
int launch(const void* data, const void* x, void* y, long long rows,
           long long cols, long long rows_pad, long long k,
           const int* offsets, int n_diags, int vector, int runs_per_tile,
           int grid, void* stream) {
  if (n_diags < 1 || n_diags > kMaxDiags || k < 1 || runs_per_tile < 1)
    return (int)cudaErrorInvalidValue;
  DiaOffsets offs;
  offs.n = n_diags;
  for (int d = 0; d < n_diags; ++d) offs.off[d] = offsets[d];
  constexpr int V = 16 / sizeof(T);
  if (vector) {
    if (k % V != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
        reinterpret_cast<uintptr_t>(y) % 16 != 0)
      return (int)cudaErrorInvalidValue;
    dia_spmm_kernel<TD, T, Acc, V><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const TD*)data, (const T*)x, (T*)y, rows, cols, rows_pad, k,
        runs_per_tile, offs);
  } else {
    dia_spmm_kernel<TD, T, Acc, 1><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const TD*)data, (const T*)x, (T*)y, rows, cols, rows_pad, k,
        runs_per_tile, offs);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface, bound with ctypes: one entry per form (data, X),
// named by it (f32, f64, bf16 for (bf16, bf16), bf16_f32 for bf16 data
// and f32 X).  ``offsets`` is a host array of n_diags ints; ``vector``
// picks the 16-byte variant (1) or the scalar one (0); a CTA takes tiles
// of ``runs_per_tile`` runs of 4 rows.  Returns cudaGetLastError() after
// the launch (0 on success).
#define SPRS_DIA_SPMM_ENTRY(NAME, TD, T, ACC)                                   \
  extern "C" int NAME(const void* data, const void* x, void* y, long long rows, \
                      long long cols, long long rows_pad, long long k,          \
                      const int* offsets, int n_diags, int vector,              \
                      int runs_per_tile, int grid, void* stream) {              \
    return launch<TD, T, ACC>(data, x, y, rows, cols, rows_pad, k, offsets,     \
                              n_diags, vector, runs_per_tile, grid, stream);    \
  }

SPRS_DIA_SPMM_ENTRY(sprs_dia_spmm_f32, float, float, float)
SPRS_DIA_SPMM_ENTRY(sprs_dia_spmm_f64, double, double, double)
SPRS_DIA_SPMM_ENTRY(sprs_dia_spmm_bf16, __nv_bfloat16, __nv_bfloat16, float)
SPRS_DIA_SPMM_ENTRY(sprs_dia_spmm_bf16_f32, __nv_bfloat16, float, float)
