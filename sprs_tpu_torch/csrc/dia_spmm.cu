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
// about 0.65 ms at 3.35 TB/s) against 2 * n_diags * rows * k flops.  What
// keeps a kernel from that bound is the bytes it has in flight and the
// L2 traffic: X is needed once per diagonal.
//
// Design: each thread owns a vector of V columns (V = 16 / sizeof(T), one
// 16-byte load or store; the "vector" variant) on a run of kRun = 4
// consecutive rows.  For every diagonal it loads the run's 4 coefficients
// data[d, i] once and reuses each across its V columns, and it issues the
// run's 4 independent 16-byte loads of X before their FMAs, so a thread
// keeps 64 bytes of X in flight per diagonal where one thread per entry
// kept 4 (f32).  X rows of the diagonals with |off| <= 1 (the grid
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
// variant: the same kernel with V = 1.  Offsets arrive by value, at most
// kMaxDiags of them.  Index math is 64-bit.

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

template <typename T, typename Acc, int V>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    dia_spmm_kernel(const T* __restrict__ data, const T* __restrict__ x,
                    T* __restrict__ y, long long rows, long long cols,
                    long long rows_pad, long long k, int runs_per_tile,
                    DiaOffsets offs) {
  using VT = Vec<T, V>;
  const long long kv = k / V;  // vectors per row
  const int slots = kThreads / kv > 0 ? (int)(kThreads / kv) : 1;
  // thread -> (run within the tile, first column vector); a thread whose
  // run lies past the tile's runs has nothing to do
  const int q = (int)(threadIdx.x / (kv < kThreads ? kv : kThreads));
  const long long cv0 = threadIdx.x % (kv < kThreads ? kv : kThreads);
  const long long cv_step = kv < kThreads ? kv : kThreads;
  if (q >= runs_per_tile || q >= slots) return;
  const long long tile_rows = (long long)runs_per_tile * kRun;
  const long long n_tiles = (rows + tile_rows - 1) / tile_rows;
  const VT* xv = reinterpret_cast<const VT*>(x);
  VT* yv = reinterpret_cast<VT*>(y);

  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long i0 = tile * tile_rows + (long long)q * kRun;
    if (i0 >= rows) continue;
    for (long long cv = cv0; cv < kv; cv += cv_step) {
      // the run's window of X rows i0 - 1 .. i0 + kRun, zero outside X
      VT win[kRun + 2];
#pragma unroll
      for (int w = 0; w < kRun + 2; ++w) {
        const long long j = i0 - 1 + w;
        if (j >= 0 && j < cols) {
          win[w] = xv[j * kv + cv];
        } else {
#pragma unroll
          for (int e = 0; e < V; ++e) win[w].v[e] = T(0);
        }
      }
      Acc acc[kRun][V];
#pragma unroll
      for (int r = 0; r < kRun; ++r)
#pragma unroll
        for (int e = 0; e < V; ++e) acc[r][e] = Acc(0);

      for (int d = 0; d < offs.n; ++d) {
        const int off = offs.off[d];
        Acc a[kRun];
#pragma unroll
        for (int r = 0; r < kRun; ++r)
          a[r] = (i0 + r < rows) ? (Acc)data[(long long)d * rows_pad + i0 + r]
                                 : Acc(0);
        VT xr[kRun];
        if (off >= -1 && off <= 1) {
#pragma unroll
          for (int r = 0; r < kRun; ++r)
            xr[r] = off < 0 ? win[r] : (off == 0 ? win[r + 1] : win[r + 2]);
        } else {
#pragma unroll
          for (int r = 0; r < kRun; ++r) {
            const long long j = i0 + r + off;
            if (j >= 0 && j < cols) {
              xr[r] = xv[j * kv + cv];
            } else {
#pragma unroll
              for (int e = 0; e < V; ++e) xr[r].v[e] = T(0);
            }
          }
        }
#pragma unroll
        for (int r = 0; r < kRun; ++r)
#pragma unroll
          for (int e = 0; e < V; ++e) acc[r][e] += a[r] * (Acc)xr[r].v[e];
      }
#pragma unroll
      for (int r = 0; r < kRun; ++r) {
        if (i0 + r < rows) {
          VT out;
#pragma unroll
          for (int e = 0; e < V; ++e) out.v[e] = (T)acc[r][e];
          yv[(i0 + r) * kv + cv] = out;
        }
      }
    }
  }
}

template <typename T, typename Acc>
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
    dia_spmm_kernel<T, Acc, V><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const T*)data, (const T*)x, (T*)y, rows, cols, rows_pad, k,
        runs_per_tile, offs);
  } else {
    dia_spmm_kernel<T, Acc, 1><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const T*)data, (const T*)x, (T*)y, rows, cols, rows_pad, k,
        runs_per_tile, offs);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface, bound with ctypes.  ``offsets`` is a host array of
// n_diags ints; ``vector`` picks the 16-byte variant (1) or the scalar
// one (0); a CTA takes tiles of ``runs_per_tile`` runs of 4 rows.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int sprs_dia_spmm_f32(const void* data, const void* x, void* y,
                                 long long rows, long long cols,
                                 long long rows_pad, long long k,
                                 const int* offsets, int n_diags, int vector,
                                 int runs_per_tile, int grid, void* stream) {
  return launch<float, float>(data, x, y, rows, cols, rows_pad, k, offsets,
                              n_diags, vector, runs_per_tile, grid, stream);
}

extern "C" int sprs_dia_spmm_f64(const void* data, const void* x, void* y,
                                 long long rows, long long cols,
                                 long long rows_pad, long long k,
                                 const int* offsets, int n_diags, int vector,
                                 int runs_per_tile, int grid, void* stream) {
  return launch<double, double>(data, x, y, rows, cols, rows_pad, k,
                                offsets, n_diags, vector, runs_per_tile, grid,
                                stream);
}
