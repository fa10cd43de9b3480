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
// adding it, as the Pallas kernels' f16 products are rounded.  Y's type TY
// may be wider than X's TX (seven forms: (f64, f16), (f64, bf16), (f64,
// f32), (f32, f16), (f32, bf16), (f16, bf16), (bf16, f16)), never
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
// cols * k * sizeof(X) + rows * k * sizeof(Y) bytes (2M rows, 5
// diagonals, 128 RHS, f32: 2.2 GB, about 0.65 ms at 3.35 TB/s) against
// 2 * n_diags * rows * k flops.  What keeps a kernel from that bound is
// the bytes it has in flight and the L2 traffic: X is needed once per
// diagonal.
//
// Design, the "tma" variant (rows of X whole 16-byte vectors, X and Y on
// 16-byte boundaries; ops/cuda/dia_spmm.py: ``variant``).  A tile is T
// consecutive rows by kc columns: kc is k, or an even share of k in
// chunks of at most 128 columns (TMA's box is at most 256 elements), T a
// multiple of 8 up to 128, and the tile at most kPairs * 512 16-byte
// vectors of X: 32 KB where the sums are f32, 16 KB where they are f64
// (T = 64 rows at kc = 128 f32 columns, 16 at 128 f64 ones).  One
// persistent CTA per SM walks the (tile, chunk) items in grid-stride
// order, so the card works on a narrow window of rows and the far
// diagonals' X rows (+-1024 on the 2048 x 1024 grid) are still in L2 when
// the neighbouring tiles need them.  For each tile the X rows it needs
// form slabs: diagonals consecutive in storage order whose offsets span
// at most kMaxSpan = 2 rows (their T-row windows overlap) share one slab
// of T + span rows (the grid Laplacians' -1, 0, +1: T + 2 rows); every
// other diagonal is a slab of its own.  The plan depends on the offsets
// alone, so the host makes it once per launch (plan_slabs, mirrored by
// ops/cuda/dia_spmm.py::slab_plan).  Only consecutive diagonals merge, so
// unsorted offsets keep their storage order of summation.  Each slab is
// one 2-D TMA load of X (one tensor map per slab height) whose rows
// outside [0, cols), negative ones included, the TMA unit fills with
// zeros: no bounds test is left in the consumer loop.  The slab's
// coefficients data[d, i0 : i0 + T] arrive the same way, one box of the
// (n_diags, rows_pad) array per diagonal.  Slabs pass through a ring of
// up to 16 stages in dynamic shared memory (as many as 227 KB hold: 6 to
// 16), each with a full and an empty mbarrier.  One producer thread
// issues the loads with expect_tx; 16 consumer warps wait on the full
// barrier, run the FMAs in Acc in storage order, and release the stage.
// A consumer thread owns kPairs (row, 16-byte vector) pairs of the tile,
// fixed for the whole launch, so its registers hold kPairs * V
// accumulators (at most 32 registers: 32 f32 sums, or 16 f64 ones, for
// 16-bit X) and their shared-memory offsets: nothing of X, and no
// instantiation spills.  A
// warp's 16-byte reads of a slab row are contiguous, so no bank is hit
// twice.  (f16, f16) takes its products two at a time with __hmul2_rn, the
// correctly rounded f16 product (the same value as rounding the exact f32
// product), then adds them in f32.  Y is written from registers with
// 16-byte stores.  The tensor maps are encoded on the host at each launch
// (cuTensorMapEncodeTiled through cudaGetDriverEntryPoint, tma.cuh).
//
// What set these numbers (benches/torch_kernel_variants.py --kernels k2,
// NVIDIA H100 80GB HBM3, 700 W, the 2048 x 1024 grid at 128 RHS): X's
// bytes in flight.  With no Y stores at all, two CTAs of 8 stages of
// 16-row tiles took 0.95 ms in f32, so the far slabs' loads set the time;
// one CTA per SM with a ring as deep as shared memory allows took 0.78 ms.
// 16 consumer warps keep the 16-bit forms fed ((f16, f16) 0.44 ms, 0.66
// with 8).  32 KB tiles beat 16 KB ones where the sums are f32 (f32
// 0.78 against 0.92 ms) and lose where they are f64 ((f64, f64)
// 2.36-2.42 against 1.58: 6 stages).  Against PR 4's design (a thread's registers
// holding a window of X, the vector variant this one replaced) it is no
// slower in any of the sixteen forms and faster in fourteen: (f64, f16)
// 1.28 against 2.91 ms, where the old one spilled.
//
// The "scalar" variant takes widths whose rows are not whole 16-byte
// vectors and an X or Y off 16-byte alignment: each thread owns one
// column on a run of kRun = 4 consecutive rows, loads the run's X window
// rows i0 - 1 .. i0 + 4 once for the diagonals with |off| <= 1, and loads
// the other rows directly; a CTA takes a tile of runs across all k
// columns, tiles in grid-stride order.  Offsets arrive by value, at most
// kMaxDiags of them.  Index math is 64-bit there; the tma variant's TMA
// coordinates are 32-bit, so it takes rows, cols and offsets below 2^30.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "tma.cuh"

namespace {

constexpr int kMaxDiags = 64;

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

// ---------------------------------------------------------------------------
// Scalar variant
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;
constexpr int kRun = 4;        // consecutive rows per thread
constexpr int kMinBlocks = 3;  // resident CTAs per SM: at most 80 registers

struct DiaOffsets {
  int n;
  int off[kMaxDiags];
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

// TD: the diagonals' type; TX: X's; TY: Y's, promote(TD, TX).  A thread
// owns one column of a run of kRun consecutive rows.
template <typename TD, typename TX, typename TY, typename Acc>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    dia_spmm_scalar_kernel(const TD* __restrict__ data, const TX* __restrict__ x,
                           TY* __restrict__ y, long long rows, long long cols,
                           long long rows_pad, long long k, int runs_per_tile,
                           DiaOffsets offs) {
  constexpr int R = kRun;
  const int slots = kThreads / k > 0 ? (int)(kThreads / k) : 1;
  // thread -> (run within the tile, first column); a thread whose run lies
  // past the tile's runs has nothing to do
  const long long c_step = k < kThreads ? k : kThreads;
  const int q = (int)(threadIdx.x / c_step);
  const long long c0 = threadIdx.x % c_step;
  if (q >= runs_per_tile || q >= slots) return;
  const long long tile_rows = (long long)runs_per_tile * R;
  const long long n_tiles = (rows + tile_rows - 1) / tile_rows;

  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long i0 = tile * tile_rows + (long long)q * R;
    if (i0 >= rows) continue;
    for (long long c = c0; c < k; c += c_step) {
      // the run's window of X rows i0 - 1 .. i0 + R, zero outside X
      TX win[R + 2];
#pragma unroll
      for (int w = 0; w < R + 2; ++w) {
        const long long j = i0 - 1 + w;
        if (j >= 0 && j < cols) {
          win[w] = x[j * k + c];
        } else {
          win[w] = Cvt<TX>::out(0.0f);
        }
      }
      Acc acc[R];
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = Acc(0);

      for (int d = 0; d < offs.n; ++d) {
        const int off = offs.off[d];
        // the run's coefficients, then its X values, then the FMAs
        Acc a[R];
#pragma unroll
        for (int r = 0; r < R; ++r)
          a[r] = (i0 + r < rows) ? (Acc)Cvt<TD>::in(data[(long long)d * rows_pad + i0 + r])
                                 : Acc(0);
        TX xr[R];
        if (off >= -1 && off <= 1) {
#pragma unroll
          for (int r = 0; r < R; ++r)
            xr[r] = off < 0 ? win[r] : (off == 0 ? win[r + 1] : win[r + 2]);
        } else {
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const long long j = i0 + r + off;
            if (j >= 0 && j < cols) {
              xr[r] = x[j * k + c];
            } else {
              xr[r] = Cvt<TX>::out(0.0f);
            }
          }
        }
#pragma unroll
        for (int r = 0; r < R; ++r)
          acc[r] += mul<TD, TX, Acc>(a[r], (Acc)Cvt<TX>::in(xr[r]));
      }
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (i0 + r < rows) y[(i0 + r) * k + c] = Cvt<TY>::out(acc[r]);
    }
  }
}

// ---------------------------------------------------------------------------
// TMA variant
// ---------------------------------------------------------------------------

constexpr int kTmaConsumerWarps = 16;
constexpr int kTmaConsumers = kTmaConsumerWarps * 32;
constexpr int kTmaThreads = kTmaConsumers + 32;  // + the producer warp
constexpr int kTmaCtasPerSm = 1;
constexpr int kMaxTileCols = 128;   // kc
constexpr int kMaxTileRows = 128;   // T
constexpr int kMaxSpan = 2;         // rows between a slab's lowest and highest offset
constexpr int kSlabDiags = kMaxSpan + 1;
constexpr int kMaxStages = 16;
constexpr int kSmemAlign = 128;     // TMA destinations
// 228 KB of shared memory per SM, 1 KB of it reserved per CTA
constexpr int kSmemPerCta = 233472 / kTmaCtasPerSm - 1024;
constexpr long long kCoordLimit = 1ll << 30;  // TMA coordinates are 32-bit

// (row, vector) pairs of a tile per consumer thread: 4 where the sums are
// f32, 2 where they are f64 (twice the registers a sum), so that a tile is
// 32 or 16 KB of X (T * kc / V = kPairs * kTmaConsumers vectors)
template <typename Acc>
constexpr int kPairs = sizeof(Acc) == 8 ? 2 : 4;

struct SlabPlan {
  int n_slabs;
  int tile_rows;    // T
  int tile_cols;    // kc
  int n_chunks;     // ceil(k / kc)
  int stages;       // S
  int stage_bytes;  // X slab of up to T + kMaxSpan rows, then kSlabDiags coefficient strips
  int coef_offset;  // bytes from a stage's start to its first strip
  int coef_stride;  // bytes between strips
  int off[kMaxDiags];
  int lo[kMaxDiags];      // slab: its lowest offset (first X row - first tile row)
  int packed[kMaxDiags];  // slab: first diagonal | count << 8 | span << 16
};

// Mirrors ops/cuda/dia_spmm.py::slab_plan: consecutive diagonals join a
// slab while its offsets span at most kMaxSpan rows and it holds at most
// kSlabDiags diagonals.  Returns the number of slabs.
int plan_slabs(const int* offsets, int n, SlabPlan* plan) {
  int n_slabs = 0;
  for (int d = 0; d < n;) {
    int lo = offsets[d], hi = offsets[d], nd = 1;
    while (d + nd < n && nd < kSlabDiags) {
      const int o = offsets[d + nd];
      const int nlo = o < lo ? o : lo, nhi = o > hi ? o : hi;
      if (nhi - nlo > kMaxSpan) break;
      lo = nlo;
      hi = nhi;
      ++nd;
    }
    plan->lo[n_slabs] = lo;
    plan->packed[n_slabs] = d | nd << 8 | (hi - lo) << 16;
    ++n_slabs;
    d += nd;
  }
  return n_slabs;
}

// A vector of V values of T: one 16-byte load or store.
template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

// acc[e] += a * x[e] in the form's arithmetic: (f16, f16) rounds each
// product to f16 (two per __hmul2_rn) before its f32 sum; every other form
// multiplies in Acc (exact in f32 for two 16-bit values).
template <typename TD, typename TX, typename Acc, int V>
__device__ __forceinline__ void fma_vec(Acc (&acc)[V], TD a, const Vec<TX, V>& x) {
  if constexpr (std::is_same_v<TD, __half> && std::is_same_v<TX, __half>) {
    const __half2 a2 = __half2half2(a);
    const __half2* x2 = reinterpret_cast<const __half2*>(x.v);
#pragma unroll
    for (int q = 0; q < V / 2; ++q) {
      const float2 p = __half22float2(__hmul2_rn(a2, x2[q]));
      acc[2 * q] += p.x;
      acc[2 * q + 1] += p.y;
    }
  } else {
    const Acc ac = (Acc)Cvt<TD>::in(a);
#pragma unroll
    for (int e = 0; e < V; ++e) acc[e] += ac * (Acc)Cvt<TX>::in(x.v[e]);
  }
}

template <typename TD, typename TX, typename TY, typename Acc>
__global__ void __launch_bounds__(kTmaThreads, kTmaCtasPerSm)
    dia_spmm_tma_kernel(const __grid_constant__ CUtensorMap map_x0,
                        const __grid_constant__ CUtensorMap map_x1,
                        const __grid_constant__ CUtensorMap map_x2,
                        const __grid_constant__ CUtensorMap map_d,
                        TY* __restrict__ y, long long rows, long long k,
                        const __grid_constant__ SlabPlan plan) {
  static_assert(sizeof(TY) >= sizeof(TX), "Y is at least as wide as X");
  constexpr int V = 16 / sizeof(TX);  // columns per 16-byte vector of X
  constexpr int P = kPairs<Acc>;
  constexpr int YV = 16 / sizeof(TY);
  constexpr int NS = V / YV;  // 16-byte stores per vector of Y
  using VT = Vec<TX, V>;
  using VY = Vec<TY, YV>;

  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + kSmemAlign - 1) & ~uintptr_t(kSmemAlign - 1));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + plan.stages * plan.stage_bytes);
  uint64_t* empty = full + kMaxStages;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int T = plan.tile_rows;
  const int kc = plan.tile_cols;
  const long long n_items = (rows + T - 1) / T * plan.n_chunks;

  if (threadIdx.x == 0) {
    for (int s = 0; s < plan.stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kTmaConsumerWarps);  // one arrive per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kTmaConsumerWarps) {
    // producer: one thread walks the items' slabs through the ring
    if (lane == 0) {
      int s = 0;
      uint32_t phase = 0;
      for (long long item = blockIdx.x; item < n_items; item += gridDim.x) {
        const int i0 = (int)(item / plan.n_chunks) * T;
        const int c0 = (int)(item % plan.n_chunks) * kc;
        for (int sl = 0; sl < plan.n_slabs; ++sl) {
          const int d0 = plan.packed[sl] & 0xFF;
          const int nd = (plan.packed[sl] >> 8) & 0xFF;
          const int span = plan.packed[sl] >> 16;
          mbar_wait(&empty[s], phase ^ 1);
          unsigned char* stage = smem + s * plan.stage_bytes;
          mbar_expect_tx(&full[s], (T + span) * kc * (int)sizeof(TX) + nd * T * (int)sizeof(TD));
          const CUtensorMap* mx = span == 0 ? &map_x0 : (span == 1 ? &map_x1 : &map_x2);
          tma_load_2d(stage, mx, &full[s], c0, i0 + plan.lo[sl]);
          for (int dd = 0; dd < nd; ++dd)
            tma_load_2d(stage + plan.coef_offset + dd * plan.coef_stride, &map_d, &full[s], i0,
                        d0 + dd);
          if (++s == plan.stages) {
            s = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  // consumers: pair j of thread t is (row r, vector cv) of the tile, with
  // p = t + j * kTmaConsumers = r * kv + cv; pairs past the tile's rows are
  // idle (valid pairs are a prefix)
  const int kv = kc / V;
  int pr[P], pc[P];
  uint32_t poff[P];
  int n_valid = 0;
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const int p = threadIdx.x + j * kTmaConsumers;
    const bool valid = p / kv < T;
    pr[j] = valid ? p / kv : 0;
    pc[j] = valid ? (p % kv) * V : 0;
    poff[j] = (uint32_t)(pr[j] * kc + pc[j]) * sizeof(TX);
    n_valid += valid;
  }
  const uint32_t row_bytes = (uint32_t)kc * sizeof(TX);
  int s = 0;
  uint32_t phase = 0;
  for (long long item = blockIdx.x; item < n_items; item += gridDim.x) {
    const long long i0 = item / plan.n_chunks * T;
    const long long c0 = item % plan.n_chunks * kc;
    Acc acc[P][V];
#pragma unroll
    for (int j = 0; j < P; ++j)
#pragma unroll
      for (int e = 0; e < V; ++e) acc[j][e] = Acc(0);
    for (int sl = 0; sl < plan.n_slabs; ++sl) {
      const int d0 = plan.packed[sl] & 0xFF;
      const int nd = (plan.packed[sl] >> 8) & 0xFF;
      mbar_wait(&full[s], phase);
      const unsigned char* stage = smem + s * plan.stage_bytes;
      for (int dd = 0; dd < nd; ++dd) {
        const unsigned char* xs = stage + (plan.off[d0 + dd] - plan.lo[sl]) * row_bytes;
        const TD* coef = reinterpret_cast<const TD*>(stage + plan.coef_offset + dd * plan.coef_stride);
#pragma unroll
        for (int j = 0; j < P; ++j)
          if (j < n_valid)
            fma_vec<TD, TX, Acc, V>(acc[j], coef[pr[j]],
                                    *reinterpret_cast<const VT*>(xs + poff[j]));
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
      if (++s == plan.stages) {
        s = 0;
        phase ^= 1;
      }
    }
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const long long row = i0 + pr[j], col = c0 + pc[j];
      if (j < n_valid && row < rows && col < k) {
        VY* dst = reinterpret_cast<VY*>(y + row * k + col);
#pragma unroll
        for (int t = 0; t < NS; ++t) {
          VY out;
#pragma unroll
          for (int e = 0; e < YV; ++e) out.v[e] = Cvt<TY>::out(acc[j][t * YV + e]);
          dst[t] = out;
        }
      }
    }
  }
}

template <typename T>
constexpr CUtensorMapDataType map_type() {
  if constexpr (std::is_same_v<T, __half>) return CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  if constexpr (std::is_same_v<T, __nv_bfloat16>) return CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  if constexpr (std::is_same_v<T, float>) return CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  return CU_TENSOR_MAP_DATA_TYPE_FLOAT64;
}

// A 2-D tensor map over a row-major (outer, inner) matrix of T, boxes of
// box_outer x box_inner, no swizzle, zeros outside the matrix.
template <typename T>
bool tile_map(CUtensorMap* map, const void* base, long long inner, long long outer,
              int box_inner, int box_outer) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  const cuuint64_t strides[1] = {(cuuint64_t)inner * sizeof(T)};
  const cuuint32_t box[2] = {(cuuint32_t)box_inner, (cuuint32_t)box_outer};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, map_type<T>(), 2, const_cast<void*>(base), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The tma variant: a tile of tile_rows x tile_cols (ops/cuda/dia_spmm.py::
// tile_shape), ``grid`` persistent CTAs.
template <typename TD, typename TX, typename TY, typename Acc>
int launch_tma(const void* data, const void* x, void* y, long long rows, long long cols,
               long long rows_pad, long long k, const int* offsets, int n_diags,
               int tile_rows, int tile_cols, int grid, void* stream) {
  constexpr int V = 16 / sizeof(TX);
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  if (k % V != 0 || tile_cols % V != 0 || tile_cols < V || tile_cols > kMaxTileCols ||
      tile_rows % 8 != 0 || tile_rows < 8 || tile_rows > kMaxTileRows ||
      tile_rows * (tile_cols / V) > kPairs<Acc> * kTmaConsumers || !aligned(data) || !aligned(x) || !aligned(y) ||
      (rows_pad * (long long)sizeof(TD)) % 16 != 0 || cols < 1 || rows_pad < rows ||
      rows >= kCoordLimit || cols >= kCoordLimit || rows_pad >= kCoordLimit || grid < 1)
    return (int)cudaErrorInvalidValue;
  SlabPlan plan;
  for (int d = 0; d < n_diags; ++d) {
    if (offsets[d] <= -kCoordLimit || offsets[d] >= kCoordLimit) return (int)cudaErrorInvalidValue;
    plan.off[d] = offsets[d];
  }
  plan.n_slabs = plan_slabs(offsets, n_diags, &plan);
  plan.tile_rows = tile_rows;
  plan.tile_cols = tile_cols;
  plan.n_chunks = (int)((k + tile_cols - 1) / tile_cols);
  const auto round = [](int v) { return (v + kSmemAlign - 1) / kSmemAlign * kSmemAlign; };
  plan.coef_offset = round((tile_rows + kMaxSpan) * tile_cols * (int)sizeof(TX));
  plan.coef_stride = round(tile_rows * (int)sizeof(TD));
  plan.stage_bytes = plan.coef_offset + kSlabDiags * plan.coef_stride;
  constexpr int kBarrierBytes = 2 * kMaxStages * 8;
  plan.stages = (kSmemPerCta - kSmemAlign - kBarrierBytes) / plan.stage_bytes;
  if (plan.stages > kMaxStages) plan.stages = kMaxStages;
  if (plan.stages < 2) return (int)cudaErrorInvalidValue;
  const int smem = kSmemAlign + plan.stages * plan.stage_bytes + kBarrierBytes;

  // one map of X per slab height the plan uses (the others stay unused)
  CUtensorMap map_x[kMaxSpan + 1] = {}, map_d;
  bool encoded[kMaxSpan + 1] = {};
  for (int sl = 0; sl < plan.n_slabs; ++sl) {
    const int span = plan.packed[sl] >> 16;
    if (!encoded[span] && !tile_map<TX>(&map_x[span], x, k, cols, tile_cols, tile_rows + span))
      return (int)cudaErrorInvalidValue;
    encoded[span] = true;
  }
  if (!tile_map<TD>(&map_d, data, rows_pad, n_diags, tile_rows, 1))
    return (int)cudaErrorInvalidValue;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(dia_spmm_tma_kernel<TD, TX, TY, Acc>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 kSmemPerCta);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  dia_spmm_tma_kernel<TD, TX, TY, Acc><<<grid, kTmaThreads, smem, (cudaStream_t)stream>>>(
      map_x[0], map_x[1], map_x[2], map_d, (TY*)y, rows, k, plan);
  return (int)cudaGetLastError();
}

template <typename TD, typename TX, typename TY, typename Acc>
int launch(const void* data, const void* x, void* y, long long rows,
           long long cols, long long rows_pad, long long k,
           const int* offsets, int n_diags, int tma, int tile_rows,
           int tile_cols, int grid, void* stream) {
  if (n_diags < 1 || n_diags > kMaxDiags || k < 1 || tile_rows < 1)
    return (int)cudaErrorInvalidValue;
  if (tma)
    return launch_tma<TD, TX, TY, Acc>(data, x, y, rows, cols, rows_pad, k, offsets, n_diags,
                                       tile_rows, tile_cols, grid, stream);
  DiaOffsets offs;
  offs.n = n_diags;
  for (int d = 0; d < n_diags; ++d) offs.off[d] = offsets[d];
  dia_spmm_scalar_kernel<TD, TX, TY, Acc><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const TD*)data, (const TX*)x, (TY*)y, rows, cols, rows_pad, k, tile_rows, offs);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface, bound with ctypes: one entry per form (data, X),
// named sprs_dia_spmm_<data>_<x>, or sprs_dia_spmm_<t> where both are t
// (ops/cuda/forms.py::FORMS).  ``offsets`` is a host array of n_diags
// ints; ``tma`` picks the tma variant (1; a tile of tile_rows x
// tile_cols) or the scalar one (0; a tile of tile_rows runs, tile_cols
// unused); ``grid`` CTAs.  Returns cudaGetLastError() after the launch (0
// on success).
#define SPRS_DIA_SPMM_ENTRY(NAME, TD, TX, TY, ACC)                              \
  extern "C" int NAME(const void* data, const void* x, void* y, long long rows, \
                      long long cols, long long rows_pad, long long k,          \
                      const int* offsets, int n_diags, int tma,                 \
                      int tile_rows, int tile_cols, int grid, void* stream) {   \
    return launch<TD, TX, TY, ACC>(data, x, y, rows, cols, rows_pad, k,         \
                                   offsets, n_diags, tma, tile_rows,            \
                                   tile_cols, grid, stream);                    \
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
