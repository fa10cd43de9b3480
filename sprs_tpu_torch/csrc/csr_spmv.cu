// Merge-based CSR sparse matrix-vector product for Hopper (sm_90a).
//
//     y[r] = sum_{k = indptr[r]}^{indptr[r+1]-1} data[k] * x[indices[k]],
//            0 <= r < rows.
//
// Slots at or past indptr[rows] are padding and are never read.
// Products and sums are taken in Acc = promote(out, f32), out =
// promote(data, x), and rounded once to out.  Sixteen forms (data, x),
// every pair of f16, bf16, f32 and f64: Acc is f64 where either is f64,
// else f32; (f16, f16) alone rounds each product to f16 before adding it
// (Mul), as K1, K2 and K5 do.  An index outside [0, cols) is clamped into
// range, so no operand can make a read leave x.
//
// Replaces no Pallas kernel: the JAX package's CSR product is XLA's
// segment_sum (sprs_tpu/ops/prod.py), and the port's plain version
// rebuilt every entry's row id, gathered x and summed by a sorting
// accumulate (formats/util.py::index_sum_), 94 ms a product on the
// kron23 graph against a 0.65 ms byte bound.
//
// Bound: bytes.  One call must move nnz * (4 + sizeof(data)) bytes of
// indices and values, the rows + 1 row pointers, x once and y once (the
// kron23 graph in f32: 2.07 GB of entries, 0.648 ms at 3.35 TB/s),
// against 2 * nnz flops.  As in K5, each gather of x is a random read
// that L2 serves as a 32-byte sector (8.3 GB of L2 traffic at kron23);
// there a 33.6 MB f32 x fits the 50 MB L2 and the entries do not.
// Design (Merrill and Garland, "Merge-based Parallel Sparse
// Matrix-Vector Multiplication", SC'16):
//
// - the merge path of the row ends indptr[1..rows] with the entry
//   positions 0..nnz-1 has rows + nnz items; each CTA takes a fixed
//   share of kTile = kThreads * kItems of them and each thread kItems,
//   whatever the rows' lengths: a hub row is split over many CTAs like
//   any other run of entries, and short rows leave no lane idle.  A CTA
//   finds its two ends by a 32-way search of indptr in one warp each
//   (about five dependent reads for 8M rows), so the grid needs no
//   preparation: it is sized from rows + cap, both known on the host,
//   and CTAs past rows + indptr[rows] return at once;
// - values and indices stream through with evict-first loads (__ldcs)
//   and x is gathered through the read-only path (__ldg), so the stream
//   does not push x out of L2.  A CTA loads its entries' products into
//   shared memory with all its threads (every gather in flight at once),
//   then each thread walks its kItems of the path there.  The products
//   and the tile's row ends share one buffer (kTile * sizeof(Acc) bytes:
//   11 KB in f32), which leaves L1 to the gathers of x: with the L1
//   carved down to a few KB the kron23 product took twice as long.  11
//   items a thread measured 1.2 % faster than 7; a larger L1 share, 128
//   or 512 threads, and a separate search kernel ahead of the tiles each
//   moved it by 1 % or less (the gathers' L2 sectors set the pace);
// - no float atomics, so one input gives the same bits on every run and
//   every card: rows that end inside a thread are written directly; a
//   row that crosses threads takes the partial sums of the threads
//   before it from a segmented scan over the CTA (a fixed tree); a row
//   that crosses CTAs is finished by a second kernel, which adds its
//   CTAs' partial sums in CTA order and writes y once.  The tile size
//   does not depend on the card's SM count.
// Index math for path positions is 64-bit: rows + nnz may pass 2^31.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 11;
constexpr int kTile = kThreads * kItems;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// A stored type to and from its accumulator; bf16 and f16 by the
// intrinsics, whose rounding (to nearest even) is that of torch's casts.
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

// An evict-first load of a streamed operand (read once per call).
template <typename T>
__device__ __forceinline__ T stream(const T* p) {
  if constexpr (std::is_same_v<T, __half>) {
    return __ushort_as_half(__ldcs(reinterpret_cast<const unsigned short*>(p)));
  } else if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    return __ushort_as_bfloat16(__ldcs(reinterpret_cast<const unsigned short*>(p)));
  } else {
    return __ldcs(p);
  }
}

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

// The merge-path split of diagonal d, searched by one warp: the number
// of row ends among the first d path items.  Row end p precedes entry j
// when indptr[p + 1] <= j, so the split is the first p in [lo, hi) with
// indptr[p + 1] > d - p - 1, or hi.  Each round tests 32 pivots spread
// over the range and keeps the part between the last true and the first
// false one; every lane returns the split.
__device__ __forceinline__ long long warp_split(const int* __restrict__ indptr, long long rows,
                                                long long nnz, long long d) {
  const int lane = threadIdx.x & 31;
  long long lo = d - nnz > 0 ? d - nnz : 0;
  long long hi = d < rows ? d : rows;
  while (lo < hi) {
    const long long p = lo + ((hi - lo) * lane) / 32;
    const bool before = (long long)__ldg(&indptr[p + 1]) <= d - p - 1;
    const int k = __popc(__ballot_sync(kFull, before));  // the pivots are sorted: a prefix
    const long long p_last = __shfl_sync(kFull, p, k > 0 ? k - 1 : 0);
    const long long p_next = __shfl_sync(kFull, p, k < 32 ? k : 31);
    if (k > 0) lo = p_last + 1;
    if (k < 32) hi = p_next;
  }
  return lo;
}

// The reduce-by-row operator of the segmented scan: b's row, and a's sum
// added in front of b's where both are partial sums of one row.  The
// threads' rows never decrease, so it is associative over them.
template <typename Acc>
__device__ __forceinline__ Acc join(int a_row, Acc a, int b_row, Acc b) {
  return a_row == b_row ? a + b : b;
}

template <typename TD, typename TX, typename TY, typename Acc>
__global__ void __launch_bounds__(kThreads)
csr_spmv_tiles(const int* __restrict__ indptr, const int* __restrict__ indices,
               const TD* __restrict__ data, const TX* __restrict__ x, TY* __restrict__ y,
               Acc* __restrict__ carry, Acc* __restrict__ head, int* __restrict__ carry_row,
               long long rows, long long cols, long long cap) {
  // the tile's products in entry order, then its row ends
  // indptr[x0 + 1 + i] as ints: the tile holds at most kTile of the two
  __shared__ Acc s_buf[kTile];
  __shared__ long long s_split[4];  // x0, x1, indptr[x0], indptr[x1]
  __shared__ int s_wrow[kWarps];
  __shared__ Acc s_wsum[kWarps];

  const long long stored = __ldg(&indptr[rows]);
  const long long nnz = stored < cap ? (stored > 0 ? stored : 0) : cap;
  const long long total = rows + nnz;
  const long long d0 = (long long)blockIdx.x * kTile;
  if (d0 >= total) return;
  const long long d1 = d0 + kTile < total ? d0 + kTile : total;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp < 2) {
    const long long s = warp_split(indptr, rows, nnz, warp == 0 ? d0 : d1);
    if (lane == 0) {
      s_split[warp] = s;
      s_split[2 + warp] = __ldg(&indptr[s]);
    }
  }
  __syncthreads();
  const long long x0 = s_split[0], x1 = s_split[1];
  const long long y0 = d0 - x0, y1 = d1 - x1;
  // the tile's row ends and entries; clamped so that a malformed indptr
  // cannot make an index leave shared memory
  const int n_nz = (int)max(0LL, min(y1 - y0, (long long)kTile));
  const int n_ends = (int)max(0LL, min(x1 - x0, (long long)(kTile - n_nz)));
  Acc* const s_prod = s_buf;
  int* const s_end = reinterpret_cast<int*>(s_buf + n_nz);
  const int len = (int)(d1 - d0);
  // row x0 began in an earlier CTA, which carries its partial sum
  const bool continued = y0 > s_split[2];

  for (int i = threadIdx.x; i < n_ends; i += kThreads) s_end[i] = __ldg(&indptr[x0 + 1 + i]);
  {
    int c[kItems];
    TD v[kItems];
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int j = threadIdx.x + i * kThreads;
      if (j < n_nz) {
        long long col = stream(&indices[y0 + j]);
        c[i] = (int)(col < 0 ? 0 : (col >= cols ? cols - 1 : col));
        v[i] = stream(&data[y0 + j]);
      }
    }
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int j = threadIdx.x + i * kThreads;
      if (j < n_nz)
        s_prod[j] = mul<TD, TX, Acc>((Acc)Cvt<TD>::in(v[i]), (Acc)Cvt<TX>::in(__ldg(&x[c[i]])));
    }
  }
  __syncthreads();

  // this thread's share of the path, [a, b) of the tile's items, and
  // where it starts: lx row ends and ly entries into the tile
  const int a = min((int)threadIdx.x * kItems, len), b = min(a + kItems, len);
  int lo = max(a - n_nz, 0), hi = min(a, n_ends);
  while (lo < hi) {
    const int p = (lo + hi) >> 1;
    if ((long long)s_end[p] <= y0 + a - p - 1) lo = p + 1; else hi = p;
  }
  int lx = lo, ly = a - lo;
  Acc run = 0, first = 0;
  int first_row = -1;
  for (int i = a; i < b; ++i) {
    if (ly < n_nz && (lx >= n_ends || y0 + ly < (long long)s_end[lx])) {
      run += s_prod[ly++];
    } else {
      if (first_row < 0) {
        first_row = lx;
        first = run;
      } else if (x0 + lx < rows) {
        y[x0 + lx] = Cvt<TY>::out(run);
      }
      run = 0;
      ++lx;
    }
  }

  // segmented scan of the threads' trailing partial sums (row lx, sum
  // run): in a warp by shuffles, then across the warps' totals
  Acc inc = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int r = __shfl_up_sync(kFull, lx, off);
    const Acc s = __shfl_up_sync(kFull, inc, off);
    if (lane >= off) inc = join(r, s, lx, inc);
  }
  const int ex_row = __shfl_up_sync(kFull, lx, 1);
  const Acc ex_warp = __shfl_up_sync(kFull, inc, 1);
  if (lane == 31) {
    s_wrow[warp] = lx;
    s_wsum[warp] = inc;
  }
  __syncthreads();
  int pre_row = -1;
  Acc pre = 0;
  for (int w = 0; w < warp; ++w) {
    pre = w > 0 ? join(pre_row, pre, s_wrow[w], s_wsum[w]) : s_wsum[w];
    pre_row = s_wrow[w];
  }
  // the sum of the partials of this thread's first row in the threads
  // before it (its row is the previous thread's last)
  int in_row = pre_row;
  Acc in = pre;
  if (lane > 0) {
    in = warp > 0 ? join(pre_row, pre, ex_row, ex_warp) : ex_warp;
    in_row = ex_row;
  }
  if (first_row >= 0) {
    const Acc v = (threadIdx.x > 0 && in_row == first_row) ? in + first : first;
    if (first_row == 0 && continued)
      head[blockIdx.x] = v;
    else if (x0 + first_row < rows)
      y[x0 + first_row] = Cvt<TY>::out(v);
  }
  if (threadIdx.x == kThreads - 1) {
    // the CTA's trailing partial: row x1, if the tile holds entries of it
    const Acc total_sum = warp > 0 ? join(pre_row, pre, lx, inc) : inc;
    carry[blockIdx.x] = total_sum;
    carry_row[blockIdx.x] = (x1 < rows && y1 > s_split[3]) ? (int)x1 : -1;
  }
}

// One warp per tile: the first tile of a run that carries one row adds
// the run's partial sums in CTA order (a fixed shuffle tree per 32),
// then the ending CTA's head sum, and writes the row once.
template <typename TY, typename Acc>
__global__ void __launch_bounds__(kThreads)
csr_spmv_carries(const int* __restrict__ indptr, const Acc* __restrict__ carry,
                 const Acc* __restrict__ head, const int* __restrict__ carry_row,
                 TY* __restrict__ y, long long rows, long long cap) {
  const long long stored = __ldg(&indptr[rows]);
  const long long nnz = stored < cap ? (stored > 0 ? stored : 0) : cap;
  const long long live = (rows + nnz + kTile - 1) / kTile;
  const long long t = ((long long)blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (t >= live) return;
  const int r = carry_row[t];
  if (r < 0 || (t > 0 && carry_row[t - 1] == r)) return;
  Acc sum = 0;
  long long base = t;
  for (;;) {
    const long long c = base + lane;
    const bool in = c < live && carry_row[c] == r;
    Acc v = in ? carry[c] : Acc(0);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
    sum += v;
    const unsigned m = __ballot_sync(kFull, in);
    if (m != kFull) {
      base += __popc(m);
      break;
    }
    base += 32;
  }
  if (lane == 0 && base < live) y[r] = Cvt<TY>::out(sum + head[base]);
}

template <typename TD, typename TX, typename TY, typename Acc>
int launch(const void* indptr, const void* indices, const void* data, const void* x, void* y,
           void* work, long long rows, long long cols, long long cap, long long tiles,
           void* stream) {
  if (rows < 1 || cols < 1 || cap < 0 || tiles < 1 || tiles > 0x7fffffffLL ||
      tiles * kTile < rows + cap)
    return (int)cudaErrorInvalidValue;
  auto* s = (cudaStream_t)stream;
  Acc* carry = (Acc*)work;
  Acc* head = carry + tiles;
  int* carry_row = (int*)(head + tiles);
  csr_spmv_tiles<TD, TX, TY, Acc><<<(unsigned)tiles, kThreads, 0, s>>>(
      (const int*)indptr, (const int*)indices, (const TD*)data, (const TX*)x, (TY*)y, carry, head,
      carry_row, rows, cols, cap);
  const long long blocks = (tiles * 32 + kThreads - 1) / kThreads;
  csr_spmv_carries<TY, Acc><<<(unsigned)blocks, kThreads, 0, s>>>(
      (const int*)indptr, carry, head, carry_row, (TY*)y, rows, cap);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface, bound with ctypes: one entry per form (data, x),
// named sprs_csr_spmv_<data>_<x>, or sprs_csr_spmv_<t> where both are t
// (ops/cuda/forms.py::FORMS).  `tiles` is ceil((rows + cap) / kTile)
// (ops/cuda/csr_spmv.py::tiles); `work` holds tiles * 20 bytes (two
// accumulators of up to 8 bytes and a row id per tile).  Launches the
// tile kernel and the carry kernel on `stream`; returns
// cudaGetLastError() after them (0 on success).

#define SPRS_CSR_SPMV_ENTRY(NAME, TD, TX, TY, ACC)                                             \
  extern "C" int NAME(const void* indptr, const void* indices, const void* data, const void* x, \
                      void* y, void* work, long long rows, long long cols, long long cap,       \
                      long long tiles, void* stream) {                                         \
    return launch<TD, TX, TY, ACC>(indptr, indices, data, x, y, work, rows, cols, cap, tiles,   \
                                   stream);                                                    \
  }

#define F16 __half
#define BF16 __nv_bfloat16
SPRS_CSR_SPMV_ENTRY(sprs_csr_spmv_f16, F16, F16, F16, float)
SPRS_CSR_SPMV_ENTRY(sprs_csr_spmv_f16_bf16, F16, BF16, float, float)
SPRS_CSR_SPMV_ENTRY(sprs_csr_spmv_f16_f32, F16, float, float, float)
SPRS_CSR_SPMV_ENTRY(sprs_csr_spmv_f16_f64, F16, double, double, double)
SPRS_CSR_SPMV_ENTRY(sprs_csr_spmv_bf16_f16, BF16, F16, float, float)
SPRS_CSR_SPMV_ENTRY(sprs_csr_spmv_bf16, BF16, BF16, BF16, float)
SPRS_CSR_SPMV_ENTRY(sprs_csr_spmv_bf16_f32, BF16, float, float, float)
SPRS_CSR_SPMV_ENTRY(sprs_csr_spmv_bf16_f64, BF16, double, double, double)
SPRS_CSR_SPMV_ENTRY(sprs_csr_spmv_f32_f16, float, F16, float, float)
SPRS_CSR_SPMV_ENTRY(sprs_csr_spmv_f32_bf16, float, BF16, float, float)
SPRS_CSR_SPMV_ENTRY(sprs_csr_spmv_f32, float, float, float, float)
SPRS_CSR_SPMV_ENTRY(sprs_csr_spmv_f32_f64, float, double, double, double)
SPRS_CSR_SPMV_ENTRY(sprs_csr_spmv_f64_f16, double, F16, double, double)
SPRS_CSR_SPMV_ENTRY(sprs_csr_spmv_f64_bf16, double, BF16, double, double)
SPRS_CSR_SPMV_ENTRY(sprs_csr_spmv_f64_f32, double, float, double, double)
SPRS_CSR_SPMV_ENTRY(sprs_csr_spmv_f64, double, double, double, double)
