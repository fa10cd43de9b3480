// Row-wise bitonic co-sort of (n, 128) keys and values for Hopper (sm_90a).
//
// Each row of keys (int32 or float32) is sorted ascending, and the 4-byte
// values ride the same permutation.  The network is the JAX package's,
// stage for stage: for k = 2, 4, .., 128 and j = k/2, .., 1, element i
// meets its partner i ^ j and keeps the min when bit j and bit k of i
// agree, else the max.  Float keys are ordered as jnp.minimum orders
// them, -0.0 below +0.0; an element takes its partner's value only when
// the two keys differ as numbers, so +0.0 against -0.0 moves the keys'
// bits and not the values (the JAX rule `swap = new_key != key`).  Running
// the same 28 stages with the same rule makes the result equal to the
// plain torch version bit for bit, keys and values, ties included.
//
// Replaces the TPU kernel sprs_tpu/ops/pallas/sort.py::_sort_rows_128
// (network _stage, kernel _make_kernel).  There the partners come from
// lane rolls of a (rows_blk, 128) VMEM tile.
//
// Bound: bytes.  One call must read keys and values once and write them
// once, 2 * n * 128 * 8 bytes (43,750 rows: 89.6 MB, 26.7 us at
// 3.35 TB/s).  What keeps a kernel from it is the instruction count of
// 28 stages on every element: they run on the integer pipe, 16 lanes per
// SM sub-partition, so every instruction counts twice.  Design:
//
// - 16 lanes own a row, kPerLane = 8 elements each in registers, two
//   rows per warp.  The 18 stages with j < 8 pair registers inside a
//   thread; only the 10 with j >= 8 exchange with lane l ^ (j / 8)
//   through __shfl_xor_sync (15 of 28 with 4 elements per lane);
// - inside a thread, one compare-exchange per pair, not one per element:
//   a min, a max, a compare and two value selects.  Each pair's direction
//   is known at compile time: where it is a bit of the lane's place in the
//   row, the lane complements its keys for that phase of the network
//   (one XOR per element) and sorts ascending; a direction chosen per pair
//   at run time cost nvcc four more instructions per pair;
// - keys are compared as signed ints: float bits are mapped once on load
//   to ints whose order is the float order, -0.0 (-1) just below +0.0
//   (0), and back on store (the plain version's map, so every bit
//   pattern, NaNs included, sorts where the plain version puts it); every
//   compare is an integer min or max, and the one float tie that moves
//   bits and not values costs two adds and an OR;
// - loads and stores are 16 bytes per lane with streaming hints: the
//   data is touched once.
// The pad lanes of a row past n_rows still run the network (their
// shuffles need them) but load and store nothing.

#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 128;
constexpr int kPerLane = 8;
constexpr int kRowLanes = kLanes / kPerLane;  // lanes per row
constexpr int kThreads = 256;
constexpr int kMinBlocks = 4;

constexpr int log2i(int v) { return v <= 1 ? 0 : 1 + log2i(v >> 1); }
constexpr int kLogPer = log2i(kPerLane);

// Float bits -> an int whose signed order is the float order, -0.0 (-1)
// just below +0.0 (0): ops/cuda/sort.py::_order_map, its own inverse.
// Ints pass unchanged.
template <bool F>
__device__ __forceinline__ int ordered(int b) {
  return F ? b ^ ((b >> 31) & 0x7fffffff) : b;
}

// Whether two ordered keys differ as numbers: -0.0 against +0.0 (-1 and
// 0) does not, so the value stays.  phase's complement maps {-1, 0} onto
// itself, so the test holds on complemented keys as well.
template <bool F>
__device__ __forceinline__ bool differ(int a, int b) {
  return F ? a != b && (((unsigned)a + 1u) | ((unsigned)b + 1u)) > 1u : a != b;
}

// A stage with j = 1 << TJ < kPerLane: pairs of registers inside the
// thread.  q is the lane's place in its row, so element i = q * kPerLane + r.
// The pair's direction is bit TK of i: a bit of r, known here, or a bit of
// q, which phase has folded into the keys, so the pair sorts ascending.
template <bool F, int TK, int TJ>
__device__ __forceinline__ void stage_in(int (&key)[kPerLane],
                                         unsigned (&val)[kPerLane]) {
  constexpr int J = 1 << TJ;
#pragma unroll
  for (int r = 0; r < kPerLane; ++r) {
    if (r & J) continue;
    const bool asc = TK >= kLogPer || ((r >> TK) & 1) == 0;
    const int a = key[r], b = key[r | J];
    const int lo = asc ? min(a, b) : max(a, b);
    const int hi = asc ? max(a, b) : min(a, b);
    const bool swap = differ<F>(lo, a);
    const unsigned va = val[r], vb = val[r | J];
    val[r] = swap ? vb : va;
    val[r | J] = swap ? va : vb;
    key[r] = lo;
    key[r | J] = hi;
  }
}

// A stage with j >= kPerLane: each lane holds one side of every pair and
// computes it after two shuffles with lane q ^ (j / kPerLane) of its row;
// the lower lane keeps the min (the keys of a descending block are
// complemented, see phase).
template <bool F, int TJ>
__device__ __forceinline__ void stage_cross(int (&key)[kPerLane],
                                            unsigned (&val)[kPerLane], int q) {
  constexpr int m = 1 << (TJ - kLogPer);
  const bool keep_min = (q & m) == 0;
#pragma unroll
  for (int r = 0; r < kPerLane; ++r) {
    const int pk = __shfl_xor_sync(0xffffffffu, key[r], m);
    const unsigned pv = __shfl_xor_sync(0xffffffffu, val[r], m);
    const int nk = keep_min ? min(key[r], pk) : max(key[r], pk);
    if (differ<F>(nk, key[r])) val[r] = pv;
    key[r] = nk;
  }
}

// The stages TJ, TJ - 1, .., 0 of phase TK, in the network's order.
template <bool F, int TK, int TJ>
__device__ __forceinline__ void stages(int (&key)[kPerLane],
                                       unsigned (&val)[kPerLane], int q) {
  if constexpr ((1 << TJ) < kPerLane)
    stage_in<F, TK, TJ>(key, val);
  else
    stage_cross<F, TJ>(key, val, q);
  if constexpr (TJ > 0) stages<F, TK, TJ - 1>(key, val, q);
}

// Phases TK onward (k = 2^TK merges blocks of k elements, ascending where
// bit TK of i is 0, else descending).  Where that bit is one of q's, the
// whole lane sorts one way: its keys are complemented for the phase (~ is
// order-reversing on ints), so every compare-exchange below is ascending
// and no pair chooses its direction at run time.
template <bool F, int TK>
__device__ __forceinline__ void phase(int (&key)[kPerLane],
                                      unsigned (&val)[kPerLane], int q) {
  if constexpr (TK <= 7) {
    const int f = TK >= kLogPer ? -((q >> (TK - kLogPer)) & 1) : 0;
#pragma unroll
    for (int r = 0; r < kPerLane; ++r) key[r] ^= f;
    stages<F, TK, TK - 1>(key, val, q);
#pragma unroll
    for (int r = 0; r < kPerLane; ++r) key[r] ^= f;
    phase<F, TK + 1>(key, val, q);
  }
}

template <bool F>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
sort_rows_kernel(const int* __restrict__ keys, const unsigned* __restrict__ vals,
                 int* __restrict__ keys_out, unsigned* __restrict__ vals_out,
                 long long n_rows) {
  constexpr int kRowsPerWarp = 32 / kRowLanes;
  constexpr int kVec = kPerLane / 4;  // 16-byte vectors per lane
  const int lane = threadIdx.x & 31;
  const int q = lane % kRowLanes;
  const long long warp = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const long long n_warps = ((long long)gridDim.x * blockDim.x) >> 5;
  // The loop bound is the same for every lane of a warp, so each shuffle
  // runs with all 32 lanes present.
  for (long long w = warp; w * kRowsPerWarp < n_rows; w += n_warps) {
    const long long row = w * kRowsPerWarp + lane / kRowLanes;
    const bool live = row < n_rows;
    const long long base = row * kLanes + q * kPerLane;
    int key[kPerLane];
    unsigned val[kPerLane];
#pragma unroll
    for (int v = 0; v < kVec; ++v) {
      int4 k4 = make_int4(0, 0, 0, 0);
      uint4 v4 = make_uint4(0, 0, 0, 0);
      if (live) {
        k4 = __ldcs(reinterpret_cast<const int4*>(keys + base) + v);
        v4 = __ldcs(reinterpret_cast<const uint4*>(vals + base) + v);
      }
      key[4 * v] = ordered<F>(k4.x);
      key[4 * v + 1] = ordered<F>(k4.y);
      key[4 * v + 2] = ordered<F>(k4.z);
      key[4 * v + 3] = ordered<F>(k4.w);
      val[4 * v] = v4.x;
      val[4 * v + 1] = v4.y;
      val[4 * v + 2] = v4.z;
      val[4 * v + 3] = v4.w;
    }
    phase<F, 1>(key, val, q);
    if (live) {
#pragma unroll
      for (int v = 0; v < kVec; ++v) {
        __stcs(reinterpret_cast<int4*>(keys_out + base) + v,
               make_int4(ordered<F>(key[4 * v]), ordered<F>(key[4 * v + 1]),
                         ordered<F>(key[4 * v + 2]), ordered<F>(key[4 * v + 3])));
        __stcs(reinterpret_cast<uint4*>(vals_out + base) + v,
               make_uint4(val[4 * v], val[4 * v + 1], val[4 * v + 2], val[4 * v + 3]));
      }
    }
  }
}

template <bool F>
int launch(const void* keys, const void* vals, void* keys_out,
           void* vals_out, long long n_rows, int grid, int block,
           void* stream) {
  if (block != kThreads) return (int)cudaErrorInvalidValue;
  sort_rows_kernel<F><<<grid, block, 0, (cudaStream_t)stream>>>(
      (const int*)keys, (const unsigned*)vals, (int*)keys_out,
      (unsigned*)vals_out, n_rows);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface, bound with ctypes.  All four arrays are contiguous
// (n_rows, 128) and 16-byte aligned; `block` must be 256 (kThreads).
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int sprs_sort_rows_i32(const void* keys, const void* vals,
                                  void* keys_out, void* vals_out,
                                  long long n_rows, int grid, int block,
                                  void* stream) {
  return launch<false>(keys, vals, keys_out, vals_out, n_rows, grid, block,
                       stream);
}

extern "C" int sprs_sort_rows_f32(const void* keys, const void* vals,
                                  void* keys_out, void* vals_out,
                                  long long n_rows, int grid, int block,
                                  void* stream) {
  return launch<true>(keys, vals, keys_out, vals_out, n_rows, grid, block,
                      stream);
}
