// Row-wise bitonic co-sort of (n, 128) keys and values for Hopper (sm_90a).
//
// Each row of keys (int32 or float32) is sorted ascending, and the 4-byte
// values ride the same permutation.  The network is the JAX package's,
// stage for stage: for k = 2, 4, .., 128 and j = k/2, .., 1, element i
// meets its partner i ^ j, keeps the min when bit j and bit k of i agree
// (else the max), and takes the partner's value only when its key changed
// (swap = new_key != key).  That tie rule keeps each key with its own
// value, and running the same 28 stages makes the result equal to the
// plain torch transcription bit for bit, values under ties included.
//
// Replaces the TPU kernel sprs_tpu/ops/pallas/sort.py::_sort_rows_128
// (network _stage, kernel _make_kernel).  There the partners come from
// lane rolls of a (rows_blk, 128) VMEM tile.  Here a warp owns one row:
// lane l holds elements 4l .. 4l+3 in registers, the stages with j < 4
// exchange registers inside the thread, and those with j >= 4 exchange
// with lane l ^ (j / 4) through __shfl_xor_sync.  Nothing goes through
// shared memory.
//
// Bound: bytes.  One call must read keys and values once and write them
// once, 2 * n * 128 * 8 bytes (43,750 rows: 89.6 MB, 26.7 us at
// 3.35 TB/s), against 28 compare-exchange stages of a few integer
// operations per element, which stay under the memory time.  Each lane
// moves 16 bytes of keys and 16 of values per load and store, so a warp's
// accesses are whole 512-byte rows.

#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 128;

template <typename K>
__device__ __forceinline__ void stage(K (&key)[4], unsigned (&val)[4],
                                      int lane, int j, int tj, int tk) {
  K pk[4];
  unsigned pv[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    if (j >= 4) {
      pk[r] = __shfl_xor_sync(0xffffffffu, key[r], j >> 2);
      pv[r] = __shfl_xor_sync(0xffffffffu, val[r], j >> 2);
    } else {
      pk[r] = key[r ^ j];
      pv[r] = val[r ^ j];
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = lane * 4 + r;
    const bool keep_min = (((i >> tj) ^ (i >> tk)) & 1) == 0;
    const K lo = pk[r] < key[r] ? pk[r] : key[r];
    const K hi = pk[r] > key[r] ? pk[r] : key[r];
    const K nk = keep_min ? lo : hi;
    if (nk != key[r]) val[r] = pv[r];
    key[r] = nk;
  }
}

template <typename K>
__global__ void sort_rows_kernel(const K* __restrict__ keys,
                                 const unsigned* __restrict__ vals,
                                 K* __restrict__ keys_out,
                                 unsigned* __restrict__ vals_out,
                                 long long n_rows) {
  const int lane = threadIdx.x & 31;
  const long long warp =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const long long n_warps = ((long long)gridDim.x * blockDim.x) >> 5;
  // The loop bound is the same for every lane of a warp, so each shuffle
  // runs with all 32 lanes present.
  for (long long row = warp; row < n_rows; row += n_warps) {
    const long long base = row * kLanes + lane * 4;
    K key[4];
    unsigned val[4];
    *reinterpret_cast<int4*>(key) = *reinterpret_cast<const int4*>(keys + base);
    *reinterpret_cast<uint4*>(val) =
        *reinterpret_cast<const uint4*>(vals + base);
#pragma unroll
    for (int tk = 1; tk <= 7; ++tk) {
#pragma unroll
      for (int tj = tk - 1; tj >= 0; --tj) {
        stage<K>(key, val, lane, 1 << tj, tj, tk);
      }
    }
    *reinterpret_cast<int4*>(keys_out + base) = *reinterpret_cast<int4*>(key);
    *reinterpret_cast<uint4*>(vals_out + base) = *reinterpret_cast<uint4*>(val);
  }
}

template <typename K>
int launch(const void* keys, const void* vals, void* keys_out,
           void* vals_out, long long n_rows, int grid, int block,
           void* stream) {
  if (block % 32 != 0) return (int)cudaErrorInvalidValue;
  sort_rows_kernel<K><<<grid, block, 0, (cudaStream_t)stream>>>(
      (const K*)keys, (const unsigned*)vals, (K*)keys_out,
      (unsigned*)vals_out, n_rows);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface, bound with ctypes.  All four arrays are contiguous
// (n_rows, 128) and 16-byte aligned.  Returns cudaGetLastError() after
// the launch (0 on success).
extern "C" int sprs_sort_rows_i32(const void* keys, const void* vals,
                                  void* keys_out, void* vals_out,
                                  long long n_rows, int grid, int block,
                                  void* stream) {
  return launch<int>(keys, vals, keys_out, vals_out, n_rows, grid, block,
                     stream);
}

extern "C" int sprs_sort_rows_f32(const void* keys, const void* vals,
                                  void* keys_out, void* vals_out,
                                  long long n_rows, int grid, int block,
                                  void* stream) {
  return launch<float>(keys, vals, keys_out, vals_out, n_rows, grid, block,
                       stream);
}
