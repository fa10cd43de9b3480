// ELLPACK sparse matrix-vector product for Hopper (sm_90a).
//
//     y[r] = sum_j data[r * width + j] * x[indices[r * width + j]],
//            0 <= r < rows, j = 0 .. width-1,
//
// pad slots included (index 0, data 0: they add 0 * x[0], as the plain
// torch version does, so a non-finite x[0] gives the same result in both).
// Products and sums are taken in Acc = promote(out, f32), out =
// promote(data, x), and rounded once to out.  Sixteen forms (data, x),
// every pair of f16, bf16, f32 and f64: Acc is f64 where either is f64,
// else f32; (f16, f16) alone rounds each product to f16 before adding it
// (Mul), as the Pallas kernel's f16 products are rounded.  The Pallas
// kernel takes the ten pairs whose promotion is the data's type (its
// output has the data's type); the other six are what the JAX package's
// prepare_spmv ELL arm computes, in XLA.  An index outside [0, cols) is
// clamped into range, so no operand can make a read leave x.
//
// Replaces the TPU kernel sprs_tpu/ops/pallas/spmv.py::_ell_spmv_pallas
// (body _kernel).  That kernel keeps x resident in VMEM and streams
// (row_block, width) tiles of indices and data through an in-order grid;
// Mosaic could not lower its arbitrary gather, so on the TPU it never
// compiled.  On Hopper the gather is a plain load.
//
// Bound: bytes.  One call must move rows_pad * width * (4 + sizeof(data))
// bytes of indices and data, x once and y once (the 1024^2 mesh operator
// in f64, width 7: 104.9 MB, 31.3 us at 3.35 TB/s), against
// 2 * rows * width flops.  What the card meets first is L2: each slot's
// gather is a random read of x that L2 serves as a whole 32-byte sector,
// 4 to 8 times the bytes it uses (at the mesh step 235 MB of sectors
// beside the 105 MB streamed; at random8 537 MB), and whatever x's type:
// a bf16 x saves none of them.  Design:
//
// - a group of G lanes owns a row, G the smallest power of two >= width
//   (at most 32, chosen by the wrapper; a wider row loops over 32-slot
//   chunks).  Lane g takes slot g, so a warp's index and data loads are
//   contiguous runs of the row-major arrays (at width 7: 4 rows x 7
//   slots per instruction), each line is read by one instruction, every
//   lane issues its gather at once, and a shuffle tree of log2(G) steps
//   sums the row.  The tree sums in
//   another order than the plain version's row sum: the results agree to
//   rounding (1e-5 of max|y| for an f32 output, 1e-12 for f64, one step
//   of a 16-bit output: 2^-7 of max|y| for bf16, 2^-10 for f16);
// - a group takes one row per pass of its grid-stride loop and the grid
//   is one wave at full occupancy (32 registers, 8 blocks of 256 per SM):
//   2048 gathers in flight per SM keep L2 busy.  Cache policies that keep
//   x in L2 ahead of the streamed operands, and a thread per row with the
//   width as a template parameter, measured no faster
//   (benches/torch_kernel_variants.py).
// Index math is 64-bit: rows * width overflows int32 above 2^31 slots.
//
// A renumbered operand (order non-null: ops/renumber.py, EllMat.order) is
// a square operator whose gathers of x outgrew the L2, stored by
// Cuthill-McKee levels: stored row r is the caller's row order[r], its
// slots in their order.  A product is two passes: ell_gather_kernel
// copies x' = x[order], then K5 runs over the stored rows and x', its
// store writing y[order[r]].  Each row sums as before, so y is bit-equal
// to K5 on the operator as given.  The rows in flight now read x' from a
// window of about three levels, so a gather is an L2 hit where it was a
// random sector from device memory.  HPCG's 27-point stencil at 256^3 in
// f64 under a random numbering (mean gather distance 43.1 MB of x, 0.62
// MB renumbered), on an H100 80GB HBM3 at 700 W: K5 15.72 ms as given;
// renumbered, the gather 0.53 ms and K5 3.91 ms, 4.45 ms a product
// against the 1.710 ms bound of its 5.73 GB (38 %).  What bounds it now:
// the 5.4 GB of indices and data streamed (1.61 ms at 3.35 TB/s), the L2
// sectors of x' (one 32-byte sector a slot) and the scattered store (K5 with
// its store in stored order: 3.43 ms).  Rows given to blocks or groups in
// contiguous chunks, and x' loaded past L1 (__ldcg), were no faster with
// the scattered store (4.26-4.29 and 3.95 ms).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kGatherUnroll = 4;

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

template <typename TD, typename TX, typename TY, typename Acc, int G>
__global__ void __launch_bounds__(kThreads)
ell_spmv_kernel(const int* __restrict__ indices, const TD* __restrict__ data,
                const TX* __restrict__ x, TY* __restrict__ y,
                const int* __restrict__ order, long long rows, long long cols,
                int width) {
  const int lane = threadIdx.x & 31;
  const int g = lane & (G - 1);
  // the lanes of this group: every shuffle below stays inside it, and all
  // of them run the same passes (they share their rows)
  const unsigned mask =
      G == 32 ? 0xffffffffu : ((1u << G) - 1u) << (lane & ~(G - 1));
  const long long group = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / G;
  const long long n_groups = (long long)gridDim.x * blockDim.x / G;
  for (long long r = group; r < rows; r += n_groups) {
    const long long base = r * width;
    Acc acc = 0;
    // j - g: the chunk's first slot, the same for every lane of the group
    for (int j = g; j - g < width; j += G) {
      if (j < width) {
        long long c = __ldg(&indices[base + j]);
        c = c < 0 ? 0 : (c >= cols ? cols - 1 : c);
        acc += mul<TD, TX, Acc>((Acc)Cvt<TD>::in(__ldg(&data[base + j])),
                                (Acc)Cvt<TX>::in(__ldg(&x[c])));
      }
    }
#pragma unroll
    for (int off = G / 2; off > 0; off >>= 1)
      acc += __shfl_xor_sync(mask, acc, off);
    if (g == 0) {
      // a renumbered operand: stored row r is the caller's row order[r]
      long long out = r;
      if (order != nullptr) {
        out = __ldg(&order[r]);
        out = out < 0 ? 0 : (out >= rows ? rows - 1 : out);
      }
      y[out] = Cvt<TY>::out(acc);
    }
  }
}

// The gather pass of a renumbered operand: xs[i] = x[order[i]], a copy of
// W-byte words (x's type moved bit for bit).  Each thread keeps
// kGatherUnroll reads of x in flight; order's reads and xs's writes are
// coalesced, x's are the scattered ones.  An order entry outside [0, n)
// is clamped into range, as K5 clamps its indices.
template <typename W>
__global__ void __launch_bounds__(kThreads)
ell_gather_kernel(const int* __restrict__ order, const W* __restrict__ x,
                  W* __restrict__ xs, long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i0 = (long long)blockIdx.x * blockDim.x + threadIdx.x; i0 < n;
       i0 += kGatherUnroll * stride) {
    long long c[kGatherUnroll];
#pragma unroll
    for (int u = 0; u < kGatherUnroll; ++u) {
      const long long i = i0 + u * stride;
      long long v = i < n ? __ldg(&order[i]) : 0;
      c[u] = v < 0 ? 0 : (v >= n ? n - 1 : v);
    }
    W w[kGatherUnroll];
#pragma unroll
    for (int u = 0; u < kGatherUnroll; ++u)
      if (i0 + u * stride < n) w[u] = __ldg(&x[c[u]]);
#pragma unroll
    for (int u = 0; u < kGatherUnroll; ++u)
      if (i0 + u * stride < n) xs[i0 + u * stride] = w[u];
  }
}

template <typename TD, typename TX, typename TY, typename Acc>
int launch(const void* indices, const void* data, const void* x, void* y,
           const void* order, long long rows, long long cols, int width,
           int lanes, int grid, int block, void* stream) {
  if (width < 0 || cols < 1 || block != kThreads || (order != nullptr && rows != cols))
    return (int)cudaErrorInvalidValue;
  auto* s = (cudaStream_t)stream;
  const int* i = (const int*)indices;
  const TD* d = (const TD*)data;
  const TX* v = (const TX*)x;
  TY* out = (TY*)y;
  const int* o = (const int*)order;
#define ELL_CASE(G)                                                                       \
  case G:                                                                                 \
    ell_spmv_kernel<TD, TX, TY, Acc, G><<<grid, block, 0, s>>>(i, d, v, out, o, rows, cols, width); \
    break;
  switch (lanes) {
    ELL_CASE(1) ELL_CASE(2) ELL_CASE(4) ELL_CASE(8) ELL_CASE(16) ELL_CASE(32)
    default: return (int)cudaErrorInvalidValue;
  }
#undef ELL_CASE
  return (int)cudaGetLastError();
}

template <typename W>
int gather(const void* order, const void* x, void* xs, long long n, int grid, int block,
           void* stream) {
  if (n < 0 || block != kThreads) return (int)cudaErrorInvalidValue;
  ell_gather_kernel<W><<<grid, block, 0, (cudaStream_t)stream>>>(
      (const int*)order, (const W*)x, (W*)xs, n);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface, bound with ctypes: one entry per form (data, x),
// named sprs_ell_spmv_<data>_<x>, or sprs_ell_spmv_<t> where both are t
// (ops/cuda/forms.py::FORMS).  `lanes` is G, a power of two up to 32,
// which the wrapper chooses (ops/cuda/ell_spmv.py::group_lanes) and sizes
// the grid by; any such G computes the product.  `block` must be 256
// (kThreads).  `order` is null, or a renumbered square operand's int32
// order: row r's sum is then stored at y[order[r]].  Returns
// cudaGetLastError() after the launch (0 on success).
#define SPRS_ELL_SPMV_ENTRY(NAME, TD, TX, TY, ACC)                              \
  extern "C" int NAME(const void* indices, const void* data, const void* x,     \
                      void* y, const void* order, long long rows,               \
                      long long cols, int width, int lanes, int grid,           \
                      int block, void* stream) {                                \
    return launch<TD, TX, TY, ACC>(indices, data, x, y, order, rows, cols,      \
                                   width, lanes, grid, block, stream);          \
  }

// The gather pass, one entry per width of x's type in bytes:
// sprs_ell_gather_b2 (f16, bf16), _b4 (f32), _b8 (f64).  `block` must be
// 256; the wrapper sizes the grid (ops/cuda/ell_spmv.py::gather_config).
#define SPRS_ELL_GATHER_ENTRY(NAME, W)                                          \
  extern "C" int NAME(const void* order, const void* x, void* xs, long long n,  \
                      int grid, int block, void* stream) {                      \
    return gather<W>(order, x, xs, n, grid, block, stream);                     \
  }

SPRS_ELL_GATHER_ENTRY(sprs_ell_gather_b2, unsigned short)
SPRS_ELL_GATHER_ENTRY(sprs_ell_gather_b4, unsigned int)
SPRS_ELL_GATHER_ENTRY(sprs_ell_gather_b8, unsigned long long)

#define F16 __half
#define BF16 __nv_bfloat16
SPRS_ELL_SPMV_ENTRY(sprs_ell_spmv_f16, F16, F16, F16, float)
SPRS_ELL_SPMV_ENTRY(sprs_ell_spmv_f16_bf16, F16, BF16, float, float)
SPRS_ELL_SPMV_ENTRY(sprs_ell_spmv_f16_f32, F16, float, float, float)
SPRS_ELL_SPMV_ENTRY(sprs_ell_spmv_f16_f64, F16, double, double, double)
SPRS_ELL_SPMV_ENTRY(sprs_ell_spmv_bf16_f16, BF16, F16, float, float)
SPRS_ELL_SPMV_ENTRY(sprs_ell_spmv_bf16, BF16, BF16, BF16, float)
SPRS_ELL_SPMV_ENTRY(sprs_ell_spmv_bf16_f32, BF16, float, float, float)
SPRS_ELL_SPMV_ENTRY(sprs_ell_spmv_bf16_f64, BF16, double, double, double)
SPRS_ELL_SPMV_ENTRY(sprs_ell_spmv_f32_f16, float, F16, float, float)
SPRS_ELL_SPMV_ENTRY(sprs_ell_spmv_f32_bf16, float, BF16, float, float)
SPRS_ELL_SPMV_ENTRY(sprs_ell_spmv_f32, float, float, float, float)
SPRS_ELL_SPMV_ENTRY(sprs_ell_spmv_f32_f64, float, double, double, double)
SPRS_ELL_SPMV_ENTRY(sprs_ell_spmv_f64_f16, double, F16, double, double)
SPRS_ELL_SPMV_ENTRY(sprs_ell_spmv_f64_bf16, double, BF16, double, double)
SPRS_ELL_SPMV_ENTRY(sprs_ell_spmv_f64_f32, double, float, double, double)
SPRS_ELL_SPMV_ENTRY(sprs_ell_spmv_f64, double, double, double, double)
