// ELLPACK sparse matrix-vector product for Hopper (sm_90a).
//
//     y[r] = sum_j data[r * width + j] * x[indices[r * width + j]],
//            0 <= r < rows, j = 0 .. width-1 in order,
//
// pad slots included (index 0, data 0: they add 0 * x[0], as the plain
// torch version does, so a non-finite x[0] gives the same result in both).
// The sum is taken in T: f32 for f32, f64 for f64.  An index outside
// [0, cols) is clamped into range, so no operand can make a read leave x.
//
// Replaces the TPU kernel sprs_tpu/ops/pallas/spmv.py::_ell_spmv_pallas
// (body _kernel).  That kernel keeps x resident in VMEM and streams
// (row_block, width) tiles of indices and data through an in-order grid;
// Mosaic could not lower its arbitrary gather, so on the TPU it never
// compiled.  On Hopper the gather is a plain load.
//
// Bound: bytes.  One call must move rows_pad * width * (4 + sizeof(T))
// bytes of indices and data, x once and y once (the 1024^2 mesh operator
// in f64, width 7: 104.9 MB, 31.3 us at 3.35 TB/s), against
// 2 * rows * width flops.  Design: one thread per row in a grid-stride
// loop.  A warp's 32 rows are 32 * width contiguous slots of indices and
// of data, so the lines a warp touches on its first slot are the lines it
// reads on the next ones: through L1 each byte crosses device memory
// about once.  x (8 MB for one million f64 unknowns) sits in the 50 MB L2
// and is read through the read-only path (__ldg); for a mesh whose
// labels are permuted, each gather is a random 8-byte read that L2
// serves.  Index math is 64-bit: rows * width overflows int32 above 2^31
// slots.

#include <cuda_runtime.h>

namespace {

template <typename T>
__global__ void ell_spmv_kernel(const int* __restrict__ indices,
                                const T* __restrict__ data,
                                const T* __restrict__ x, T* __restrict__ y,
                                long long rows, long long cols, int width) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       r < rows; r += stride) {
    const long long base = r * width;
    T acc = 0;
    for (int j = 0; j < width; ++j) {
      long long c = __ldg(&indices[base + j]);
      c = c < 0 ? 0 : (c >= cols ? cols - 1 : c);
      acc += __ldg(&data[base + j]) * __ldg(&x[c]);
    }
    y[r] = acc;
  }
}

template <typename T>
int launch(const void* indices, const void* data, const void* x, void* y,
           long long rows, long long cols, int width, int grid, int block,
           void* stream) {
  if (width < 0 || cols < 1) return (int)cudaErrorInvalidValue;
  ell_spmv_kernel<T><<<grid, block, 0, (cudaStream_t)stream>>>(
      (const int*)indices, (const T*)data, (const T*)x, (T*)y, rows, cols,
      width);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface, bound with ctypes.  Returns cudaGetLastError() after
// the launch (0 on success).
extern "C" int sprs_ell_spmv_f32(const void* indices, const void* data,
                                 const void* x, void* y, long long rows,
                                 long long cols, int width, int grid,
                                 int block, void* stream) {
  return launch<float>(indices, data, x, y, rows, cols, width, grid, block,
                       stream);
}

extern "C" int sprs_ell_spmv_f64(const void* indices, const void* data,
                                 const void* x, void* y, long long rows,
                                 long long cols, int width, int grid,
                                 int block, void* stream) {
  return launch<double>(indices, data, x, y, rows, cols, width, grid, block,
                        stream);
}
