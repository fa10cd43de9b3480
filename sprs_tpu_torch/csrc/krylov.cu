// Kernel K8: BiCGSTAB's vector updates, reductions and scalar logic for
// Hopper (sm_90a), in six passes an iteration around the caller's three
// products (linalg/bicgstab.py::_fused; ops/cuda/krylov.py names the
// passes and holds each one's plain torch twin):
//
//   1. rv:   r̂·v; then safe = |r̂·v| > eps, α = safe ? ρ / r̂·v : 0
//   2. s:    s = r − α v
//   3. tt:   t·t and t·s; then ω = t·t > eps ? t·s / t·t : 0
//   4. xr:   x += α p̂ + ω ŝ; r = s − ω t, with r̂·r, r·r and r̂·r̂; then
//            the soft restart, ρ_next, β and whether ‖r‖ passed
//   5. true: ‖b − A·x‖²; then done, lied and ρ
//   6. p:    p = r + β (p − ω v); where the soft restart fired r̂ = p = r,
//            where the recursive residual lied r = r̂ = p = b − A·x
//
// The arithmetic is the masked loop's (linalg/bicgstab.py::_plain), op
// for op and in its type (float32 or float64): every product, sum and
// quotient of an update is rounded on its own (the _rn intrinsics, which
// nvcc never contracts into an FMA), as torch's unfused elementwise ops
// round them.  Sums of products are taken in float64 and rounded once to
// the type; the scalars and the flags follow from them as in the loop
// and live on the device, in `sc` (slots below), so the host reads
// nothing but `done`, once an iteration.
//
// Replaces no Pallas kernel: the JAX solver is a lax.while_loop that XLA
// fuses by itself.  On the card the loop ran its updates op by op, about
// 80 device ops and 63 vector passes an iteration (2.87 ms at a 4096²
// float64 grid, where a vector is 134 MB, 2.7 times the 50 MB L2).
//
// Bound: bytes.  The six passes move 20 vectors an iteration
// (2 + 3 + 2 + 7 + 2 + 4, with ŝ = s and p̂ = p read once where there is
// no preconditioner): 2.68 GB or 0.80 ms at 3.35 TB/s at 4096² in
// float64; the flops are a few per element.  Design:
//
// - each pass is one grid-stride stream over the vectors, kUnroll
//   elements a thread in flight (all loads of a round issued before its
//   stores), on a grid fixed by n alone (at most kMaxGrid blocks), so a
//   thread always sums the same elements in the same order;
// - a reduction is two-stage and deterministic, with no float atomics:
//   each block sums its threads by a fixed tree (warp shuffles, then one
//   warp over the warps) into its slot of `part`; an integer counter
//   picks the last block to finish, which adds the blocks' partials in
//   block order by the same tree, computes the scalars, writes them to
//   `sc` and sets the counter back to 0 for the next pass.  One input
//   gives the same bits on every run;
// - vectors may alias one another (a preconditioner that returns its
//   input, an operator that is the identity): no pointer is __restrict__
//   and no vector is read through the read-only path; each element is
//   read and written by one thread only.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;
constexpr int kMaxGrid = 1024;  // ops/cuda/krylov.py: MAX_GRID
constexpr unsigned kFull = 0xffffffffu;

// The slots of `sc` (ops/cuda/krylov.py: SLOTS), in the vectors' type;
// a flag is 1 or 0.
enum Slot { RHO, ALPHA, OMEGA, BETA, THRESH, EPS, TINY, SAFE, SOFT, REC, RHO_NEXT, LIED, DONE };

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float quo(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double quo(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float root(float a) { return __fsqrt_rn(a); }
__device__ __forceinline__ double root(double a) { return __dsqrt_rn(a); }

// torch.maximum: NaN where either is NaN
template <typename T>
__device__ __forceinline__ T maximum(T a, T b) {
  return a != a ? a : (b != b ? b : (a > b ? a : b));
}

template <typename T>
__device__ __forceinline__ T where(bool c, T a, T b) {
  return c ? a : b;
}

// One thread's place in the grid-stride loop: round j covers the
// elements first + j * step * kUnroll + u * step, u < kUnroll.
struct Stride {
  long long first, step;
  __device__ Stride()
      : first((long long)blockIdx.x * kThreads + threadIdx.x), step((long long)gridDim.x * kThreads) {}
};

// Sums each of acc[0..K) over the block by a fixed tree; thread 0 holds
// the totals.  `shm` holds K * kWarps values.
template <int K>
__device__ __forceinline__ void block_sum(double (&acc)[K], double* shm) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    for (int o = 16; o > 0; o >>= 1) acc[k] += __shfl_down_sync(kFull, acc[k], o);
    if (lane == 0) shm[k * kWarps + warp] = acc[k];
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      double v = lane < kWarps ? shm[k * kWarps + lane] : 0.0;
      for (int o = kWarps / 2; o > 0; o >>= 1) v += __shfl_down_sync(kFull, v, o);
      acc[k] = v;
    }
  }
}

// The second stage of a reduction: every block leaves its totals in
// part[k * kMaxGrid + block]; the last block to finish adds them in block
// order and gets true back on thread 0, with the grid's totals in acc.
// Every other thread of every block gets false.
template <int K>
__device__ bool grid_sum(double (&acc)[K], double* part, unsigned* count) {
  __shared__ double shm[K * kWarps];
  __shared__ bool last;
  block_sum<K>(acc, shm);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) part[k * kMaxGrid + blockIdx.x] = acc[k];
    __threadfence();
    last = atomicAdd(count, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return false;
  __threadfence();
#pragma unroll
  for (int k = 0; k < K; ++k) {
    acc[k] = 0.0;
    for (int j = threadIdx.x; j < (int)gridDim.x; j += kThreads) acc[k] += __ldcg(&part[k * kMaxGrid + j]);
  }
  block_sum<K>(acc, shm);
  if (threadIdx.x != 0) return false;
  *count = 0;
  return true;
}

// pass 1: r̂·v, then safe and α
template <typename T>
__global__ void __launch_bounds__(kThreads)
k8_rv(const T* rhat, const T* v, T* sc, double* part, unsigned* count, long long n) {
  const Stride g;
  double acc[1] = {0.0};
  for (long long i0 = g.first; i0 < n; i0 += g.step * kUnroll) {
    T a[kUnroll], b[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = i0 + u * g.step;
      a[u] = i < n ? rhat[i] : T(0);
      b[u] = i < n ? v[i] : T(0);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) acc[0] = fma((double)a[u], (double)b[u], acc[0]);
  }
  if (!grid_sum<1>(acc, part, count)) return;
  const T rv = (T)acc[0];
  const bool safe = fabs(rv) > sc[EPS];
  sc[SAFE] = T(safe);
  sc[ALPHA] = where(safe, quo(sc[RHO], where(safe, rv, T(1))), T(0));
}

// pass 2: s = r − α v
template <typename T>
__global__ void __launch_bounds__(kThreads)
k8_s(const T* r, const T* v, T* s, const T* sc, long long n) {
  const Stride g;
  const T alpha = sc[ALPHA];
  for (long long i0 = g.first; i0 < n; i0 += g.step * kUnroll) {
    T a[kUnroll], b[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = i0 + u * g.step;
      if (i < n) {
        a[u] = r[i];
        b[u] = v[i];
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = i0 + u * g.step;
      if (i < n) s[i] = sub(a[u], mul(alpha, b[u]));
    }
  }
}

// pass 3: t·t and t·s, then ω
template <typename T>
__global__ void __launch_bounds__(kThreads)
k8_tt(const T* t, const T* s, T* sc, double* part, unsigned* count, long long n) {
  const Stride g;
  double acc[2] = {0.0, 0.0};
  for (long long i0 = g.first; i0 < n; i0 += g.step * kUnroll) {
    T a[kUnroll], b[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = i0 + u * g.step;
      a[u] = i < n ? t[i] : T(0);
      b[u] = i < n ? s[i] : T(0);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      acc[0] = fma((double)a[u], (double)a[u], acc[0]);
      acc[1] = fma((double)a[u], (double)b[u], acc[1]);
    }
  }
  if (!grid_sum<2>(acc, part, count)) return;
  const T tt = (T)acc[0], ts = (T)acc[1];
  const bool big = tt > sc[EPS];
  sc[OMEGA] = where(big, quo(ts, where(big, tt, T(1))), T(0));
}

// pass 4: x += α p̂ + ω ŝ and r = s − ω t, with r̂·r, r·r and r̂·r̂; then
// the soft restart, ρ_next, β and whether the recursive residual passed.
// kSame: ŝ is s (no preconditioner), read once.
template <typename T, bool kSame>
__global__ void __launch_bounds__(kThreads)
k8_xr(T* x, const T* phat, const T* shat, const T* s, const T* t, T* r, const T* rhat, T* sc,
      double* part, unsigned* count, long long n) {
  const Stride g;
  const T alpha = sc[ALPHA], omega = sc[OMEGA];
  double acc[3] = {0.0, 0.0, 0.0};
  for (long long i0 = g.first; i0 < n; i0 += g.step * kUnroll) {
    T xv[kUnroll], pv[kUnroll], shv[kUnroll], sv[kUnroll], tv[kUnroll], hv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = i0 + u * g.step;
      if (i < n) {
        xv[u] = x[i];
        pv[u] = phat[i];
        sv[u] = s[i];
        shv[u] = kSame ? sv[u] : shat[i];
        tv[u] = t[i];
        hv[u] = rhat[i];
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = i0 + u * g.step;
      if (i < n) {
        x[i] = add(add(xv[u], mul(alpha, pv[u])), mul(omega, shv[u]));
        const T rn = sub(sv[u], mul(omega, tv[u]));
        r[i] = rn;
        acc[0] = fma((double)hv[u], (double)rn, acc[0]);
        acc[1] = fma((double)rn, (double)rn, acc[1]);
        acc[2] = fma((double)hv[u], (double)hv[u], acc[2]);
      }
    }
  }
  if (!grid_sum<3>(acc, part, count)) return;
  const T rho_new = (T)acc[0], rr = (T)acc[1], hh = (T)acc[2];
  const T nr = root(rr), nh = root(hh);
  const bool soft = fabs(rho_new) < mul(sc[EPS], maximum(mul(nr, nh), sc[TINY]));
  const T rho_next = where(soft, rr, rho_new);
  const T rho = sc[RHO];
  const bool safe = sc[SAFE] != T(0);
  sc[BETA] = where(safe && !soft,
                   mul(quo(rho_next, where(fabs(rho) > T(0), rho, T(1))),
                       quo(alpha, where(fabs(omega) > T(0), omega, T(1)))),
                   T(0));
  sc[SOFT] = T(soft);
  sc[RHO_NEXT] = rho_next;
  sc[REC] = T(nr <= sc[THRESH]);
}

// pass 5: ‖b − A·x‖², then done, lied and ρ
template <typename T>
__global__ void __launch_bounds__(kThreads)
k8_true(const T* b, const T* ax, T* sc, double* part, unsigned* count, long long n) {
  const Stride g;
  double acc[1] = {0.0};
  for (long long i0 = g.first; i0 < n; i0 += g.step * kUnroll) {
    T d[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = i0 + u * g.step;
      d[u] = i < n ? sub(b[i], ax[i]) : T(0);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) acc[0] = fma((double)d[u], (double)d[u], acc[0]);
  }
  if (!grid_sum<1>(acc, part, count)) return;
  const T tr2 = (T)acc[0];
  const bool small = root(tr2) <= sc[THRESH];
  const bool rec = sc[REC] != T(0);
  const bool lied = rec && !small;
  sc[DONE] = T(rec && small);
  sc[LIED] = T(lied);
  sc[RHO] = where(lied, tr2, sc[RHO_NEXT]);
}

// pass 6: p = r + β (p − ω v), or the soft restart r̂ = p = r, or the
// hard one r = r̂ = p = b − A·x; the branch is the same in every thread.
template <typename T>
__global__ void __launch_bounds__(kThreads)
k8_p(const T* b, const T* ax, T* r, T* rhat, T* p, const T* v, const T* sc, long long n) {
  const Stride g;
  const bool lied = sc[LIED] != T(0), soft = sc[SOFT] != T(0);
  const T beta = sc[BETA], omega = sc[OMEGA];
  for (long long i0 = g.first; i0 < n; i0 += g.step * kUnroll) {
    T a[kUnroll], c[kUnroll], e[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = i0 + u * g.step;
      if (i < n) {
        if (lied) {
          a[u] = b[i];
          c[u] = ax[i];
        } else if (soft) {
          a[u] = r[i];
        } else {
          a[u] = r[i];
          c[u] = p[i];
          e[u] = v[i];
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = i0 + u * g.step;
      if (i < n) {
        if (lied) {
          const T d = sub(a[u], c[u]);
          r[i] = d;
          rhat[i] = d;
          p[i] = d;
        } else if (soft) {
          rhat[i] = a[u];
          p[i] = a[u];
        } else {
          p[i] = add(a[u], mul(beta, sub(c[u], mul(omega, e[u]))));
        }
      }
    }
  }
}

// `work`: 3 * kMaxGrid partial sums, then the counter
struct Work {
  double* part;
  unsigned* count;
  explicit Work(void* w)
      : part(static_cast<double*>(w)), count(reinterpret_cast<unsigned*>(part + 3 * kMaxGrid)) {}
};

#define SPRS_CAST(p) static_cast<T*>(const_cast<void*>(p))

template <typename T>
int rv(const void* rhat, const void* v, void* sc, void* work, long long n, int grid, void* stream) {
  const Work w(work);
  k8_rv<T><<<grid, kThreads, 0, (cudaStream_t)stream>>>(SPRS_CAST(rhat), SPRS_CAST(v), SPRS_CAST(sc),
                                                        w.part, w.count, n);
  return (int)cudaGetLastError();
}

template <typename T>
int s_update(const void* r, const void* v, void* s, const void* sc, long long n, int grid,
             void* stream) {
  k8_s<T><<<grid, kThreads, 0, (cudaStream_t)stream>>>(SPRS_CAST(r), SPRS_CAST(v), SPRS_CAST(s),
                                                       SPRS_CAST(sc), n);
  return (int)cudaGetLastError();
}

template <typename T>
int tt(const void* t, const void* s, void* sc, void* work, long long n, int grid, void* stream) {
  const Work w(work);
  k8_tt<T><<<grid, kThreads, 0, (cudaStream_t)stream>>>(SPRS_CAST(t), SPRS_CAST(s), SPRS_CAST(sc),
                                                        w.part, w.count, n);
  return (int)cudaGetLastError();
}

template <typename T>
int xr(void* x, const void* phat, const void* shat, const void* s, const void* t, void* r,
       const void* rhat, void* sc, void* work, long long n, int grid, void* stream) {
  const Work w(work);
  if (shat == s) {
    k8_xr<T, true><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        SPRS_CAST(x), SPRS_CAST(phat), SPRS_CAST(shat), SPRS_CAST(s), SPRS_CAST(t), SPRS_CAST(r),
        SPRS_CAST(rhat), SPRS_CAST(sc), w.part, w.count, n);
  } else {
    k8_xr<T, false><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        SPRS_CAST(x), SPRS_CAST(phat), SPRS_CAST(shat), SPRS_CAST(s), SPRS_CAST(t), SPRS_CAST(r),
        SPRS_CAST(rhat), SPRS_CAST(sc), w.part, w.count, n);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int true_residual(const void* b, const void* ax, void* sc, void* work, long long n, int grid,
                  void* stream) {
  const Work w(work);
  k8_true<T><<<grid, kThreads, 0, (cudaStream_t)stream>>>(SPRS_CAST(b), SPRS_CAST(ax), SPRS_CAST(sc),
                                                          w.part, w.count, n);
  return (int)cudaGetLastError();
}

template <typename T>
int p_update(const void* b, const void* ax, void* r, void* rhat, void* p, const void* v,
             const void* sc, long long n, int grid, void* stream) {
  k8_p<T><<<grid, kThreads, 0, (cudaStream_t)stream>>>(SPRS_CAST(b), SPRS_CAST(ax), SPRS_CAST(r),
                                                       SPRS_CAST(rhat), SPRS_CAST(p), SPRS_CAST(v),
                                                       SPRS_CAST(sc), n);
  return (int)cudaGetLastError();
}

#undef SPRS_CAST

}  // namespace

// Plain C interface, bound with ctypes: sprs_k8_<pass>_<f32|f64>, one
// launch each on `stream`, returning cudaGetLastError() after it (0 on
// success).  `sc` holds the slots of Slot in the vectors' type; `work`
// holds 3 * kMaxGrid doubles of partial sums and then an unsigned
// counter, which must be 0 before the first reducing pass (the last
// block of each pass sets it back to 0); `grid` is at most kMaxGrid
// (ops/cuda/krylov.py::grid).

#define SPRS_K8_ENTRIES(SUFFIX, T)                                                                  \
  extern "C" int sprs_k8_rv_##SUFFIX(const void* rhat, const void* v, void* sc, void* work,         \
                                     long long n, int grid, void* stream) {                         \
    return rv<T>(rhat, v, sc, work, n, grid, stream);                                               \
  }                                                                                                 \
  extern "C" int sprs_k8_s_##SUFFIX(const void* r, const void* v, void* s, const void* sc,          \
                                    long long n, int grid, void* stream) {                          \
    return s_update<T>(r, v, s, sc, n, grid, stream);                                               \
  }                                                                                                 \
  extern "C" int sprs_k8_tt_##SUFFIX(const void* t, const void* s, void* sc, void* work,            \
                                     long long n, int grid, void* stream) {                         \
    return tt<T>(t, s, sc, work, n, grid, stream);                                                  \
  }                                                                                                 \
  extern "C" int sprs_k8_xr_##SUFFIX(void* x, const void* phat, const void* shat, const void* s,    \
                                     const void* t, void* r, const void* rhat, void* sc, void* work, \
                                     long long n, int grid, void* stream) {                         \
    return xr<T>(x, phat, shat, s, t, r, rhat, sc, work, n, grid, stream);                          \
  }                                                                                                 \
  extern "C" int sprs_k8_true_##SUFFIX(const void* b, const void* ax, void* sc, void* work,         \
                                       long long n, int grid, void* stream) {                       \
    return true_residual<T>(b, ax, sc, work, n, grid, stream);                                      \
  }                                                                                                 \
  extern "C" int sprs_k8_p_##SUFFIX(const void* b, const void* ax, void* r, void* rhat, void* p,    \
                                    const void* v, const void* sc, long long n, int grid,           \
                                    void* stream) {                                                 \
    return p_update<T>(b, ax, r, rhat, p, v, sc, n, grid, stream);                                  \
  }

SPRS_K8_ENTRIES(f32, float)
SPRS_K8_ENTRIES(f64, double)
