// LDL' factorisation and solve of symmetric tridiagonal systems, one
// system a block, float64: the two recurrences of every Newton step of
// the Laplace marginal (``marginal._thomas_factor``/``_thomas_solve``).
//
// For a system with diagonal a_0..a_{T-1} and a constant off-diagonal b:
//   delta_0 = a_0,  delta_i = a_i - b^2 / delta_{i-1}      (D of LDL')
//   ell_i   = b / delta_i,  i < T - 1                        (L below 1s)
// and the solve of (L D L') x = r:
//   y_0 = r_0,  y_i = r_i - ell_{i-1} y_{i-1};  z = y / delta
//   x_{T-1} = z_{T-1},  x_i = z_i - ell_i x_{i+1}.
//
// Replaces the TPU path's associative scans (``lax.associative_scan`` of
// 2x2 Mobius maps and of affine maps over blocks of 128). The port's
// plain PyTorch form runs each as a log-depth doubling scan, ~12 levels
// of several batched kernels each at T = 5,000: about 350 kernels a
// Newton step, each a few microseconds of launch latency over a few
// thousand elements. Here one launch does each recurrence.
//
// What bounds it on an H100: latency, not bandwidth or arithmetic. A
// system is ~60 float64 operations and 40 bytes an element (5,000
// elements: 0.3 MFLOP and 0.2 MB, 0.06 us at 3.35 TB/s), spread over one
// block of the card's 132 SMs.
//
// Design: a block of kThreads threads takes one system; thread t owns
// the contiguous chunk [t L, t L + L) of its elements, L = ceil(T /
// kThreads).
// - factor: each thread composes its chunk's Mobius maps
//   [[a_i, -b^2], [1, 0]] (delta_{i-1} -> delta_i on homogeneous
//   coordinates) into one 2x2 matrix, renormalised by a power of two at
//   each step (exact; without it the products overflow within a few
//   hundred steps); a Hillis-Steele scan over the block's matrices in
//   shared memory gives each thread the map from the start to its chunk,
//   so delta just before its chunk; then the scalar recurrence runs over
//   the chunk.
// - solve: the same with affine maps y -> c y + d, forward for y and
//   backward (a suffix scan) for x. Each thread reads and writes only its
//   own chunk in device memory (z is kept in x between the two passes),
//   so the shared scans are the only exchange between threads.
// Results differ from the doubling scans' in rounding only (~1e-15
// relative for the SPD systems of the marginal).
//
// Plain C interface for ctypes; launches on the caller's stream, never
// syncs and allocates nothing.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;

struct M2 {  // [[a, b], [c, d]]
  double a, b, c, d;
};

struct Af {  // y -> c y + d
  double c, d;
};

__device__ __forceinline__ M2 mul(const M2& y, const M2& x) {  // y @ x
  return {y.a * x.a + y.b * x.c, y.a * x.b + y.b * x.d,
          y.c * x.a + y.d * x.c, y.c * x.b + y.d * x.d};
}

// m scaled by a power of two that brings its largest entry into [0.5, 1)
__device__ __forceinline__ M2 renorm(M2 m) {
  const double s = fmax(fmax(fabs(m.a), fabs(m.b)), fmax(fabs(m.c), fabs(m.d)));
  if (s > 0.0 && isfinite(s)) {
    int e;
    frexp(s, &e);
    const double k = ldexp(1.0, -e);
    m.a *= k;
    m.b *= k;
    m.c *= k;
    m.d *= k;
  }
  return m;
}

// later after earlier
__device__ __forceinline__ Af after(const Af& later, const Af& earlier) {
  return {later.c * earlier.c, later.c * earlier.d + later.d};
}

__global__ void __launch_bounds__(kThreads)
tri_factor_f64(const double* __restrict__ a, const double* __restrict__ b, int T,
               double* __restrict__ delta, double* __restrict__ ell) {
  __shared__ M2 buf[2][kThreads];
  const int t = threadIdx.x;
  const size_t p = blockIdx.x;
  const double* ap = a + p * T;
  double* dp = delta + p * T;
  double* lp = ell + p * (T - 1);
  const double bv = b[p];
  const double bb = bv * bv;
  const int L = (T + kThreads - 1) / kThreads;
  const int lo = min(T, t * L);
  const int hi = min(T, lo + L);

  M2 m = {1.0, 0.0, 0.0, 1.0};
  for (int i = lo; i < hi; ++i) m = renorm(mul({__ldg(ap + i), -bb, 1.0, 0.0}, m));

  // inclusive scan: chunk t's entry becomes C_t ... C_0
  int cur = 0;
  buf[0][t] = m;
  __syncthreads();
  for (int off = 1; off < kThreads; off <<= 1) {
    M2 x = buf[cur][t];
    if (t >= off) x = renorm(mul(x, buf[cur][t - off]));
    buf[cur ^ 1][t] = x;
    cur ^= 1;
    __syncthreads();
  }
  if (lo >= hi) return;

  // delta just before the chunk: the prefix map applied to [1, 0]
  // (the state before delta_0, which M_0 takes to [a_0, 1])
  int i = lo;
  double prev;
  if (t == 0) {
    prev = __ldg(ap);
    dp[0] = prev;
    if (T > 1) lp[0] = bv / prev;
    i = 1;
  } else {
    const M2 q = buf[cur][t - 1];
    prev = q.a / q.c;
  }
  for (; i < hi; ++i) {
    const double d = __ldg(ap + i) - bb / prev;
    dp[i] = d;
    if (i < T - 1) lp[i] = bv / d;
    prev = d;
  }
}

__global__ void __launch_bounds__(kThreads)
tri_solve_f64(const double* __restrict__ delta, const double* __restrict__ ell,
              const double* __restrict__ r, int T, double* __restrict__ x) {
  __shared__ Af buf[2][kThreads];
  const int t = threadIdx.x;
  const size_t p = blockIdx.x;
  const double* dp = delta + p * T;
  const double* lp = ell + p * (T - 1);
  const double* rp = r + p * T;
  double* xp = x + p * T;
  const int L = (T + kThreads - 1) / kThreads;
  const int lo = min(T, t * L);
  const int hi = min(T, lo + L);

  // forward: y_i = c_i y_{i-1} + r_i, c_0 = 0, c_i = -ell_{i-1}
  Af m = {1.0, 0.0};
  for (int i = lo; i < hi; ++i) {
    const double c = i ? -__ldg(lp + i - 1) : 0.0;
    m = after({c, __ldg(rp + i)}, m);
  }
  int cur = 0;
  buf[0][t] = m;
  __syncthreads();
  for (int off = 1; off < kThreads; off <<= 1) {
    Af v = buf[cur][t];
    if (t >= off) v = after(v, buf[cur][t - off]);
    buf[cur ^ 1][t] = v;
    cur ^= 1;
    __syncthreads();
  }
  // y just before the chunk: c_0 = 0, so the prefix's offset
  double y = t ? buf[cur][t - 1].d : 0.0;
  for (int i = lo; i < hi; ++i) {
    const double c = i ? -__ldg(lp + i - 1) : 0.0;
    y = c * y + __ldg(rp + i);
    xp[i] = y / __ldg(dp + i);                       // z, this thread's own
  }

  // backward: x_i = c_i x_{i+1} + z_i, c_{T-1} = 0, c_i = -ell_i
  m = {1.0, 0.0};
  for (int i = hi - 1; i >= lo; --i) {
    const double c = i < T - 1 ? -__ldg(lp + i) : 0.0;
    m = after({c, xp[i]}, m);
  }
  __syncthreads();                                   // the forward scan's reads are done
  cur = 0;
  buf[0][t] = m;
  __syncthreads();
  for (int off = 1; off < kThreads; off <<= 1) {
    Af v = buf[cur][t];
    if (t + off < kThreads) v = after(v, buf[cur][t + off]);
    buf[cur ^ 1][t] = v;
    cur ^= 1;
    __syncthreads();
  }
  // x just after the chunk: c_{T-1} = 0, so the suffix's offset
  double xn = t + 1 < kThreads ? buf[cur][t + 1].d : 0.0;
  for (int i = hi - 1; i >= lo; --i) {
    const double c = i < T - 1 ? -__ldg(lp + i) : 0.0;
    xn = c * xn + xp[i];
    xp[i] = xn;
  }
}

}  // namespace

extern "C" {

// a (P, T), b (P,), all float64 and contiguous; writes delta (P, T) and
// ell (P, T - 1). Returns cudaGetLastError() of the launch.
int tri_factor(const double* a, const double* b, int P, int T, double* delta, double* ell,
               void* stream) {
  if (P <= 0 || T < 2) return static_cast<int>(cudaErrorInvalidValue);
  tri_factor_f64<<<P, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a, b, T, delta, ell);
  return static_cast<int>(cudaGetLastError());
}

// delta (P, T), ell (P, T - 1), r (P, T), all float64 and contiguous;
// writes x (P, T), which must not alias r. Returns cudaGetLastError().
int tri_solve(const double* delta, const double* ell, const double* r, int P, int T, double* x,
              void* stream) {
  if (P <= 0 || T < 2) return static_cast<int>(cudaErrorInvalidValue);
  tri_solve_f64<<<P, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(delta, ell, r, T, x);
  return static_cast<int>(cudaGetLastError());
}

const char* tri_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
