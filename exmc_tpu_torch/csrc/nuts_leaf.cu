// One leaf of the NUTS tree's subtree build (nuts/tree.py::_build_subtree)
// for every chain of a batch, in one launch, under a diagonal metric.
//
// Between two value-and-grad calls the eager tree issues ~80 small
// operations a leaf: the leapfrog's second half-kick, the kinetic energy,
// joint and delta, the NaN-safe divergence, the log-weight, accept, rho,
// logaddexp, the multinomial take, the checkpoint write or the U-turn
// checks, every keep of the subtree's state, and the next leaf's drift.
// Here one launch does all of it and leaves the next leaf's position ready
// for the value-and-grad. Per chain c with live[c] set (nuts/leaf.py,
// leaf_plain, is the same arithmetic in PyTorch):
//   r      = p_half + (eps/2) g          (g, logp: the value-and-grad at z_in)
//   joint  = logp - 0.5 r.(M^-1 r),  delta = joint - joint0
//   div    = !(delta >= -threshold),  lw = div ? -inf : delta
//   accept = div ? 0 : exp(min(delta, 0))
//   rho'   = rho + (div ? 0 : r),  lsw' = logaddexp(lsw, lw)
//   take   = !div && leaf_logu[c, n] < lw - lsw'
//   even n: checkpoint slot `slot` <- (r, rho', r_old); odd n: the U-turn
//           checks of slots idx_min..idx_max with Stan's two extended ones
//   state  <- (z_in, r, g, ...), proposal <- (z_in, logp, g, joint) if take
//   live   <- !turning && !div; any_live[n & 1] <- 1 if some chain is live
//   next:  p_half = r + (eps/2) g,  z_in = z + eps (M^-1 p_half)
// A chain that is not live keeps every field, z_in included, as the eager
// keeps do. The leaf index, the slot and the checked range are the same for
// every chain (all build the same leaf), so they come in as arguments.
//
// Replaces no TPU kernel: on the TPU, XLA fuses the whole leaf body of the
// JAX package's lax.while_loop (exmc_tpu/nuts/tree.py, _build_subtree) into
// one program. On the card the eager form is bound by the host's issue of
// its operations (~1 ms a leaf), not by the device.
//
// What bounds it on an H100: the bytes of the state and the checkpoints
// it reads and writes, ~(15 + 6 k) C d values for k checked slots (under
// 1 MB at 1024 x 10 in float32: well under a microsecond at 3.35 TB/s).
// So it is bound by latency: one launch, a few dependent loads a chain.
//
// Design:
// - One warp per chain, lanes striding over d. Each dot product sums its
//   lane's terms in order and then across the warp by an xor butterfly:
//   float addition commutes, so every lane ends with the same bits, and
//   the fixed order gives the same bits on every call. No atomics but the
//   any-live flag, which every live chain sets to the same 1.
// - The flag alternates between two words: leaf n zeroes word (n + 1) & 1
//   for the next leaf and sets word n & 1, which the host reads once.
// - Each elementwise step is rounded as the eager operation rounds it (the
//   build passes --fmad=false); only the dot products' order of summation
//   differs from torch.sum's.
// - The state lives in buffers the wrapper allocates once per subtree and
//   the kernels update in place; their addresses ride in one struct, so a
//   launch passes the value-and-grad's two outputs and five integers.
// Plain C interface for ctypes; launches on the caller's stream, never
// syncs and allocates nothing.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

extern "C" {
// Mirrored by nuts/leaf.py's _Buffers (ctypes).
struct LeafBuffers {
  void* vec;              // (kVec, C, d) rows: the fields of enum Vec
  void* scal;             // (kScal, C): the fields of enum Scal
  int32_t* n;             // (C,) leaves built
  uint8_t* mask;          // (3, C) bools: the fields of enum Mask
  void* ckpt;             // (C, max_depth, 3, d): (r, rho, r_prev) a slot
  int32_t* any_live;      // (2,)
  const void* eps;        // (C,) signed step sizes
  const void* inv;        // inverse mass, chain c's row at c * inv_stride
  const void* joint0;     // (C,)
  const uint8_t* active;  // (C,)
  const void* leaf_logu;  // chain c, leaf n at c * logu_stride_c + n * logu_stride_n
  int64_t inv_stride, logu_stride_c, logu_stride_n;
  int32_t C, d, max_depth, dtype;  // dtype: 0 float32, 1 float64
  double threshold;                // a leaf diverges unless delta >= -threshold
};
}

namespace {

enum Vec { kZ, kR, kG, kRFirst, kZProp, kGProp, kRho, kPHalf, kZIn, kVec };
enum Scal { kLogpProp, kJointProp, kLsw, kSumAccept, kScal };
enum Mask { kTurning, kDiverging, kLive };

constexpr int kWarps = 8;  // chains of a block
constexpr int kThreads = 32 * kWarps;

__device__ __forceinline__ float exp_(float x) { return expf(x); }
__device__ __forceinline__ double exp_(double x) { return exp(x); }
__device__ __forceinline__ float log1p_(float x) { return log1pf(x); }
__device__ __forceinline__ double log1p_(double x) { return log1p(x); }

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// torch.logaddexp's formula
template <typename T>
__device__ __forceinline__ T logaddexp(T a, T b) {
  if (isinf(a) && a == b) return a;
  const T m = a > b ? a : b;
  return m + log1p_(exp_(-fabs(a - b)));
}

template <typename T>
struct Row {
  T* v[kVec];
  const T* inv;
  T eps;
};

template <typename T>
__device__ __forceinline__ Row<T> row_of(const LeafBuffers& b, int c) {
  Row<T> row;
  const size_t cd = static_cast<size_t>(b.C) * b.d;
  T* vec = static_cast<T*>(b.vec) + static_cast<size_t>(c) * b.d;
#pragma unroll
  for (int k = 0; k < kVec; ++k) row.v[k] = vec + k * cd;
  row.inv = static_cast<const T*>(b.inv) + c * b.inv_stride;
  row.eps = static_cast<const T*>(b.eps)[c];
  return row;
}

// The subtree's initial state from (z0, r0, g0) and leaf 0's drift, for
// every chain.
template <typename T>
__global__ void __launch_bounds__(kThreads)
leaf_start(LeafBuffers b, const T* __restrict__ z0, const T* __restrict__ r0,
           const T* __restrict__ g0) {
  const int c = (blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (blockIdx.x == 0 && threadIdx.x == 0) b.any_live[0] = 0;
  if (c >= b.C) return;
  const Row<T> w = row_of<T>(b, c);
  const T half = T(0.5) * w.eps;
  const size_t at = static_cast<size_t>(c) * b.d;
  for (int j = lane; j < b.d; j += 32) {
    const T z = z0[at + j], r = r0[at + j], g = g0[at + j];
    w.v[kZ][j] = z;
    w.v[kR][j] = r;
    w.v[kG][j] = g;
    w.v[kRFirst][j] = T(0);
    w.v[kZProp][j] = z;
    w.v[kGProp][j] = g;
    w.v[kRho][j] = T(0);
    const T ph = r + half * g;
    w.v[kPHalf][j] = ph;
    w.v[kZIn][j] = z + w.eps * (w.inv[j] * ph);
  }
  if (lane == 0) {
    T* scal = static_cast<T*>(b.scal);
    scal[kLogpProp * b.C + c] = T(0);
    scal[kJointProp * b.C + c] = static_cast<const T*>(b.joint0)[c];
    scal[kLsw * b.C + c] = -static_cast<T>(INFINITY);
    scal[kSumAccept * b.C + c] = T(0);
    b.n[c] = 0;
    b.mask[kTurning * b.C + c] = 0;
    b.mask[kDiverging * b.C + c] = 0;
    b.mask[kLive * b.C + c] = b.active[c];
  }
}

// Leaf n of every live chain, from the value-and-grad (logp, g) at z_in.
template <typename T>
__global__ void __launch_bounds__(kThreads)
leaf_step(LeafBuffers b, const T* __restrict__ logp, const T* __restrict__ gn, int n,
          int slot, int idx_min, int idx_max, int has_next) {
  const int c = (blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (blockIdx.x == 0 && threadIdx.x == 0) b.any_live[(n + 1) & 1] = 0;
  // the whole warp leaves together, so the shuffles below see all lanes
  if (c >= b.C || !b.mask[kLive * b.C + c]) return;
  const int d = b.d;
  const Row<T> w = row_of<T>(b, c);
  const T* inv = w.inv;
  const T* g = gn + static_cast<size_t>(c) * d;
  T* ph = w.v[kPHalf];
  T* rr = w.v[kR];
  T* rh = w.v[kRho];
  const T half = T(0.5) * w.eps;

  T ke = T(0);
  for (int j = lane; j < d; j += 32) {
    const T r = ph[j] + half * g[j];
    ke += r * (inv[j] * r);
  }
  ke = warp_sum(ke);
  const T joint = logp[c] - T(0.5) * ke;
  const T delta = joint - static_cast<const T*>(b.joint0)[c];
  const bool div = !(delta >= -static_cast<T>(b.threshold));
  const T lw = div ? -static_cast<T>(INFINITY) : delta;
  const T accept = div ? T(0) : exp_(delta < T(0) ? delta : T(0));
  T* scal = static_cast<T*>(b.scal);
  const T lsw = logaddexp(scal[kLsw * b.C + c], lw);
  const T logu = static_cast<const T*>(b.leaf_logu)[c * b.logu_stride_c + n * b.logu_stride_n];
  const bool take = !div && logu < lw - lsw;
  const bool even = (n & 1) == 0;
  T* ck = static_cast<T*>(b.ckpt) + static_cast<size_t>(c) * b.max_depth * 3 * d;

  for (int j = lane; j < d; j += 32) {
    const T gj = g[j], zin = w.v[kZIn][j];
    const T r = ph[j] + half * gj;
    const T rho = rh[j] + (div ? T(0) : r);
    if (even) {
      T* s = ck + static_cast<size_t>(slot) * 3 * d;
      s[j] = r;
      s[d + j] = rho;
      s[2 * d + j] = rr[j];
    }
    w.v[kZ][j] = zin;
    rr[j] = r;
    w.v[kG][j] = gj;
    if (n == 0) w.v[kRFirst][j] = r;
    if (take) {
      w.v[kZProp][j] = zin;
      w.v[kGProp][j] = gj;
    }
    rh[j] = rho;
    if (has_next) {
      const T p2 = r + half * gj;
      ph[j] = p2;
      w.v[kZIn][j] = zin + w.eps * (inv[j] * p2);
    }
  }

  // odd leaf: the sub-trajectories that end here (nuts/leaf.py,
  // iterative_uturn_check); each lane reads back only its own r and rho
  bool turn = false;
  if (!even) {
    for (int i = idx_min; i <= idx_max; ++i) {
      const T* cr = ck + static_cast<size_t>(i) * 3 * d;
      const T* crho = cr + d;
      T s1 = T(0), s2 = T(0);
      for (int j = lane; j < d; j += 32) {
        const T sub = (rh[j] - crho[j]) + cr[j];
        s1 += sub * (inv[j] * cr[j]);
        s2 += sub * (inv[j] * rr[j]);
      }
      s1 = warp_sum(s1);
      s2 = warp_sum(s2);
      turn = turn || s1 <= T(0) || s2 <= T(0);
    }
    for (int i = idx_min; i < idx_max; ++i) {
      const T* lo_r = ck + static_cast<size_t>(i) * 3 * d;
      const T* lo_rho = lo_r + d;
      const T* nx_r = lo_r + 3 * d;
      const T* nx_rho = nx_r + d;
      const T* nx_prev = nx_r + 2 * d;
      T s1 = T(0), s2 = T(0), s3 = T(0), s4 = T(0);
      for (int j = lane; j < d; j += 32) {
        const T left = (nx_rho[j] - lo_rho[j]) + lo_r[j];
        s1 += left * (inv[j] * lo_r[j]);
        s2 += left * (inv[j] * nx_r[j]);
        const T right = ((rh[j] - nx_rho[j]) + nx_r[j]) + nx_prev[j];
        s3 += right * (inv[j] * nx_prev[j]);
        s4 += right * (inv[j] * rr[j]);
      }
      s1 = warp_sum(s1);
      s2 = warp_sum(s2);
      s3 = warp_sum(s3);
      s4 = warp_sum(s4);
      turn = turn || s1 <= T(0) || s2 <= T(0) || s3 <= T(0) || s4 <= T(0);
    }
  }

  if (lane == 0) {
    const bool turning = !div && turn;
    b.n[c] += 1;
    if (take) {
      scal[kLogpProp * b.C + c] = logp[c];
      scal[kJointProp * b.C + c] = joint;
    }
    scal[kLsw * b.C + c] = lsw;
    scal[kSumAccept * b.C + c] = scal[kSumAccept * b.C + c] + accept;
    b.mask[kTurning * b.C + c] = turning;
    b.mask[kDiverging * b.C + c] = div;
    const bool live = !turning && !div;
    b.mask[kLive * b.C + c] = live;
    if (live) b.any_live[n & 1] = 1;
  }
}

int grid_of(int chains) { return (chains + kWarps - 1) / kWarps; }

}  // namespace

extern "C" {

int nuts_leaf_start(const LeafBuffers* b, const void* z0, const void* r0, const void* g0,
                    void* stream) {
  if (b->C <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b->dtype == 1) {
    leaf_start<double><<<grid_of(b->C), kThreads, 0, s>>>(
        *b, static_cast<const double*>(z0), static_cast<const double*>(r0),
        static_cast<const double*>(g0));
  } else {
    leaf_start<float><<<grid_of(b->C), kThreads, 0, s>>>(
        *b, static_cast<const float*>(z0), static_cast<const float*>(r0),
        static_cast<const float*>(g0));
  }
  return static_cast<int>(cudaGetLastError());
}

int nuts_leaf_step(const LeafBuffers* b, const void* logp, const void* g, int n, int slot,
                   int idx_min, int idx_max, int has_next, void* stream) {
  if (b->C <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b->dtype == 1) {
    leaf_step<double><<<grid_of(b->C), kThreads, 0, s>>>(
        *b, static_cast<const double*>(logp), static_cast<const double*>(g), n, slot, idx_min,
        idx_max, has_next);
  } else {
    leaf_step<float><<<grid_of(b->C), kThreads, 0, s>>>(
        *b, static_cast<const float*>(logp), static_cast<const float*>(g), n, slot, idx_min,
        idx_max, has_next);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* nuts_leaf_error_string(int rc) {
  return cudaGetErrorString(static_cast<cudaError_t>(rc));
}

}  // extern "C"
