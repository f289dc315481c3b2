// The summed Bernoulli-logit GLM likelihood and its gradient, for every
// chain of a batch, in one pass over the design matrix.
//
// For chains c, rows i < N and columns j < D:
//   eta_ci = x_i . beta_c + b0_c
//   lp_c   = sum_i [ y_i eta_ci - softplus(eta_ci) ],
//            softplus(e) = max(e, 0) + log1p(exp(-|e|))
//   d lp_c / d beta_c = sum_i r_ci x_i,  d lp_c / d b0_c = sum_i r_ci,
//            r_ci = y_i - sigmoid(eta_ci)
//
// Replaces no TPU kernel: the JAX package leaves this likelihood to XLA,
// which fuses it. The port's eager form made about ten passes over the
// (C, N) logits, each reading and writing the whole array, for the value
// and its backward. Here the logits and the residuals live only in
// registers and shared memory: no (C, N) array reaches device memory.
//
// What bounds it on an H100: 4 N D C float32 operations (the two
// products; the likelihood adds ~40 instructions a (chain, row) pair on
// the CUDA cores and the special-function units) against 67 TFLOP/s, and
// 4 N (D + 1) bytes of X and y read once against 3.35 TB/s. At C = 64 the
// operations bound it (0.120 ms against 0.038 ms at 581,012 x 54): each
// float of X feeds 128 multiply-adds, 64 chains in each product. It runs
// at about 30 % of that bound (0.40 ms): both products read one float of
// shared memory per two fmaf, and an SM's shared memory gives 32 floats
// a clock against 128 fmaf, so they run near half the fmaf rate.
//
// Design:
// - Work split. A block takes a tile of 64 chains (blockIdx.y; chains
//   past C are zero rows, so any C runs) and walks the row tiles
//   blockIdx.x, blockIdx.x + gridDim.x, ... of 64 rows: about two blocks
//   an SM in all. Each tile of X and y is staged into shared memory with
//   4-byte cp.async (rows of D floats are not 16-byte aligned for every
//   D), double-buffered, so the next tile loads while this one computes.
//   The tile is stored with an appended column of ones (the intercept's
//   column; its coefficient is b0) and zero pads up to a multiple of 4
//   columns, at a row stride S whose count of 16-byte words is odd, so
//   that the float4 reads of eight neighbouring rows hit eight banks.
// - The two products, with explicit fmaf on the CUDA cores (the build
//   passes --fmad=false, so no other contraction happens; no tensor
//   cores: float32 throughout). The logits: each thread forms 4 chains x
//   4 rows of the (64 x 64) tile, 8 float4 reads of shared memory a step
//   of 4 columns for 64 fmaf. The likelihood is applied in registers;
//   each thread adds its rows' terms to its chains' lp and writes the
//   residuals to shared memory. The gradient: each thread owns MT tiles
//   of 4 chains x 4 columns of the (64 x D+1) gradient, two float4 reads
//   a row for 16 fmaf each, and keeps them in registers across all the
//   block's row tiles.
// - Reduction without atomics. Each block writes its partial sums
//   (gradient, intercept and lp of its chains) to a scratch buffer; a
//   second kernel sums the blocks' partials in block order. The grid
//   depends only on N, C and the card's SM count, so two calls give the
//   same bits. The lp, ~N/2 nats, is summed with Kahan's compensation in
//   each thread and across the blocks: plain float32 sums left it 5e-7
//   of the terms' magnitude from float64, five times torch.sum's error.
// Plain C interface for ctypes; launches on the caller's stream, never
// syncs and allocates nothing (the wrapper passes the scratch).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChains = 64;              // chains of a block's tile
constexpr int kRows = 64;                // rows of a tile of X
constexpr int kResStride = kChains + 4;  // residuals [row][chain]
constexpr int kMaxD = 255;               // D + 1 columns in at most 4 x 16 gradient tiles a thread
constexpr int kBlocksPerSm = 2;

__host__ __device__ inline int padded_cols(int d) { return (d + 1 + 3) & ~3; }

__host__ __device__ inline int row_stride(int dp) { return ((dp >> 2) & 1) ? dp : dp + 4; }

size_t smem_bytes(int d) {
  const int s = row_stride(padded_cols(d));
  return sizeof(float) * (static_cast<size_t>(2 * kRows + kChains) * s
                          + kRows * kResStride + 2 * kRows);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 4 : 0;  // 0: no read, the word is zero-filled
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <int MT>
__global__ void __launch_bounds__(kThreads, MT == 1 ? kBlocksPerSm : 1)
glm_logit_partials(const float* __restrict__ x, const float* __restrict__ y,
                   const float* __restrict__ beta, const float* __restrict__ b0,
                   int N, int D, int C, float* __restrict__ partial) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int DA = D + 1;  // with the intercept's column
  const int DP = padded_cols(D);
  const int S = row_stride(DP);
  float* xs0 = smem;                     // [2][kRows][S]
  float* bs = xs0 + 2 * kRows * S;       // [kChains][S]
  float* rs = bs + kChains * S;          // [kRows][kResStride]
  float* ys0 = rs + kRows * kResStride;  // [2][kRows]

  const int tid = threadIdx.x;
  const int chain0 = blockIdx.y * kChains;
  const int ntiles = (N + kRows - 1) / kRows;

  // the block's coefficients, the intercept as column D
  for (int i = tid; i < kChains * DP; i += kThreads) {
    const int c = i / DP, j = i - c * DP;
    const int chain = chain0 + c;
    float v = 0.f;
    if (chain < C) {
      if (j < D) {
        v = beta[static_cast<size_t>(chain) * D + j];
      } else if (j == D && b0 != nullptr) {
        v = b0[chain];
      }
    }
    bs[c * S + j] = v;
  }
  // the column of ones and the zero pads of both buffers; cp.async
  // writes only the columns below D
  for (int i = tid; i < 2 * kRows * (DP - D); i += kThreads) {
    const int r = i / (DP - D), j = D + (i - r * (DP - D));
    xs0[r * S + j] = (j == D) ? 1.f : 0.f;
  }

  // element i = r D + j of a tile: the thread's first, and its step
  const int r_first = tid / D, j_first = tid - r_first * D;
  const int r_step = kThreads / D, j_step = kThreads - r_step * D;
  auto load_tile = [&](int tile, int buf) {
    const int row0 = tile * kRows;
    float* xs = xs0 + buf * kRows * S;
    const float* src = x + static_cast<size_t>(row0) * D;
    const int valid = min(kRows, N - row0) * D;
    int r = r_first, j = j_first;
    for (int i = tid; i < kRows * D; i += kThreads) {
      cp_async4(xs + r * S + j, i < valid ? src + i : x, i < valid);
      r += r_step;
      j += j_step;
      if (j >= D) {
        j -= D;
        ++r;
      }
    }
    if (tid < kRows) {
      const bool ok = row0 + tid < N;
      cp_async4(ys0 + buf * kRows + tid, ok ? y + row0 + tid : y, ok);
    }
    cp_async_commit();
  };

  const int lane = tid & 31, warp = tid >> 5;
  // logits: chains ec + 4a, rows er + 8b of the tile (a, b < 4). A warp
  // reads 4 neighbouring chains' and 8 neighbouring rows' float4 at once.
  const int ec = (warp & 3) * 16 + (lane >> 3);
  const int er = (warp >> 2) * 32 + (lane & 7);
  // gradient: tile t = tid + m * kThreads holds chains 4 (t / ncg) + a
  // and columns 4 (t % ncg) + b
  const int ncg = DP >> 2;
  const int ngrad = (kChains / 4) * ncg;

  // each chain's lp over the thread's rows, compensated (Kahan): the
  // sum reaches ~N/2 nats, where plain float32 adds lose ~1e-7 of it each
  float lp_acc[4] = {0.f, 0.f, 0.f, 0.f};
  float lp_comp[4] = {0.f, 0.f, 0.f, 0.f};
  float g[MT][4][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) g[m][a][b] = 0.f;

  int buf = 0;
  if (static_cast<int>(blockIdx.x) < ntiles) load_tile(blockIdx.x, 0);
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int next = tile + gridDim.x;
    if (next < ntiles) {
      load_tile(next, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* xs = xs0 + buf * kRows * S;
    const float* ys = ys0 + buf * kRows;

    float eta[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) eta[a][b] = 0.f;
    for (int j = 0; j < DP; j += 4) {
      float4 xv[4], bv[4];
#pragma unroll
      for (int b = 0; b < 4; ++b)
        xv[b] = *reinterpret_cast<const float4*>(xs + (er + 8 * b) * S + j);
#pragma unroll
      for (int a = 0; a < 4; ++a)
        bv[a] = *reinterpret_cast<const float4*>(bs + (ec + 4 * a) * S + j);
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          eta[a][b] = fmaf(bv[a].x, xv[b].x, eta[a][b]);
          eta[a][b] = fmaf(bv[a].y, xv[b].y, eta[a][b]);
          eta[a][b] = fmaf(bv[a].z, xv[b].z, eta[a][b]);
          eta[a][b] = fmaf(bv[a].w, xv[b].w, eta[a][b]);
        }
    }

    const int row0 = tile * kRows;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int r = er + 8 * b;
      const bool ok = row0 + r < N;
      const float yv = ys[r];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float e = eta[a][b];
        const float t = expf(-fabsf(e));
        const float softplus = fmaxf(e, 0.f) + log1pf(t);
        const float inv = 1.f / (1.f + t);
        const float sig = e >= 0.f ? inv : t * inv;
        const float term = (ok ? yv * e - softplus : 0.f) - lp_comp[a];
        const float sum = lp_acc[a] + term;
        lp_comp[a] = (sum - lp_acc[a]) - term;
        lp_acc[a] = sum;
        rs[r * kResStride + ec + 4 * a] = ok ? yv - sig : 0.f;
      }
    }
    __syncthreads();

#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const int t = tid + m * kThreads;
      if (t < ngrad) {
        const int c4 = (t / ncg) * 4, k4 = (t % ncg) * 4;
#pragma unroll 4
        for (int r = 0; r < kRows; ++r) {
          const float4 rv = *reinterpret_cast<const float4*>(rs + r * kResStride + c4);
          const float4 xv = *reinterpret_cast<const float4*>(xs + r * S + k4);
          const float ra[4] = {rv.x, rv.y, rv.z, rv.w};
          const float xb[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int b = 0; b < 4; ++b) g[m][a][b] = fmaf(ra[a], xb[b], g[m][a][b]);
        }
      }
    }
    __syncthreads();
    buf ^= 1;
  }

  // each chain's lp: 16 threads hold parts of it; summed in a fixed order
  float* red = rs;  // [16][kChains]
  const int slot = (warp >> 2) * 8 + (lane & 7);
#pragma unroll
  for (int a = 0; a < 4; ++a) red[slot * kChains + ec + 4 * a] = lp_acc[a];
  __syncthreads();
  const int W = D + 2;  // gradient, intercept, lp
  float* out = partial + static_cast<size_t>(blockIdx.x) * C * W;
  if (tid < kChains && chain0 + tid < C) {
    float s = 0.f;
    for (int k = 0; k < 16; ++k) s += red[k * kChains + tid];
    out[static_cast<size_t>(chain0 + tid) * W + DA] = s;
  }
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    const int t = tid + m * kThreads;
    if (t < ngrad) {
      const int c4 = (t / ncg) * 4, k4 = (t % ncg) * 4;
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int chain = chain0 + c4 + a;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int k = k4 + b;
          if (chain < C && k < DA) out[static_cast<size_t>(chain) * W + k] = g[m][a][b];
        }
      }
    }
  }
}

// out = sum over blocks of partial[block], in block order, compensated
__global__ void glm_logit_reduce(const float* __restrict__ partial, int nblk, int C, int D,
                                 float* __restrict__ lp, float* __restrict__ g_beta,
                                 float* __restrict__ g_b0) {
  const int W = D + 2;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= C * W) return;
  float s = 0.f, comp = 0.f;
  for (int b = 0; b < nblk; ++b) {
    const float v = partial[static_cast<size_t>(b) * C * W + i] - comp;
    const float t = s + v;
    comp = (t - s) - v;
    s = t;
  }
  const int c = i / W, k = i - c * W;
  if (k < D) {
    g_beta[static_cast<size_t>(c) * D + k] = s;
  } else if (k == D) {
    g_b0[c] = s;
  } else {
    lp[c] = s;
  }
}

template <int MT>
cudaError_t launch(const float* x, const float* y, const float* beta, const float* b0, int N,
                   int D, int C, float* partial, int nblk, cudaStream_t stream) {
  const size_t shmem = smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(glm_logit_partials<MT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(shmem));
  if (err != cudaSuccess) return err;
  const dim3 grid(nblk, (C + kChains - 1) / kChains);
  glm_logit_partials<MT><<<grid, kThreads, shmem, stream>>>(x, y, beta, b0, N, D, C, partial);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Largest D the kernel takes (shared memory: 217,600 bytes at D = 255).
int glm_logit_max_d() { return kMaxD; }

// Row blocks of a call: about kBlocksPerSm blocks an SM in all, at most
// one a row tile. A negative value is a CUDA error code.
int glm_logit_blocks(int N, int C) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return -static_cast<int>(err);
  const int ntiles = (N + kRows - 1) / kRows;
  const int nct = (C + kChains - 1) / kChains;
  int nblk = (kBlocksPerSm * sms + nct - 1) / nct;
  if (nblk > ntiles) nblk = ntiles;
  return nblk < 1 ? 1 : nblk;
}

// x (N, D), y (N,), beta (C, D), b0 (C,) or null, all float32 and
// contiguous; partial (nblk, C, D + 2) scratch; writes lp (C,),
// g_beta (C, D) and g_b0 (C,). Returns cudaGetLastError() of the
// launches.
int glm_logit_f32(const float* x, const float* y, const float* beta, const float* b0, int N,
                  int D, int C, float* partial, int nblk, float* lp, float* g_beta,
                  float* g_b0, void* stream) {
  if (N <= 0 || C <= 0 || D <= 0 || D > kMaxD || nblk <= 0
      || nblk > (N + kRows - 1) / kRows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int dp = padded_cols(D);
  cudaError_t err;
  if (dp <= 64) {
    err = launch<1>(x, y, beta, b0, N, D, C, partial, nblk, s);
  } else if (dp <= 128) {
    err = launch<2>(x, y, beta, b0, N, D, C, partial, nblk, s);
  } else {
    err = launch<4>(x, y, beta, b0, N, D, C, partial, nblk, s);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int total = C * (D + 2);
  glm_logit_reduce<<<(total + 255) / 256, 256, 0, s>>>(partial, nblk, C, D, lp, g_beta, g_b0);
  return static_cast<int>(cudaGetLastError());
}

const char* glm_logit_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
