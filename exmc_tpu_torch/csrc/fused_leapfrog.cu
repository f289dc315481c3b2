// Fused K-step leapfrog for diagonal-Gaussian potentials, all chains at once.
//
// Replaces the Pallas TPU kernel exmc_tpu/ops/fused_leapfrog.py::_kernel
// (pallas_call at fused_leapfrog.py:88). For every chain row c:
//   grad(q) = -prec * (q - mu)
//   repeat K times:  p_half = p + 0.5*eps*grad(q)
//                    q      = q + eps*inv_mass*p_half
//                    p      = p_half + 0.5*eps*grad(q)
//   logp[c] = -0.5 * sum_j prec_j * (q_j - mu_j)^2
//
// What bounds it on an H100: the function reads q, p (C x d) and
// mu, prec, inv_mass (d) once and writes q, p and logp once:
// 4 * (4*C*d + 3*d + C) bytes, against 3.35 TB/s. It does 10 f32
// operations per coordinate and step (2 per gradient, 2 per kick, 2 per
// drift, with eps*inv_mass hoisted out of the loop) plus 4 per coordinate
// for the final logp: 10*K*C*d + 4*C*d operations, against 67 TFLOP/s
// f32 outside the tensor cores. So it is memory-bound at small K and
// bound by f32 arithmetic at large K.
//
// Design: the whole K-step loop stays out of device memory. One block
// holds a tile of chain rows (blockDim.y rows); in a row, thread x owns
// coordinates x, x + blockDim.x, ... (VPT of them, neighbouring threads on
// neighbouring addresses), and keeps their q, p, mu, prec and
// eps*inv_mass in registers for all K steps. The ragged edges in C and d
// are masked: a masked coordinate holds zeros and adds nothing to logp.
// The per-row logp is a warp-shuffle sum plus a shared-memory sum over
// the row's warps. The arithmetic is the Pallas body's, in its order; the
// build turns off FMA contraction (--fmad=false) so each step rounds as
// the plain PyTorch version does.
//
// Plain C interface for ctypes; launches on the caller's stream and
// returns cudaGetLastError() of the launch.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <int VPT>
__global__ void fused_leapfrog_kernel(const float* __restrict__ q,
                                      const float* __restrict__ p,
                                      const float* __restrict__ mu,
                                      const float* __restrict__ prec,
                                      const float* __restrict__ inv_mass,
                                      float eps, int C, int d, int K,
                                      float* __restrict__ q_out,
                                      float* __restrict__ p_out,
                                      float* __restrict__ logp_out) {
  extern __shared__ float row_partial[];  // blockDim.y * (blockDim.x / 32)
  const int tx = threadIdx.x;
  const int row = threadIdx.y;
  const int chain = blockIdx.x * blockDim.y + row;
  const bool live_row = chain < C;
  const size_t base = static_cast<size_t>(chain) * d;

  float qr[VPT], pr[VPT], mur[VPT], precr[VPT], step[VPT];
  bool ok[VPT];
  const float half_eps = 0.5f * eps;
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int j = tx + k * blockDim.x;
    ok[k] = live_row && j < d;
    qr[k] = ok[k] ? q[base + j] : 0.f;
    pr[k] = ok[k] ? p[base + j] : 0.f;
    mur[k] = ok[k] ? mu[j] : 0.f;
    precr[k] = ok[k] ? prec[j] : 0.f;
    step[k] = ok[k] ? eps * inv_mass[j] : 0.f;
  }

  for (int s = 0; s < K; ++s) {
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      const float g0 = -precr[k] * (qr[k] - mur[k]);
      const float p_half = pr[k] + half_eps * g0;
      qr[k] = qr[k] + step[k] * p_half;
      const float g1 = -precr[k] * (qr[k] - mur[k]);
      pr[k] = p_half + half_eps * g1;
    }
  }

  float acc = 0.f;
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    if (ok[k]) {
      const int j = tx + k * blockDim.x;
      q_out[base + j] = qr[k];
      p_out[base + j] = pr[k];
    }
    const float diff = qr[k] - mur[k];
    acc += precr[k] * diff * diff;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    acc += __shfl_down_sync(0xffffffffu, acc, off);
  }
  const int warps_per_row = blockDim.x / 32;
  if ((tx & 31) == 0) row_partial[row * warps_per_row + (tx >> 5)] = acc;
  __syncthreads();
  if (tx == 0 && live_row) {
    float total = 0.f;
    for (int w = 0; w < warps_per_row; ++w) total += row_partial[row * warps_per_row + w];
    logp_out[chain] = -0.5f * total;
  }
}

template <int VPT>
cudaError_t launch(const float* q, const float* p, const float* mu,
                   const float* prec, const float* inv_mass, float eps, int C,
                   int d, int K, float* q_out, float* p_out, float* logp_out,
                   cudaStream_t stream) {
  // threads per row: the coordinates a row needs at VPT per thread,
  // rounded up to whole warps; rows fill the rest of the block
  const int per_row = (d + VPT - 1) / VPT;
  const int tx = ((per_row + 31) / 32) * 32;
  const int ty = kThreads / tx;
  const dim3 block(tx, ty);
  const dim3 grid((C + ty - 1) / ty);
  const size_t shmem = sizeof(float) * ty * (tx / 32);
  fused_leapfrog_kernel<VPT><<<grid, block, shmem, stream>>>(
      q, p, mu, prec, inv_mass, eps, C, d, K, q_out, p_out, logp_out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Largest d the kernel takes: kThreads threads of 16 coordinates each.
int fused_leapfrog_max_d() { return kThreads * 16; }

int fused_leapfrog_gaussian_f32(const float* q, const float* p,
                                const float* mu, const float* prec,
                                const float* inv_mass, float eps, int C, int d,
                                int K, float* q_out, float* p_out,
                                float* logp_out, void* stream) {
  if (C <= 0 || d <= 0 || K < 0 || d > kThreads * 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (d <= kThreads) {
    err = launch<1>(q, p, mu, prec, inv_mass, eps, C, d, K, q_out, p_out, logp_out, s);
  } else if (d <= 2 * kThreads) {
    err = launch<2>(q, p, mu, prec, inv_mass, eps, C, d, K, q_out, p_out, logp_out, s);
  } else if (d <= 4 * kThreads) {
    err = launch<4>(q, p, mu, prec, inv_mass, eps, C, d, K, q_out, p_out, logp_out, s);
  } else if (d <= 8 * kThreads) {
    err = launch<8>(q, p, mu, prec, inv_mass, eps, C, d, K, q_out, p_out, logp_out, s);
  } else {
    err = launch<16>(q, p, mu, prec, inv_mass, eps, C, d, K, q_out, p_out, logp_out, s);
  }
  return static_cast<int>(err);
}

const char* fused_leapfrog_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
