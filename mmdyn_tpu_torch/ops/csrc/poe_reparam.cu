// Fused product-of-experts posterior + reparameterisation over all modality
// subsets, f32.
//
// Replaces the Pallas kernel _poe_kernel (mmdyn_tpu/ops/kernels.py), which
// casts the expert contraction as a (K, M) x (M, Bt*D) MXU matmul. Here
// M <= 4 and K <= 7, so the contraction lives in registers: one thread per
// (b, d) element, grid-strided, loads the M expert means/log-variances once,
// computes each precision T_m once, and loops over the K subsets with the
// (K, M) 0/1 mask held in shared memory.
//
// Per element, for each subset k:
//   var_m = exp(lv_m) + eps,  T_m = 1 / (var_m + eps)   (the double epsilon)
//   S_k   = sum_m mask_km T_m
//   pd_mu = sum_m mask_km mu_m T_m / S_k
//   pd_lv = log(1 / S_k + eps)
//   z     = pd_mu + noise_k * exp(0.5 pd_lv)
//
// Bound by memory bytes: (2M + K) floats read and 3K floats written per
// element, no reuse across elements. Neighbouring threads touch neighbouring
// addresses in every plane, so every load and store is coalesced.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxExperts = 4;
constexpr int kMaxSubsets = 7;

template <int M>
__global__ void poe_reparam_kernel(const float* __restrict__ mu,
                                   const float* __restrict__ lv,
                                   const float* __restrict__ mask,
                                   const float* __restrict__ noise,
                                   float* __restrict__ z,
                                   float* __restrict__ pd_mu,
                                   float* __restrict__ pd_lv,
                                   int n_subsets, long long n, float eps) {
  __shared__ float s_mask[kMaxSubsets * kMaxExperts];
  for (int i = threadIdx.x; i < n_subsets * M; i += blockDim.x) {
    s_mask[i] = mask[i];
  }
  __syncthreads();

  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    float t[M];
    float a[M];
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const float var = expf(lv[m * n + i]) + eps;
      t[m] = 1.0f / (var + eps);
      a[m] = mu[m * n + i] * t[m];
    }
    // issue every noise load before the first store, so the K loads are in
    // flight together rather than one per subset
    float nz[kMaxSubsets];
#pragma unroll
    for (int k = 0; k < kMaxSubsets; ++k) {
      if (k < n_subsets) nz[k] = noise[k * n + i];
    }
#pragma unroll
    for (int k = 0; k < kMaxSubsets; ++k) {
      if (k >= n_subsets) break;
      float s = 0.0f;
      float acc = 0.0f;
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const float w = s_mask[k * M + m];
        s += w * t[m];
        acc += w * a[m];
      }
      const float out_mu = acc / s;
      const float out_lv = logf(1.0f / s + eps);
      const long long o = k * n + i;
      pd_mu[o] = out_mu;
      pd_lv[o] = out_lv;
      z[o] = out_mu + nz[k] * expf(0.5f * out_lv);
    }
  }
}

template <int M>
void launch(const float* mu, const float* lv, const float* mask,
            const float* noise, float* z, float* pd_mu, float* pd_lv,
            int n_subsets, long long n, float eps, cudaStream_t stream) {
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 132 * 16) blocks = 132 * 16;  // grid-stride beyond 16 blocks/SM
  if (blocks < 1) blocks = 1;
  poe_reparam_kernel<M><<<(int)blocks, threads, 0, stream>>>(
      mu, lv, mask, noise, z, pd_mu, pd_lv, n_subsets, n, eps);
}

}  // namespace

// mu, lv: (M, n); mask: (K, M); noise, z, pd_mu, pd_lv: (K, n); n = B * D.
// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for
// M or K out of range).
extern "C" int poe_reparam_f32(const float* mu, const float* lv,
                               const float* mask, const float* noise, float* z,
                               float* pd_mu, float* pd_lv, int n_experts,
                               int n_subsets, long long n, float eps,
                               cudaStream_t stream) {
  if (n_subsets < 1 || n_subsets > kMaxSubsets) return cudaErrorInvalidValue;
  switch (n_experts) {
    case 1: launch<1>(mu, lv, mask, noise, z, pd_mu, pd_lv, n_subsets, n, eps, stream); break;
    case 2: launch<2>(mu, lv, mask, noise, z, pd_mu, pd_lv, n_subsets, n, eps, stream); break;
    case 3: launch<3>(mu, lv, mask, noise, z, pd_mu, pd_lv, n_subsets, n, eps, stream); break;
    case 4: launch<4>(mu, lv, mask, noise, z, pd_mu, pd_lv, n_subsets, n, eps, stream); break;
    default: return cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
