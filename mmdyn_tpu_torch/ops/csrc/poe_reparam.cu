// Fused product-of-experts posterior + reparameterisation over all modality
// subsets, f32.
//
// Replaces the Pallas kernel _poe_kernel (mmdyn_tpu/ops/kernels.py:86), which
// casts the expert contraction as a (K, M) x (M, Bt*D) MXU matmul. Here
// M <= 4 and K <= 7, so the contraction lives in registers.
//
// Per element, for each subset k:
//   var_m = exp(lv_m) + eps,  T_m = 1 / (var_m + eps)   (the double epsilon)
//   S_k   = sum_m mask_km T_m
//   pd_mu = sum_m mask_km mu_m T_m / S_k
//   pd_lv = log(1 / S_k + eps)
//   z     = pd_mu + noise_k * exp(0.5 pd_lv)
//
// Bound by memory bytes on paper: (2M + K) floats read and 3K floats written
// per element, no reuse across elements; at M=4, K=7, B=512, D=256 that is
// 18.9 MB, 5.6 us at the H100's 3.35 TB/s.
//
// At that shape the kernel is not a stream: its 131,072 elements are one
// wave of the card, so its time is one chain: every thread's loads, then
// every thread's arithmetic (18 IEEE divisions, 7 logf and 11 expf per
// element), then the stores. What the design does:
//   * one element per thread: 4,096 warps, about 8 per scheduler, the most
//     the shape offers to hide the divide / log / exp latencies (4 or 8
//     elements per thread in float4 accesses, and bulk copies through shared
//     memory, measured slower on the card: PERF.md);
//   * M and K are template parameters, so the K subsets are straight-line
//     code the compiler can interleave (behind a runtime K bound they run
//     one after another);
//   * no prologue: the K*M <= 28 mask floats come through the read-only path
//     (L1-resident after the first warp), issued with the 2M + K data loads,
//     all before any arithmetic, not staged in shared memory behind a barrier;
//   * neighbouring threads touch neighbouring floats of every plane, so each
//     warp access is one 128-byte line, and any n and any float-aligned
//     pointer (an offset view, a ragged B * D) take the same path.

#include <cuda_runtime.h>

namespace {

// 128 threads per block: 64 and 256 read within the run-to-run spread at
// the flagship shape (PERF.md).
constexpr int kThreads = 128;

// mu, lv: (M, n); mask: (K, M); noise, z, pd_mu, pd_lv: (K, n). One thread
// per element i of every plane.
template <int M, int K>
__global__ void __launch_bounds__(kThreads)
poe_reparam_kernel(const float* __restrict__ mu, const float* __restrict__ lv,
                   const float* __restrict__ mask, const float* __restrict__ noise,
                   float* __restrict__ z, float* __restrict__ pd_mu,
                   float* __restrict__ pd_lv, long long n, float eps) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;

  // every load first: mask, experts, noise
  float w[K][M], x_mu[M], x_lv[M], x_nz[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int m = 0; m < M; ++m) w[k][m] = __ldg(mask + k * M + m);
  }
#pragma unroll
  for (int m = 0; m < M; ++m) {
    x_mu[m] = __ldg(mu + m * n + i);
    x_lv[m] = __ldg(lv + m * n + i);
  }
#pragma unroll
  for (int k = 0; k < K; ++k) x_nz[k] = __ldg(noise + k * n + i);

  float t[M], a[M];
#pragma unroll
  for (int m = 0; m < M; ++m) {
    const float var = expf(x_lv[m]) + eps;
    t[m] = 1.0f / (var + eps);
    a[m] = x_mu[m] * t[m];
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float s = 0.0f;
    float acc = 0.0f;
#pragma unroll
    for (int m = 0; m < M; ++m) {
      s += w[k][m] * t[m];
      acc += w[k][m] * a[m];
    }
    const float out_mu = acc / s;
    const float out_lv = logf(1.0f / s + eps);
    pd_mu[k * n + i] = out_mu;
    pd_lv[k * n + i] = out_lv;
    z[k * n + i] = out_mu + x_nz[k] * expf(0.5f * out_lv);
  }
}

template <int M, int K>
int launch(const float* mu, const float* lv, const float* mask,
           const float* noise, float* z, float* pd_mu, float* pd_lv,
           long long n, float eps, cudaStream_t stream) {
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (blocks == 0) return cudaSuccess;  // no elements, nothing to launch
  poe_reparam_kernel<M, K><<<(unsigned)blocks, kThreads, 0, stream>>>(
      mu, lv, mask, noise, z, pd_mu, pd_lv, n, eps);
  return (int)cudaGetLastError();
}

template <int M>
int launch_k(int n_subsets, const float* mu, const float* lv,
             const float* mask, const float* noise, float* z, float* pd_mu,
             float* pd_lv, long long n, float eps, cudaStream_t stream) {
  switch (n_subsets) {
#define POE_K(K)                                                              \
  case K:                                                                     \
    return launch<M, K>(mu, lv, mask, noise, z, pd_mu, pd_lv, n, eps, stream);
    POE_K(1) POE_K(2) POE_K(3) POE_K(4) POE_K(5) POE_K(6) POE_K(7)
#undef POE_K
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// mu, lv: (M, n); mask: (K, M); noise, z, pd_mu, pd_lv: (K, n); n = B * D;
// M <= 4, K <= 7. Returns cudaGetLastError() after the launch (cudaSuccess
// without one for n = 0), or cudaErrorInvalidValue for arguments out of
// range.
extern "C" int poe_reparam_f32(const float* mu, const float* lv,
                               const float* mask, const float* noise, float* z,
                               float* pd_mu, float* pd_lv, int n_experts,
                               int n_subsets, long long n, float eps,
                               cudaStream_t stream) {
  if (n < 0) return cudaErrorInvalidValue;
  switch (n_experts) {
#define POE_M(M)                                                              \
  case M:                                                                     \
    return launch_k<M>(n_subsets, mu, lv, mask, noise, z, pd_mu, pd_lv, n,    \
                       eps, stream);
    POE_M(1) POE_M(2) POE_M(3) POE_M(4)
#undef POE_M
    default:
      return cudaErrorInvalidValue;
  }
}
