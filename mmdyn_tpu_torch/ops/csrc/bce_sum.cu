// Sum-reduced BCE-with-logits of (K, B*P) logits against a (B*P) target
// shared over the K subsets, with an optional (B*P) mask multiplying both
// sides; f32 or bf16 logits, f32 target, mask and sum, f32 math:
//
//   sum_{k,j} max(x, 0) - x * t + log1p(exp(-|x|)),
//   x = logits[k, j] * m[j],  t = target[j] * m[j]
//
// Replaces the Pallas kernels _bce_kernel / _bce_kernel_nomask
// (mmdyn_tpu/ops/kernels.py), which accumulate into one SMEM scalar across a
// sequential TPU grid. GPU blocks run in no order, so the sum is taken in two
// passes with no float atomics, and is bit-identical from run to run:
//
//   pass 1: a fixed grid of blocks walks j grid-strided; each thread loads
//           target[j] (and mask[j]) once and the K logits of column j, so the
//           target is never broadcast over K. Threads reduce with warp
//           shuffles, warps through shared memory, and each block writes one
//           partial.
//   pass 2: one block sums the partials in a fixed order.
//
// Bound by memory bytes: K*B*P logits + B*P target (+ B*P mask) read once.
//
// The logits' element type is a template parameter: float for the float32
// and bfloat16 activation policies, __nv_bfloat16 for bfloat16_full, whose
// decoders emit bf16 logits (the JAX package upcasts them inside its fused
// reduce, mmdyn_tpu/ops/kernels.py::_bce_jnp). Both instantiations share the
// grid, the block size, the partial count and the fixed-order second pass,
// so either gives the same bits on every run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

extern "C" int bce_sum_num_partials(long long row);

namespace {

constexpr int kThreads = 256;
constexpr int kMaxPartials = 1024;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// Sum of v over the block, valid in thread 0. blockDim.x == kThreads.
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float s_warp[kThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) s_warp[warp] = v;
  __syncthreads();
  v = threadIdx.x < kThreads / 32 ? s_warp[threadIdx.x] : 0.0f;
  if (warp == 0) v = warp_sum(v);
  return v;
}

__device__ __forceinline__ float bce(float x, float t) {
  return fmaxf(x, 0.0f) - x * t + log1pf(expf(-fabsf(x)));
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__global__ void bce_partial_kernel(const T* __restrict__ logits,
                                   const float* __restrict__ target,
                                   const float* __restrict__ mask,
                                   float* __restrict__ partials, int k_rows,
                                   long long row) {
  float acc = 0.0f;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x; j < row;
       j += stride) {
    const float m = mask != nullptr ? mask[j] : 1.0f;
    const float t = target[j] * m;
    for (int k = 0; k < k_rows; ++k) {
      acc += bce(to_float(logits[k * row + j]) * m, t);
    }
  }
  acc = block_sum(acc);
  if (threadIdx.x == 0) partials[blockIdx.x] = acc;
}

__global__ void bce_final_kernel(const float* __restrict__ partials,
                                 int n_partials, float* __restrict__ out) {
  float acc = 0.0f;
  for (int i = threadIdx.x; i < n_partials; i += blockDim.x) acc += partials[i];
  acc = block_sum(acc);
  if (threadIdx.x == 0) out[0] = acc;
}

template <typename T>
int bce_sum(const T* logits, const float* target, const float* mask, float* partials,
            float* out, int k_rows, long long row, cudaStream_t stream) {
  const int blocks = bce_sum_num_partials(row);
  bce_partial_kernel<T><<<blocks, kThreads, 0, stream>>>(logits, target, mask,
                                                         partials, k_rows, row);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bce_final_kernel<<<1, kThreads, 0, stream>>>(partials, blocks, out);
  return (int)cudaGetLastError();
}

}  // namespace

// The number of pass-1 blocks (and partials) for a row of `row` elements:
// depends on the shape only, so the summation order is fixed for a shape.
extern "C" int bce_sum_num_partials(long long row) {
  long long blocks = (row + kThreads - 1) / kThreads;
  if (blocks > kMaxPartials) blocks = kMaxPartials;
  return blocks < 1 ? 1 : (int)blocks;
}

// logits: (k_rows, row); target, mask: (row), mask may be null;
// partials: bce_sum_num_partials(row) floats of scratch; out: one float.
extern "C" int bce_sum_f32(const float* logits, const float* target,
                           const float* mask, float* partials, float* out,
                           int k_rows, long long row, cudaStream_t stream) {
  return bce_sum(logits, target, mask, partials, out, k_rows, row, stream);
}

// The same with bf16 logits.
extern "C" int bce_sum_bf16(const __nv_bfloat16* logits, const float* target,
                            const float* mask, float* partials, float* out,
                            int k_rows, long long row, cudaStream_t stream) {
  return bce_sum(logits, target, mask, partials, out, k_rows, row, stream);
}
