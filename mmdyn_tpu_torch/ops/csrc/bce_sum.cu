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
//   pass 1: a fixed grid of blocks walks the columns grid-strided; each
//           thread loads target[j] (and mask[j]) once for the K logits of
//           column j, so the target is never broadcast over K. Threads reduce
//           with warp shuffles, warps through shared memory, and each block
//           writes one partial. The partial count is a function of the shape.
//   pass 2: one block sums the partials in a fixed order.
//
// Both element types are bound by memory bytes: K*B*P logits + B*P target
// (+ B*P mask) read once.
//
// float32 logits (bce_sum_f32; the float32 and bfloat16 policies): one column
// per thread and iteration, scalar loads, accurate expf / log1pf. At K=4,
// B=512, P=12288 its bound is 125.8 MB, 37.6 us at 3.35 TB/s.
//
// bf16 logits (bce_sum_bf16; bfloat16_full, whose decoders emit bf16 logits;
// the JAX package upcasts them inside its fused reduce, _bce_jnp). Bound:
// 75.5 MB, 22.5 us at 3.35 TB/s at the same shape. The f32 design on bf16
// logits read no faster than on f32 ones (73 us, 31% of the bound): its
// 2-byte scalar loads made 64-byte warp requests, one column's K + 1 loads in
// flight per thread, and each logit cost some 55 SASS instructions (accurate
// expf and log1pf). This design (34 us, 67%; PERF.md):
//   * loads in flight: each thread takes a group of 8 consecutive columns and
//     issues one 16-byte load of 8 bf16 logits per row and two of the target
//     (two more of the mask) before any arithmetic: 512-byte warp requests.
//     Two groups per iteration read 4% slower (72 registers against 48, so
//     fewer warps in flight). This path needs every row, the target and the
//     mask on 16-byte boundaries (row % 8 == 0 and aligned bases, as on every
//     main path); any other input takes a scalar-load instantiation of the
//     same kernel, with the same arithmetic and the ragged last group's
//     missing columns left out.
//   * instructions per logit: exp(-|x|) is one ex2.approx of a pre-scaled
//     argument, and the group's sum of log1p(e) is one lg2.approx of the
//     product of its 8K factors (1 + e), each in (1, 2]: at most 2^(8K), far
//     from overflow. 8 SASS instructions per logit where the f32 design
//     took 55; with the accurate expf / log1pf the 16-byte loads alone
//     read 50 us. Error: ex2 / lg2.approx add about 2^-22 relative /
//     absolute, the product's roundings at most 8K * 2^-24 relative, and an
//     e under 2^-24 is lost in 1 + e (at most 6e-8 per logit); the sums
//     agree with the plain version's to a few 1e-7 relative (PERF.md).
//   * K (1..7: the MVAE's at most 7 subsets) and the mask are template
//     parameters: straight-line rows and no mask multiply where there is
//     none.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

extern "C" int bce_sum_num_partials(long long row);
extern "C" int bce_sum_bf16_num_partials(long long row);

namespace {

constexpr int kThreads = 256;
constexpr int kMaxPartials = 1024;
constexpr int kGroup = 8;              // bf16 columns in one 16-byte load
constexpr float kLog2e = 1.442695040888963f;
constexpr float kLn2 = 0.6931471805599453f;

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

// ---------------------------------------------------------------------------
// float32 logits
// ---------------------------------------------------------------------------

__device__ __forceinline__ float bce(float x, float t) {
  return fmaxf(x, 0.0f) - x * t + log1pf(expf(-fabsf(x)));
}

__global__ void bce_partial_kernel(const float* __restrict__ logits,
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
      acc += bce(logits[k * row + j] * m, t);
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

// ---------------------------------------------------------------------------
// bf16 logits
// ---------------------------------------------------------------------------

__device__ __forceinline__ float ex2_approx(float a) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(a));
  return r;
}

__device__ __forceinline__ float lg2_approx(float a) {
  float r;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(a));
  return r;
}

// The raw inputs of one group of kGroup consecutive columns.
template <int kK>
struct Group {
  uint32_t x[kK][kGroup / 2];   // bf16 pairs: column 2q in the low half
  float t[kGroup];
  float m[kGroup];
  int valid;                    // columns of the group inside the row
};

// 16-byte loads: row % kGroup == 0 and 16-byte-aligned bases.
template <int kK, bool kMask>
__device__ __forceinline__ void load_vec(Group<kK>& g, const __nv_bfloat16* logits,
                                         const float* target, const float* mask,
                                         long long row, long long j0) {
#pragma unroll
  for (int k = 0; k < kK; ++k) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(logits + k * row + j0));
    g.x[k][0] = v.x;
    g.x[k][1] = v.y;
    g.x[k][2] = v.z;
    g.x[k][3] = v.w;
  }
  const float4* t4 = reinterpret_cast<const float4*>(target + j0);
  const float4 ta = __ldg(t4), tb = __ldg(t4 + 1);
  g.t[0] = ta.x; g.t[1] = ta.y; g.t[2] = ta.z; g.t[3] = ta.w;
  g.t[4] = tb.x; g.t[5] = tb.y; g.t[6] = tb.z; g.t[7] = tb.w;
  if constexpr (kMask) {
    const float4* m4 = reinterpret_cast<const float4*>(mask + j0);
    const float4 ma = __ldg(m4), mb = __ldg(m4 + 1);
    g.m[0] = ma.x; g.m[1] = ma.y; g.m[2] = ma.z; g.m[3] = ma.w;
    g.m[4] = mb.x; g.m[5] = mb.y; g.m[6] = mb.z; g.m[7] = mb.w;
  }
  g.valid = kGroup;
}

// Scalar loads, any row and any element-aligned bases; the columns past the
// row's end read as zeros.
template <int kK, bool kMask>
__device__ __forceinline__ void load_scalar(Group<kK>& g, const __nv_bfloat16* logits,
                                            const float* target, const float* mask,
                                            long long row, long long j0) {
  const unsigned short* raw = reinterpret_cast<const unsigned short*>(logits);
  const int valid = row - j0 < kGroup ? (int)(row - j0) : kGroup;
#pragma unroll
  for (int k = 0; k < kK; ++k) {
#pragma unroll
    for (int q = 0; q < kGroup / 2; ++q) {
      const uint32_t lo = 2 * q < valid ? __ldg(raw + k * row + j0 + 2 * q) : 0u;
      const uint32_t hi = 2 * q + 1 < valid ? __ldg(raw + k * row + j0 + 2 * q + 1) : 0u;
      g.x[k][q] = lo | (hi << 16);
    }
  }
#pragma unroll
  for (int i = 0; i < kGroup; ++i) {
    g.t[i] = i < valid ? __ldg(target + j0 + i) : 0.0f;
    if constexpr (kMask) g.m[i] = i < valid ? __ldg(mask + j0 + i) : 0.0f;
  }
  g.valid = valid;
}

// The group's loss: sum_i [sum_k max(x, 0)] - t_i * [sum_k x] plus
// ln 2 * lg2(prod_{k,i} (1 + exp(-|x|))). A column past the row's end has
// x = t = 0 and leaves its factors out of the product.
template <int kK, bool kMask, bool kTail>
__device__ __forceinline__ float group_loss(const Group<kK>& g) {
  float p[kK];
#pragma unroll
  for (int k = 0; k < kK; ++k) p[k] = 1.0f;
  float relu = 0.0f, dot = 0.0f;
#pragma unroll
  for (int i = 0; i < kGroup; ++i) {
    float sx = 0.0f;
#pragma unroll
    for (int k = 0; k < kK; ++k) {
      const uint32_t w = g.x[k][i / 2];
      float x = __uint_as_float(i % 2 ? w & 0xffff0000u : w << 16);
      if constexpr (kMask) x *= g.m[i];
      const float e = ex2_approx(-fabsf(x) * kLog2e);
      if (!kTail || i < g.valid) p[k] = fmaf(p[k], e, p[k]);
      relu += fmaxf(x, 0.0f);
      sx += x;
    }
    float t = g.t[i];
    if constexpr (kMask) t *= g.m[i];
    dot = fmaf(t, sx, dot);
  }
  float prod = p[0];
#pragma unroll
  for (int k = 1; k < kK; ++k) prod *= p[k];
  return relu - dot + kLn2 * lg2_approx(prod);
}

template <int kK, bool kMask, bool kVec>
__global__ void __launch_bounds__(kThreads)
bce_partial_bf16_kernel(const __nv_bfloat16* __restrict__ logits,
                        const float* __restrict__ target,
                        const float* __restrict__ mask,
                        float* __restrict__ partials, long long row) {
  const long long groups = (row + kGroup - 1) / kGroup;
  const long long stride = (long long)gridDim.x * kThreads;
  float acc = 0.0f;
  for (long long g = (long long)blockIdx.x * kThreads + threadIdx.x; g < groups;
       g += stride) {
    Group<kK> grp;                 // every load of the group, then the math
    if constexpr (kVec) {
      load_vec<kK, kMask>(grp, logits, target, mask, row, g * kGroup);
    } else {
      load_scalar<kK, kMask>(grp, logits, target, mask, row, g * kGroup);
    }
    acc += group_loss<kK, kMask, !kVec>(grp);
  }
  acc = block_sum(acc);
  if (threadIdx.x == 0) partials[blockIdx.x] = acc;
}

// Checks the pass-1 launch just made, then launches pass 2.
int final_pass(const float* partials, int n_partials, float* out, cudaStream_t stream) {
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bce_final_kernel<<<1, kThreads, 0, stream>>>(partials, n_partials, out);
  return (int)cudaGetLastError();
}

template <int kK, bool kMask, bool kVec>
int launch_bf16(const __nv_bfloat16* logits, const float* target, const float* mask,
                float* partials, float* out, long long row, cudaStream_t stream) {
  const int blocks = bce_sum_bf16_num_partials(row);
  bce_partial_bf16_kernel<kK, kMask, kVec><<<blocks, kThreads, 0, stream>>>(
      logits, target, mask, partials, row);
  return final_pass(partials, blocks, out, stream);
}

template <int kK>
int bce_sum_bf16_rows(const __nv_bfloat16* logits, const float* target,
                      const float* mask, float* partials, float* out, long long row,
                      cudaStream_t stream) {
  const bool vec = row % kGroup == 0 &&
                   ((uintptr_t)logits | (uintptr_t)target | (uintptr_t)mask) % 16 == 0;
  if (mask != nullptr) {
    return vec ? launch_bf16<kK, true, true>(logits, target, mask, partials, out, row, stream)
               : launch_bf16<kK, true, false>(logits, target, mask, partials, out, row, stream);
  }
  return vec ? launch_bf16<kK, false, true>(logits, target, mask, partials, out, row, stream)
             : launch_bf16<kK, false, false>(logits, target, mask, partials, out, row, stream);
}

}  // namespace

// The number of pass-1 blocks (and partials) for a row of `row` elements:
// depends on the shape only, so the summation order is fixed for a shape.
extern "C" int bce_sum_num_partials(long long row) {
  long long blocks = (row + kThreads - 1) / kThreads;
  if (blocks > kMaxPartials) blocks = kMaxPartials;
  return blocks < 1 ? 1 : (int)blocks;
}

// The same for bf16 logits, whose threads take groups of kGroup columns.
extern "C" int bce_sum_bf16_num_partials(long long row) {
  return bce_sum_num_partials((row + kGroup - 1) / kGroup);
}

// logits: (k_rows, row); target, mask: (row), mask may be null;
// partials: bce_sum_num_partials(row) floats of scratch; out: one float.
extern "C" int bce_sum_f32(const float* logits, const float* target,
                           const float* mask, float* partials, float* out,
                           int k_rows, long long row, cudaStream_t stream) {
  const int blocks = bce_sum_num_partials(row);
  bce_partial_kernel<<<blocks, kThreads, 0, stream>>>(logits, target, mask,
                                                      partials, k_rows, row);
  return final_pass(partials, blocks, out, stream);
}

// The same with bf16 logits, 1 <= k_rows <= 7; partials:
// bce_sum_bf16_num_partials(row) floats.
extern "C" int bce_sum_bf16(const __nv_bfloat16* logits, const float* target,
                            const float* mask, float* partials, float* out,
                            int k_rows, long long row, cudaStream_t stream) {
  switch (k_rows) {
    case 1: return bce_sum_bf16_rows<1>(logits, target, mask, partials, out, row, stream);
    case 2: return bce_sum_bf16_rows<2>(logits, target, mask, partials, out, row, stream);
    case 3: return bce_sum_bf16_rows<3>(logits, target, mask, partials, out, row, stream);
    case 4: return bce_sum_bf16_rows<4>(logits, target, mask, partials, out, row, stream);
    case 5: return bce_sum_bf16_rows<5>(logits, target, mask, partials, out, row, stream);
    case 6: return bce_sum_bf16_rows<6>(logits, target, mask, partials, out, row, stream);
    case 7: return bce_sum_bf16_rows<7>(logits, target, mask, partials, out, row, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
