// Weight gradient of a float32 convolution with a 4 x 4 kernel (groups 1,
// dilation 1, stride 1 or 2, padding 0 or 1), as one implicit GEMM summed
// over the batch:
//
//   dW[m, n] = sum_k dY[k, m] * X[k, n],   n = (ci, kh, kw),  k = (b, oh, ow)
//   X[k, n]  = x[b, ci, oh*s - p + kh, ow*s - p + kw]   (0 outside the image)
//
// M = C_out, N = C_in * 16, K = batch * H_out * W_out; x (B, C_in, H, W) and
// dy (B, C_out, H_out, W_out) NCHW contiguous, dW (C_out, C_in, 4, 4). A
// transposed convolution's weight gradient is the same sum with the roles
// swapped (its output gradient as x, its input as dy); the wrapper does that.
//
// Replaces no TPU kernel: XLA computes the JAX package's convolution
// gradients. It was added because cuDNN's deterministic algorithms, which the
// training step needs to rerun bit for bit, leave float32 weight gradients to
// wgrad_alg1 and FFT, at under a third of the card's float32 rate: the fast
// algorithms split the batch sum and add the pieces with atomics.
//
// Bound by FFMA throughput: float32 with TF32 off, so no tensor cores. The
// cnn models' layers are 2 * M * N * K = 6.4 to 215 GFLOP at 2,048 / 8,192
// rows, against 0.1 to 1.4 GB of input. Design:
//   * block tiles of BM x BN (128 x 128, 64 x 128 or 32 x 64, by M), a
//     register tile of 8 x 8 (4 x 4 for the smallest) per thread, 16 k rows
//     a stage;
//   * both operands gathered into shared memory by 4-byte cp.async with zero
//     fill (the image border, the ragged ends of M, N and K), 3 or 4 stages
//     in flight. In a warp, lane / 4 is the k row it loads and lane % 4 the m
//     offset (A) or the tap column kw (B): 32-byte runs of dY, 11- to 18-float
//     runs of x, and conflict-free stores into rows padded by 4 floats. A k
//     row's (b, oh, ow) is two multiply-shift divisions; everything else of
//     an address is set before the loop, in 32-bit offsets;
//   * deterministic split-K: S splits of K, S and the tile a function of
//     (M, N, K) alone (conv_wgrad_f32_splits), never of timing. Split s writes
//     its partial to ws[s] (S x M x N, allocated by the caller), and a second
//     kernel sums the S partials in order s = 0, 1, ... into dW. No atomics:
//     the same inputs give the same bits in every run and every process.
// Both kernels' names contain "wgrad". On the H100 (700 W) the 16 weight
// gradients of a dyn_modeling step at 256 x 8 take 35.0 ms, 55% of their
// 19.2 ms bound; cuDNN's deterministic ones 88.9 ms (PERF.md).

#include <cuda_runtime.h>

extern "C" int conv_wgrad_f32_splits(int m, int n, long long k);
extern "C" int conv_wgrad_f32(const float* x, const float* dy, float* ws, float* dw,
                              int batch, int c, int h, int w, int m, int ho, int wo,
                              int stride, int pad, int splits, cudaStream_t stream);

namespace {

constexpr int kTaps = 4;        // kernel height and width
constexpr int kSMs = 132;       // H100 SXM
constexpr int kMinStagesPerSplit = 16;

// q = n / d and r = n % d for 0 <= n < 2^31 by a multiply and a shift
// (CUTLASS's FastDivmod).
struct Divmod {
  unsigned d, mul, shift;
};

Divmod make_divmod(unsigned d) {
  Divmod f{d, 0u, 0u};
  if (d != 1) {
    unsigned l = 0;
    while ((1u << l) < d) ++l;             // ceil(log2 d)
    const unsigned p = 31 + l;
    f.mul = (unsigned)(((1ull << p) + d - 1) / d);
    f.shift = p - 32;
  }
  return f;
}

__device__ __forceinline__ void divmod(const Divmod& f, int n, int& q, int& r) {
  q = f.d == 1 ? n : (int)(__umulhi((unsigned)n, f.mul) >> f.shift);
  r = n - q * (int)f.d;
}

// Offsets are 32-bit: the wrapper keeps x, dy and the workspace under 2^31
// elements.
struct Problem {
  const float* x;
  const float* dy;
  float* ws;
  int m, n, c, h, w, stride, pad;
  int plane;                   // H_out * W_out
  int hw;                      // H * W
  int k_total, k_split;        // K, and K a split (a multiple of the tile's BK)
  Divmod by_plane, by_wo;
};

// Zero-fills the 4 bytes at dst when !valid, without reading src.
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               ::"r"(s), "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// A block tile of BM x BN outputs, TM x TN per thread, BK k rows a stage,
// kStages stages in flight; kResident blocks an SM holds at once (the launch
// bounds cap the registers to fit).
template <int BM_, int BN_, int TM_, int TN_, int BK_, int kStages_, int kResident_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, TM = TM_, TN = TN_, BK = BK_;
  static constexpr int kStages = kStages_, kResident = kResident_;
  static constexpr int kThreads = (BM / TM) * (BN / TN);
  static constexpr int kWarps = kThreads / 32;
  static constexpr int kAPer = BM / (4 * kWarps);         // A loads a k row
  static constexpr int kBPer = (BN / kTaps) / kWarps;     // B loads a k row
  static constexpr int kLda = BM + 4, kLdb = BN + 4;
  static constexpr int kSmem = kStages * BK * (kLda + kLdb) * (int)sizeof(float);
  static_assert(kThreads % 32 == 0 && BK % 8 == 0, "tile");
  static_assert(BM % (4 * kWarps) == 0 && (BN / kTaps) % kWarps == 0, "tile");
  static_assert(TM % 4 == 0 && TN % 4 == 0 && BN % 16 == 0, "float4 fragments");
};

template <class T>
__global__ void __launch_bounds__(T::kThreads, T::kResident)
wgrad_splitk_kernel(Problem pr) {
  constexpr int BM = T::BM, BN = T::BN, TM = T::TM, TN = T::TN, BK = T::BK;
  constexpr int W = T::kWarps, kStages = T::kStages;
  extern __shared__ __align__(16) float smem[];
  float* const As = smem;                          // [kStages][BK][kLda]
  float* const Bs = smem + kStages * BK * T::kLda; // [kStages][BK][kLdb]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int sub = lane & 3;         // the m offset (A) and tap column kw (B)
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int k_begin = blockIdx.z * pr.k_split;
  const int k_end = min(k_begin + pr.k_split, pr.k_total);
  const int stages = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;

  // A: rows m = m0 + sub + 4 * (warp + W * i) of dY
  const int a_m = m0 + sub + 4 * warp;
  const int a_off = a_m * pr.plane;
  const int a_image = pr.m * pr.plane;
  unsigned a_ok = 0;
#pragma unroll
  for (int i = 0; i < T::kAPer; ++i) a_ok |= (unsigned)(a_m + 4 * W * i < pr.m) << i;
  // B: tap groups q = n0 / 4 + warp + W * j of x, q = ci * 4 + kh
  const int b_image = pr.c * pr.hw;
  int b_off[T::kBPer], b_kh[T::kBPer];
  unsigned b_ok = 0;
#pragma unroll
  for (int j = 0; j < T::kBPer; ++j) {
    const int q = n0 / kTaps + warp + W * j;
    b_kh[j] = q & 3;
    b_off[j] = (q >> 2) * pr.hw + b_kh[j] * pr.w;
    b_ok |= (unsigned)((q >> 2) < pr.c) << j;
  }

  // the k rows lane / 4 + 8 r of stage t
  auto load = [&](int stage, int t) {
#pragma unroll
    for (int r = 0; r < BK / 8; ++r) {
      const int row = (lane >> 2) + 8 * r;
      const int k = k_begin + t * BK + row;
      const bool kv = k < k_end;
      int b, p, oh, ow;
      divmod(pr.by_plane, kv ? k : 0, b, p);
      divmod(pr.by_wo, p, oh, ow);
      const float* a_src = pr.dy + (b * a_image + p + a_off);
      float* a_dst = As + (stage * BK + row) * T::kLda + sub + 4 * warp;
#pragma unroll
      for (int i = 0; i < T::kAPer; ++i)
        cp_async4(a_dst + 4 * W * i, a_src + i * 4 * W * pr.plane, kv && (a_ok >> i & 1));
      const int ih = oh * pr.stride - pr.pad;
      const int iw = ow * pr.stride - pr.pad + sub;
      const bool wv = kv && (unsigned)iw < (unsigned)pr.w;
      const float* b_src = pr.x + (b * b_image + ih * pr.w + iw);
      float* b_dst = Bs + (stage * BK + row) * T::kLdb + kTaps * warp + sub;
#pragma unroll
      for (int j = 0; j < T::kBPer; ++j)
        cp_async4(b_dst + kTaps * W * j, b_src + b_off[j],
                  wv && (b_ok >> j & 1) && (unsigned)(ih + b_kh[j]) < (unsigned)pr.h);
    }
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  constexpr int kTx = BN / TN;
  const int tx = tid % kTx, ty = tid / kTx;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < stages) load(s, s);
    cp_async_commit();
  }
  for (int t = 0; t < stages; ++t) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int next = t + kStages - 1;
    if (next < stages) load(next % kStages, next);
    cp_async_commit();
    const float* a_st = As + (t % kStages) * BK * T::kLda + ty * 4;
    const float* b_st = Bs + (t % kStages) * BK * T::kLdb + tx * 4;
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int c = 0; c < TM / 4; ++c)
        *reinterpret_cast<float4*>(&a[4 * c]) = *reinterpret_cast<const float4*>(
            a_st + kk * T::kLda + c * (BM / (TM / 4)));
#pragma unroll
      for (int c = 0; c < TN / 4; ++c)
        *reinterpret_cast<float4*>(&b[4 * c]) = *reinterpret_cast<const float4*>(
            b_st + kk * T::kLdb + c * (BN / (TN / 4)));
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();

  float* out = pr.ws + blockIdx.z * pr.m * pr.n;
#pragma unroll
  for (int ci = 0; ci < TM / 4; ++ci)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int mm = m0 + ty * 4 + ci * (BM / (TM / 4)) + i;
      if (mm >= pr.m) continue;
#pragma unroll
      for (int cj = 0; cj < TN / 4; ++cj) {
        const int nn = n0 + tx * 4 + cj * (BN / (TN / 4));
        if (nn >= pr.n) continue;        // N is a multiple of 16: whole float4s
        const int r = 4 * ci + i;
        *reinterpret_cast<float4*>(&out[mm * pr.n + nn]) = make_float4(
            acc[r][4 * cj], acc[r][4 * cj + 1], acc[r][4 * cj + 2], acc[r][4 * cj + 3]);
      }
    }
}

// dw[i] = ws[0][i] + ws[1][i] + ... + ws[S-1][i], in that order.
__global__ void wgrad_reduce_kernel(const float4* __restrict__ ws, float4* __restrict__ dw,
                                    int mn4, int splits) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= mn4) return;
  float4 s = ws[i];
  for (int k = 1; k < splits; ++k) {
    const float4 v = ws[k * mn4 + i];
    s.x += v.x;
    s.y += v.y;
    s.z += v.z;
    s.w += v.w;
  }
  dw[i] = s;
}

// The tiles, by M: the cnn models' C_out of 128 and 256, 64, and 32 or 3.
using Big = Tile<128, 128, 8, 8, 16, 3, 2>;
using Mid = Tile<64, 128, 8, 8, 16, 4, 4>;
using Small = Tile<32, 64, 4, 4, 16, 4, 8>;

template <class T>
long long splits_for(int m, int n, long long k) {
  const long long tiles = (long long)((m + T::BM - 1) / T::BM) * ((n + T::BN - 1) / T::BN);
  const long long k_stages = (k + T::BK - 1) / T::BK;
  long long splits = 2LL * kSMs * T::kResident / tiles;      // two waves
  const long long most = k_stages / kMinStagesPerSplit;
  if (splits > most) splits = most;
  if (splits < 1) splits = 1;
  return splits > 65535 ? 65535 : splits;
}

template <class T>
int launch(Problem pr, int splits, cudaStream_t stream) {
  const int k_stages = (pr.k_total + T::BK - 1) / T::BK;
  pr.k_split = (k_stages + splits - 1) / splits * T::BK;
  auto kernel = wgrad_splitk_kernel<T>;
  if (T::kSmem > 48 * 1024) {          // above 48 KB only when asked for
    const int err = (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
    if (err != 0) return err;
  }
  const dim3 grid((pr.n + T::BN - 1) / T::BN, (pr.m + T::BM - 1) / T::BM, splits);
  kernel<<<grid, T::kThreads, T::kSmem, stream>>>(pr);
  return (int)cudaGetLastError();
}

}  // namespace

// The split count, a function of the GEMM's shape alone: at most two waves
// of the card's resident blocks, each split at least kMinStagesPerSplit
// stages of K (one split where K is short).
extern "C" int conv_wgrad_f32_splits(int m, int n, long long k) {
  if (m > 64) return (int)splits_for<Big>(m, n, k);
  if (m > 32) return (int)splits_for<Mid>(m, n, k);
  return (int)splits_for<Small>(m, n, k);
}

extern "C" int conv_wgrad_f32(const float* x, const float* dy, float* ws, float* dw,
                              int batch, int c, int h, int w, int m, int ho, int wo,
                              int stride, int pad, int splits, cudaStream_t stream) {
  Problem pr;
  pr.x = x;
  pr.dy = dy;
  pr.ws = ws;
  pr.m = m;
  pr.n = c * kTaps * kTaps;
  pr.c = c;
  pr.h = h;
  pr.w = w;
  pr.stride = stride;
  pr.pad = pad;
  pr.plane = ho * wo;
  pr.hw = h * w;
  pr.k_total = batch * ho * wo;
  pr.k_split = 0;
  pr.by_plane = make_divmod((unsigned)pr.plane);
  pr.by_wo = make_divmod((unsigned)wo);
  const int err = m > 64   ? launch<Big>(pr, splits, stream)
                  : m > 32 ? launch<Mid>(pr, splits, stream)
                           : launch<Small>(pr, splits, stream);
  if (err != 0) return err;
  const int mn4 = pr.m * pr.n / 4;
  wgrad_reduce_kernel<<<(mn4 + 255) / 256, 256, 0, stream>>>(
      reinterpret_cast<const float4*>(ws), reinterpret_cast<float4*>(dw), mn4, splits);
  return (int)cudaGetLastError();
}
