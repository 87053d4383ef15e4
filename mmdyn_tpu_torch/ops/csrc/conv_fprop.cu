// Forward of a float32 convolution with a 4 x 4 kernel (groups 1, dilation 1,
// stride 1 or 2, padding 0 or 1), as one implicit GEMM on the tensor cores:
//
//   Y[b, co, oh, ow] = sum over (ci, kh, kw) of X[b, ci, oh*s - p + kh, ow*s - p + kw]
//                                              * W[co, ci, kh, kw]   (0 outside the image)
//
// M = batch * H_out * W_out (the output pixels), N = C_out, K = C_in * 16,
// k = (ci, kh, kw) in W's own order; x (B, C_in, H, W) and w (C_out, C_in, 4,
// 4) NCHW contiguous, y (B, C_out, H_out, W_out). A transposed convolution's
// data gradient is the same sum, its output gradient as x and its weight
// (C_in, C_out, 4, 4) as w; the wrapper does that.
//
// Replaces no TPU kernel: XLA computes the JAX package's convolutions. It was
// added because cuDNN's float32 forward (sm80_xmma_fprop_implicit_gemm and,
// for 3 input channels, implicit_convolve_sgemm) ran on FFMA: 33.1 ms of a
// 140 ms dyn_modeling step at 256 x 8, the last library kernels of the
// float32 convolutions.
//
// Bound: on FFMA the cnn models' 16 calls of that step are 1.29 TFLOP, 19.2 ms
// at 67 TFLOP/s. This kernel runs them on the tensor cores in TF32 (495
// TFLOP/s), three products a term: 3.87 TFLOP, 7.8 ms; the two 3-channel
// calls are bound by bytes (0.11 and 0.44 ms at 3.35 TB/s).
//
// Precision. Each operand is split as v = hi + lo, hi = v rounded to TF32 and
// lo = v - hi (exact in float32) rounded to TF32, so v - (hi + lo) is within
// 2^-22 |v|. A term x * w is taken as hi_x hi_w + hi_x lo_w + lo_x hi_w,
// dropping lo_x lo_w (under 2^-22 of the term); the tensor cores multiply
// TF32 values exactly. The rest is additions. The tensor cores' own additions
// truncate: chained through all of K = 2,048 in one accumulator the sums
// read 1.6e-5 to 1.8e-5 of the largest output from float64 (PERF.md). So
// each 32 rows of k (four k8 steps, three products each: hi_x lo_w, lo_x
// hi_w, hi_x hi_w) go into a fresh fragment, which is then added into a
// float32 accumulator with a rounded add, chunk after chunk in the order of
// k. At the 16 calls of a dyn step the gap to float64 reads 3.0e-7 to 5.3e-7
// of the largest output, under cuDNN's float32 FFMA forward's 3.1e-7 to
// 2.3e-6; cuDNN's plain TF32 reads 2.8e-4 to 3.2e-4 (PERF.md).
//
// Design (sm_90a):
//   * the weight is split once per call by fprop_split_kernel into a
//     workspace laid out as the kernel's stages: for each channel tile and
//     16 rows of k one contiguous block, hi then lo, each BN x 16 in the 8 x
//     16-byte core matrices of a wgmma operand, zero past N and K; a stage's
//     block is copied by 16-byte cp.async as it is;
//   * x is gathered per stage into shared memory by 4-byte cp.async with zero
//     fill (the image border, the ragged ends of M and K), 16 rows of k by 64
//     pixels, 5 stages in flight, and split in registers into the A operand;
//   * one warpgroup a block: wgmma.m64nBNk8.f32.tf32.tf32 with A (64 output
//     pixels x 8 k) from registers and B (BN output channels x 8 k) from
//     shared memory, BN = 128, 64 or 32 by N; two blocks an SM, so that one
//     block's products run while the other waits, splits or adds;
//   * the epilogue stages the tile through shared memory, so each warp stores
//     32 consecutive pixels of a channel;
//   * no split-K and no atomics: each output is one thread's chain of 32-k
//     chunks in the order above, whatever the batch or the grid, so the same
//     inputs give the same bits in every run and every process, and an
//     image's result does not depend on the images beside it.
// Every kernel's name contains "fprop".

#include <cuda_runtime.h>

#include <type_traits>

extern "C" long long conv_fprop_f32_workspace(int n, int k);
extern "C" int conv_fprop_f32(const float* x, const float* w, float* ws, float* y, int batch,
                              int c, int h, int w_, int n, int ho, int wo, int stride, int pad,
                              cudaStream_t stream);

namespace {

constexpr int kTaps = 4;        // kernel height and width

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

// Offsets into x and y are 32-bit: the wrapper keeps both under 2^31
// elements.
struct Problem {
  const float* x;
  const float* wt;             // the weight's split parts, laid out for the tile
  float* y;
  int c, h, w;                 // C_in and x's plane
  int n, k, m;                 // N = C_out, K = C_in * 16, M = batch * ho * wo
  int plane_in, image_in, plane_out;
  int stride, pad;
  int m_tiles;                 // tiles of M, the grid's fast index; N tiles follow
  Divmod by_plane, by_wo;      // ho * wo, wo
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               ::"r"(s), "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// v = hi + lo, as the header says: hi = v rounded to TF32, to nearest with
// ties away from zero (cvt.rna.tf32.f32's rounding for finite v, in two
// integer operations where cvt takes four), and lo = v - hi, exact in
// float32, rounded the same way. The tensor cores read only a TF32
// operand's top 19 bits, so lo is passed unmasked, as ptxas passes cvt's.
__device__ __forceinline__ void split_tf32(float v, unsigned& hi, unsigned& lo) {
  hi = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi)) + 0x1000u;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Waits until at most N committed wgmma groups are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Makes the block's shared-memory writes (cp.async's) visible to wgmma's reads.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// d (+)= a * B on a 64 x N x 8 TF32 tile of the warpgroup (N = 32, 64, 128),
// A from registers, B from shared memory through its descriptor; d = a * B
// where !accumulate.
__device__ __forceinline__ void wgmma_n32(float (&d)[16], const unsigned (&a)[4],
                                          unsigned long long desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_n64(float (&d)[32], const unsigned (&a)[4],
                                          unsigned long long desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_n128(float (&d)[64], const unsigned (&a)[4],
                                          unsigned long long desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      "%60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
}

// A wgmma shared-memory descriptor of a K-major tile without swizzle: 8 x 16-byte
// core matrices, the next along K lbo bytes on, the next 8 rows sbo bytes on.
__device__ __forceinline__ unsigned long long smem_desc(const float* at, int lbo, int sbo) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(at);
  return (unsigned long long)((a & 0x3ffff) >> 4) |
         (unsigned long long)((lbo >> 4) & 0x3fff) << 16 |
         (unsigned long long)((sbo >> 4) & 0x3fff) << 32;
}

template <int BN>
__device__ __forceinline__ void wgmma_tf32(float (&d)[BN / 2], const unsigned (&a)[4],
                                           unsigned long long desc, int accumulate) {
  if constexpr (BN == 128) wgmma_n128(d, a, desc, accumulate);
  else if constexpr (BN == 64) wgmma_n64(d, a, desc, accumulate);
  else wgmma_n32(d, a, desc, accumulate);
}

// k rows a wgmma chain sums in a register fragment before it is added to the
// float32 accumulator: four k8 steps, in every tile (header).
constexpr int kChunkK = 32;

// A block of one warpgroup: 64 pixels x BN channels (the wgmma's N), BK = 16
// k rows a stage, 5 stages in flight, two blocks an SM (so that one block's
// products run while the other waits, splits or adds). The weight's stage is
// one contiguous block of the workspace (hi then lo, each BN x BK in 8-row x
// 4-float core matrices, k fastest: 8-row groups BK * 32 bytes apart); x's is
// gathered, BK rows of BM pixels. Each thread gathers kRows consecutive k rows
// (taps) of one pixel.
template <int BN_>
struct Tile {
  static constexpr int BN = BN_, BM = 64, BK = 16, kStages = 5, kResident = 2;
  static constexpr int kThreads = 128;
  static constexpr int kRowGroups = kThreads / BM;              // 2
  static constexpr int kRows = BK / kRowGroups;
  static constexpr int kWFloats = 2 * BN * BK;                  // hi and lo
  static constexpr int kWLoads = kWFloats / 4 / kThreads;
  static constexpr int kLdx = BM + 8, kLdc = BM + 4;
  static constexpr int kStageFloats = kWFloats + BK * kLdx;
  static constexpr int kPipe = kStages * kStageFloats, kOut = BN * kLdc;
  static constexpr int kSmem = (kPipe > kOut ? kPipe : kOut) * (int)sizeof(float);
  static_assert(kChunkK == 2 * BK && kRows <= 32 && kWLoads * 4 * kThreads == kWFloats, "tile");
  static_assert(kLdx % 32 == 8 && kLdc % 32 == 4, "banks");
};

// y = x (*) w for the pixel tile blockIdx.x % m_tiles and the channel tile
// blockIdx.x / m_tiles (neighbouring blocks read the same weight stages).
template <class T>
__global__ void __launch_bounds__(T::kThreads, T::kResident)
fprop_wgmma_kernel(Problem pr) {
  constexpr int BN = T::BN, BM = T::BM, BK = T::BK, kStages = T::kStages;
  constexpr int kTap2 = kTaps * kTaps;
  extern __shared__ __align__(128) float smem[];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m_tile = blockIdx.x % pr.m_tiles, n_tile = blockIdx.x / pr.m_tiles;
  const int m0 = m_tile * BM, n0 = n_tile * BN;
  const int stages = (pr.k + BK - 1) / BK;
  // the weight's stages of this channel tile, one after another
  const float* const w_tile = pr.wt + (long long)n_tile * stages * T::kWFloats;

  // this thread's x elements of a stage: one pixel, kRows k rows (taps), their
  // offsets in channel 0 (0 where outside the image) and whether each falls
  // inside the image (the same for every channel)
  const int col_t = tid % BM, rg = tid / BM;
  int x_off[T::kRows];
  unsigned x_ok = 0;
  {
    const int pix = m0 + col_t;
    int b, q, oh, ow;
    divmod(pr.by_plane, pix < pr.m ? pix : 0, b, q);
    divmod(pr.by_wo, q, oh, ow);
    const int ih = oh * pr.stride - pr.pad, iw = ow * pr.stride - pr.pad;
#pragma unroll
    for (int r = 0; r < T::kRows; ++r) {
      const int tap = (rg * T::kRows + r) % kTap2;
      const int hh = ih + tap / kTaps, ww = iw + tap % kTaps;
      const bool ok = pix < pr.m && (unsigned)hh < (unsigned)pr.h && (unsigned)ww < (unsigned)pr.w;
      x_ok |= (unsigned)ok << r;
      x_off[r] = ok ? b * pr.image_in + hh * pr.w + ww : 0;
    }
  }

  // every source address stays inside its tensor, zero-filled or not
  auto load = [&](int slot, int st) {
    float* ws = smem + slot * T::kStageFloats;
    const float* src = w_tile + st * T::kWFloats;
#pragma unroll
    for (int u = 0; u < T::kWLoads; ++u) {
      const int at = 4 * (tid + u * T::kThreads);
      cp_async16(ws + at, src + at);
    }
    float* xs = ws + T::kWFloats + rg * T::kRows * T::kLdx + col_t;
#pragma unroll
    for (int r = 0; r < T::kRows; ++r) {
      const int ch = st * BK / kTap2 + (rg * T::kRows + r) / kTap2;
      const bool kv = ch < pr.c;
      cp_async4(xs + r * T::kLdx, pr.x + (x_off[r] + (kv ? ch * pr.plane_in : 0)),
                kv && (x_ok >> r & 1));
    }
  };

  // a chunk's wgmma groups stay in flight until its second stage, so both
  // stages of a chunk keep their slots: loads run kAhead stages ahead
  constexpr int kStageSteps = BK / 8, kChunkStages = kChunkK / BK;
  constexpr int kAhead = kStages - kChunkStages;
  float acc[BN / 2], part[BN / 2];
  unsigned ah[kChunkK / 8][4], al[kChunkK / 8][4];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = part[i] = 0.0f;

#pragma unroll
  for (int s = 0; s < kAhead; ++s) {
    if (s < stages) load(s, s);
    cp_async_commit();
  }
  // this thread's rows of the warpgroup's A fragments: pixels p and p + 8
  const int p = 16 * warp + (lane >> 2), t = lane & 3;
  auto add_chunk = [&]() {
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] += part[i];
  };
  // stage st, the q-th of its chunk
  auto step = [&](int st, auto pos) {
    constexpr int q = decltype(pos)::value;
    cp_async_wait<kAhead - 1>();
    fence_proxy_async();
    __syncthreads();
    const float* ws = smem + (st % kStages) * T::kStageFloats;
    const float* xs = ws + T::kWFloats + t * T::kLdx + p;
#pragma unroll
    for (int s = 0; s < kStageSteps; ++s) {
      const float* at = xs + 8 * s * T::kLdx;
      const int i = q * kStageSteps + s;
      split_tf32(at[0], ah[i][0], al[i][0]);
      split_tf32(at[8], ah[i][1], al[i][1]);
      split_tf32(at[4 * T::kLdx], ah[i][2], al[i][2]);
      split_tf32(at[4 * T::kLdx + 8], ah[i][3], al[i][3]);
    }
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < kStageSteps; ++s) {
      // k8 step s: x_hi w_lo, x_lo w_hi, x_hi w_hi (the chunk's first into a
      // cleared fragment)
      const int i = q * kStageSteps + s;
      const float* w_hi = ws + 8 * s * 8;               // two core matrices a k8 step
      const unsigned long long hi = smem_desc(w_hi, 128, BK * 32);
      const unsigned long long lo = smem_desc(w_hi + BN * BK, 128, BK * 32);
      wgmma_tf32<BN>(part, ah[i], lo, q > 0 || s > 0);
      wgmma_tf32<BN>(part, al[i], hi, 1);
      wgmma_tf32<BN>(part, ah[i], hi, 1);
    }
    wgmma_commit();
    const int next = st + kAhead;
    if (next < stages) load(next % kStages, next);
    cp_async_commit();
    if (q == kChunkStages - 1) add_chunk();
  };
  for (int st = 0; st < stages; st += kChunkStages) {
    step(st, std::integral_constant<int, 0>());
    if (st + 1 < stages) step(st + 1, std::integral_constant<int, 1>());
    else add_chunk();                                   // K ends inside the chunk
  }
  cp_async_wait<0>();
  __syncthreads();                                   // the pipeline's buffers are free

  // the tile through shared memory, cs[channel][pixel]: acc[4 j + e] is
  // pixel p + 8 (e >> 1), channel 8 j + 2 t + (e & 1)
  float* const cs = smem;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      cs[(8 * j + 2 * t + (e & 1)) * T::kLdc + p + 8 * (e >> 1)] = acc[4 * j + e];
  __syncthreads();

  // each thread one pixel of the tile, on every (kThreads / BM)-th channel
  const int pix = m0 + col_t;
  if (pix < pr.m) {
    int b, q;
    divmod(pr.by_plane, pix, b, q);
    float* out = pr.y + (b * pr.n + n0) * pr.plane_out + q;
    const int chans = pr.n - n0 < BN ? pr.n - n0 : BN;
    for (int ch = rg; ch < chans; ch += T::kRowGroups)
      out[ch * pr.plane_out] = cs[ch * T::kLdc + col_t];
  }
}

// The weight's TF32 hi and lo parts, laid out for Tile T: for each channel
// tile and k stage one block, hi then lo, each BN x BK as 8-row x 4-float
// core matrices (k4 fastest, then 8-row groups); zero past N and K.
template <class T>
__global__ void fprop_split_kernel(const float* __restrict__ w, float* __restrict__ ws, int n,
                                   int k, int stages, long long total) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  constexpr int BN = T::BN, BK = T::BK;
  const long long block = i / T::kWFloats;
  const int in = (int)(i % T::kWFloats), half = in / (BN * BK), e = in % (BN * BK);
  const int n_tile = (int)(block / stages), st = (int)(block % stages);
  const int core = e / 32, row = n_tile * BN + core / (BK / 4) * 8 + e % 32 / 4;
  const int col = st * BK + core % (BK / 4) * 4 + e % 4;
  float v = 0.0f;
  if (row < n && col < k) {
    unsigned hi, lo;
    split_tf32(w[(long long)row * k + col], hi, lo);
    v = __uint_as_float(half ? lo & 0xffffe000u : hi);
  }
  ws[i] = v;
}

// The channel tile: the smallest of 32, 64 and 128 that holds N, else 128.
int tile_n(int n) { return n > 64 ? 128 : n > 32 ? 64 : 32; }

// f(Tile<BN>()) for the channel tile of N.
template <class F>
auto with_tile(int n, F f) {
  switch (tile_n(n)) {
    case 128: return f(Tile<128>());
    case 64: return f(Tile<64>());
    default: return f(Tile<32>());
  }
}

template <class T>
long long workspace(int n, int k) {
  return (long long)((n + T::BN - 1) / T::BN) * ((k + T::BK - 1) / T::BK) * T::kWFloats;
}

int allow_smem(const void* kernel, int bytes) {
  if (bytes <= 48 * 1024) return 0;     // above 48 KB only when asked for
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <class T>
int launch(Problem pr, const float* w, float* ws, cudaStream_t stream) {
  const int stages = (pr.k + T::BK - 1) / T::BK;
  const long long total = workspace<T>(pr.n, pr.k);
  fprop_split_kernel<T><<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(w, ws, pr.n, pr.k,
                                                                             stages, total);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  auto kernel = fprop_wgmma_kernel<T>;
  err = allow_smem((const void*)kernel, T::kSmem);
  if (err != 0) return err;
  pr.wt = ws;
  pr.m_tiles = (pr.m + T::BM - 1) / T::BM;
  const long long grid = (long long)pr.m_tiles * ((pr.n + T::BN - 1) / T::BN);
  kernel<<<(unsigned)grid, T::kThreads, T::kSmem, stream>>>(pr);
  return (int)cudaGetLastError();
}

}  // namespace

// Floats of the workspace conv_fprop_f32 takes for N output channels and K =
// C_in * 16: the weight's hi and lo parts laid out for the tile.
extern "C" long long conv_fprop_f32_workspace(int n, int k) {
  return with_tile(n, [=](auto t) { return workspace<decltype(t)>(n, k); });
}

// c = C_in, (h, w_) x's size; n = C_out, (ho, wo) y's; ws holds
// conv_fprop_f32_workspace floats. On `stream`: the weight's split, then the
// GEMM.
extern "C" int conv_fprop_f32(const float* x, const float* w, float* ws, float* y, int batch,
                              int c, int h, int w_, int n, int ho, int wo, int stride, int pad,
                              cudaStream_t stream) {
  Problem pr;
  pr.x = x;
  pr.wt = nullptr;
  pr.y = y;
  pr.c = c;
  pr.h = h;
  pr.w = w_;
  pr.n = n;
  pr.k = c * kTaps * kTaps;
  pr.m = batch * ho * wo;
  pr.plane_in = h * w_;
  pr.image_in = c * h * w_;
  pr.plane_out = ho * wo;
  pr.stride = stride;
  pr.pad = pad;
  pr.m_tiles = 0;
  pr.by_plane = make_divmod((unsigned)(ho * wo));
  pr.by_wo = make_divmod((unsigned)wo);
  return with_tile(n, [&](auto t) { return launch<decltype(t)>(pr, w, ws, stream); });
}
