// Data gradient of a float32 convolution with a 4 x 4 kernel (groups 1,
// dilation 1, stride 1 or 2, padding 0 or 1):
//
//   dX[b, ci, ih, iw] = sum over (co, kh, kw) of dY[b, co, oh, ow] * W[co, ci, kh, kw]
//                       over the taps with ih = oh*s - p + kh, iw = ow*s - p + kw
//
// dy (B, C_dy, H_dy, W_dy) and w (C_dy, C_x, 4, 4) NCHW contiguous, dx
// (B, C_x, H, W). A transposed convolution's forward is the same sum, its input
// as dy and its weight (C_in, C_out, 4, 4) as w; the wrapper does that.
//
// Replaces no TPU kernel: XLA computes the JAX package's data gradients. It was
// added because cuDNN's deterministic algorithms, which the training step needs
// to rerun bit for bit, leave float32 data gradients (and so the decoders'
// transposed-convolution forwards) to dgrad2d_alg1_1 and to 32 x 32 FFTs, at
// 12-24% of an H100's float32 rate.
//
// Bound by FFMA throughput: float32 with TF32 off, so no tensor cores. The cnn
// models' 14 calls of a dyn_modeling step at 256 x 8 are 1.28 TFLOP, 19.0 ms at
// 67 TFLOP/s. Two GEMMs, both 8 x 8 register tiles fed by 3 or 4 cp.async
// stages, the tile a function of the shapes alone:
//   * stride 2 (dgrad_implicit_kernel): M = C_x, N = the dX pixels of one
//     sub-pixel phase (ih % 2, iw % 2), K = C_dy x 4. With a 4 x 4 kernel each
//     dX pixel of a phase receives exactly 2 x 2 taps, so no multiply hits a
//     tap that does not exist. The weight is first laid out as wt[phase][k][m]
//     (m padded to 4) by a small kernel, so that its tiles are 16-byte rows;
//     dY is gathered by 4-byte cp.async with zero fill outside the image.
//     Tiles by M: 128 x 128, 64 x 128, 32 x 256. Each output is one thread's
//     chain of fused multiply-adds over k = (co, tap), channel-major. (Stride
//     1 on planes larger than a tile takes it too, with all 16 taps and zero
//     fill; so does a dX of at most 4 channels whose weight does not fit
//     dgrad_direct_kernel's shared memory.)
//   * stride 2 with at most 4 channels of dX (dgrad_direct_kernel, the
//     decoders' last layer): no GEMM; each thread reads a 3 x 4 window of dY a
//     channel into registers for all the products it feeds, in the same order.
//   * stride 1 (dgrad_scatter_kernel, the models' 5 x 5 <-> 8 x 8 layers,
//     where gathering all 16 taps would multiply by zero 61% of the time): the
//     GEMM of w read as it is, M = C_x * 16 (channel, tap), N = whole images'
//     dY pixels, K = C_dy; then each dX pixel adds its existing taps from the
//     tile in shared memory, kh then kw, each tap a chain over co.
//   * no split-K and no atomics: each dX element is written once, by one
//     thread, in an order that depends on neither the batch, the tile nor the
//     grid, so the same inputs give the same bits in every run and every
//     process, and an image's result does not depend on the images beside it.
// Every kernel's name contains "dgrad".

#include <cuda_runtime.h>

extern "C" int conv_dgrad_f32_workspace(int m, int c, int stride, int ho, int wo);
extern "C" int conv_dgrad_f32(const float* dy, const float* w, float* wt, float* dx,
                              int batch, int m, int ho, int wo, int c, int h, int w_,
                              int stride, int pad, cudaStream_t stream);

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

// Offsets are 32-bit: the wrapper keeps dy, dx and wt under 2^31 elements.
struct Problem {
  const float* dy;
  const float* wt;
  float* dx;
  int c, mp;                   // M = C_x, and M rounded up to 4 (wt's row length)
  int k;                       // K = C_dy * taps a phase
  int n;                       // N = batch * hn * wn, the pixels of a phase
  int h, w;                    // dX's height and width
  int ho, wo;                  // dY's
  int plane, image;            // H_dy * W_dy, C_dy * H_dy * W_dy
  int pad;
  Divmod by_grid, by_wn;       // hn * wn, wn: a phase's pixel grid
};

// Zero-fills the bytes at dst when !valid, without reading src.
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               ::"r"(s), "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(s), "l"(src), "r"(valid ? 16 : 0));
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
// bounds cap the registers to fit). Each thread gathers kCols columns of dY's
// tile, on kRows of its k rows.
template <int BM_, int BN_, int TM_, int TN_, int BK_, int kStages_, int kResident_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, TM = TM_, TN = TN_, BK = BK_;
  static constexpr int kStages = kStages_, kResident = kResident_;
  static constexpr int kThreads = (BM / TM) * (BN / TN);
  static constexpr int kColThreads = BN < kThreads ? BN : kThreads;
  static constexpr int kRowGroups = kThreads / kColThreads;
  static constexpr int kCols = BN / kColThreads;
  static constexpr int kRows = BK / kRowGroups;
  static constexpr int kAChunks = BK * BM / 4;            // 16-byte loads of A a stage
  static constexpr int kLda = BM + 4, kLdb = BN + 4;
  static constexpr int kSmem = kStages * BK * (kLda + kLdb) * (int)sizeof(float);
  static_assert(kThreads % 32 == 0 && BN % kColThreads == 0 && BK % kRowGroups == 0, "tile");
  static_assert(kCols * kRows <= 64, "one validity bit a gathered element");
  static_assert(TM % 4 == 0 && TN % 4 == 0 && BM % 4 == 0 && BK % 16 == 0, "tile");
};

// Rows k0 .. k0 + BK of a row-major [K][ld] matrix, columns m0 .. m0 + BM,
// into As[stage] by 16-byte cp.async, zero past (k_total, m_total); ld,
// m0 and m_total are multiples of 4.
template <class T>
__device__ __forceinline__ void load_a(float* As, int stage, const float* a, int ld, int k0,
                                       int k_total, int m0, int m_total) {
#pragma unroll
  for (int u = 0; u < (T::kAChunks + T::kThreads - 1) / T::kThreads; ++u) {
    const int idx = threadIdx.x + u * T::kThreads;
    if (T::kAChunks % T::kThreads == 0 || idx < T::kAChunks) {
      const int row = idx / (T::BM / 4), col = 4 * (idx % (T::BM / 4));
      const bool ok = k0 + row < k_total && m0 + col < m_total;
      const float* src = ok ? a + (k0 + row) * ld + m0 + col : a;
      cp_async16(As + (stage * T::BK + row) * T::kLda + col, src, ok);
    }
  }
}

// acc[i][j] += A[k][m] * B[k][n] over the `stages` stages of BK rows, k in
// order, load(stage slot, stage) filling As and Bs; one chain of fused
// multiply-adds an output.
template <class T, class Load>
__device__ __forceinline__ void mainloop(float (&acc)[T::TM][T::TN], const float* As,
                                         const float* Bs, int stages, Load load) {
  constexpr int BM = T::BM, BN = T::BN, TM = T::TM, TN = T::TN, BK = T::BK;
  constexpr int kStages = T::kStages, kTx = BN / TN;
  const int tx = threadIdx.x % kTx, ty = threadIdx.x / kTx;
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
}

// S: the stride. A phase's pixel (i, j) is dX's (S*i + ph, S*j + pw); its tap
// (a, cc), 0 <= a, cc < kAxis, reads dY at (i + bh - a, j + bw - cc). At
// stride 2 the four phases of an N tile are neighbouring blocks, so that
// they share dY in L2 and fill dX's sectors together.
template <class T, int S>
__global__ void __launch_bounds__(T::kThreads, T::kResident)
dgrad_implicit_kernel(Problem pr) {
  constexpr int BM = T::BM, BN = T::BN, TM = T::TM, TN = T::TN, BK = T::BK;
  constexpr int kAxis = S == 1 ? kTaps : kTaps / 2;       // taps an axis in a phase
  constexpr int kPhaseTaps = kAxis * kAxis;                // 16 or 4
  constexpr int kPhases = S * S;
  extern __shared__ __align__(16) float smem[];
  float* const As = smem;                            // [kStages][BK][kLda]
  float* const Bs = smem + T::kStages * BK * T::kLda;  // [kStages][BK][kLdb]

  const int tid = threadIdx.x;
  const int phase = blockIdx.x % kPhases;            // 0 at stride 1
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x / kPhases * BN;
  const int ph = phase >> 1, pw = phase & 1;
  const int bh = S == 1 ? pr.pad : (ph + pr.pad) >> 1;
  const int bw = S == 1 ? pr.pad : (pw + pr.pad) >> 1;
  const float* const a_base = pr.wt + phase * pr.k * pr.mp;

  // this thread's dY columns: their (b, i, j) offsets, and which taps of
  // each fall inside dY (the same for every channel)
  const int col_t = tid % T::kColThreads, rg = tid / T::kColThreads;
  int b_off[T::kCols];
  unsigned long long b_ok = 0;
#pragma unroll
  for (int cc = 0; cc < T::kCols; ++cc) {
    const int nn = n0 + col_t + T::kColThreads * cc;
    int b, q, i, j;
    divmod(pr.by_grid, nn < pr.n ? nn : 0, b, q);
    divmod(pr.by_wn, q, i, j);
    b_off[cc] = b * pr.image + (i + bh) * pr.wo + (j + bw);
#pragma unroll
    for (int r = 0; r < T::kRows; ++r) {
      const int t = (rg + T::kRowGroups * r) % kPhaseTaps;
      const int dh = i + bh - t / kAxis, dw = j + bw - t % kAxis;
      const bool ok = nn < pr.n && (unsigned)dh < (unsigned)pr.ho &&
                      (unsigned)dw < (unsigned)pr.wo;
      b_ok |= (unsigned long long)ok << (r * T::kCols + cc);
    }
  }
  // this thread's k rows of a stage: channel and tap offsets in dY
  int r_off[T::kRows];
#pragma unroll
  for (int r = 0; r < T::kRows; ++r) {
    const int row = rg + T::kRowGroups * r, t = row % kPhaseTaps;
    r_off[r] = (row / kPhaseTaps) * pr.plane - (t / kAxis) * pr.wo - t % kAxis;
  }

  auto load = [&](int stage, int st) {
    const int k0 = st * BK;
    load_a<T>(As, stage, a_base, pr.mp, k0, pr.k, m0, pr.mp);
    const int co_off = (k0 / kPhaseTaps) * pr.plane;
#pragma unroll
    for (int r = 0; r < T::kRows; ++r) {
      const int row = rg + T::kRowGroups * r;
      const bool kv = k0 + row < pr.k;
      float* dst = Bs + (stage * BK + row) * T::kLdb + col_t;
#pragma unroll
      for (int cc = 0; cc < T::kCols; ++cc) {
        const bool ok = kv && (b_ok >> (r * T::kCols + cc) & 1);
        const float* src = ok ? pr.dy + (b_off[cc] + co_off + r_off[r]) : pr.dy;
        cp_async4(dst + T::kColThreads * cc, src, ok);
      }
    }
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;
  mainloop<T>(acc, As, Bs, (pr.k + BK - 1) / BK, load);

  // dX[b, m, S*i + ph, S*j + pw]
  constexpr int kTx = BN / TN;
  const int tx = tid % kTx, ty = tid / kTx;
  const int hw = pr.h * pr.w;
  int o_off[TN];
  unsigned o_ok = 0;
#pragma unroll
  for (int cj = 0; cj < TN / 4; ++cj)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int nn = n0 + tx * 4 + cj * (BN / (TN / 4)) + jj;
      int b, q, i, j;
      divmod(pr.by_grid, nn < pr.n ? nn : 0, b, q);
      divmod(pr.by_wn, q, i, j);
      const int ih = S * i + ph, iw = S * j + pw;
      o_off[4 * cj + jj] = b * pr.c * hw + ih * pr.w + iw;
      o_ok |= (unsigned)(nn < pr.n && ih < pr.h && iw < pr.w) << (4 * cj + jj);
    }
#pragma unroll
  for (int ci = 0; ci < TM / 4; ++ci)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int mm = m0 + ty * 4 + ci * (BM / (TM / 4)) + i;
      if (mm >= pr.c) continue;
#pragma unroll
      for (int j = 0; j < TN; ++j)
        if (o_ok >> j & 1) pr.dx[o_off[j] + mm * hw] = acc[4 * ci + i][j];
    }
}

// Stride 1 where an image's dY plane fits a tile (the cnn models' 5 x 5): the
// GEMM T[(ci, kh, kw), (b, oh, ow)] = sum over co of w[co, (ci, kh, kw)] *
// dY[b, co, oh, ow], M = C_x * 16 rows read straight from w, N = whole images'
// dY pixels, K = C_dy; then each dX pixel sums its taps from the tile in
// shared memory, kh then kw in order: dX[b, ci, ih, iw] = sum of T[(ci, kh,
// kw), (b, ih + p - kh, iw + p - kw)]. Every multiply is a tap that exists.
// A tile's rows are BM / 16 channels of dX, its columns BN / plane images.
template <class T>
__global__ void __launch_bounds__(T::kThreads, T::kResident)
dgrad_scatter_kernel(const float* __restrict__ dy, const float* __restrict__ w,
                     float* __restrict__ dx, int batch, int m, int c, int ho, int wo, int h,
                     int w_, int pad) {
  constexpr int BM = T::BM, BN = T::BN, TM = T::TM, TN = T::TN, BK = T::BK;
  constexpr int kLdc = BN + 4;
  static_assert(BM % (kTaps * kTaps) == 0, "whole channels a tile");
  extern __shared__ __align__(16) float smem[];
  float* const As = smem;
  float* const Bs = smem + T::kStages * BK * T::kLda;
  float* const Cs = smem;                            // [BM][kLdc], after the loop

  const int tid = threadIdx.x;
  const int plane = ho * wo, images = BN / plane, m_rows = c * kTaps * kTaps;
  const int m0 = blockIdx.y * BM, img0 = blockIdx.x * images;

  const int col_t = tid % T::kColThreads, rg = tid / T::kColThreads;
  int b_off[T::kCols];
  unsigned b_ok = 0;
#pragma unroll
  for (int cc = 0; cc < T::kCols; ++cc) {
    const int col = col_t + T::kColThreads * cc, b = img0 + col / plane;
    b_off[cc] = b * m * plane + col % plane;
    b_ok |= (unsigned)(col < images * plane && b < batch) << cc;
  }

  auto load = [&](int stage, int st) {
    const int k0 = st * BK;
    load_a<T>(As, stage, w, m_rows, k0, m, m0, m_rows);
#pragma unroll
    for (int r = 0; r < T::kRows; ++r) {
      const int row = rg + T::kRowGroups * r;
      const bool kv = k0 + row < m;
      float* dst = Bs + (stage * BK + row) * T::kLdb + col_t;
#pragma unroll
      for (int cc = 0; cc < T::kCols; ++cc) {
        const bool ok = kv && (b_ok >> cc & 1);
        const float* src = ok ? dy + (b_off[cc] + (k0 + row) * plane) : dy;
        cp_async4(dst + T::kColThreads * cc, src, ok);
      }
    }
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;
  mainloop<T>(acc, As, Bs, (m + BK - 1) / BK, load);
  __syncthreads();                                   // the pipeline's buffers are free

  constexpr int kTx = BN / TN;
  const int tx = tid % kTx, ty = tid / kTx;
#pragma unroll
  for (int ci = 0; ci < TM / 4; ++ci)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float* row = Cs + (ty * 4 + ci * (BM / (TM / 4)) + i) * kLdc + tx * 4;
#pragma unroll
      for (int cj = 0; cj < TN / 4; ++cj)
        *reinterpret_cast<float4*>(row + cj * (BN / (TN / 4))) =
            make_float4(acc[4 * ci + i][4 * cj], acc[4 * ci + i][4 * cj + 1],
                        acc[4 * ci + i][4 * cj + 2], acc[4 * ci + i][4 * cj + 3]);
    }
  __syncthreads();

  const int hw = h * w_, per_channel = images * hw;
  const int c0 = m0 / (kTaps * kTaps);
  for (int o = tid; o < BM / (kTaps * kTaps) * per_channel; o += T::kThreads) {
    const int cl = o / per_channel, rest = o % per_channel;
    const int il = rest / hw, pix = rest % hw;
    const int ih = pix / w_, iw = pix % w_;
    const int b = img0 + il, ci = c0 + cl;
    if (b >= batch || ci >= c) continue;
    const float* t = Cs + cl * kTaps * kTaps * kLdc + il * plane;
    float v = 0.0f;
#pragma unroll
    for (int kh = 0; kh < kTaps; ++kh) {
      const int oh = ih + pad - kh;
      if ((unsigned)oh >= (unsigned)ho) continue;
#pragma unroll
      for (int kw = 0; kw < kTaps; ++kw) {
        const int ow = iw + pad - kw;
        if ((unsigned)ow < (unsigned)wo) v += t[(kh * kTaps + kw) * kLdc + oh * wo + ow];
      }
    }
    dx[(b * c + ci) * hw + pix] = v;
  }
}

// Stride 2 where dX has at most 4 channels (the decoders' last layer, 32 -> 3),
// where a GEMM tile would use each gathered dY value for at most 4 products:
// each thread computes the 2 x 2 sub-pixels of two neighbouring phase pixels
// (i, j0) and (i, j0 + 1) for every channel of dX from the 3 x 4 dY values
// around them, each read once into registers for 32 * C products, the weight
// in shared memory. Each output sums over (co, tap) in the implicit kernel's
// order, channel-major, with zero for a tap outside dY.
template <int C, int P>
__global__ void __launch_bounds__(256)
dgrad_direct_kernel(const float* __restrict__ dy, const float* __restrict__ w,
                    float* __restrict__ dx, int batch, int m, int ho, int wo, int h, int w_) {
  extern __shared__ __align__(16) float ws[];           // w: [m][C][4][4]
  for (int i = threadIdx.x; i < m * C * kTaps * kTaps; i += blockDim.x) ws[i] = w[i];
  __syncthreads();
  const int hn = (h + 1) / 2, wn = (w_ + 1) / 2, pairs = (wn + 1) / 2;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= batch * hn * pairs) return;
  const int b = idx / (hn * pairs), q = idx % (hn * pairs);
  const int i = q / pairs, j0 = 2 * (q % pairs);
  // dY rows i - 1 + r and columns j0 - 1 + s inside dY
  unsigned ok = 0;
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int s = 0; s < 4; ++s)
      ok |= (unsigned)((unsigned)(i - 1 + r) < (unsigned)ho &&
                       (unsigned)(j0 - 1 + s) < (unsigned)wo) << (4 * r + s);
  const int plane = ho * wo, at = (i - 1) * wo + j0 - 1;
  const float* src = dy + b * m * plane;

  float acc[C][4][2];                                   // [ci][phase][pixel]
#pragma unroll
  for (int ci = 0; ci < C; ++ci)
#pragma unroll
    for (int z = 0; z < 4; ++z) acc[ci][z][0] = acc[ci][z][1] = 0.0f;
  for (int co = 0; co < m; ++co, src += plane) {
    float v[3][4];
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int s = 0; s < 4; ++s)
        v[r][s] = ok >> (4 * r + s) & 1 ? __ldg(src + at + r * wo + s) : 0.0f;
#pragma unroll
    for (int ci = 0; ci < C; ++ci) {
      float wk[kTaps][kTaps];
#pragma unroll
      for (int kh = 0; kh < kTaps; ++kh)
        *reinterpret_cast<float4*>(wk[kh]) = *reinterpret_cast<const float4*>(
            ws + ((co * C + ci) * kTaps + kh) * kTaps);
#pragma unroll
      for (int z = 0; z < 4; ++z) {
        const int ph = z >> 1, pw = z & 1;
#pragma unroll
        for (int t = 0; t < 4; ++t) {                   // t = 2 a + cc
          const int a = t >> 1, cc = t & 1;
          const int kh = ((ph + P) & 1) + 2 * a, kw = ((pw + P) & 1) + 2 * cc;
          const int r = ((ph + P) >> 1) - a + 1, s = ((pw + P) >> 1) - cc + 1;
#pragma unroll
          for (int x = 0; x < 2; ++x)
            acc[ci][z][x] = fmaf(wk[kh][kw], v[r][s + x], acc[ci][z][x]);
        }
      }
    }
  }
  const int hw = h * w_;
#pragma unroll
  for (int z = 0; z < 4; ++z) {
    const int ih = 2 * i + (z >> 1);
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const int iw = 2 * (j0 + x) + (z & 1);
      if (ih >= h || iw >= w_ || j0 + x >= wn) continue;
#pragma unroll
      for (int ci = 0; ci < C; ++ci) dx[(b * C + ci) * hw + ih * w_ + iw] = acc[ci][z][x];
    }
  }
}

// wt[z][k][m] = w[co, m, kh, kw] for k = co * taps + t, zero for m >= c: at
// stride 1 the 16 taps t = 4 kh + kw; at stride 2, phase z = (ph, pw), the 2 x 2
// taps t = 2 a + cc with kh = ((ph + pad) & 1) + 2 a, kw = ((pw + pad) & 1) + 2 cc.
__global__ void dgrad_weight_kernel(const float* __restrict__ w, float* __restrict__ wt,
                                    int m, int c, int mp, int stride, int pad) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= kTaps * kTaps * m * mp) return;
  const int col = idx % mp, rest = idx / mp;
  const int taps = stride == 1 ? kTaps * kTaps : 4;
  const int z = rest / (m * taps), k = rest % (m * taps);
  const int co = k / taps, t = k % taps;
  int kh, kw;
  if (stride == 1) {
    kh = t / kTaps;
    kw = t % kTaps;
  } else {
    kh = (((z >> 1) + pad) & 1) + 2 * (t >> 1);
    kw = (((z & 1) + pad) & 1) + 2 * (t & 1);
  }
  wt[idx] = col < c ? w[(co * c + col) * kTaps * kTaps + kh * kTaps + kw] : 0.0f;
}

// The tiles, by M: the cnn models' C_x of 128, 64 and 32; the stride-1
// GEMM's M = C_x * 16, whose epilogue reuses the pipeline's shared memory.
using Big = Tile<128, 128, 8, 8, 16, 3, 2>;
using Mid = Tile<64, 128, 8, 8, 16, 4, 4>;
using Small = Tile<32, 256, 8, 8, 16, 3, 3>;
using Scatter = Tile<128, 128, 8, 8, 16, 4, 2>;
static_assert(Scatter::kSmem >= Scatter::BM * (Scatter::BN + 4) * (int)sizeof(float),
              "the scatter epilogue's tile fits the pipeline's buffers");

int allow_smem(const void* kernel, int bytes) {
  if (bytes <= 48 * 1024) return 0;     // above 48 KB only when asked for
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <class T, int S>
int launch(const Problem& pr, cudaStream_t stream) {
  auto kernel = dgrad_implicit_kernel<T, S>;
  const int err = allow_smem((const void*)kernel, T::kSmem);
  if (err != 0) return err;
  const dim3 grid((pr.n + T::BN - 1) / T::BN * S * S, (pr.c + T::BM - 1) / T::BM);
  kernel<<<grid, T::kThreads, T::kSmem, stream>>>(pr);
  return (int)cudaGetLastError();
}

template <class T>
int launch_tile(const Problem& pr, int stride, cudaStream_t stream) {
  return stride == 1 ? launch<T, 1>(pr, stream) : launch<T, 2>(pr, stream);
}

// Whether a call takes dgrad_scatter_kernel: stride 1, and an image's dY
// plane fits its tile.
bool scatter(int stride, int ho, int wo) {
  return stride == 1 && ho * wo <= Scatter::BN;
}

// Whether a call takes dgrad_direct_kernel: stride 2, at most 4 channels of
// dX, and the weight fits 48 KB of shared memory.
bool direct(int stride, int m, int c) {
  return stride == 2 && c <= 4 && m * c * kTaps * kTaps * (int)sizeof(float) <= 48 * 1024;
}

template <int C, int P>
int launch_direct(const float* dy, const float* w, float* dx, int batch, int m, int ho, int wo,
                  int h, int w_, cudaStream_t stream) {
  const long long threads = (long long)batch * ((h + 1) / 2) * (((w_ + 1) / 2 + 1) / 2);
  const int smem = m * C * kTaps * kTaps * (int)sizeof(float);
  dgrad_direct_kernel<C, P><<<(unsigned)((threads + 255) / 256), 256, smem, stream>>>(
      dy, w, dx, batch, m, ho, wo, h, w_);
  return (int)cudaGetLastError();
}

template <int P>
int launch_direct_pad(const float* dy, const float* w, float* dx, int batch, int m, int ho,
                      int wo, int c, int h, int w_, cudaStream_t stream) {
  switch (c) {
    case 1: return launch_direct<1, P>(dy, w, dx, batch, m, ho, wo, h, w_, stream);
    case 2: return launch_direct<2, P>(dy, w, dx, batch, m, ho, wo, h, w_, stream);
    case 3: return launch_direct<3, P>(dy, w, dx, batch, m, ho, wo, h, w_, stream);
    default: return launch_direct<4, P>(dy, w, dx, batch, m, ho, wo, h, w_, stream);
  }
}

}  // namespace

// Floats of the re-laid weight wt that conv_dgrad_f32 takes: 16 x C_dy x M
// rounded up to 4; 0 where the call reads w as it is.
extern "C" int conv_dgrad_f32_workspace(int m, int c, int stride, int ho, int wo) {
  return scatter(stride, ho, wo) || direct(stride, m, c) ? 0
                                                         : kTaps * kTaps * m * ((c + 3) / 4 * 4);
}

// m = C_dy, (ho, wo) dY's size; c = C_x, (h, w_) dX's. On `stream`: the
// stride-1 GEMM with its tap sums or the direct kernel (one launch), or the
// weight's layout and the implicit GEMM (two).
extern "C" int conv_dgrad_f32(const float* dy, const float* w, float* wt, float* dx,
                              int batch, int m, int ho, int wo, int c, int h, int w_,
                              int stride, int pad, cudaStream_t stream) {
  if (scatter(stride, ho, wo)) {
    auto kernel = dgrad_scatter_kernel<Scatter>;
    const int err = allow_smem((const void*)kernel, Scatter::kSmem);
    if (err != 0) return err;
    const int images = Scatter::BN / (ho * wo);
    const dim3 grid((batch + images - 1) / images,
                    (c * kTaps * kTaps + Scatter::BM - 1) / Scatter::BM);
    kernel<<<grid, Scatter::kThreads, Scatter::kSmem, stream>>>(dy, w, dx, batch, m, c, ho, wo,
                                                                h, w_, pad);
    return (int)cudaGetLastError();
  }
  if (direct(stride, m, c))
    return pad == 0 ? launch_direct_pad<0>(dy, w, dx, batch, m, ho, wo, c, h, w_, stream)
                    : launch_direct_pad<1>(dy, w, dx, batch, m, ho, wo, c, h, w_, stream);
  const int mp = (c + 3) / 4 * 4;
  const int total = conv_dgrad_f32_workspace(m, c, stride, ho, wo);
  dgrad_weight_kernel<<<(total + 255) / 256, 256, 0, stream>>>(w, wt, m, c, mp, stride, pad);
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  const int hn = stride == 1 ? h : (h + 1) / 2, wn = stride == 1 ? w_ : (w_ + 1) / 2;
  Problem pr;
  pr.dy = dy;
  pr.wt = wt;
  pr.dx = dx;
  pr.c = c;
  pr.mp = mp;
  pr.k = m * (stride == 1 ? kTaps * kTaps : 4);
  pr.n = batch * hn * wn;
  pr.h = h;
  pr.w = w_;
  pr.ho = ho;
  pr.wo = wo;
  pr.plane = ho * wo;
  pr.image = m * ho * wo;
  pr.pad = pad;
  pr.by_grid = make_divmod((unsigned)(hn * wn));
  pr.by_wn = make_divmod((unsigned)wn);
  return c > 64   ? launch_tile<Big>(pr, stride, stream)
         : c > 32 ? launch_tile<Mid>(pr, stride, stream)
                  : launch_tile<Small>(pr, stride, stream);
}
