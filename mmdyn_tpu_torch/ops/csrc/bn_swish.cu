// Train-mode BatchNorm followed by swish, forward and backward, for float32
// NCHW activations.
//
// BatchNorm + swish of x (G * N, C, H, W) with statistics per (group g,
// channel c) over the N rows of the group and the H * W plane (biased
// variance; the cnn decoders run their K subsets as G = K groups):
//
//   mean, var = the group-channel's statistics,  inv = rsqrt(var + eps)
//   u = (x - mean) * (inv * weight) + bias,      y = u * sigmoid(u)
//
// and its backward from the output's gradient g, with x_hat = (x - mean) * inv
// and s = sigmoid(u), the closed form of the JAX package's _train_bn_manual
// (mmdyn_tpu/models/layers.py) with swish's derivative folded in:
//
//   ct = g * s * (1 + u * (1 - s))
//   dx = weight * inv / M * (M * ct - sum(ct) - x_hat * sum(ct * x_hat))
//   dweight = sum over groups of sum(ct * x_hat),  dbias = sum over groups of sum(ct)
//
// M = N * H * W, the sums over one group-channel. (A swish with no BatchNorm
// before it runs as torch's F.silu, one vectorized pass each way.)
//
// Replaces no TPU kernel: XLA fuses BatchNorm and swish into the
// convolutions' neighbouring passes in the JAX package. Run as separate
// PyTorch operations and differentiated op by op, they took about 11 passes
// over each element forward and 26 backward.
//
// Bound by bytes: x read and y written forward, g and x read and dx written
// backward, 20 bytes an element; at 3.35 TB/s the cnn-mvae's dyn_modeling
// step at 2,048 rows (1,066.4 M elements) is 6.37 ms. Design:
//   * every pass splits a group-channel's N * H * W elements, in row-major
//     order, into pieces of kPiece (4,096) and gives one piece to a block of
//     256 threads (grid: pieces x group-channels). A thread takes four quads
//     of four consecutive elements, loaded as float4 where H * W % 4 == 0 and
//     the pointers are 16-byte aligned, else element by element in the same
//     order; all loads are issued before any arithmetic;
//   * forward, three kernels: the statistics (each block the exact two-pass
//     mean and M2 of its piece, from registers), their merge (Chan's formula
//     over the pieces in a fixed tree: the variance keeps two-pass accuracy),
//     and one read-and-write pass for y. Only x, mean and inv are kept for the
//     backward: x_hat, u and the sigmoid are computed again there;
//   * backward, three kernels: sum(ct) and sum(ct * x_hat) of each piece,
//     their merge in a fixed tree (and the weight and bias gradients, summed
//     over the groups in order), and one pass for dx;
//   * deterministic: no atomics; the pieces, the grid and every order of
//     summation follow the shapes alone, so a rerun and another process give
//     the same bits.
// Every kernel's name starts with bn_swish_.

#include <cuda_runtime.h>
#include <stdint.h>

extern "C" int bn_swish_pieces(int n, int hw);
extern "C" int bn_swish_forward(const float* x, const float* weight, const float* bias,
                                float* y, float* mean, float* var, float* inv, float* ws,
                                int groups, int n, int c, int hw, float eps,
                                cudaStream_t stream);
extern "C" int bn_swish_backward(const float* g, const float* x, const float* weight,
                                 const float* bias, const float* mean, const float* inv,
                                 float* dx, float* dweight, float* dbias, float* ws,
                                 float* sums, int groups, int n, int c, int hw,
                                 cudaStream_t stream);

namespace {

constexpr int kThreads = 256;
constexpr int kQuads = 4;                            // quads a thread
constexpr int kPiece = kThreads * kQuads * 4;        // elements a block
constexpr int kWarps = kThreads / 32;

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

__device__ __forceinline__ int div_of(const Divmod& f, int n) {
  return f.d == 1 ? n : (int)(__umulhi((unsigned)n, f.mul) >> f.shift);
}

// One group-channel's elements: element k (row-major over N rows of H * W)
// lies at base + (k / hw) * row + k % hw. Offsets are 32-bit: the wrapper
// keeps the tensor under 2^31 elements.
struct Segment {
  int groups, n, c, hw;
  int length;                 // N * H * W
  int pieces;                 // blocks a group-channel
  int row;                    // C * H * W, from one row to the next
  Divmod by_hw;
};

__device__ __forceinline__ int segment_base(const Segment& sg, int gc) {
  const int g = gc / sg.c, ch = gc - g * sg.c;
  return (g * sg.n * sg.c + ch) * sg.hw;
}

__device__ __forceinline__ int offset_of(const Segment& sg, int base, int k) {
  const int r = div_of(sg.by_hw, k);
  return base + r * sg.row + (k - r * sg.hw);
}

// The block's quads: quad i of this thread holds elements 4 * q .. 4 * q + 3
// of the segment, q = piece * kPiece / 4 + tid + kThreads * i; zeros past the
// segment's end, with valid[i] the number of its elements inside.
template <bool kVec>
__device__ __forceinline__ void load_quads(const float* __restrict__ p, const Segment& sg,
                                           int base, int piece, float4 (&v)[kQuads],
                                           int (&valid)[kQuads]) {
#pragma unroll
  for (int i = 0; i < kQuads; ++i) {
    const int k = piece * kPiece + 4 * (threadIdx.x + kThreads * i);
    valid[i] = max(0, min(4, sg.length - k));
    if (kVec) {
      v[i] = valid[i] ? __ldg(reinterpret_cast<const float4*>(p + offset_of(sg, base, k)))
                      : make_float4(0.f, 0.f, 0.f, 0.f);
    } else {
      float e[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) e[j] = j < valid[i] ? __ldg(p + offset_of(sg, base, k + j)) : 0.f;
      v[i] = make_float4(e[0], e[1], e[2], e[3]);
    }
  }
}

template <bool kVec>
__device__ __forceinline__ void store_quads(float* __restrict__ p, const Segment& sg, int base,
                                            int piece, const float4 (&v)[kQuads],
                                            const int (&valid)[kQuads]) {
#pragma unroll
  for (int i = 0; i < kQuads; ++i) {
    const int k = piece * kPiece + 4 * (threadIdx.x + kThreads * i);
    if (kVec) {
      if (valid[i]) *reinterpret_cast<float4*>(p + offset_of(sg, base, k)) = v[i];
    } else {
      const float e[4] = {v[i].x, v[i].y, v[i].z, v[i].w};
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (j < valid[i]) p[offset_of(sg, base, k + j)] = e[j];
    }
  }
}

__device__ __forceinline__ float at(const float4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

__device__ __forceinline__ float sigmoid(float u) { return 1.0f / (1.0f + expf(-u)); }

// The sum of ``a`` over the block, the same in every thread: a butterfly in
// each warp, then the warps' sums in order. ``red`` is kWarps floats of
// shared memory; the block synchronises before returning.
__device__ __forceinline__ float block_sum(float a, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) a += __shfl_xor_sync(0xffffffffu, a, o);
  __syncthreads();                             // ``red`` may still be read
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = a;
  __syncthreads();
  float s = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) s += red[w];
  return s;
}

// The piece's count, mean and M2, each piece's in ws[gc * pieces + piece].
template <bool kVec>
__global__ void __launch_bounds__(kThreads) bn_swish_stats_kernel(const float* __restrict__ x,
                                                                  float2* __restrict__ ws,
                                                                  Segment sg) {
  __shared__ float red[kWarps];
  const int gc = blockIdx.y, piece = blockIdx.x;
  const int base = segment_base(sg, gc);
  float4 v[kQuads];
  int valid[kQuads];
  load_quads<kVec>(x, sg, base, piece, v, valid);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < kQuads; ++i) s += (v[i].x + v[i].y) + (v[i].z + v[i].w);
  const float count = (float)min(kPiece, sg.length - piece * kPiece);
  const float mean = block_sum(s, red) / count;
  float d = 0.f, m2 = 0.f;
#pragma unroll
  for (int i = 0; i < kQuads; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (j < valid[i]) {
        const float t = at(v[i], j) - mean;
        d += t;
        m2 += t * t;
      }
  d = block_sum(d, red);
  m2 = block_sum(m2, red);
  if (threadIdx.x == 0) ws[gc * sg.pieces + piece] = make_float2(mean, m2 - d * d / count);
}

// (count, mean, M2) of a and b together (Chan et al.).
__device__ __forceinline__ void chan(float& na, float& ma, float& qa, float nb, float mb,
                                     float qb) {
  const float n = na + nb;
  if (nb == 0.f) return;
  const float d = mb - ma, f = nb / n;
  ma += d * f;
  qa += qb + d * d * na * f;
  na = n;
}

// Each channel's statistics, one block a channel, its groups in turn: the
// pieces merged by a fixed tree (thread t takes pieces t, t + 256, ... in
// order, then halving strides), so the order never changes.
__global__ void __launch_bounds__(kThreads) bn_swish_stats_merge_kernel(
    const float2* __restrict__ ws, float* __restrict__ mean, float* __restrict__ var,
    float* __restrict__ inv, Segment sg, float eps) {
  __shared__ float sn[kThreads], sm[kThreads], sq[kThreads];
  const int t = threadIdx.x;
  for (int g = 0; g < sg.groups; ++g) {
    const int gc = g * sg.c + blockIdx.x;
    float n = 0.f, m = 0.f, q = 0.f;
    for (int p = t; p < sg.pieces; p += kThreads) {
      const float2 w = ws[gc * sg.pieces + p];
      chan(n, m, q, (float)min(kPiece, sg.length - p * kPiece), w.x, w.y);
    }
    sn[t] = n;
    sm[t] = m;
    sq[t] = q;
    __syncthreads();
    for (int stride = kThreads / 2; stride > 0; stride >>= 1) {
      if (t < stride) {
        n = sn[t], m = sm[t], q = sq[t];
        chan(n, m, q, sn[t + stride], sm[t + stride], sq[t + stride]);
        sn[t] = n;
        sm[t] = m;
        sq[t] = q;
      }
      __syncthreads();
    }
    if (t == 0) {
      const float v = fmaxf(sq[0] / (float)sg.length, 0.f);     // biased
      mean[gc] = sm[0];
      var[gc] = v;
      inv[gc] = rsqrtf(v + eps);
    }
    __syncthreads();
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads) bn_swish_norm_kernel(
    const float* __restrict__ x, const float* __restrict__ weight,
    const float* __restrict__ bias, const float* __restrict__ mean,
    const float* __restrict__ inv, float* __restrict__ y, Segment sg) {
  const int gc = blockIdx.y, piece = blockIdx.x;
  const int base = segment_base(sg, gc);
  float4 v[kQuads];
  int valid[kQuads];
  load_quads<kVec>(x, sg, base, piece, v, valid);
  const int ch = gc % sg.c;
  const float mu = mean[gc], scale = inv[gc] * weight[ch], b = bias[ch];
#pragma unroll
  for (int i = 0; i < kQuads; ++i) {
    float e[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float u = (at(v[i], j) - mu) * scale + b;
      e[j] = u * sigmoid(u);
    }
    v[i] = make_float4(e[0], e[1], e[2], e[3]);
  }
  store_quads<kVec>(y, sg, base, piece, v, valid);
}

// The cotangent at u of the element x whose output gradient is gy; x_hat on
// the side.
struct Affine {
  float mu, inv, scale, b;
};

__device__ __forceinline__ float cotangent(const Affine& a, float x, float gy, float& x_hat) {
  const float xc = x - a.mu;
  x_hat = xc * a.inv;
  const float u = xc * a.scale + a.b;
  const float s = sigmoid(u);
  return gy * s * (1.f + u * (1.f - s));
}

__device__ __forceinline__ Affine affine_of(int gc, const Segment& sg,
                                            const float* __restrict__ weight,
                                            const float* __restrict__ bias,
                                            const float* __restrict__ mean,
                                            const float* __restrict__ inv) {
  const int ch = gc % sg.c;
  const float i = inv[gc];
  return Affine{mean[gc], i, i * weight[ch], bias[ch]};
}

// The piece's sum(ct) and sum(ct * x_hat), in ws[gc * pieces + piece].
template <bool kVec>
__global__ void __launch_bounds__(kThreads) bn_swish_grad_sums_kernel(
    const float* __restrict__ gy, const float* __restrict__ x,
    const float* __restrict__ weight, const float* __restrict__ bias,
    const float* __restrict__ mean, const float* __restrict__ inv,
    float2* __restrict__ ws, Segment sg) {
  __shared__ float red[kWarps];
  const int gc = blockIdx.y, piece = blockIdx.x;
  const int base = segment_base(sg, gc);
  float4 gv[kQuads], xv[kQuads];
  int valid[kQuads];
  load_quads<kVec>(gy, sg, base, piece, gv, valid);
  load_quads<kVec>(x, sg, base, piece, xv, valid);
  const Affine a = affine_of(gc, sg, weight, bias, mean, inv);
  float s_ct = 0.f, s_ctx = 0.f;
#pragma unroll
  for (int i = 0; i < kQuads; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (j < valid[i]) {
        float x_hat;
        const float ct = cotangent(a, at(xv[i], j), at(gv[i], j), x_hat);
        s_ct += ct;
        s_ctx += ct * x_hat;
      }
  s_ct = block_sum(s_ct, red);
  s_ctx = block_sum(s_ctx, red);
  if (threadIdx.x == 0) ws[gc * sg.pieces + piece] = make_float2(s_ct, s_ctx);
}

// Each channel's sums, one block a channel, its groups in turn, the pieces
// added by the same fixed tree as the statistics; sums[gc] and
// sums[G * C + gc] are sum(ct) and sum(ct * x_hat), and the weight and bias
// gradients add the groups' sums in order g = 0, 1, ...
__global__ void __launch_bounds__(kThreads) bn_swish_grad_merge_kernel(
    const float2* __restrict__ ws, float* __restrict__ sums, float* __restrict__ dweight,
    float* __restrict__ dbias, Segment sg) {
  __shared__ float sa[kThreads], sb[kThreads];
  const int t = threadIdx.x;
  float dw = 0.f, db = 0.f;
  for (int g = 0; g < sg.groups; ++g) {
    const int gc = g * sg.c + blockIdx.x;
    float a = 0.f, b = 0.f;
    for (int p = t; p < sg.pieces; p += kThreads) {
      const float2 w = ws[gc * sg.pieces + p];
      a += w.x;
      b += w.y;
    }
    sa[t] = a;
    sb[t] = b;
    __syncthreads();
    for (int stride = kThreads / 2; stride > 0; stride >>= 1) {
      if (t < stride) {
        sa[t] += sa[t + stride];
        sb[t] += sb[t + stride];
      }
      __syncthreads();
    }
    if (t == 0) {
      sums[gc] = sa[0];
      sums[sg.groups * sg.c + gc] = sb[0];
      db += sa[0];
      dw += sb[0];
    }
    __syncthreads();
  }
  if (t == 0) {
    dweight[blockIdx.x] = dw;
    dbias[blockIdx.x] = db;
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads) bn_swish_dx_kernel(
    const float* __restrict__ gy, const float* __restrict__ x,
    const float* __restrict__ weight, const float* __restrict__ bias,
    const float* __restrict__ mean, const float* __restrict__ inv,
    const float* __restrict__ sums, float* __restrict__ dx, Segment sg) {
  const int gc = blockIdx.y, piece = blockIdx.x;
  const int base = segment_base(sg, gc);
  float4 gv[kQuads], xv[kQuads];
  int valid[kQuads];
  load_quads<kVec>(gy, sg, base, piece, gv, valid);
  load_quads<kVec>(x, sg, base, piece, xv, valid);
  const Affine a = affine_of(gc, sg, weight, bias, mean, inv);
  const float m = (float)sg.length;
  const float k = a.scale / m;                          // weight * inv / M
  const float s_ct = sums[gc], s_ctx = sums[sg.groups * sg.c + gc];
#pragma unroll
  for (int i = 0; i < kQuads; ++i) {
    float e[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float x_hat;
      const float ct = cotangent(a, at(xv[i], j), at(gv[i], j), x_hat);
      e[j] = k * (m * ct - s_ct - x_hat * s_ctx);
    }
    gv[i] = make_float4(e[0], e[1], e[2], e[3]);
  }
  store_quads<kVec>(dx, sg, base, piece, gv, valid);
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

Segment segment_of(int groups, int n, int c, int hw) {
  Segment sg;
  sg.groups = groups;
  sg.n = n;
  sg.c = c;
  sg.hw = hw;
  sg.length = n * hw;
  sg.pieces = (sg.length + kPiece - 1) / kPiece;
  sg.row = c * hw;
  sg.by_hw = make_divmod((unsigned)hw);
  return sg;
}

dim3 grid_of(const Segment& sg) { return dim3(sg.pieces, sg.groups * sg.c); }

}  // namespace

// The blocks (pieces) of one group-channel of N rows of H * W elements.
extern "C" int bn_swish_pieces(int n, int hw) {
  return (int)(((long long)n * hw + kPiece - 1) / kPiece);
}

// ws: G * C * bn_swish_pieces(n, hw) float2; mean, var, inv: G * C each.
extern "C" int bn_swish_forward(const float* x, const float* weight, const float* bias,
                                float* y, float* mean, float* var, float* inv, float* ws,
                                int groups, int n, int c, int hw, float eps,
                                cudaStream_t stream) {
  const Segment sg = segment_of(groups, n, c, hw);
  const bool vec = hw % 4 == 0 && aligned16(x) && aligned16(y);
  float2* part = reinterpret_cast<float2*>(ws);
  if (vec)
    bn_swish_stats_kernel<true><<<grid_of(sg), kThreads, 0, stream>>>(x, part, sg);
  else
    bn_swish_stats_kernel<false><<<grid_of(sg), kThreads, 0, stream>>>(x, part, sg);
  bn_swish_stats_merge_kernel<<<c, kThreads, 0, stream>>>(part, mean, var, inv, sg, eps);
  if (vec)
    bn_swish_norm_kernel<true><<<grid_of(sg), kThreads, 0, stream>>>(x, weight, bias, mean,
                                                                     inv, y, sg);
  else
    bn_swish_norm_kernel<false><<<grid_of(sg), kThreads, 0, stream>>>(x, weight, bias, mean,
                                                                      inv, y, sg);
  return (int)cudaGetLastError();
}

// ws: G * C * bn_swish_pieces(n, hw) float2; sums: 2 * G * C; dweight, dbias: C.
extern "C" int bn_swish_backward(const float* g, const float* x, const float* weight,
                                 const float* bias, const float* mean, const float* inv,
                                 float* dx, float* dweight, float* dbias, float* ws,
                                 float* sums, int groups, int n, int c, int hw,
                                 cudaStream_t stream) {
  const Segment sg = segment_of(groups, n, c, hw);
  const bool vec = hw % 4 == 0 && aligned16(g) && aligned16(x) && aligned16(dx);
  float2* part = reinterpret_cast<float2*>(ws);
  if (vec)
    bn_swish_grad_sums_kernel<true><<<grid_of(sg), kThreads, 0, stream>>>(
        g, x, weight, bias, mean, inv, part, sg);
  else
    bn_swish_grad_sums_kernel<false><<<grid_of(sg), kThreads, 0, stream>>>(
        g, x, weight, bias, mean, inv, part, sg);
  bn_swish_grad_merge_kernel<<<c, kThreads, 0, stream>>>(part, sums, dweight, dbias, sg);
  if (vec)
    bn_swish_dx_kernel<true><<<grid_of(sg), kThreads, 0, stream>>>(g, x, weight, bias, mean,
                                                                   inv, sums, dx, sg);
  else
    bn_swish_dx_kernel<false><<<grid_of(sg), kThreads, 0, stream>>>(g, x, weight, bias, mean,
                                                                    inv, sums, dx, sg);
  return (int)cudaGetLastError();
}
