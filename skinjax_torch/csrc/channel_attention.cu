// DaViT's channel multi-head attention with its projections, forward and
// backward, for Hopper (sm_90a).
//
// It replaces the Pallas TPU kernel K8 of skinjax/ops/pallas/channel_attention.py:
// _ch_call with its forward body _ch_fwd_kernel and its backward body
// _ch_bwd_kernel. x is (B, N, C) contiguous, wqkv (C, 3C), bqkv (3C), wproj
// (C, C), bproj (C), all in the input type (bf16 or fp32). Per batch b and head
// h (hd = C / heads channels; q, k, v the head's (N, hd) slices):
//
//   forward   q, k, v = round(x.W + b)
//             s = (k^T.v) * scale           (hd, hd), summed over all N tokens, fp32
//             p = softmax(s) over each row, fp32
//             of = round(q.round(p)^T);  y = round(of.Wproj + bproj)
//   backward  q, k, v as above, do = round(dy.Wproj^T)
//             p recomputed;  pb = round(p)
//             of = round(q.pb^T);  dq = round(do.pb)
//             dp = do^T.q                    (hd, hd), summed over all N tokens, fp32
//             ds = round(p * (dp - rowsum(dp * p)) * scale)
//             dk = round(v.ds^T);  dv = round(k.ds)
//
// "round" is the cast to the input type where the Pallas kernel casts; every
// sum is fp32; the scale multiplies the fp32 scores after the product, as the
// Pallas kernel does. The backward emits dqkv (B, N, 3C) and of (B, N, C); dx
// and the weight gradients are flat matrix products outside the kernel
// (ops/channel_attention.py), as in skinjax's _ca_bwd.
//
// Layout. The TPU kernel scores the full (C, C) product under a block-diagonal
// head mask, because a 32-channel head would fill a quarter of its 128 lanes;
// the mask makes every entry off the head blocks exactly 0. Here each block
// computes one head's (hd, hd) block directly; there is no mask.
//
// Launches. The scores of a head are sums over every token (3136 at DaViT's
// stage 0), and blocks run in no order, so the sum is split in two passes with
// no atomics: (1) a block per (segment of 256 tokens, head, batch) projects its
// tokens 64 at a time and writes the segment's (hd, hd) partial of k^T.v (and,
// backward, of do^T.q; it also stores q, k, v and do, rounded, in a scratch for
// (3)); (2) a block per (head, batch) adds the partials in segment order and
// does the softmax (and, backward, ds), a warp a row; (3) a block per (64
// tokens, head, batch) computes its rows' of = q.pb^T (forward: q projected
// here) or of, dq, dk and dv (backward, from the scratch); (4) forward only, a
// tiled projection y = of.Wproj + bproj. The order of every sum is fixed by the
// shapes, so two calls on the same inputs give bit-identical results.
//
// What bounds it: at DaViT-tiny's stage 0 (B=64, N=3136, C=96, 3 heads) a
// forward does ~17 GFLOP (the projections ~85% of it) against ~77 MB of x and
// y: on the bf16 tensor cores bytes bound it (~23 us). This first version is
// simple and runs on the CUDA cores in fp32 (no mma, no TMA): the projections
// are register-tiled from shared memory (8 rows x 1-4 columns a thread, as
// K7's), a block re-reads its tokens' x from L2 once per head, and the
// backward's scratch adds 4 (B, N, C) planes of traffic. PERF.md records how
// far it is from its bound. Limit: hd <= 32 (DaViT: 32).
//
// C interface: each entry point launches on the given stream and returns
// cudaGetLastError() as an int (0 = success);
// skinjax_channel_attention_error_string maps the code to its message.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxHd = 32;   // channels per head
constexpr int kRows = 64;    // token rows a projection tile
constexpr int kRowsPer = 8;  // rows per thread in the projection
constexpr int kSeg = 256;    // tokens a block of the partial sums, kRows-aligned
constexpr int kKc = 32;      // input channels per projection chunk
constexpr int kXs = kKc + 1;     // row stride of the x / dy chunk
constexpr int kQs = kMaxHd + 1;  // row stride of q, k, v, do and the (hd, hd) planes
constexpr int kPairs = kMaxHd * kMaxHd / kThreads;  // (c, d) pairs a thread
constexpr int kTile = 64;    // output projection: 64 x 64 tiles
constexpr int kTileK = 16;

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to T and back: the cast points of the Pallas kernel
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32<T>(from_f32<T>(x));
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

struct Dims {
  int B, N, C, heads, hd, n_seg;
};

// shared-memory floats of the projection: an x chunk, a dy chunk, a weight
// chunk of up to four parts and the four (kRows, hd) parts it writes
constexpr int kChunkFloats = kRows * kXs;
constexpr int kWeightFloats = kKc * (4 * kMaxHd + 1);
constexpr int kPartFloats = kRows * kQs;
constexpr int proj_smem_bytes() { return 4 * (2 * kChunkFloats + kWeightFloats + 4 * kPartFloats); }
constexpr int grad_smem_bytes() { return 4 * (4 * kPartFloats + 2 * kMaxHd * kQs); }

// Rows n0 .. n0 + rows - 1 of batch b projected onto head hi's hd columns of
// each part, into out[part][r][d] (kRows rows a part, stride kQs), rounded to
// T: the parts kFirst .. kFirst + kCount - 1 of x.Wqkv + bqkv (0 q, 1 k, 2 v),
// then, with kDo, do = dy.Wproj^T. Thread (rb, d) accumulates rows rb*8 ..
// rb*8 + 7 of column d of every part, summing over the input channels in order.
template <typename T, int kFirst, int kCount, bool kDo>
__device__ void project(const T* __restrict__ x, const T* __restrict__ dy,
                        const T* __restrict__ wqkv, const T* __restrict__ bqkv,
                        const T* __restrict__ wproj, const Dims& g, int b, int hi, int n0,
                        int rows, float* xs, float* dys, float* ws, float* out) {
  constexpr int kParts = kCount + (kDo ? 1 : 0);
  constexpr int ws_stride = 4 * kMaxHd + 1;
  const int C = g.C, hd = g.hd;
  const int d = threadIdx.x % hd;
  const int rb = threadIdx.x / hd;
  const bool active = rb < kRows / kRowsPer;
  const long long row0 = (long long)b * g.N + n0;
  float acc[kRowsPer][kParts];
#pragma unroll
  for (int i = 0; i < kRowsPer; ++i)
#pragma unroll
    for (int p = 0; p < kParts; ++p) acc[i][p] = 0.f;

  for (int k0 = 0; k0 < C; k0 += kKc) {
    const int kc = min(kKc, C - k0);
    for (int idx = threadIdx.x; idx < kRows * kKc; idx += kThreads) {
      const int r = idx / kKc, kk = idx - r * kKc;
      const bool in = r < rows && kk < kc;
      xs[r * kXs + kk] = in ? to_f32<T>(x[(row0 + r) * C + k0 + kk]) : 0.f;
      if (kDo) dys[r * kXs + kk] = in ? to_f32<T>(dy[(row0 + r) * C + k0 + kk]) : 0.f;
    }
    for (int idx = threadIdx.x; idx < kKc * kCount * hd; idx += kThreads) {
      const int kk = idx / (kCount * hd), c = idx - kk * kCount * hd;
      const int p = c / hd, dd = c - p * hd;
      ws[kk * ws_stride + c] =
          kk < kc ? to_f32<T>(wqkv[(size_t)(k0 + kk) * 3 * C + (kFirst + p) * C + hi * hd + dd])
                  : 0.f;
    }
    if (kDo) {
      for (int idx = threadIdx.x; idx < hd * kKc; idx += kThreads) {
        const int dd = idx / kKc, kk = idx - dd * kKc;
        ws[kk * ws_stride + kCount * hd + dd] =
            kk < kc ? to_f32<T>(wproj[(size_t)(hi * hd + dd) * C + k0 + kk]) : 0.f;
      }
    }
    __syncthreads();
    if (active) {
#pragma unroll 4
      for (int kk = 0; kk < kKc; ++kk) {
        float wv[kParts];
#pragma unroll
        for (int p = 0; p < kParts; ++p) wv[p] = ws[kk * ws_stride + p * hd + d];
#pragma unroll
        for (int i = 0; i < kRowsPer; ++i) {
          const float xv = xs[(rb * kRowsPer + i) * kXs + kk];
#pragma unroll
          for (int p = 0; p < kCount; ++p) acc[i][p] = fmaf(xv, wv[p], acc[i][p]);
          if (kDo)
            acc[i][kParts - 1] =
                fmaf(dys[(rb * kRowsPer + i) * kXs + kk], wv[kParts - 1], acc[i][kParts - 1]);
        }
      }
    }
    __syncthreads();
  }
  if (active) {
#pragma unroll
    for (int i = 0; i < kRowsPer; ++i) {
      const int r = rb * kRowsPer + i;
#pragma unroll
      for (int p = 0; p < kCount; ++p)
        out[(p * kRows + r) * kQs + d] =
            round_to<T>(__fadd_rn(acc[i][p], to_f32<T>(bqkv[(kFirst + p) * C + hi * hd + d])));
      if (kDo) out[((kParts - 1) * kRows + r) * kQs + d] = round_to<T>(acc[i][kParts - 1]);
    }
  }
  __syncthreads();
}

// The (hd, hd) pairs (c, d) of this thread: c * hd + d = threadIdx.x + j * kThreads.
__device__ __forceinline__ bool pair(const Dims& g, int j, int& c, int& d) {
  const int idx = threadIdx.x + j * kThreads;
  c = idx / g.hd;
  d = idx - c * g.hd;
  return idx < g.hd * g.hd;
}

// (1) Partial sums of a segment: part_s[b][hi][seg] = k^T.v over its tokens
// (kBwd: part_dp = do^T.q too, and q, k, v, do stored in qkvd (B, N, 4, C)).
template <typename T, bool kBwd>
__global__ void __launch_bounds__(kThreads)
    ca_partial_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                      const T* __restrict__ wqkv, const T* __restrict__ bqkv,
                      const T* __restrict__ wproj, T* __restrict__ qkvd,
                      float* __restrict__ part_s, float* __restrict__ part_dp, Dims g) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;
  float* dys = xs + kChunkFloats;
  float* ws = dys + kChunkFloats;
  float* parts = ws + kWeightFloats;
  // forward: parts 0, 1 = k, v; backward: parts 0..3 = q, k, v, do
  const float* k = parts + (kBwd ? kPartFloats : 0);
  const float* v = k + kPartFloats;
  const float* q = parts;
  const float* dout = parts + 3 * kPartFloats;
  const int seg = blockIdx.x, hi = blockIdx.y, b = blockIdx.z;
  const int hd = g.hd;
  float as[kPairs], ad[kPairs];
#pragma unroll
  for (int j = 0; j < kPairs; ++j) as[j] = ad[j] = 0.f;

  const int end = min(g.N, (seg + 1) * kSeg);
  for (int n0 = seg * kSeg; n0 < end; n0 += kRows) {
    const int rows = min(kRows, end - n0);
    if (kBwd)
      project<T, 0, 3, true>(x, dy, wqkv, bqkv, wproj, g, b, hi, n0, rows, xs, dys, ws, parts);
    else
      project<T, 1, 2, false>(x, nullptr, wqkv, bqkv, nullptr, g, b, hi, n0, rows, xs, nullptr,
                              ws, parts);
#pragma unroll
    for (int j = 0; j < kPairs; ++j) {
      int c, d;
      if (!pair(g, j, c, d)) continue;
      for (int r = 0; r < rows; ++r) {
        as[j] = fmaf(k[r * kQs + c], v[r * kQs + d], as[j]);
        if (kBwd) ad[j] = fmaf(dout[r * kQs + c], q[r * kQs + d], ad[j]);
      }
    }
    if (kBwd) {
      for (int idx = threadIdx.x; idx < 4 * rows * hd; idx += kThreads) {
        const int p = idx / (rows * hd), rem = idx - p * rows * hd;
        const int r = rem / hd, d = rem - r * hd;
        qkvd[(((long long)b * g.N + n0 + r) * 4 + p) * g.C + hi * hd + d] =
            from_f32<T>(parts[(p * kRows + r) * kQs + d]);
      }
    }
    __syncthreads();  // the parts consumed before the next tile's projection
  }
  const long long at = (((long long)b * g.heads + hi) * g.n_seg + seg) * hd * hd;
#pragma unroll
  for (int j = 0; j < kPairs; ++j) {
    int c, d;
    if (!pair(g, j, c, d)) continue;
    part_s[at + c * hd + d] = as[j];
    if (kBwd) part_dp[at + c * hd + d] = ad[j];
  }
}

// (2) For one (head, batch): s = the partials' sum in segment order * scale,
// p = softmax(s) a warp a row; pb = round(p) (fp32 holding T's value) and,
// kBwd, ds = round(p * (dp - rowsum(dp * p)) * scale).
template <typename T, bool kBwd>
__global__ void __launch_bounds__(kThreads)
    ca_softmax_kernel(const float* __restrict__ part_s, const float* __restrict__ part_dp,
                      float* __restrict__ pb, float* __restrict__ ds, Dims g, float scale) {
  const int hi = blockIdx.x, b = blockIdx.y;
  const int hd = g.hd;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long plane = ((long long)b * g.heads + hi) * hd * hd;
  const long long parts = plane * g.n_seg;
  for (int c = warp; c < hd; c += kWarps) {
    float s = -CUDART_INF_F, dp = 0.f;
    if (lane < hd) {
      float a = 0.f;
      for (int seg = 0; seg < g.n_seg; ++seg) a += part_s[parts + (long long)seg * hd * hd + c * hd + lane];
      s = __fmul_rn(a, scale);
      if (kBwd)
        for (int seg = 0; seg < g.n_seg; ++seg)
          dp += part_dp[parts + (long long)seg * hd * hd + c * hd + lane];
    }
    const float mx = warp_max(s);
    const float e = lane < hd ? expf(s - mx) : 0.f;
    const float p = e / warp_sum(e);
    if (lane < hd) pb[plane + c * hd + lane] = round_to<T>(p);
    if (kBwd) {
      const float rs = warp_sum(lane < hd ? __fmul_rn(dp, p) : 0.f);
      if (lane < hd)
        ds[plane + c * hd + lane] = round_to<T>(__fmul_rn(__fmul_rn(p, __fsub_rn(dp, rs)), scale));
    }
  }
}

// (3) forward: of[n][hi*hd + c] = round(sum_d q[n][d] pb[c][d]) for 64 tokens,
// q projected here.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    ca_out_kernel(const T* __restrict__ x, const T* __restrict__ wqkv, const T* __restrict__ bqkv,
                  const float* __restrict__ pb, T* __restrict__ of, Dims g) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;
  float* ws = xs + 2 * kChunkFloats;
  float* q = ws + kWeightFloats;
  float* ps = q + 4 * kPartFloats;
  const int n0 = blockIdx.x * kRows, hi = blockIdx.y, b = blockIdx.z;
  const int hd = g.hd;
  const int rows = min(kRows, g.N - n0);
  const long long plane = ((long long)b * g.heads + hi) * hd * hd;
  for (int idx = threadIdx.x; idx < hd * hd; idx += kThreads)
    ps[(idx / hd) * kQs + idx % hd] = pb[plane + idx];
  project<T, 0, 1, false>(x, nullptr, wqkv, bqkv, nullptr, g, b, hi, n0, rows, xs, nullptr, ws,
                          q);
  for (int idx = threadIdx.x; idx < rows * hd; idx += kThreads) {
    const int r = idx / hd, c = idx - r * hd;
    float a = 0.f;
    for (int d = 0; d < hd; ++d) a = fmaf(q[r * kQs + d], ps[c * kQs + d], a);
    of[((long long)b * g.N + n0 + r) * g.C + hi * hd + c] = from_f32<T>(a);
  }
}

// (3) backward: of, dq, dk, dv for 64 tokens from the scratch of (1) and the
// pb, ds planes of (2); dq, dk, dv go to dqkv (B, N, 3C).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    ca_grad_kernel(const T* __restrict__ qkvd, const float* __restrict__ pb,
                   const float* __restrict__ ds, T* __restrict__ dqkv, T* __restrict__ of,
                   Dims g) {
  extern __shared__ __align__(16) float smem[];
  float* parts = smem;  // q, k, v, do
  float* ps = parts + 4 * kPartFloats;
  float* dss = ps + kMaxHd * kQs;
  const int n0 = blockIdx.x * kRows, hi = blockIdx.y, b = blockIdx.z;
  const int hd = g.hd, C = g.C;
  const int rows = min(kRows, g.N - n0);
  const long long plane = ((long long)b * g.heads + hi) * hd * hd;
  for (int idx = threadIdx.x; idx < hd * hd; idx += kThreads) {
    ps[(idx / hd) * kQs + idx % hd] = pb[plane + idx];
    dss[(idx / hd) * kQs + idx % hd] = ds[plane + idx];
  }
  for (int idx = threadIdx.x; idx < 4 * rows * hd; idx += kThreads) {
    const int p = idx / (rows * hd), rem = idx - p * rows * hd;
    const int r = rem / hd, d = rem - r * hd;
    parts[(p * kRows + r) * kQs + d] =
        to_f32<T>(qkvd[(((long long)b * g.N + n0 + r) * 4 + p) * C + hi * hd + d]);
  }
  __syncthreads();
  const float* q = parts;
  const float* k = parts + kPartFloats;
  const float* v = parts + 2 * kPartFloats;
  const float* dout = parts + 3 * kPartFloats;
  for (int idx = threadIdx.x; idx < rows * hd; idx += kThreads) {
    const int r = idx / hd, j = idx - r * hd;  // j: c of of and dk, d of dq and dv
    float o = 0.f, dq = 0.f, dk = 0.f, dv = 0.f;
    for (int i = 0; i < hd; ++i) {
      o = fmaf(q[r * kQs + i], ps[j * kQs + i], o);        // sum_d q[d] pb[c][d]
      dq = fmaf(dout[r * kQs + i], ps[i * kQs + j], dq);   // sum_c do[c] pb[c][d]
      dk = fmaf(v[r * kQs + i], dss[j * kQs + i], dk);     // sum_d v[d] ds[c][d]
      dv = fmaf(k[r * kQs + i], dss[i * kQs + j], dv);     // sum_c k[c] ds[c][d]
    }
    const long long row = (long long)b * g.N + n0 + r;
    of[row * C + hi * hd + j] = from_f32<T>(o);
    dqkv[row * 3 * C + hi * hd + j] = from_f32<T>(dq);
    dqkv[row * 3 * C + C + hi * hd + j] = from_f32<T>(dk);
    dqkv[row * 3 * C + 2 * C + hi * hd + j] = from_f32<T>(dv);
  }
}

// (4) Output projection: out (M, N) = round(a (M, K) . wt (K, N) + bias), 64 x
// 64 tiles, 16 deep, each thread 4 x 4 outputs at a stride of 16.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    ca_proj_kernel(const T* __restrict__ a, const T* __restrict__ wt, const T* __restrict__ bias,
                   T* __restrict__ out, int M, int N, int K) {
  __shared__ float as[kTileK][kTile + 4];
  __shared__ float bs[kTileK][kTile + 4];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const long long m0 = (long long)blockIdx.y * kTile;
  const int n0 = blockIdx.x * kTile;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < K; k0 += kTileK) {
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int idx = threadIdx.x + kThreads * t;
      const int r = idx / kTileK, kk = idx - r * kTileK;
      as[kk][r] = (m0 + r < M && k0 + kk < K) ? to_f32<T>(a[(m0 + r) * K + k0 + kk]) : 0.f;
      const int kb = idx / kTile, c = idx - kb * kTile;
      bs[kb][c] = (k0 + kb < K && n0 + c < N) ? to_f32<T>(wt[(size_t)(k0 + kb) * N + n0 + c])
                                               : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kTileK; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = as[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += av[i] * bv[j];
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long r = m0 + ty + 16 * i;
    if (r >= M) break;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = n0 + tx + 16 * j;
      if (c < N) out[r * N + c] = from_f32<T>(acc[i][j] + to_f32<T>(bias[c]));
    }
  }
}

Dims dims(int B, int N, int C, int heads) {
  Dims g;
  g.B = B;
  g.N = N;
  g.C = C;
  g.heads = heads;
  g.hd = heads > 0 ? C / heads : 0;
  g.n_seg = (N + kSeg - 1) / kSeg;
  return g;
}

bool bad_dims(const Dims& g, int n_seg) {
  return g.N < 1 || g.heads < 1 || g.C % g.heads != 0 || g.hd < 1 || g.hd > kMaxHd ||
         g.B < 1 || g.B > 65535 || g.heads > 65535 || n_seg != g.n_seg;
}

template <typename T>
cudaError_t launch_fwd(const void* x, const void* wqkv, const void* bqkv, const void* wproj,
                       const void* bproj, float* part, float* pb, void* of, void* y,
                       const Dims& g, float scale, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(wqkv);
  const T* bt = static_cast<const T*>(bqkv);
  const int smem = proj_smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(ca_partial_kernel<T, false>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  ca_partial_kernel<T, false><<<dim3(g.n_seg, g.heads, g.B), kThreads, smem, stream>>>(
      xt, nullptr, wt, bt, nullptr, nullptr, part, nullptr, g);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ca_softmax_kernel<T, false><<<dim3(g.heads, g.B), kThreads, 0, stream>>>(part, nullptr, pb,
                                                                           nullptr, g, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int out_smem = smem + 4 * kMaxHd * kQs;
  err = cudaFuncSetAttribute(ca_out_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             out_smem);
  if (err != cudaSuccess) return err;
  ca_out_kernel<T><<<dim3((g.N + kRows - 1) / kRows, g.heads, g.B), kThreads, out_smem,
                     stream>>>(xt, wt, bt, pb, static_cast<T*>(of), g);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const long long M = (long long)g.B * g.N;
  ca_proj_kernel<T><<<dim3((g.C + kTile - 1) / kTile, (unsigned)((M + kTile - 1) / kTile)),
                      kThreads, 0, stream>>>(static_cast<const T*>(of),
                                             static_cast<const T*>(wproj),
                                             static_cast<const T*>(bproj), static_cast<T*>(y),
                                             (int)M, g.C, g.C);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const void* x, const void* dy, const void* wqkv, const void* bqkv,
                       const void* wproj, void* qkvd, float* part, float* pb, float* ds,
                       void* dqkv, void* of, const Dims& g, float scale, cudaStream_t stream) {
  const int smem = proj_smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(ca_partial_kernel<T, true>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  float* part_dp = part + (long long)g.B * g.heads * g.n_seg * g.hd * g.hd;
  ca_partial_kernel<T, true><<<dim3(g.n_seg, g.heads, g.B), kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), static_cast<const T*>(wqkv),
      static_cast<const T*>(bqkv), static_cast<const T*>(wproj), static_cast<T*>(qkvd), part,
      part_dp, g);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ca_softmax_kernel<T, true><<<dim3(g.heads, g.B), kThreads, 0, stream>>>(part, part_dp, pb, ds,
                                                                          g, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int gsmem = grad_smem_bytes();
  err = cudaFuncSetAttribute(ca_grad_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             gsmem);
  if (err != cudaSuccess) return err;
  ca_grad_kernel<T><<<dim3((g.N + kRows - 1) / kRows, g.heads, g.B), kThreads, gsmem, stream>>>(
      static_cast<const T*>(qkvd), pb, ds, static_cast<T*>(dqkv), static_cast<T*>(of), g);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* skinjax_channel_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// bf16: 0 for float, 1 for bfloat16 (x, the weights, of and y share it).
// x (B, N, C) contiguous; wqkv (C, 3C), bqkv (3C), wproj (C, C), bproj (C).
// Scratch: part (B, heads, n_seg, hd, hd) fp32, pb (B, heads, hd, hd) fp32, of
// (B, N, C); n_seg = ceil(N / 256). y (B, N, C) is written.
int skinjax_channel_attention_fwd(int bf16, const void* x, const void* wqkv, const void* bqkv,
                                  const void* wproj, const void* bproj, float* part, float* pb,
                                  void* of, void* y, int B, int N, int C, int heads, int n_seg,
                                  float scale, void* stream) {
  const Dims g = dims(B, N, C, heads);
  if (bad_dims(g, n_seg)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch_fwd<__nv_bfloat16>(x, wqkv, bqkv, wproj, bproj, part, pb, of, y, g, scale, s);
  return launch_fwd<float>(x, wqkv, bqkv, wproj, bproj, part, pb, of, y, g, scale, s);
}

// dy like x. Scratch: qkvd (B, N, 4, C) in the input type, part (2, B, heads,
// n_seg, hd, hd) fp32, pb and ds (B, heads, hd, hd) fp32. Writes dqkv (B, N,
// 3C) and of (B, N, C).
int skinjax_channel_attention_bwd(int bf16, const void* x, const void* dy, const void* wqkv,
                                  const void* bqkv, const void* wproj, void* qkvd, float* part,
                                  float* pb, float* ds, void* dqkv, void* of, int B, int N, int C,
                                  int heads, int n_seg, float scale, void* stream) {
  const Dims g = dims(B, N, C, heads);
  if (bad_dims(g, n_seg)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch_bwd<__nv_bfloat16>(x, dy, wqkv, bqkv, wproj, qkvd, part, pb, ds, dqkv, of, g,
                                     scale, s);
  return launch_bwd<float>(x, dy, wqkv, bqkv, wproj, qkvd, part, pb, ds, dqkv, of, g, scale, s);
}

}  // extern "C"
