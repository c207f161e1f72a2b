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
// no atomics: (1) a block per segment of 256 tokens writes the segment's
// (hd, hd) partials of k^T.v (and, backward, of do^T.q); (2) a block per
// (head, batch), ca_softmax_kernel, adds the partials in segment order and
// does the softmax (and, backward, ds), a warp a row; (3) a block per 64
// tokens computes of and, forward, y = round(of.Wproj + bproj), or, backward,
// of, dq, dk and dv. The order of every sum is fixed by the shapes, so two
// calls on the same inputs give bit-identical results.
//
// What bounds it: at DaViT-tiny's stage 0 (B=64, N=3136, C=96, 3 heads) a
// forward does ~17 GFLOP (the projections ~85% of it) against ~77 MB of x and
// y, a backward ~35 GFLOP against ~231 MB: on the bf16 tensor cores bytes
// bound both (~23 and ~69 us).
//
// The tensor-core route, bf16 at 32 channels a head and a head count that
// 3 divides (DaViT's 3, 6, 12, 24), runs on the tensor cores
// (mma.sync.m16n8k16 from ldmatrix fragments, fp32 accumulators in
// registers; mma_bf16.cuh). A block owns its 64-row token tiles for a group
// of kG = 3 heads (every head in (3) of the forward), so it reads each
// 32-channel step of x (and dy) once, by 16-byte cp.async, for every column
// of the group: ca_partial_mma_kernel, ca_out_mma_kernel and
// ca_grad_mma_kernel, below. The forward's (3) fuses the output projection
// (of stays in shared memory); the backward's (1) stores q, k, v and do as
// four (B, N, C) planes for its (3). The caller chooses the route
// (ops/channel_attention.py plan); the entry points check its shapes. The
// CUDA-core route, every other shape and the fp32 instantiation, runs fp32
// FMAs, no mma: a block per head, the projections register-tiled from shared memory (8 rows x 1-4
// columns a thread), q, k, v and do stored to a (B, N, 4, C) scratch by the
// backward's (1) for its (3), and (4), forward only, a tiled projection y =
// of.Wproj + bproj (ca_proj_kernel); TF32 would not hold their 1e-4 checks.
// PERF.md records how far each is from its bound. Limit: hd <= 32 (DaViT:
// 32).
//
// C interface: each entry point launches on the given stream and returns
// cudaGetLastError() as an int (0 = success);
// skinjax_channel_attention_error_string maps the code to its message.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "mma_bf16.cuh"

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
constexpr int kProjTile = 64;  // output projection: 64 x 64 tiles
constexpr int kProjTileK = 16;

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
  __shared__ float as[kProjTileK][kProjTile + 4];
  __shared__ float bs[kProjTileK][kProjTile + 4];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const long long m0 = (long long)blockIdx.y * kProjTile;
  const int n0 = blockIdx.x * kProjTile;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < K; k0 += kProjTileK) {
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int idx = threadIdx.x + kThreads * t;
      const int r = idx / kProjTileK, kk = idx - r * kProjTileK;
      as[kk][r] = (m0 + r < M && k0 + kk < K) ? to_f32<T>(a[(m0 + r) * K + k0 + kk]) : 0.f;
      const int kb = idx / kProjTile, c = idx - kb * kProjTile;
      bs[kb][c] = (k0 + kb < K && n0 + c < N) ? to_f32<T>(wt[(size_t)(k0 + kb) * N + n0 + c])
                                               : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kProjTileK; ++kk) {
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

// ---- The bf16 instantiation on the tensor cores (32 channels a head) ----
//
// Four warps take a 64-row token tile, a warp 16 rows; a block has 4 kCS
// warps, one column group of the tile's projections each set of four (kCS
// groups). Every projection is a (64 x 32) unit: rows of x (or dy) times a
// (C x 32) slice of Wqkv (or the transpose of a head's 32 rows of Wproj).
// project_tile streams the C input channels in 32-deep steps, two deep by
// cp.async: a step brings the tile's x (and dy) columns once for every unit
// of the block and, unless they stay in shared memory, the units' slices;
// a warp adds its units' products (up to kG, 16 fp32 accumulators each)
// in registers, in channel order.
//
//   ca_partial_mma_kernel<kBwd>  a block per (segment of 256 tokens, group of
//     kG heads, batch): 8 warps (k, v) or, backward, 16 (q, k, v, do) project
//     each 64-row tile (the weight slices held for all the segment's tiles
//     where they fit, partial_resident); the units go rounded (+ bias) into
//     (64 x 32) tiles, and, backward, from there to the scratch's four (B,
//     N, C) planes as 16-byte rows; then a warp per (head, 16 rows of k^T.v
//     or do^T.q) adds the tile's (16 x 32) product on the tensor cores, A =
//     k^T (or do^T) by ldmatrix.trans, B = v (or q) by ldmatrix.trans, into
//     accumulators kept in registers over the segment and stored once at
//     its end.
//   ca_out_mma_kernel  a block of 8 warps per (64 tokens, batch), every
//     head: q of 6 heads a pass (a warp 3), then per head of_h = round(q_h .
//     pb_h^T) from q's accumulators as A fragments into a (64 x C) bf16 tile
//     of of; then y = round(of . Wproj + bproj), 192 columns a pass, A from
//     the of tile, Wproj streamed, out through shared memory as 16-byte
//     rows. of never reaches device memory.
//   ca_grad_mma_kernel  a block of 16 warps per (64 tokens, kG heads,
//     batch): q, k, v, do read back from the scratch, then each warp its
//     product with its part's rows as A fragments: of = q.pb^T, dv = k.ds,
//     dk = v.ds^T, dq = do.pb, out through shared memory as 16-byte rows of
//     of and dqkv.
//
// The (hd, hd) planes pb and ds (fp32 holding bf16 values) come to shared
// memory as bf16, exactly. The scratch (q, k, v, do: 308 MB of traffic at
// DaViT-tiny's stage 0, B=64) cost less on the card than projecting them
// again in (3) (14.8 GFLOP) at every stage (PERF.md).

constexpr int kHd = 32;              // channels a head on this route
constexpr int kL = tile_ld<kHd>();   // row stride of the 32-wide bf16 tiles
constexpr int kA = kTile * kL;       // a (64 x 32) tile: a step of x or dy, a head's q, k, v, do
constexpr int kU = kHd * kL;         // a (32 x 32) slice of a weight, or a head's pb or ds
constexpr int kG = 3;                // heads a block's group; the route takes heads % kG == 0
constexpr int kYCols = 2 * kG * kHd;  // output columns of a y pass (ca_out_mma_kernel)
constexpr int kYl = kYCols + 8;          // row stride of the y tile

// The origin of a unit's (32 x 32) weight block in a row-major matrix (ld
// elements a row); p == nullptr: no unit
struct Slice {
  const bf16* p;
  long long ld;
};

// dst (64 x 32 at stride kL) = rows [row0, row0 + rows) of the row-major
// (.. x C) src at columns [k0, k0 + 32), zero past rows; 16-byte cp.async
template <int kN>
__device__ __forceinline__ void load_rows(bf16* __restrict__ dst, const bf16* __restrict__ src,
                                          int C, long long row0, int rows, int k0) {
  for (int i = threadIdx.x; i < kTile * 4; i += kN) {
    const int r = i >> 2, c = (i & 3) * 8;
    bf16* d = dst + r * kL + c;
    if (r < rows)
      cp_async16(d, src + (row0 + r) * C + k0 + c);
    else
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
  }
}

// count (32 x 32) bf16 tiles at stride kL: tile u from the fp32 (hd, hd)
// plane number plane(u) of planes (< 0: none), values that bf16 holds
// exactly
template <int kN, typename F>
__device__ __forceinline__ void load_planes(bf16* __restrict__ dst,
                                            const float* __restrict__ planes, int count,
                                            F&& plane) {
  for (int i = threadIdx.x; i < count * kHd * kHd; i += kN) {
    const int u = i >> 10, c = (i >> 5) & 31, d = i & 31;
    const long long at = plane(u);
    if (at >= 0) dst[u * kU + c * kL + d] = __float2bfloat16_rn(planes[at * kHd * kHd + i % 1024]);
  }
}

// The A fragment of rows c0.. (16) and columns n0.. (16) of X^T, X the (64 x
// 32) bf16 tile x: a head's k or do, tokens as rows (ldmatrix.trans)
__device__ __forceinline__ void load_at(unsigned (&a)[4], const bf16* x, int n0, int c0) {
  const int lane = threadIdx.x & 31, m = lane >> 3;
  ldsm_x4_trans(a, x + (n0 + (lane & 7) + ((m >> 1) << 3)) * kL + c0 + ((m & 1) << 3));
}

// x (a warp's 16 x 32 accumulators) += the bias of its columns (b: the
// 32 columns' bias), one fp32 add each
__device__ __forceinline__ void add_bias(float (&x)[4][4], const bf16* __restrict__ b) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int jd = 0; jd < 4; ++jd) {
    const float b0 = __bfloat162float(b[8 * jd + 2 * t]);
    const float b1 = __bfloat162float(b[8 * jd + 2 * t + 1]);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      x[jd][2 * h] = __fadd_rn(x[jd][2 * h], b0);
      x[jd][2 * h + 1] = __fadd_rn(x[jd][2 * h + 1], b1);
    }
  }
}

// the A fragments (two 16-column steps) of a warp's (16 x 32) accumulators,
// rounded to bf16
__device__ __forceinline__ void pack_rows(unsigned (&a)[2][4], const float (&x)[4][4]) {
#pragma unroll
  for (int ks = 0; ks < 2; ++ks)
    pack_a_chunk(a[ks], *reinterpret_cast<const float(*)[2][4]>(&x[2 * ks]));
}

// a warp's (16 x 32) x rounded to bf16 into rows 16 rw + g, + 8 of the tile
// dst (row stride ld), zero at rows >= rows
__device__ __forceinline__ void store_rows(bf16* __restrict__ dst, int ld,
                                           const float (&x)[4][4], int rw, int rows) {
  const int lane = threadIdx.x & 31, t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = 16 * rw + (lane >> 2) + 8 * h;
#pragma unroll
    for (int jd = 0; jd < 4; ++jd)
      *reinterpret_cast<unsigned*>(dst + r * ld + 8 * jd + 2 * t) =
          r < rows ? pack_bf16(x[jd][2 * h], x[jd][2 * h + 1]) : 0u;
  }
}

// rows [0, rows) x columns [0, cols) of the bf16 tile src (row stride lds)
// to rows row0.. of the row-major dst (ld elements a row) at column c0, in
// 16-byte pieces (cols a multiple of 8)
template <int kN>
__device__ __forceinline__ void store_tile(bf16* __restrict__ dst, long long ld, long long row0,
                                           int c0, const bf16* __restrict__ src, int lds,
                                           int rows, int cols) {
  const int v = cols >> 3;
  for (int i = threadIdx.x; i < rows * v; i += kN) {
    const int r = i / v, c = (i - r * v) * 8;
    *reinterpret_cast<uint4*>(dst + (row0 + r) * ld + c0 + c) =
        *reinterpret_cast<const uint4*>(src + r * lds + c);
  }
}

// The shared-memory elements of a projection step: x (and, kDo, dy) and the
// block's kCS * kG weight slices
template <int kCS, bool kDo>
__host__ __device__ constexpr int proj_stage() {
  return (kDo ? 2 : 1) * kA + kCS * kG * kU;
}

// The (32 x 32) slices of a block's units (cg, j) for input channels k0..
// into dst, unit cg kG + j at dst + (cg kG + j) kU; cp.async
template <int kCS, typename Unit>
__device__ __forceinline__ void load_step_slices(bf16* __restrict__ dst, int k0, Unit&& unit) {
  for (int i = threadIdx.x; i < kCS * kG * 128; i += 128 * kCS) {
    const int u = i >> 7, r = (i >> 2) & 31, c = (i & 3) * 8;
    const Slice sl = unit(u / kG, u % kG, k0);
    if (sl.p) cp_async16(dst + u * kU + r * kL + c, sl.p + r * sl.ld + c);
  }
}

// acc[j] = the warp's 16 rows of unit (cg, j), cg = warp / 4 its column
// group: rows [row0, row0 + rows) of x (kDo: of dy for the last group,
// whose slices are (32 output x 32 input) blocks of Wproj, do = dy.Wproj^T)
// times the slice unit(cg, j, k0) gives for input channels k0.., summed over
// the C channels in 32-deep steps, two stages in region. The slices come
// with each step, or, wres not null, stay in shared memory at wres
// (load_slices): step st's unit u at wres + (st kCS kG + u) kU. Every
// thread of the block calls it; it ends with a barrier, region free.
template <int kCS, bool kDo, typename Unit>
__device__ __forceinline__ void project_tile(float (&acc)[kG][4][4], bf16* __restrict__ region,
                                             const bf16* __restrict__ x,
                                             const bf16* __restrict__ dy, int C, long long row0,
                                             int rows, Unit&& unit,
                                             const bf16* __restrict__ wres = nullptr) {
  constexpr int kN = 128 * kCS, kNA = kDo ? 2 : 1, kStage = proj_stage<kCS, kDo>();
  constexpr int kUnits = kCS * kG;
  const int warp = threadIdx.x >> 5, cg = warp >> 2, rw = warp & 3;
  const bool from_dy = kDo && cg == kCS - 1;
  bool has[kG];
#pragma unroll
  for (int j = 0; j < kG; ++j) {
    zero_acc<kHd>(acc[j]);
    has[j] = unit(cg, j, 0).p != nullptr;
  }
  pipeline(
      C / kHd,
      [&](int st, int buf) {
        bf16* const s = region + buf * kStage;
        const int k0 = st * kHd;
        load_rows<kN>(s, x, C, row0, rows, k0);
        if constexpr (kDo) load_rows<kN>(s + kA, dy, C, row0, rows, k0);
        if (!wres) load_step_slices<kCS>(s + kNA * kA, k0, unit);
      },
      [&](int st, int buf) {
        const bf16* const s = region + buf * kStage;
        const bf16* const ws = wres ? wres + st * kUnits * kU : s + kNA * kA;
        unsigned af[2][4];
        load_a<kHd>(af, s + (from_dy ? kA : 0) + 16 * rw * kL);
#pragma unroll
        for (int j = 0; j < kG; ++j) {
          if (!has[j]) continue;
          const bf16* const w = ws + (cg * kG + j) * kU;
#pragma unroll
          for (int ks = 0; ks < 2; ++ks) {
            if (from_dy)
              warp_abt_step(acc[j], af[ks], w, ks);
            else
              warp_ax_chunk<kHd>(acc[j], af[ks], w, ks);
          }
        }
      });
}

// Every step's slices of project_tile's units into wres, by cp.async in
// one group, in flight until the first step waits
template <int kCS, typename Unit>
__device__ __forceinline__ void load_slices(bf16* __restrict__ wres, int C, Unit&& unit) {
  for (int st = 0; st < C / kHd; ++st)
    load_step_slices<kCS>(wres + st * kCS * kG * kU, st * kHd, unit);
  cp_async_commit();
}

// The unit (cg, j) of (1) and (3) of the backward and (1) of the forward:
// part p (0 q, 1 k, 2 v of Wqkv's columns; 3 do, Wproj's rows) of head h0 + j
__device__ __forceinline__ Slice qkvd_slice(const bf16* wqkv, const bf16* wproj, int C, int h0,
                                            int p, int j, int k0) {
  if (p < 3) return Slice{wqkv + (long long)k0 * 3 * C + p * C + (h0 + j) * kHd, 3LL * C};
  return Slice{wproj + (long long)(h0 + j) * kHd * C + k0, (long long)C};
}

// (1)'s shared memory: two projection stages (the tiles over them) and,
// with the weights resident, every step's slices after them
constexpr int partial_smem_bytes(bool bwd, bool resident, int C) {
  const int stages = 2 * (bwd ? proj_stage<4, true>() : proj_stage<2, false>());
  return 2 * (stages + (resident ? C / kHd * (bwd ? 4 : 2) * kG * kU : 0));
}

// Whether (1) keeps the weight slices in shared memory for all its tiles:
// where a segment has more than one tile and the blocks an SM runs without
// them (the forward 2, by its registers; the backward 1) still fit
// (DaViT-tiny: stage 0). Where they fit only at one block an SM (the
// forward at stages 1 and 2) the kernel ran slower than with the slices
// streamed (PERF.md).
bool partial_resident(const Dims& g, bool bwd) {
  return (g.N < kSeg ? g.N : kSeg) > kTile &&
         (bwd ? 1 : 2) * partial_smem_bytes(bwd, true, g.C) <= 232448;
}
static_assert(6 * kA <= 2 * proj_stage<2, false>(), "k, v tiles fit in the forward's stages");
static_assert(12 * kA <= 2 * proj_stage<4, true>(), "q, k, v, do tiles fit in the stages");

// (1) bf16: the segment's partial sums part_s[b][h][seg] = k^T.v over its
// tokens (kBwd: part_dp = do^T.q too) for the group's heads h0 .. h0 + kG - 1;
// blockIdx = (segment, group, batch).
template <bool kBwd>
__global__ void __launch_bounds__(kBwd ? 512 : 256)
    ca_partial_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dy,
                          const bf16* __restrict__ wqkv, const bf16* __restrict__ bqkv,
                          const bf16* __restrict__ wproj, bf16* __restrict__ qkvd,
                          float* __restrict__ part_s, float* __restrict__ part_dp, Dims g,
                          int resident) {
  constexpr int kCS = kBwd ? 4 : 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* const region = reinterpret_cast<bf16*>(smem_raw);
  bf16* const wres = resident ? region + 2 * proj_stage<kCS, kBwd>() : nullptr;
  const int seg = blockIdx.x, b = blockIdx.z, C = g.C;
  const int h0 = blockIdx.y * kG;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, t = lane & 3;
  const int cg = warp >> 2, rw = warp & 3;
  const int part = kBwd ? cg : cg + 1;  // 0 q, 1 k, 2 v, 3 do
  // this warp's (hd, hd) product: head j, kind (0 k^T.v, 1 do^T.q), rows 16 mb..
  const int pj = kBwd ? warp >> 2 : warp >> 1, kind = kBwd ? (warp >> 1) & 1 : 0;
  const int mb = warp & 1;
  const bool prod = pj < kG;
  // the tiles of part p, head j after the projections (the parts in order)
  auto tile = [&](int p, int j) { return region + ((kBwd ? p : p - 1) * kG + j) * kA; };
  float pacc[4][4];
  zero_acc<kHd>(pacc);
  float acc[kG][4][4];
  const auto unit = [&](int c, int j, int k0) {
    return qkvd_slice(wqkv, wproj, C, h0, kBwd ? c : c + 1, j, k0);
  };
  if (wres) load_slices<kCS>(wres, C, unit);
  const int end = min(g.N, (seg + 1) * kSeg);
  for (int n0 = seg * kSeg; n0 < end; n0 += kTile) {
    const int rows = min(kTile, end - n0);
    project_tile<kCS, kBwd>(acc, region, x, dy, C, (long long)b * g.N + n0, rows, unit, wres);
#pragma unroll
    for (int j = 0; j < kG; ++j) {
      if (part < 3) add_bias(acc[j], bqkv + part * C + (h0 + j) * kHd);
      store_rows(tile(part, j), kL, acc[j], rw, rows);
    }
    __syncthreads();
    if constexpr (kBwd) {  // q, k, v, do to the scratch's four (B, N, C) planes
      const long long plane = (long long)g.B * g.N * C;
      for (int i = threadIdx.x; i < 4 * kG * kTile * 4; i += kCS * 128) {
        const int u = i >> 8, r = (i >> 2) & 63, c = (i & 3) * 8, p = u / kG, j = u - p * kG;
        if (r < rows)
          *reinterpret_cast<uint4*>(qkvd + p * plane + ((long long)b * g.N + n0 + r) * C +
                                    (h0 + j) * kHd + c) =
              *reinterpret_cast<const uint4*>(tile(p, j) + r * kL + c);
      }
    }
    if (prod) {
      const bf16* const ta = tile(kind ? 3 : 1, pj);  // k or do: A = its transpose
      const bf16* const tb = tile(kind ? 0 : 2, pj);  // v or q
#pragma unroll
      for (int ks = 0; ks < kTile / 16; ++ks) {
        unsigned a[4];
        load_at(a, ta, 16 * ks, 16 * mb);
        warp_ax_chunk<kHd>(pacc, a, tb, ks);
      }
    }
    __syncthreads();  // the tiles read before the next tile's steps
  }
  if (prod) {
    float* const out = (kind ? part_dp : part_s) +
                       (((long long)b * g.heads + h0 + pj) * g.n_seg + seg) * kHd * kHd;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = 16 * mb + (lane >> 2) + 8 * h;
#pragma unroll
      for (int jd = 0; jd < 4; ++jd)
        *reinterpret_cast<float2*>(out + c * kHd + 8 * jd + 2 * t) =
            make_float2(pacc[jd][2 * h], pacc[jd][2 * h + 1]);
    }
  }
}

// (3) forward, bf16: y for 64 tokens of batch b, every head; blockIdx = (64
// tokens, batch). of lives in shared memory as a (64 x C) tile at row stride
// C + 8; a pass of q takes 6 heads, h0 + cg + 2 j (cg = warp / 4, j < 3), a
// pass of y 192 columns, c0 + 32 (cg + 2 j).
constexpr int kQHeads = 2 * kG;  // heads a pass of q takes

constexpr int out_smem_elems(int C) {
  return kTile * (C + 8) + 2 * kG * kU + 2 * proj_stage<2, false>();
}
static_assert(kTile * kYl <= 2 * proj_stage<2, false>(), "the y tile fits in the stages");

__global__ void __launch_bounds__(256)
    ca_out_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wqkv,
                      const bf16* __restrict__ bqkv, const bf16* __restrict__ wproj,
                      const bf16* __restrict__ bproj, const float* __restrict__ pb,
                      bf16* __restrict__ y, Dims g) {
  constexpr int kN = 256, kStage = proj_stage<2, false>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int C = g.C, ldo = C + 8;
  bf16* const of = reinterpret_cast<bf16*>(smem_raw);
  bf16* const pbs = of + kTile * ldo;
  bf16* const region = pbs + 2 * kG * kU;
  const int n0 = blockIdx.x * kTile, b = blockIdx.y;
  const int rows = min(kTile, g.N - n0);
  const long long row0 = (long long)b * g.N + n0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int cg = warp >> 2, rw = warp & 3;
  float acc[kG][4][4];

  for (int h0 = 0; h0 < g.heads; h0 += kQHeads) {
    load_planes<kN>(pbs, pb, 2 * kG, [&](int u) {
      const int hh = h0 + u;
      return hh < g.heads ? (long long)b * g.heads + hh : -1LL;
    });
    project_tile<2, false>(acc, region, x, nullptr, C, row0, rows, [&](int c, int j, int k0) {
      const int hh = h0 + c + 2 * j;
      return hh < g.heads ? Slice{wqkv + (long long)k0 * 3 * C + hh * kHd, 3LL * C}
                          : Slice{nullptr, 0};
    });
#pragma unroll
    for (int j = 0; j < kG; ++j) {
      const int hh = h0 + cg + 2 * j;
      if (hh >= g.heads) continue;
      unsigned qa[2][4];
      add_bias(acc[j], bqkv + hh * kHd);
      pack_rows(qa, acc[j]);
      float o[4][4];
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        float s[2][4];
        warp_abt_chunk<kHd>(s, qa, pbs + (hh - h0) * kU, kk);
#pragma unroll
        for (int jj = 0; jj < 2; ++jj)
#pragma unroll
          for (int e = 0; e < 4; ++e) o[2 * kk + jj][e] = s[jj][e];
      }
      store_rows(of + hh * kHd, ldo, o, rw, kTile);
    }
    __syncthreads();  // of's columns written, pb's tiles free
  }

  for (int c0 = 0; c0 < C; c0 += kYCols) {
    bool has[kG];
#pragma unroll
    for (int j = 0; j < kG; ++j) {
      zero_acc<kHd>(acc[j]);
      has[j] = c0 + (cg + 2 * j) * kHd < C;
    }
    pipeline(
        C / kHd,
        [&](int st, int buf) {
          bf16* const s = region + buf * kStage;
          const int k0 = st * kHd;
          for (int i = threadIdx.x; i < 2 * kG * 128; i += kN) {
            const int u = i >> 7, r = (i >> 2) & 31, c = (i & 3) * 8;
            const int col = c0 + (u / kG + 2 * (u % kG)) * kHd;
            if (col < C)
              cp_async16(s + u * kU + r * kL + c, wproj + (long long)(k0 + r) * C + col + c);
          }
        },
        [&](int st, int buf) {
          const bf16* const s = region + buf * kStage;
          const int k0 = st * kHd;
          unsigned af[2][4];
#pragma unroll
          for (int ks = 0; ks < 2; ++ks)
            ldsm_x4(af[ks], of + (16 * rw + (lane & 15)) * ldo + k0 + 16 * ks + (lane >> 4) * 8);
#pragma unroll
          for (int j = 0; j < kG; ++j) {
            if (!has[j]) continue;
#pragma unroll
            for (int ks = 0; ks < 2; ++ks)
              warp_ax_chunk<kHd>(acc[j], af[ks], s + (cg * kG + j) * kU, ks);
          }
        });
    // + bproj, rounded once, into the y tile (over the stages), then out
    bf16* const ys = region;
#pragma unroll
    for (int j = 0; j < kG; ++j) {
      if (!has[j]) continue;
      const int col = (cg + 2 * j) * kHd;
      add_bias(acc[j], bproj + c0 + col);
      store_rows(ys + col, kYl, acc[j], rw, kTile);
    }
    __syncthreads();
    store_tile<kN>(y, C, row0, c0, ys, kYl, rows, min(kYCols, C - c0));
    __syncthreads();  // the y tile read before the next pass's steps
  }
}

// (3) backward, bf16: of, dq, dk, dv for 64 tokens and the kG heads h0.. of
// batch b; blockIdx = (64 tokens, group, batch). Warp group cg takes part cg
// (q, k, v, do), its rows as (1) stored them in the four planes of qkvd.
// Then each warp one product, its part's rows the A fragments: q -> of =
// q.pb^T, k -> dv = k.ds, v -> dk = v.ds^T, do -> dq = do.pb, rounded into
// an output tile (of, dq, dk, dv: slot 0, 1, 2, 3).
constexpr int grad_mma_smem_bytes() { return 2 * (2 * kG * kU + 2 * proj_stage<4, true>()); }
static_assert(4 * kTile * (kG * kHd + 8) <= 2 * proj_stage<4, true>(),
              "the output tiles fit in the stages");

__global__ void __launch_bounds__(512)
    ca_grad_mma_kernel(const bf16* __restrict__ qkvd, const float* __restrict__ pb,
                       const float* __restrict__ ds, bf16* __restrict__ dqkv,
                       bf16* __restrict__ of, Dims g) {
  constexpr int kN = 512, kOl = kG * kHd + 8;  // row stride of the output tiles
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* const pbs = reinterpret_cast<bf16*>(smem_raw);  // pb of the kG heads, then ds
  bf16* const region = pbs + 2 * kG * kU;
  const int n0 = blockIdx.x * kTile, b = blockIdx.z, C = g.C;
  const int h0 = blockIdx.y * kG;
  const int rows = min(kTile, g.N - n0);
  const long long row0 = (long long)b * g.N + n0;
  const int warp = threadIdx.x >> 5, cg = warp >> 2, rw = warp & 3;
  const auto head = [&](int u) { return (long long)b * g.heads + h0 + u; };
  load_planes<kN>(pbs, pb, kG, head);
  load_planes<kN>(pbs + kG * kU, ds, kG, head);
  const long long plane = (long long)g.B * g.N * C;
  for (int i = threadIdx.x; i < 4 * kG * kTile * 4; i += kN) {
    const int u = i >> 8, r = (i >> 2) & 63, c = (i & 3) * 8, p = u / kG, j = u - p * kG;
    bf16* d = region + (p * kG + j) * kA + r * kL + c;
    if (r < rows)
      cp_async16(d, qkvd + p * plane + (row0 + r) * C + (h0 + j) * kHd + c);
    else
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  unsigned a[kG][2][4];  // this warp's rows of part cg, head j, as A fragments
#pragma unroll
  for (int j = 0; j < kG; ++j) load_a<kHd>(a[j], region + (cg * kG + j) * kA + 16 * rw * kL);
  __syncthreads();  // the rows read before the output tiles take their place
  const int slot = cg == 0 ? 0 : cg == 1 ? 3 : cg == 2 ? 2 : 1;
  bf16* const out = region + slot * kTile * kOl;
#pragma unroll
  for (int j = 0; j < kG; ++j) {
    const bf16* const p = pbs + (cg == 0 || cg == 3 ? 0 : kG) * kU + j * kU;  // pb or ds
    float o[4][4];
    if (cg == 0 || cg == 2) {  // of = q.pb^T, dk = v.ds^T
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        float s[2][4];
        warp_abt_chunk<kHd>(s, a[j], p, kk);
#pragma unroll
        for (int jj = 0; jj < 2; ++jj)
#pragma unroll
          for (int e = 0; e < 4; ++e) o[2 * kk + jj][e] = s[jj][e];
      }
    } else {  // dv = k.ds, dq = do.pb
      zero_acc<kHd>(o);
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) warp_ax_chunk<kHd>(o, a[j][ks], p, ks);
    }
    store_rows(out + j * kHd, kOl, o, rw, kTile);
  }
  __syncthreads();
  store_tile<kN>(of, C, row0, h0 * kHd, region, kOl, rows, kG * kHd);
#pragma unroll
  for (int s = 1; s < 4; ++s)
    store_tile<kN>(dqkv, 3LL * C, row0, (s - 1) * C + h0 * kHd, region + s * kTile * kOl, kOl,
                   rows, kG * kHd);
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
  ca_proj_kernel<T><<<dim3((g.C + kProjTile - 1) / kProjTile,
                           (unsigned)((M + kProjTile - 1) / kProjTile)),
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

// The shapes the tensor-core route takes: bf16 at 32 channels a head, a head
// count that kG divides (the caller chooses the route; x, dy, the weights,
// the outputs and the scratch 16-byte aligned, checked by the entry points)
bool mma_shapes(int bf16_in, const Dims& g) {
  return bf16_in && g.hd == kHd && g.heads % kG == 0;
}

cudaError_t launch_fwd_mma(const void* x, const void* wqkv, const void* bqkv, const void* wproj,
                           const void* bproj, float* part, float* pb, void* y, const Dims& g,
                           float scale, cudaStream_t stream) {
  const bf16* xt = static_cast<const bf16*>(x);
  const bf16* wt = static_cast<const bf16*>(wqkv);
  const bf16* bt = static_cast<const bf16*>(bqkv);
  const bool resident = partial_resident(g, false);
  int smem = partial_smem_bytes(false, resident, g.C);
  cudaError_t err = cudaFuncSetAttribute(ca_partial_mma_kernel<false>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  ca_partial_mma_kernel<false><<<dim3(g.n_seg, g.heads / kG, g.B), 256, smem, stream>>>(
      xt, nullptr, wt, bt, nullptr, nullptr, part, nullptr, g, resident);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ca_softmax_kernel<bf16, false><<<dim3(g.heads, g.B), kThreads, 0, stream>>>(part, nullptr, pb,
                                                                              nullptr, g, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  smem = 2 * out_smem_elems(g.C);
  err = cudaFuncSetAttribute(ca_out_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  ca_out_mma_kernel<<<dim3((g.N + kTile - 1) / kTile, g.B), 256, smem, stream>>>(
      xt, wt, bt, static_cast<const bf16*>(wproj), static_cast<const bf16*>(bproj), pb,
      static_cast<bf16*>(y), g);
  return cudaGetLastError();
}

// qkvd: the scratch's four (B, N, C) planes (q, k, v, do)
cudaError_t launch_bwd_mma(const void* x, const void* dy, const void* wqkv, const void* bqkv,
                           const void* wproj, void* qkvd, float* part, float* pb, float* ds,
                           void* dqkv, void* of, const Dims& g, float scale,
                           cudaStream_t stream) {
  const bf16* xt = static_cast<const bf16*>(x);
  const bf16* dyt = static_cast<const bf16*>(dy);
  const bf16* wt = static_cast<const bf16*>(wqkv);
  const bf16* bt = static_cast<const bf16*>(bqkv);
  const bf16* pt = static_cast<const bf16*>(wproj);
  float* part_dp = part + (long long)g.B * g.heads * g.n_seg * g.hd * g.hd;
  const bool resident = partial_resident(g, true);
  int smem = partial_smem_bytes(true, resident, g.C);
  cudaError_t err = cudaFuncSetAttribute(ca_partial_mma_kernel<true>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  bf16* const qt = static_cast<bf16*>(qkvd);
  ca_partial_mma_kernel<true><<<dim3(g.n_seg, g.heads / kG, g.B), 512, smem, stream>>>(
      xt, dyt, wt, bt, pt, qt, part, part_dp, g, resident);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ca_softmax_kernel<bf16, true><<<dim3(g.heads, g.B), kThreads, 0, stream>>>(part, part_dp, pb,
                                                                             ds, g, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  smem = grad_mma_smem_bytes();
  err = cudaFuncSetAttribute(ca_grad_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  ca_grad_mma_kernel<<<dim3((g.N + kTile - 1) / kTile, g.heads / kG, g.B), 512, smem, stream>>>(
      qt, pb, ds, static_cast<bf16*>(dqkv), static_cast<bf16*>(of), g);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* skinjax_channel_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// bf16: 0 for float, 1 for bfloat16 (x, the weights, of and y share it).
// mma: 1 for the tensor-core route (bf16, hd = 32, heads a multiple of 3;
// x, wqkv, wproj and y 16-byte aligned), 0 for the CUDA-core route.
// x (B, N, C) contiguous; wqkv (C, 3C), bqkv (3C), wproj (C, C), bproj (C).
// Scratch: part (B, heads, n_seg, hd, hd) fp32, pb (B, heads, hd, hd) fp32, of
// (B, N, C) (the CUDA-core route's; null on the tensor-core route); n_seg =
// ceil(N / 256). y (B, N, C) is written.
int skinjax_channel_attention_fwd(int bf16, int mma, const void* x, const void* wqkv,
                                  const void* bqkv, const void* wproj, const void* bproj,
                                  float* part, float* pb, void* of, void* y, int B, int N, int C,
                                  int heads, int n_seg, float scale, void* stream) {
  const Dims g = dims(B, N, C, heads);
  if (bad_dims(g, n_seg)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mma) {
    if (!mma_shapes(bf16, g)) return static_cast<int>(cudaErrorInvalidValue);
    if (!aligned16(x) || !aligned16(wqkv) || !aligned16(wproj) || !aligned16(y))
      return static_cast<int>(cudaErrorMisalignedAddress);
    return launch_fwd_mma(x, wqkv, bqkv, wproj, bproj, part, pb, y, g, scale, s);
  }
  if (!of) return static_cast<int>(cudaErrorInvalidValue);
  if (bf16)
    return launch_fwd<__nv_bfloat16>(x, wqkv, bqkv, wproj, bproj, part, pb, of, y, g, scale, s);
  return launch_fwd<float>(x, wqkv, bqkv, wproj, bproj, part, pb, of, y, g, scale, s);
}

// dy like x; bf16 and mma as in the forward. Scratch: qkvd in the input
// type, (B, N, 4, C) on the CUDA-core route, four (B, N, C) planes on the
// tensor-core route (where dy, dqkv, of and qkvd must be 16-byte aligned
// too); part (2, B, heads, n_seg, hd, hd) fp32, pb and ds (B, heads, hd, hd)
// fp32. Writes dqkv (B, N, 3C) and of (B, N, C).
int skinjax_channel_attention_bwd(int bf16, int mma, const void* x, const void* dy,
                                  const void* wqkv, const void* bqkv, const void* wproj,
                                  void* qkvd, float* part, float* pb, float* ds, void* dqkv,
                                  void* of, int B, int N, int C, int heads, int n_seg, float scale,
                                  void* stream) {
  const Dims g = dims(B, N, C, heads);
  if (bad_dims(g, n_seg) || !qkvd) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mma) {
    if (!mma_shapes(bf16, g)) return static_cast<int>(cudaErrorInvalidValue);
    if (!aligned16(x) || !aligned16(dy) || !aligned16(wqkv) || !aligned16(wproj) ||
        !aligned16(dqkv) || !aligned16(of) || !aligned16(qkvd))
      return static_cast<int>(cudaErrorMisalignedAddress);
    return launch_bwd_mma(x, dy, wqkv, bqkv, wproj, qkvd, part, pb, ds, dqkv, of, g, scale, s);
  }
  if (bf16)
    return launch_bwd<__nv_bfloat16>(x, dy, wqkv, bqkv, wproj, qkvd, part, pb, ds, dqkv, of, g,
                                     scale, s);
  return launch_bwd<float>(x, dy, wqkv, bqkv, wproj, qkvd, part, pb, ds, dqkv, of, g, scale, s);
}

}  // extern "C"
