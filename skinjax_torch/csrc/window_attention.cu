// Window multi-head attention straight on an NHWC map, forward and backward,
// for Hopper (sm_90a).
//
// It replaces the Pallas TPU kernel K7 of skinjax/ops/pallas/window_attention.py:
// the strip-blocked NHWC entry window_attention_nhwc, forward _strip_fwd
// (_strip_fwd_kernel, and its 4-D twin _strip_fwd4) and backward _strip_bwd
// (_strip_bwd_kernel, _strip_bwd4); and the forward _fwd (_fwd_kernel) of the
// padded-window entry window_attention, which takes windows already
// partitioned, x (nB, N, C). (That entry's backward is the recompute core in
// global_attention.cu.) Per window of N tokens (w x w on the map) and per head
// (hd = C / heads channels):
//
//   forward   qkv = round(x.Wqkv + bqkv)
//             s = (q.k^T) * scale (+ bias[head]) (+ mask[window])   fp32
//             p = softmax(s) fp32;  of = round(round(p).v)
//             y = round(of.Wproj + bproj)
//   backward  qkv as above, do = round(dy.Wproj^T)
//             p recomputed fp32;  of = round(round(p).v);  dv = round(round(p)^T.do)
//             dp = do.v^T;  ds = p * (dp - rowsum(dp * p))          fp32
//             dbias[head] += ds (summed over every window)
//             dq = round(round(ds*scale).k);  dk = round(round(ds*scale)^T.q)
//
// "round" is the cast to the input type (bf16 or fp32) at the points where the
// Pallas kernel casts; every sum is fp32. The backward emits dqkv (B,H,W,3C),
// of (B,H,W,C) and dbias (heads,N,N); dx and the weight gradients are flat
// matrix products outside the kernel (ops/window_attention.py), as in skinjax.
//
// Launches. Forward: one core launch (a block per window and head) writes
// of = p.v per head to an NHWC scratch, then one projection launch computes
// y = of.Wproj + bproj as a tiled product (bf16: wa_fwd_mma_kernel and
// wa_proj_mma_kernel; fp32: wa_fwd_kernel and proj_kernel). Backward: one
// core launch, a block per (window, head) (bf16: wa_bwd_mma_kernel; fp32:
// wa_bwd_kernel); with a bias, a block per (window group, head) that sums its
// windows' dbias in order into a partial plane of its own, and one second
// pass, dbias_reduce_kernel, that adds the partials in block order (no
// atomics, so the result does not depend on block order).
//
// Layout. There is no TPU layout here: no 56-token interleaved window, no
// padding of N to 16 with -1e9 keys, no 6-D view. A block reads the N real
// tokens of its window through their offsets, and masks its own ragged edges:
// on the NHWC map, window (i, j) of image b, win = (b*nH + i)*nW + j, as
// window_partition orders them, with the mask's plane win % (nH*nW); on
// partitioned windows (the padded entry's layout) window win's rows win*N ..
// win*N + N - 1, with the mask's plane win % n_win, n_win its plane count.
// The two layouts share every line of the forward but this address map.
//
// What bounds it: at DaViT's stage 1 (B=64, 56x56, C=96, 3 heads) a forward is
// ~18.6 GFLOP against ~77 MB, ~240 operations per byte: on the bf16 tensor
// cores the card's ridge (~295), so either bound is ~20 us; a backward ~26
// GFLOP (~38 with N padded to 64) against ~231 MB, bound by bytes (~69 us).
// The bf16 kernels (below) run every product on the tensor cores from bf16
// tiles, keep the scores and P (and the backward's dp and ds) in registers
// and stream x (and dy) and the head's weight slices by 16-byte cp.async;
// the forward core shares its projections and attention with the backward
// (wa_attend) and needs 25 KB of shared memory a block, the backward 41.5 KB.
// What bounds them now is instructions and L2 traffic: a block re-reads its
// window's x (and dy) once per head (the heads of a window are adjacent
// blocks) and the head's weight slices once per window, with N = 49 rows
// padded to 64; the forward's of makes a round trip through device memory
// (38.5 MB each way at DaViT's stage 1) between the core and the projection.
// The fp32 kernels run on the CUDA cores (no mma, no TMA), kept for the 1e-4
// checks (TF32 would not hold them): the projections register-tiled from
// shared memory (8 rows x 3 or 4 columns a thread), one block per (window,
// head); fp32 FMAs and shared-memory traffic bound them. PERF.md records how
// far each is from its bound. Limits: N <= 64 (window <= 8) and hd <= 32
// (DaViT and Swin: 32).
//
// C interface: each entry point launches on the given stream and returns
// cudaGetLastError() as an int (0 = success); skinjax_window_attention_error_string
// maps the code to its message.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <type_traits>

#include "mma_bf16.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxN = 64;   // tokens per window
constexpr int kMaxHd = 32;  // channels per head
constexpr int kKc = 32;     // input channels per projection chunk
constexpr int kRows = 8;    // rows per thread in the projection
constexpr int kXs = kKc + 1;      // row stride of the x / dy chunk
constexpr int kQs = kMaxHd + 1;   // row stride of q, k, v, do
constexpr int kSs = kMaxN + 1;    // row stride of the (N, N) planes
constexpr int kProjTile = 64;   // output projection: 64 x 64 tiles
constexpr int kTileK = 16;

// the fp32 kernels' conversions (the bf16 ones run on the tensor cores,
// below, and convert with the bf16 intrinsics)
template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) {
  return x;
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
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

struct Geometry {
  int H, W, C, heads, hd, w, N, nWw, n_win, nB;  // n_win: the mask's planes
  int partitioned;  // x is (nB, N, C) windows, not an NHWC map
};

// shared-memory floats of each core kernel (the token offsets come first)
constexpr int kTokBytes = kMaxN * 8;
constexpr int kChunkFloats = kMaxN * kXs;
constexpr int kQkvFloats = kMaxN * kQs;
constexpr int kScorePlaneFloats = kMaxN * kSs;
constexpr int fwd_smem_bytes() {
  return kTokBytes +
         4 * (kChunkFloats + kKc * (3 * kMaxHd + 1) + 3 * kQkvFloats + kScorePlaneFloats);
}
constexpr int bwd_smem_bytes() {
  return kTokBytes +
         4 * (2 * kChunkFloats + kKc * (4 * kMaxHd + 1) + 4 * kQkvFloats + 2 * kScorePlaneFloats);
}

// Token offsets (in tokens of the NHWC map, or of the partitioned windows)
// of the N rows of window win.
__device__ __forceinline__ void window_tokens(const Geometry& g, int win, long long* tok) {
  if (g.partitioned) {
    for (int r = threadIdx.x; r < g.N; r += kThreads) tok[r] = (long long)win * g.N + r;
    return;
  }
  const int b = win / g.n_win;
  const int rem = win - b * g.n_win;
  const int wi = rem / g.nWw;
  const int wj = rem - wi * g.nWw;
  for (int r = threadIdx.x; r < g.N; r += kThreads) {
    const int ry = r / g.w;
    const int rx = r - ry * g.w;
    tok[r] = ((long long)b * g.H + wi * g.w + ry) * g.W + wj * g.w + rx;
  }
}

// The head's projections of one window, into out[part][row][d] (stride kQs,
// kMaxN rows a part), rounded to T:
//   parts 0..2: x_w . Wqkv[:, part*C + hi*hd + d] + bqkv[...]   (q, k, v)
//   part 3 (kParts == 4): dy_w . Wproj[hi*hd + d, :]            (do = dy.Wproj^T)
// Thread (rb, d) accumulates rows rb*8 .. rb*8+7 of column d of every part.
template <typename T, int kParts>
__device__ void project(const T* __restrict__ x, const T* __restrict__ dy,
                        const T* __restrict__ wqkv, const T* __restrict__ bqkv,
                        const T* __restrict__ wproj, const Geometry& g, int hi,
                        const long long* tok, float* xs, float* dys, float* ws, float* out) {
  constexpr int ws_stride = kParts * kMaxHd + 1;
  const int C = g.C, hd = g.hd, N = g.N;
  const int row_blocks = (N + kRows - 1) / kRows;
  const int d = threadIdx.x % hd;
  const int rb = threadIdx.x / hd;
  const bool active = rb < row_blocks;
  float acc[kRows][kParts];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int p = 0; p < kParts; ++p) acc[i][p] = 0.f;

  for (int k0 = 0; k0 < C; k0 += kKc) {
    const int kc = min(kKc, C - k0);
    for (int idx = threadIdx.x; idx < row_blocks * kRows * kKc; idx += kThreads) {
      const int r = idx / kKc, kk = idx - r * kKc;
      const bool in = r < N && kk < kc;
      xs[r * kXs + kk] = in ? to_f32<T>(x[tok[r] * C + k0 + kk]) : 0.f;
      if (kParts == 4) dys[r * kXs + kk] = in ? to_f32<T>(dy[tok[r] * C + k0 + kk]) : 0.f;
    }
    for (int idx = threadIdx.x; idx < kKc * 3 * hd; idx += kThreads) {
      const int kk = idx / (3 * hd), c = idx - kk * 3 * hd;
      const int p = c / hd, dd = c - p * hd;
      ws[kk * ws_stride + c] =
          kk < kc ? to_f32<T>(wqkv[(size_t)(k0 + kk) * 3 * C + p * C + hi * hd + dd]) : 0.f;
    }
    if (kParts == 4) {
      for (int idx = threadIdx.x; idx < hd * kKc; idx += kThreads) {
        const int dd = idx / kKc, kk = idx - dd * kKc;
        ws[kk * ws_stride + 3 * hd + dd] =
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
        for (int i = 0; i < kRows; ++i) {
          const float xv = xs[(rb * kRows + i) * kXs + kk];
#pragma unroll
          for (int p = 0; p < 3; ++p) acc[i][p] += xv * wv[p];
          if (kParts == 4) acc[i][kParts - 1] += dys[(rb * kRows + i) * kXs + kk] * wv[kParts - 1];
        }
      }
    }
    __syncthreads();
  }
  if (active) {
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = rb * kRows + i;
      if (r >= N) break;
#pragma unroll
      for (int p = 0; p < 3; ++p)
        out[(p * kMaxN + r) * kQs + d] =
            round_to<T>(acc[i][p] + to_f32<T>(bqkv[p * C + hi * hd + d]));
      if (kParts == 4) out[(3 * kMaxN + r) * kQs + d] = round_to<T>(acc[i][kParts - 1]);
    }
  }
  __syncthreads();
}

// s = (q.k^T)*scale + bias + mask for every (n, m) of the window, then the
// fp32 softmax of each row in place; rows beyond N are left alone.
__device__ void scores_softmax(const float* q, const float* k, const float* __restrict__ bias,
                               const float* __restrict__ mask, const Geometry& g, int hi, int win,
                               float scale, float* s) {
  const int N = g.N, hd = g.hd;
  for (int idx = threadIdx.x; idx < N * N; idx += kThreads) {
    const int n = idx / N, m = idx - n * N;
    float a = 0.f;
    for (int d = 0; d < hd; ++d) a += q[n * kQs + d] * k[m * kQs + d];
    a = __fmul_rn(a, scale);
    if (bias) a = __fadd_rn(a, bias[((size_t)hi * N + n) * N + m]);
    if (mask) a = __fadd_rn(a, mask[((size_t)(win % g.n_win) * N + n) * N + m]);
    s[n * kSs + m] = a;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  for (int n = threadIdx.x / 32; n < N; n += kWarps) {
    const float v0 = lane < N ? s[n * kSs + lane] : -CUDART_INF_F;
    const float v1 = lane + 32 < N ? s[n * kSs + lane + 32] : -CUDART_INF_F;
    const float mx = warp_max(fmaxf(v0, v1));
    const float e0 = lane < N ? expf(v0 - mx) : 0.f;
    const float e1 = lane + 32 < N ? expf(v1 - mx) : 0.f;
    const float sum = warp_sum(e0 + e1);
    if (lane < N) s[n * kSs + lane] = e0 / sum;
    if (lane + 32 < N) s[n * kSs + lane + 32] = e1 / sum;
  }
  __syncthreads();
}

// Forward core: of[token, hi*hd + d] = round(round(p).v) per window and head.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    wa_fwd_kernel(const T* __restrict__ x, const T* __restrict__ wqkv, const T* __restrict__ bqkv,
                  const float* __restrict__ bias, const float* __restrict__ mask,
                  T* __restrict__ of, Geometry g, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  long long* tok = reinterpret_cast<long long*>(smem_raw);
  float* xs = reinterpret_cast<float*>(smem_raw + kTokBytes);
  float* ws = xs + kChunkFloats;
  float* qkv = ws + kKc * (3 * kMaxHd + 1);
  float* s = qkv + 3 * kQkvFloats;
  const float* q = qkv;
  const float* k = qkv + kQkvFloats;
  const float* v = qkv + 2 * kQkvFloats;
  const int hi = blockIdx.y;
  const int N = g.N, hd = g.hd, C = g.C;

  for (int win = blockIdx.x; win < g.nB; win += gridDim.x) {
    window_tokens(g, win, tok);
    __syncthreads();
    project<T, 3>(x, nullptr, wqkv, bqkv, nullptr, g, hi, tok, xs, nullptr, ws, qkv);
    scores_softmax(q, k, bias, mask, g, hi, win, scale, s);
    for (int idx = threadIdx.x; idx < N * hd; idx += kThreads) {
      const int n = idx / hd, d = idx - n * hd;
      float a = 0.f;
      for (int m = 0; m < N; ++m) a += round_to<T>(s[n * kSs + m]) * v[m * kQs + d];
      of[tok[n] * C + hi * hd + d] = from_f32<T>(a);
    }
    __syncthreads();
  }
}

// Output projection: out (M, N) = round(a (M, K) . wt (K, N) + bias), 64 x 64
// tiles, 16 deep, each thread 4 x 4 outputs at a stride of 16.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    proj_kernel(const T* __restrict__ a, const T* __restrict__ wt, const T* __restrict__ bias,
                T* __restrict__ out, int M, int N, int K) {
  __shared__ float as[kTileK][kProjTile + 4];
  __shared__ float bs[kTileK][kProjTile + 4];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const long long m0 = (long long)blockIdx.y * kProjTile;
  const int n0 = blockIdx.x * kProjTile;
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
      const int kb = idx / kProjTile, c = idx - kb * kProjTile;
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

// Backward core: dqkv and of per window and head; with a bias, this block's
// dbias sum over its windows goes to dbias_partial[blockIdx.x][hi].
template <typename T>
__global__ void __launch_bounds__(kThreads)
    wa_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dy, const T* __restrict__ wqkv,
                  const T* __restrict__ bqkv, const T* __restrict__ wproj,
                  const float* __restrict__ bias, const float* __restrict__ mask,
                  T* __restrict__ dqkv, T* __restrict__ of, float* __restrict__ dbias_partial,
                  Geometry g, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  long long* tok = reinterpret_cast<long long*>(smem_raw);
  float* xs = reinterpret_cast<float*>(smem_raw + kTokBytes);
  float* dys = xs + kChunkFloats;
  float* ws = dys + kChunkFloats;
  float* qkvd = ws + kKc * (4 * kMaxHd + 1);
  float* s = qkvd + 4 * kQkvFloats;
  float* db = s + kScorePlaneFloats;
  float* dp = xs;  // the chunk buffers are free once the projections are done
  const float* q = qkvd;
  const float* k = qkvd + kQkvFloats;
  const float* v = qkvd + 2 * kQkvFloats;
  const float* dout = qkvd + 3 * kQkvFloats;
  const int hi = blockIdx.y;
  const int N = g.N, hd = g.hd, C = g.C;
  const int lane = threadIdx.x & 31;

  if (bias)
    for (int idx = threadIdx.x; idx < kScorePlaneFloats; idx += kThreads) db[idx] = 0.f;

  for (int win = blockIdx.x; win < g.nB; win += gridDim.x) {
    window_tokens(g, win, tok);
    __syncthreads();
    project<T, 4>(x, dy, wqkv, bqkv, wproj, g, hi, tok, xs, dys, ws, qkvd);
    scores_softmax(q, k, bias, mask, g, hi, win, scale, s);  // s holds p, fp32

    // of = round(p).v, dv = round(p)^T.do, dp = do.v^T
    for (int idx = threadIdx.x; idx < N * hd; idx += kThreads) {
      const int n = idx / hd, d = idx - n * hd;
      float o = 0.f, dv = 0.f;
      for (int m = 0; m < N; ++m) {
        o += round_to<T>(s[n * kSs + m]) * v[m * kQs + d];
        dv += round_to<T>(s[m * kSs + n]) * dout[m * kQs + d];
      }
      of[tok[n] * C + hi * hd + d] = from_f32<T>(o);
      dqkv[tok[n] * 3 * C + 2 * C + hi * hd + d] = from_f32<T>(dv);
    }
    for (int idx = threadIdx.x; idx < N * N; idx += kThreads) {
      const int n = idx / N, m = idx - n * N;
      float a = 0.f;
      for (int d = 0; d < hd; ++d) a += dout[n * kQs + d] * v[m * kQs + d];
      dp[n * kSs + m] = a;
    }
    __syncthreads();

    // ds = p * (dp - rowsum(dp * p)); dbias += ds; dp <- round(ds * scale)
    for (int n = threadIdx.x / 32; n < N; n += kWarps) {
      const float p0 = lane < N ? s[n * kSs + lane] : 0.f;
      const float p1 = lane + 32 < N ? s[n * kSs + lane + 32] : 0.f;
      const float g0 = lane < N ? dp[n * kSs + lane] : 0.f;
      const float g1 = lane + 32 < N ? dp[n * kSs + lane + 32] : 0.f;
      const float rs = warp_sum(__fmul_rn(g0, p0) + __fmul_rn(g1, p1));
      const float ds0 = p0 * (g0 - rs), ds1 = p1 * (g1 - rs);
      if (lane < N) {
        if (bias) db[n * kSs + lane] += ds0;
        dp[n * kSs + lane] = round_to<T>(__fmul_rn(ds0, scale));
      }
      if (lane + 32 < N) {
        if (bias) db[n * kSs + lane + 32] += ds1;
        dp[n * kSs + lane + 32] = round_to<T>(__fmul_rn(ds1, scale));
      }
    }
    __syncthreads();

    // dq = ds.k, dk = ds^T.q
    for (int idx = threadIdx.x; idx < N * hd; idx += kThreads) {
      const int n = idx / hd, d = idx - n * hd;
      float dq = 0.f, dk = 0.f;
      for (int m = 0; m < N; ++m) {
        dq += dp[n * kSs + m] * k[m * kQs + d];
        dk += dp[m * kSs + n] * q[m * kQs + d];
      }
      dqkv[tok[n] * 3 * C + hi * hd + d] = from_f32<T>(dq);
      dqkv[tok[n] * 3 * C + C + hi * hd + d] = from_f32<T>(dk);
    }
    __syncthreads();
  }

  if (bias) {
    float* part = dbias_partial + ((size_t)blockIdx.x * g.heads + hi) * N * N;
    for (int idx = threadIdx.x; idx < N * N; idx += kThreads) {
      const int n = idx / N, m = idx - n * N;
      part[idx] = db[n * kSs + m];
    }
  }
}

// dbias[i] = sum over the blocks' partials, in block order.
__global__ void dbias_reduce_kernel(const float* __restrict__ partial, float* __restrict__ out,
                                    int blocks, int count) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  float a = 0.f;
  for (int b = 0; b < blocks; ++b) a += partial[(size_t)b * count + i];
  out[i] = a;
}

// ---- The bf16 instantiations on the tensor cores: the forward core, the
// output projection and the backward ----
//
// A core block takes one head of a window (the backward, with a bias, one
// head of a fixed set of windows, summing their dbias in registers): four
// warps, one 64-row tile that holds the window's N <= 64 tokens (rows at or
// past N are zeros, their keys -inf, their outputs not stored). Every product
// is an mma.sync.m16n8k16 (bf16 operands by ldmatrix, fp32 accumulators in
// registers; mma_bf16.cuh). Steps (1) and (2) are one device function,
// wa_attend, that both core kernels call, so the forward's of is the
// backward's bit for bit. (1) The projections: 32-channel steps of the
// window's x rows (and, for the backward, dy rows), gathered by token offset
// with 16-byte cp.async, and of the head's Wqkv columns (and Wproj rows)
// stream two deep; a warp's 16 rows of q, k, v (+ bqkv) (and do) accumulate
// in registers and are rounded to bf16 into (64 x 32) tiles. (2) The
// attention, a warp its 16 query rows, in registers: s = q.k^T * scale
// (+ bias, + mask), the fp32 softmax with quad shuffles, of = round(round(P).V)
// stored at the window's token rows. The forward core, wa_fwd_mma_kernel, is
// those two steps: 25 KB of shared memory a block. The backward,
// wa_bwd_mma_kernel, goes on in registers: dp = do.v^T, ds = P (dp -
// rowsum(dp P)), dq += round(ds * scale).K, with round(P) and round(ds *
// scale) to (64 x 64) bf16 tiles; then (3) the key side, a warp its 16 keys:
// their transposed A operands by ldmatrix.trans from those tiles, dv +=
// round(P)^T.do and dk += round(ds * scale)^T.q. The staging buffers of (1)
// hold the tiles of (2) and (3): 41.5 KB a block. The output projection,
// wa_proj_mma_kernel, is a tiled product of of and Wproj on mma.sync.

constexpr int kPc = 32;  // input channels a projection step (and the head's 32 columns)
constexpr int kPl = tile_ld<kPc>();  // row stride of the (rows x 32) bf16 tiles
constexpr int kSl = tile_ld<kTile>();  // row stride of the (64 x 64) round(P), round(ds) tiles
// a projection stage of kParts = 3 (the forward: x; Wq, Wk, Wv) or 4 (the
// backward: x, dy; Wq, Wk, Wv, Wproj): x and dy (64 x 32), Wq, Wk, Wv (32
// channels x 32), Wproj (32 x 32 channels)
template <int kParts>
__host__ __device__ constexpr int stage_elems() {
  return (kParts - 2) * kTile * kPl + kParts * kPc * kPl;
}
template <int kParts>
__host__ __device__ constexpr int region_bytes() {
  return 2 * stage_elems<kParts>() * 2;
}
static_assert(3 * kTile * kPl <= 2 * stage_elems<3>(), "the forward's tiles fit in its stages");
static_assert(4 * kTile * kPl + 2 * kTile * kSl <= 2 * stage_elems<4>(),
              "the backward's tiles fit in its stages");
constexpr int fwd_mma_smem_bytes() { return region_bytes<3>() + kTokBytes; }
constexpr int bwd_mma_smem_bytes() { return region_bytes<4>() + kTokBytes; }

// The A fragment of the (16 keys x 16 queries) block of X^T, X the (query x
// key) bf16 tile x at row stride kSl: keys k0.., queries q0.. (ldmatrix.trans)
__device__ __forceinline__ void load_at_trans(unsigned (&a)[4], const bf16* x, int q0, int k0) {
  const int lane = threadIdx.x & 31, m = lane >> 3;
  ldsm_x4_trans(a, x + (q0 + (lane & 7) + ((m >> 1) << 3)) * kSl + k0 + ((m & 1) << 3));
}

// rows r and r + 8 of x (a warp's 16 x 32 accumulators), columns 8 jd + 2 t
// + {0, 1} below hd, rounded to bf16 into out at token rows: row n at out +
// tok[n] * ldo; rows at or past N skipped
__device__ __forceinline__ void store_tok_rows(bf16* __restrict__ out, int ldo,
                                               const float (&x)[4][4], int r,
                                               const long long* tok, int N, int hd,
                                               bool pairs) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int n = r + 8 * h;
    if (n >= N) continue;
    bf16* row = out + tok[n] * ldo;
#pragma unroll
    for (int jd = 0; jd < 4; ++jd) {
      const int d = 8 * jd + 2 * t;
      if (pairs && d < hd) {
        *reinterpret_cast<__nv_bfloat162*>(row + d) =
            __floats2bfloat162_rn(x[jd][2 * h], x[jd][2 * h + 1]);
      } else {
        if (d < hd) row[d] = __float2bfloat16_rn(x[jd][2 * h]);
        if (d + 1 < hd) row[d + 1] = __float2bfloat16_rn(x[jd][2 * h + 1]);
      }
    }
  }
}

// 8 bf16 from src (count of them real, the rest zero) to dst: one 16-byte
// cp.async when vec and all are real, else element copies
__device__ __forceinline__ void copy8(bf16* dst, const bf16* src, int count, bool vec) {
  if (count >= 8 && vec) {
    cp_async16(dst, src);
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) dst[e] = e < count ? src[e] : __float2bfloat16_rn(0.f);
  }
}

// Steps (1) and (2) for head hi of window win, whose token offsets are tok:
// q, k, v (and, kParts == 4, do = dy.Wproj_head^T) of the window's rows into
// the bf16 tiles at the start of region (q, k, v, do, 64 x kPl each), then
// this warp's 16 query rows: P (fp32, 0 on rows past N) in s, where the
// backward goes on from, and of = round(round(P).V) at the token rows of of;
// kParts == 4 also writes round(P) to pt. The two kernels share every
// instruction up to here, so their of agree bit for bit.
template <int kParts, bool kBias>
__device__ __forceinline__ void wa_attend(float (&s)[4][2][4], bf16* __restrict__ region,
                                          const long long* tok, const bf16* __restrict__ x,
                                          const bf16* __restrict__ dy,
                                          const bf16* __restrict__ wqkv,
                                          const bf16* __restrict__ bqkv,
                                          const bf16* __restrict__ wproj,
                                          const float* __restrict__ bias,
                                          const float* __restrict__ mask, bf16* __restrict__ of,
                                          bf16* __restrict__ pt, const Geometry& g, int hi,
                                          int win, float scale, int vec) {
  constexpr int kStage = stage_elems<kParts>();
  bf16* const qs = region;
  bf16* const ks = qs + kTile * kPl;
  bf16* const vs = ks + kTile * kPl;
  const int N = g.N, hd = g.hd, C = g.C;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, t = lane & 3;
  const int rl = 16 * warp + (lane >> 2);  // this thread's rows of the tile: rl, rl + 8
  const bool pairs = vec;

  // (1) q, k, v (and do) of this warp's 16 rows
  float acc[kParts][4][4];
#pragma unroll
  for (int p = 0; p < kParts; ++p) zero_acc<kPc>(acc[p]);
  pipeline(
      (C + kPc - 1) / kPc,
      [&](int st, int buf) {
        bf16* const xs = region + buf * kStage;  // then dy (kParts == 4)
        bf16* const ws = xs + (kParts - 2) * kTile * kPl;  // Wq, Wk, Wv (, Wproj)
        const int k0 = st * kPc;
        for (int i = threadIdx.x; i < (kParts - 2) * kTile * 4; i += kTileThreads) {
          const int which = i >> 8, r = (i >> 2) & 63, c = (i & 3) * 8;
          bf16* d = xs + which * kTile * kPl + r * kPl + c;
          if (r < N && k0 + c < C)
            copy8(d, (which ? dy : x) + tok[r] * C + k0 + c, C - k0 - c, vec);
          else
            *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
        }
        for (int i = threadIdx.x; i < kParts * kPc * 4; i += kTileThreads) {
          const int p = i >> 7, r = (i >> 2) & 31, c = (i & 3) * 8;
          bf16* d = ws + p * kPc * kPl + r * kPl + c;
          // Wqkv: row k0 + r (a channel), columns p C + hi hd + c..; Wproj:
          // row hi hd + r (a head column), columns k0 + c..
          const bool in = p < 3 ? k0 + r < C && c < hd : r < hd && k0 + c < C;
          if (in)
            copy8(d,
                  p < 3 ? wqkv + (long long)(k0 + r) * 3 * C + p * C + hi * hd + c
                        : wproj + (long long)(hi * hd + r) * C + k0 + c,
                  p < 3 ? hd - c : C - k0 - c, vec);
          else
            *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
        }
      },
      [&](int, int buf) {
        const bf16* const xs = region + buf * kStage;
        const bf16* const ws = xs + (kParts - 2) * kTile * kPl;
        unsigned ax[2][4], ay[2][4];
        load_a<kPc>(ax, xs + 16 * warp * kPl);
        if constexpr (kParts == 4) load_a<kPc>(ay, xs + kTile * kPl + 16 * warp * kPl);
#pragma unroll
        for (int st = 0; st < 2; ++st) {
#pragma unroll
          for (int p = 0; p < 3; ++p) warp_ax_chunk<kPc>(acc[p], ax[st], ws + p * kPc * kPl, st);
          if constexpr (kParts == 4) warp_abt_step(acc[3], ay[st], ws + 3 * kPc * kPl, st);
        }
      });
  // rounded to bf16 (q, k, v after + bqkv) into the tiles; columns past hd stay 0
#pragma unroll
  for (int p = 0; p < kParts; ++p) {
    bf16* const tile = qs + p * kTile * kPl;
#pragma unroll
    for (int jd = 0; jd < 4; ++jd) {
      const int d = 8 * jd + 2 * t;
      float b0 = 0.f, b1 = 0.f;
      if (p < 3) {
        const bf16* bp = bqkv + p * C + hi * hd + d;
        if (d < hd) b0 = __bfloat162float(bp[0]);
        if (d + 1 < hd) b1 = __bfloat162float(bp[1]);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<unsigned*>(tile + (rl + 8 * h) * kPl + d) =
            pack_bf16(__fadd_rn(acc[p][jd][2 * h], b0), __fadd_rn(acc[p][jd][2 * h + 1], b1));
    }
  }
  __syncthreads();

  // (2) this warp's 16 query rows
  unsigned qf[kPc / 16][4];
  load_a<kPc>(qf, qs + 16 * warp * kPl);
  bool row_ok[2];
  const float* brow[2];
  const float* mrow[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int n = rl + 8 * h;
    row_ok[h] = n < N;
    brow[h] = kBias ? bias + ((long long)hi * N + n) * N : nullptr;
    mrow[h] = mask ? mask + ((long long)(win % g.n_win) * N + n) * N : nullptr;
  }
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    warp_abt_chunk<kPc>(s[kk], qf, ks, kk);
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = 16 * kk + 8 * j + 2 * t + (e & 1), h = e >> 1;
        float a = __fmul_rn(s[kk][j][e], scale);
        if (m >= N) {
          a = -CUDART_INF_F;
        } else if (row_ok[h]) {
          if constexpr (kBias) a = __fadd_rn(a, __ldg(brow[h] + m));
          if (mask) a = __fadd_rn(a, __ldg(mrow[h] + m));
        }
        s[kk][j][e] = a;
      }
  }
  // the fp32 softmax; P = 0 on rows past N
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = -CUDART_INF_F;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int j = 0; j < 2; ++j) mx = fmaxf(mx, fmaxf(s[kk][j][2 * h], s[kk][j][2 * h + 1]));
    const float mxl = quad_max(mx) * kLog2e;
    float sum = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float e = ex2(__fmaf_rn(s[kk][j][2 * h + c], kLog2e, -mxl));
          s[kk][j][2 * h + c] = e;
          sum += e;
        }
    const float l = quad_sum(sum);  // every lane shuffles, rows past N too
    const float inv = row_ok[h] ? 1.f / l : 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) s[kk][j][2 * h + c] = __fmul_rn(s[kk][j][2 * h + c], inv);
  }
  // of = round(round(P) . V); the backward's round(P) to its tile
  float oa[4][4];
  zero_acc<kPc>(oa);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    unsigned a[4];
    pack_a_chunk(a, s[kk]);
    if constexpr (kParts == 4) {
#pragma unroll
      for (int u = 0; u < 4; ++u)
        *reinterpret_cast<unsigned*>(pt + (rl + 8 * (u & 1)) * kSl + 16 * kk + 8 * (u >> 1) +
                                     2 * t) = a[u];
    }
    warp_ax_chunk<kPc>(oa, a, vs, kk);
  }
  store_tok_rows(of + hi * hd, C, oa, rl, tok, N, hd, pairs);
}

// Forward core, bf16: of for head hi of window win (blockIdx.x = win * heads
// + hi: a window's heads are adjacent blocks); kBias: bias is not null. Six
// blocks an SM (80 registers, a few bytes spilled) beat four and five at
// every DaViT stage: the blocks are short, latency-bound steps.
template <bool kBias>
__global__ void __launch_bounds__(kTileThreads, 6)
    wa_fwd_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wqkv,
                      const bf16* __restrict__ bqkv, const float* __restrict__ bias,
                      const float* __restrict__ mask, bf16* __restrict__ of, Geometry g,
                      float scale, int vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* const region = reinterpret_cast<bf16*>(smem_raw);
  long long* const tok = reinterpret_cast<long long*>(smem_raw + region_bytes<3>());
  const int hi = blockIdx.x % g.heads, win = blockIdx.x / g.heads;
  window_tokens(g, win, tok);
  __syncthreads();
  float s[4][2][4];
  wa_attend<3, kBias>(s, region, tok, x, nullptr, wqkv, bqkv, nullptr, bias, mask, of, nullptr,
                      g, hi, win, scale, vec);
}

// Output projection, bf16: out (M, C) = round(a (M, C) . w (C, C) + bias). A
// block of four warps takes 64 rows x kProjN = 96 columns (DaViT's and
// Swin's widths are multiples of 96), a warp 16 rows (12 blocks of 16 x 8
// fp32 accumulators a thread); 32-deep steps of a's rows and of w's (32 x 96)
// slice stream two deep by cp.async (zeros past M and C), the products are
// mma.sync from ldmatrix fragments, and the bias goes on before the one cast.
// The output tile goes out through shared memory as 16-byte row chunks. vec:
// C % 8 == 0 and a, w, out 16-byte aligned.
constexpr int kProjN = 96;
constexpr int kProjK = 32;
constexpr int kProjNl = tile_ld<kProjN>();  // row stride of the w slice and the output tile

__global__ void __launch_bounds__(kTileThreads)
    wa_proj_mma_kernel(const bf16* __restrict__ a, const bf16* __restrict__ w,
                       const bf16* __restrict__ bias, bf16* __restrict__ out, int M, int C,
                       int vec) {
  constexpr int kA = kTile * tile_ld<kProjK>(), kW = kProjK * kProjNl;
  __shared__ __align__(16) bf16 sm[2 * (kA + kW)];  // per buffer: a's rows, then w's slice
  const int n0 = blockIdx.x * kProjN, m0 = blockIdx.y * kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, t = lane & 3;
  float acc[kProjN / 8][4];
  zero_acc<kProjN>(acc);
  pipeline(
      (C + kProjK - 1) / kProjK,
      [&](int k, int buf) {
        const int k0 = k * kProjK;
        bf16* const as = sm + buf * (kA + kW);
        load_tile<kProjK>(as, a + k0, C, m0, M, C - k0, vec);
        for (int i = threadIdx.x; i < kProjK * (kProjN / 8); i += kTileThreads) {
          const int r = i / (kProjN / 8), c = (i - r * (kProjN / 8)) * 8;
          bf16* d = as + kA + r * kProjNl + c;
          if (k0 + r < C && n0 + c < C)
            copy8(d, w + (long long)(k0 + r) * C + n0 + c, C - n0 - c, vec);
          else
            *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
        }
      },
      [&](int, int buf) {
        const bf16* const as = sm + buf * (kA + kW);
        unsigned af[kProjK / 16][4];
        load_a<kProjK>(af, as + 16 * warp * tile_ld<kProjK>());
#pragma unroll
        for (int ks = 0; ks < kProjK / 16; ++ks) warp_ax_chunk<kProjN>(acc, af[ks], as + kA, ks);
      });
  // + bias, rounded, into the output tile (the stages are free: pipeline ends
  // with a barrier), then out as 16-byte row chunks
  bf16* const ot = sm;
  const int rl = 16 * warp + (lane >> 2);
#pragma unroll
  for (int jd = 0; jd < kProjN / 8; ++jd) {
    const int c = 8 * jd + 2 * t;
    const float b0 = n0 + c < C ? __bfloat162float(bias[n0 + c]) : 0.f;
    const float b1 = n0 + c + 1 < C ? __bfloat162float(bias[n0 + c + 1]) : 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<unsigned*>(ot + (rl + 8 * h) * kProjNl + c) =
          pack_bf16(__fadd_rn(acc[jd][2 * h], b0), __fadd_rn(acc[jd][2 * h + 1], b1));
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kTile * (kProjN / 8); i += kTileThreads) {
    const int r = i / (kProjN / 8), c = (i - r * (kProjN / 8)) * 8;
    if (m0 + r >= M || n0 + c >= C) continue;
    bf16* const o = out + (long long)(m0 + r) * C + n0 + c;
    const bf16* const v = ot + r * kProjNl + c;
    if (vec) {
      *reinterpret_cast<uint4*>(o) = *reinterpret_cast<const uint4*>(v);
    } else {
      for (int e = 0; e < 8 && n0 + c + e < C; ++e) o[e] = v[e];
    }
  }
}

// Backward core, bf16: dqkv and of for head hi of windows blk, blk + nblk,
// ... (blockIdx.x = blk * heads + hi); with kBias (bias not null), this
// block's dbias sum over its windows, in window order, goes to
// dbias_partial[blk][hi].
template <bool kBias>
__global__ void __launch_bounds__(kTileThreads, kBias ? 3 : 4)
    wa_bwd_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dy,
                      const bf16* __restrict__ wqkv, const bf16* __restrict__ bqkv,
                      const bf16* __restrict__ wproj, const float* __restrict__ bias,
                      const float* __restrict__ mask, bf16* __restrict__ dqkv,
                      bf16* __restrict__ of, float* __restrict__ dbias_partial, Geometry g,
                      float scale, int vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* const region = reinterpret_cast<bf16*>(smem_raw);
  long long* const tok = reinterpret_cast<long long*>(smem_raw + region_bytes<4>());
  // the attention tiles, over the projection stages
  bf16* const qs = region;
  bf16* const ks = qs + kTile * kPl;
  bf16* const vs = ks + kTile * kPl;
  bf16* const dos = vs + kTile * kPl;
  bf16* const pt = dos + kTile * kPl;  // round(P), (query x key)
  bf16* const dt = pt + kTile * kSl;   // round(ds * scale)
  const int heads = g.heads, hi = blockIdx.x % heads;
  const int blk = blockIdx.x / heads, nblk = gridDim.x / heads;
  const int N = g.N, hd = g.hd, C = g.C;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gq = lane >> 2, t = lane & 3;
  const int rl = 16 * warp + gq;  // this thread's rows of the tile: rl, rl + 8
  const bool pairs = vec;

  float db[kBias ? 4 : 1][2][4];  // this block's dbias at (rows rl, rl + 8; keys of block kk)
#pragma unroll
  for (int kk = 0; kk < (kBias ? 4 : 1); ++kk)
#pragma unroll
    for (int j = 0; j < 2; ++j) db[kk][j][0] = db[kk][j][1] = db[kk][j][2] = db[kk][j][3] = 0.f;

  for (int win = blk; win < g.nB; win += nblk) {
    window_tokens(g, win, tok);
    __syncthreads();

    // (1) and (2): q, k, v, do; P of this warp's rows in s, of, round(P) in pt
    float s[4][2][4];
    wa_attend<4, kBias>(s, region, tok, x, dy, wqkv, bqkv, wproj, bias, mask, of, pt, g, hi, win,
                        scale, vec);
    unsigned df[kPc / 16][4];
    load_a<kPc>(df, dos + 16 * warp * kPl);
    // dp = do . v^T, ds = P (dp - rowsum(dp P)) fp32, dbias += ds, and
    // dq = round(round(ds * scale) . K); round(ds * scale) to its tile
    {
      float dp[4][2][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) warp_abt_chunk<kPc>(dp[kk], df, vs, kk);
      float r[2] = {0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) r[e >> 1] += __fmul_rn(dp[kk][j][e], s[kk][j][e]);
      r[0] = quad_sum(r[0]);
      r[1] = quad_sum(r[1]);
      float dqa[4][4];
      zero_acc<kPc>(dqa);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float d[2][4];
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float ds = __fmul_rn(s[kk][j][e], __fsub_rn(dp[kk][j][e], r[e >> 1]));
            if constexpr (kBias) db[kk][j][e] += ds;
            d[j][e] = __fmul_rn(ds, scale);
          }
        unsigned a[4];
        pack_a_chunk(a, d);
#pragma unroll
        for (int u = 0; u < 4; ++u)
          *reinterpret_cast<unsigned*>(dt + (rl + 8 * (u & 1)) * kSl + 16 * kk + 8 * (u >> 1) +
                                       2 * t) = a[u];
        warp_ax_chunk<kPc>(dqa, a, ks, kk);
      }
      store_tok_rows(dqkv + hi * hd, 3 * C, dqa, rl, tok, N, hd, pairs);
    }
    __syncthreads();

    // (3) this warp's 16 keys: dv = round(P)^T . do, dk = round(ds * scale)^T . q
    {
      float dva[4][4], dka[4][4];
      zero_acc<kPc>(dva);
      zero_acc<kPc>(dka);
#pragma unroll
      for (int qq = 0; qq < 4; ++qq) {
        unsigned a[4];
        load_at_trans(a, pt, 16 * qq, 16 * warp);
        warp_ax_chunk<kPc>(dva, a, dos, qq);
        load_at_trans(a, dt, 16 * qq, 16 * warp);
        warp_ax_chunk<kPc>(dka, a, qs, qq);
      }
      store_tok_rows(dqkv + C + hi * hd, 3 * C, dka, rl, tok, N, hd, pairs);
      store_tok_rows(dqkv + 2 * C + hi * hd, 3 * C, dva, rl, tok, N, hd, pairs);
    }
    __syncthreads();  // the tiles and the token offsets free for the next window
  }

  if constexpr (kBias) {
    float* part = dbias_partial + ((long long)blk * heads + hi) * N * N;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int n = rl + 8 * (e >> 1), m = 16 * kk + 8 * j + 2 * t + (e & 1);
          if (n < N && m < N) part[n * N + m] = db[kk][j][e];
        }
  }
}

Geometry geometry(int B, int H, int W, int C, int heads, int window) {
  Geometry g;
  g.H = H;
  g.W = W;
  g.C = C;
  g.heads = heads;
  g.hd = C / heads;
  g.w = window;
  g.N = window * window;
  g.nWw = W / window;
  g.n_win = (H / window) * (W / window);
  g.nB = B * g.n_win;
  g.partitioned = 0;
  return g;
}

// nB partitioned windows of N tokens; the mask has n_win planes
Geometry partitioned(int nB, int N, int C, int heads, int n_win) {
  Geometry g;
  g.H = g.W = g.w = g.nWw = 0;
  g.C = C;
  g.heads = heads;
  g.hd = heads > 0 ? C / heads : 0;
  g.N = N;
  g.n_win = n_win;
  g.nB = nB;
  g.partitioned = 1;
  return g;
}

template <typename T>
cudaError_t launch_fwd(const void* x, const void* wqkv, const void* bqkv, const void* wproj,
                       const void* bproj, const float* bias, const float* mask, void* of, void* y,
                       const Geometry& g, int M, float scale, cudaStream_t stream) {
  cudaError_t err;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    // 16-byte copies of x, the weight slices and of's rows, pair stores
    const int vec = g.C % 8 == 0 && g.hd % 8 == 0 && aligned16(x) && aligned16(wqkv) &&
                    aligned16(wproj) && aligned16(of) && aligned16(y);
    const int smem = fwd_mma_smem_bytes();
    const auto kernel = bias ? wa_fwd_mma_kernel<true> : wa_fwd_mma_kernel<false>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    kernel<<<(unsigned)g.nB * g.heads, kTileThreads, smem, stream>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(wqkv),
        static_cast<const bf16*>(bqkv), bias, mask, static_cast<bf16*>(of), g, scale, vec);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const dim3 grid((g.C + kProjN - 1) / kProjN, (M + kTile - 1) / kTile);
    wa_proj_mma_kernel<<<grid, kTileThreads, 0, stream>>>(
        static_cast<const bf16*>(of), static_cast<const bf16*>(wproj),
        static_cast<const bf16*>(bproj), static_cast<bf16*>(y), M, g.C, vec);
  } else {
    const int smem = fwd_smem_bytes();
    err = cudaFuncSetAttribute(wa_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return err;
    wa_fwd_kernel<T><<<dim3(g.nB, g.heads), kThreads, smem, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(wqkv), static_cast<const T*>(bqkv), bias,
        mask, static_cast<T*>(of), g, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const dim3 grid((g.C + kProjTile - 1) / kProjTile, (M + kProjTile - 1) / kProjTile);
    proj_kernel<T><<<grid, kThreads, 0, stream>>>(static_cast<const T*>(of),
                                                    static_cast<const T*>(wproj),
                                                    static_cast<const T*>(bproj),
                                                    static_cast<T*>(y), M, g.C, g.C);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const void* x, const void* dy, const void* wqkv, const void* bqkv,
                       const void* wproj, const float* bias, const float* mask, void* dqkv,
                       void* of, float* dbias_partial, float* dbias, int blocks,
                       const Geometry& g, float scale, cudaStream_t stream) {
  cudaError_t err;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    // 16-byte copies of x, dy and the weight slices, pair stores of the outputs
    const int vec = g.C % 8 == 0 && g.hd % 8 == 0 && aligned16(x) && aligned16(dy) &&
                    aligned16(wqkv) && aligned16(wproj) && aligned16(dqkv) && aligned16(of);
    const int smem = bwd_mma_smem_bytes();
    const auto kernel = bias ? wa_bwd_mma_kernel<true> : wa_bwd_mma_kernel<false>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    kernel<<<(unsigned)blocks * g.heads, kTileThreads, smem, stream>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(dy),
        static_cast<const bf16*>(wqkv), static_cast<const bf16*>(bqkv),
        static_cast<const bf16*>(wproj), bias, mask, static_cast<bf16*>(dqkv),
        static_cast<bf16*>(of), dbias_partial, g, scale, vec);
  } else {
    const int smem = bwd_smem_bytes();
    err = cudaFuncSetAttribute(wa_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return err;
    wa_bwd_kernel<T><<<dim3(blocks, g.heads), kThreads, smem, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(dy), static_cast<const T*>(wqkv),
        static_cast<const T*>(bqkv), static_cast<const T*>(wproj), bias, mask,
        static_cast<T*>(dqkv), static_cast<T*>(of), dbias_partial, g, scale);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess || !bias) return err;
  const int count = g.heads * g.N * g.N;
  dbias_reduce_kernel<<<(count + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      dbias_partial, dbias, blocks, count);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* skinjax_window_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// bf16: 0 for float, 1 for bfloat16 (x, the weights, of and y share it).
// x (B, H, W, C) contiguous NHWC; wqkv (C, 3C), bqkv (3C), wproj (C, C),
// bproj (C); bias (heads, N, N) fp32 or null; mask (n_win, N, N) fp32 or null,
// n_win = (H / window) * (W / window). of and y (B, H, W, C) are written.
int skinjax_window_attention_fwd(int bf16, const void* x, const void* wqkv, const void* bqkv,
                                 const void* wproj, const void* bproj, const float* bias,
                                 const float* mask, void* of, void* y, int B, int H, int W, int C,
                                 int heads, int window, float scale, void* stream) {
  const Geometry g = geometry(B, H, W, C, heads, window);
  const int M = B * H * W;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch_fwd<__nv_bfloat16>(x, wqkv, bqkv, wproj, bproj, bias, mask, of, y, g, M, scale,
                                     s);
  return launch_fwd<float>(x, wqkv, bqkv, wproj, bproj, bias, mask, of, y, g, M, scale, s);
}

// The padded-window entry's forward: x (nB, N, C) contiguous windows, N <=
// 64, hd <= 32; bias (heads, N, N) fp32 or null; mask (n_win, N, N) fp32 or
// null, window win adding plane win % n_win. of and y (nB, N, C) are written.
int skinjax_window_attention_pad_fwd(int bf16, const void* x, const void* wqkv, const void* bqkv,
                                     const void* wproj, const void* bproj, const float* bias,
                                     const float* mask, void* of, void* y, int nB, int N, int C,
                                     int heads, int n_win, float scale, void* stream) {
  const Geometry g = partitioned(nB, N, C, heads, mask ? n_win : 1);
  if (N < 1 || N > kMaxN || heads < 1 || C % heads != 0 || g.hd > kMaxHd || g.n_win < 1 ||
      heads > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int M = nB * N;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch_fwd<__nv_bfloat16>(x, wqkv, bqkv, wproj, bproj, bias, mask, of, y, g, M, scale,
                                     s);
  return launch_fwd<float>(x, wqkv, bqkv, wproj, bproj, bias, mask, of, y, g, M, scale, s);
}

// dy like x. Writes dqkv (B, H, W, 3C) and of (B, H, W, C); with a bias,
// dbias_partial (blocks, heads, N, N) and dbias (heads, N, N). blocks: the
// number of window blocks, each summing over windows blk, blk + blocks, ...
int skinjax_window_attention_bwd(int bf16, const void* x, const void* dy, const void* wqkv,
                                 const void* bqkv, const void* wproj, const float* bias,
                                 const float* mask, void* dqkv, void* of, float* dbias_partial,
                                 float* dbias, int blocks, int B, int H, int W, int C, int heads,
                                 int window, float scale, void* stream) {
  const Geometry g = geometry(B, H, W, C, heads, window);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch_bwd<__nv_bfloat16>(x, dy, wqkv, bqkv, wproj, bias, mask, dqkv, of,
                                     dbias_partial, dbias, blocks, g, scale, s);
  return launch_bwd<float>(x, dy, wqkv, bqkv, wproj, bias, mask, dqkv, of, dbias_partial, dbias,
                           blocks, g, scale, s);
}

}  // extern "C"
