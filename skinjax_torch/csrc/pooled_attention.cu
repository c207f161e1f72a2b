// MViTv2's pooled attention core with the decomposed relative-position bias:
// the forward and the stored-probabilities backward, for Hopper (sm_90a).
//
// It replaces the Pallas TPU kernel K11 of skinjax/ops/pallas/pooled_attention.py:
// the forward _fwd_core (kernel _fwd_kernel, with emit_p) and the backward
// _bwd_core (kernel _bwd_kernel). q is (B, heads, Nq, hd), k and v are (B,
// heads, Nk, hd), bias_h (B, heads, Nq, Kh) and bias_w (B, heads, Nq, Kw), all
// contiguous in the input type, with Nk = Kh * Kw (the pooled key grid). Per
// batch b and head h:
//
//   forward   s[n, m] = (q.k^T)[n, m] * scale + bias_h[n, m / Kw] + bias_w[n, m % Kw]   fp32
//             P = softmax(s) fp32, written to p (B, heads, Nq, Nk) when asked
//             o = round(round(P) . v)
//   backward  dv = round(round(P)^T . do)
//             dp = do . v^T;  ds = P * (dp - rowsum(dp * P))                 fp32
//             dbias_h[n, a] = sum over m with m / Kw == a of ds[n, m]          fp32
//             dbias_w[n, c] = sum over m with m % Kw == c of ds[n, m]          fp32
//             dq = round((round(ds) . k) * scale);  dk = round((round(ds)^T . q) * scale)
//
// "round" is the cast to the input type (bf16 or fp32) where the Pallas kernel
// casts; every sum is fp32. The scale multiplies the fp32 product, in the
// forward before the two bias terms (added in that order) and in the backward
// after the products, as the Pallas kernel does (its reference instead scales
// q in the input type). The Pallas kernel expands the bias with two 0/1
// matrix products on the MXU; here it is an index, and (B, heads, Nq, Nk) is
// never formed. The bias gradients are per sample: there is no sum over the
// batch.
//
// Layout. No TPU padding: a block masks its own ragged edge (Nq = 3136, 784,
// 196, 49 and Nk = 196, 784, 49 in MViTv2-small at 224x224), and P is kept as
// (B, heads, Nq, Nk), not padded to multiples of 16. skinjax's query chunking
// (pooled_attention_chunked) and its VMEM and residual caps (pooled_attn_ok)
// guard Mosaic and a 16 GB TPU; a grid over query tiles needs neither.
//
// Launches. Forward: one launch. Its bf16 instantiation (the main path
// under autocast), pa_fwd_mma_kernel, runs on the tensor cores: a block per
// (64 query rows, head, batch), four warps of 16 rows, q as A fragments in
// registers, K (and V) tiles of 64 keys streaming two deep through shared
// memory by cp.async, every product an mma.sync.m16n8k16 (bf16 operands from
// ldmatrix, fp32 accumulators in registers; mma_bf16.cuh). The rows' bias
// terms (bias_h as Kh values a row, bias_w as Kw) and each key's (m / Kw,
// m % Kw) are loaded once into shared memory and added in registers. Two
// passes over the key tiles: (a) the scores and an online max and sum a row;
// (b) the scores again, P = exp(s - max) / sum written fp32 with streaming
// stores, and o += round(P) . V with the accumulators packed to bf16 as the
// A operand (FlashAttention-2's register reuse), 16 keys at a time. exp is
// the special-function unit's 2^x of a fused s * log2(e) - max * log2(e).
// The fp32 instantiation (the card-vs-CPU and fp32 twin checks at 1e-4)
// keeps pa_fwd_kernel: a block per (32 query rows, head, batch) holds its
// score rows in shared memory, streams K and then V 64 keys at a time, adds
// the bias by index and does the softmax a warp a row, fp32 FMAs on the CUDA
// cores (TF32 tensor cores would not hold 1e-4). The Pallas backward sums dk
// and dv over every query across its sequential grid; blocks here run in no
// order, so the backward is two launches with no atomics. Its bf16
// instantiation runs on the tensor cores with the same building blocks (no
// ds of size B.heads.Nq.Nk in memory; one fp32 statistic a query row, r =
// rowsum(dp * P), (B, heads, Nq)): (1) pa_bwd_rows_mma_kernel, a block per
// (64 query rows, head, batch), streams V (and K) and P's (64 x 64) tiles
// through two passes over the key tiles, (a) dp and r, which it writes, (b)
// dp again, ds in registers, dq += round(ds) . K, and the bias gradients:
// each warp writes its ds over its rows of the staged P tile, and its lanes
// sum them into (Kh + Kw) fp32 accumulators a row, in shared memory (at most
// 14 KB at the stage-1 transition) or, for a key grid too wide for it, in
// the block's own output rows; a lane owns each (row, grid row) and (row,
// grid column) pair a tile touches, so the sums take a fixed order and no
// atomics; (2) pa_bwd_cols_mma_kernel, a block per (64 keys, head, batch),
// computes each dp block in (1)'s operand and k-step order, so its ds is
// (1)'s bit for bit, and sums dv and dk over every query tile from the
// transposed (movmatrix) round(P) and round(ds). The fp32 instantiation keeps
// the CUDA-core kernels: (1) pa_bwd_dq_kernel, a block per (32 query rows,
// head, batch), computes dp, ds (written to an fp32 scratch the size of P),
// the two bias gradients and dq; (2) pa_bwd_dkv_kernel, a block per (32
// keys, head, batch), sums dv and dk over all queries, in query order, from
// P and ds.
//
// What bounds it: at MViTv2-small's stage-2 body (B=64, Nq = Nk = 196, 4
// heads, hd = 96, bf16) the forward moves ~81 MB (P's 39 MB of them) against
// 3.8 GFLOP, the backward ~112 MB against 7.6 GFLOP: on the bf16 tensor cores
// both are bound by bytes (~24 and ~34 us). The bf16 forward writes P once,
// with every other operand read once from device memory, and recomputes the
// scores (three products where two are needed). The bf16 backward computes
// six products (dp three times) where the bound counts four, reads P three
// times (its rows kernel's second pass mostly from L2), re-reads K and V
// once a query tile from L2, and sums the bias gradients on the CUDA cores;
// at Nk = 196 a quarter of its column blocks hold 4 keys. PERF.md records
// how far each is from its bound.
// Limits: Nk <= 1024 (the CUDA-core kernels keep whole score rows in shared
// memory), hd <= 128.
//
// C interface: each entry point launches on the given stream and returns
// cudaGetLastError() as an int (0 = success);
// skinjax_pooled_attention_error_string maps the code to its message.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>
#include <type_traits>

#include "mma_bf16.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxNk = 1024;
constexpr int kMaxHd = 128;
constexpr int kHs = kMaxHd + 1;  // row stride of a (rows, head dim) tile in shared memory
constexpr int kTq = 32;          // query rows a block: the forward and the dq kernel
constexpr int kKc = 64;          // keys a chunk of K or V in shared memory
constexpr int kTk = 32;          // keys a block of the dk/dv kernel
constexpr int kQc = 32;          // query rows a chunk of the dk/dv kernel
constexpr int kTs = kTk + 1;     // row stride of its (kQc, kTk) planes

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
  int B, heads, Nq, Kh, Kw, Nk, hd;
};

__host__ __device__ __forceinline__ int round_up(int x, int m) { return (x + m - 1) / m * m; }

// shared memory of the forward and the dq kernel: kTq score rows, a (kTq, hd)
// tile and a (kKc, hd) chunk
int rows_smem_bytes(int Nk) { return 4 * (kTq * (round_up(Nk, kKc) + 1) + kTq * kHs + kKc * kHs); }
constexpr int dkv_smem_bytes() { return 4 * (2 * kQc * kTs + 2 * kQc * kHs); }

// Rows n0 .. n0 + count - 1 of the (N, hd) plane `plane` (= b * heads + h) of
// x as fp32 into dst (count x kHs); zeros past N and past hd.
template <typename T>
__device__ void load_rows(const T* __restrict__ x, int N, int hd, long long plane, int n0,
                          int count, float* dst) {
  const T* base = x + plane * N * hd;
  for (int idx = threadIdx.x; idx < count * kMaxHd; idx += kThreads) {
    const int r = idx / kMaxHd, d = idx - r * kMaxHd;
    const int n = n0 + r;
    dst[r * kHs + d] = (n < N && d < hd) ? to_f32<T>(base[(long long)n * hd + d]) : 0.f;
  }
}

// acc[i][j] = sum over d < hd of a[warp + 8i][d] * bm[lane + 32j][d]: the
// (kTq x kKc) tile of a . bm^T
__device__ __forceinline__ void tile_abt(const float* a, const float* bm, int hd,
                                         float acc[4][2]) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i][0] = acc[i][1] = 0.f;
#pragma unroll 4
  for (int d = 0; d < hd; ++d) {
    float av[4], bv[2];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = a[(warp + 8 * i) * kHs + d];
#pragma unroll
    for (int j = 0; j < 2; ++j) bv[j] = bm[(lane + 32 * j) * kHs + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// acc[i][j] += sum over m < mc of s[(warp + 8i) * ss + m0 + m] * x[m][lane + 32j]:
// kTq score rows times a (kKc, hd) chunk of V or K
__device__ __forceinline__ void rows_times_chunk(const float* s, int ss, int m0, int mc,
                                                 const float* x, float acc[4][4]) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll 4
  for (int m = 0; m < mc; ++m) {
    float av[4], xv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = s[(warp + 8 * i) * ss + m0 + m];
#pragma unroll
    for (int j = 0; j < 4; ++j) xv[j] = x[m * kHs + lane + 32 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], xv[j], acc[i][j]);
  }
}

// s[r][m] = f(r, m, rows[r] . x[m]) for every real row r < n_rows and key m <
// Nk of plane `plane` of x (K or V), x streamed kKc keys at a time
template <typename T, typename F>
__device__ void score_rows(const float* rows, const T* __restrict__ x, const Dims& g,
                           long long plane, int n_rows, float* s, int ss, float* chunk, F f) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int m0 = 0; m0 < g.Nk; m0 += kKc) {
    __syncthreads();  // rows loaded; the previous chunk consumed
    load_rows<T>(x, g.Nk, g.hd, plane, m0, kKc, chunk);
    __syncthreads();
    float acc[4][2];
    tile_abt(rows, chunk, g.hd, acc);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = warp + 8 * i;
      if (r >= n_rows) continue;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int m = m0 + lane + 32 * j;
        if (m < g.Nk) s[r * ss + m] = f(r, m, acc[i][j]);
      }
    }
  }
  __syncthreads();
}

// out rows n0 + warp + 8i, channels lane + 32j of plane `plane`: acc = s . x,
// x (K or V) streamed kKc keys at a time, written as round(acc * mul)
template <typename T>
__device__ void rows_product_out(const float* s, int ss, const T* __restrict__ x, const Dims& g,
                                 long long plane, int n0, int n_rows, float* chunk, float mul,
                                 T* __restrict__ out) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int m0 = 0; m0 < g.Nk; m0 += kKc) {
    __syncthreads();  // s complete; the previous chunk consumed
    load_rows<T>(x, g.Nk, g.hd, plane, m0, kKc, chunk);
    __syncthreads();
    rows_times_chunk(s, ss, m0, min(kKc, g.Nk - m0), chunk, acc);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = warp + 8 * i;
    if (r >= n_rows) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int d = lane + 32 * j;
      if (d < g.hd) out[(plane * g.Nq + n0 + r) * g.hd + d] = from_f32<T>(acc[i][j] * mul);
    }
  }
}

// Forward: o for 32 query rows of one head of one batch; P when p is not null.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    pa_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  const T* __restrict__ bias_h, const T* __restrict__ bias_w, T* __restrict__ o,
                  float* __restrict__ p, Dims g, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int ss = round_up(g.Nk, kKc) + 1;
  float* s = smem;
  float* qs = s + kTq * ss;
  float* chunk = qs + kTq * kHs;
  const int n0 = blockIdx.x * kTq;
  const long long plane = (long long)blockIdx.z * g.heads + blockIdx.y;
  const int n_rows = min(kTq, g.Nq - n0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  load_rows<T>(q, g.Nq, g.hd, plane, n0, kTq, qs);
  score_rows<T>(qs, k, g, plane, n_rows, s, ss, chunk, [&](int r, int m, float a) {
    const long long n = plane * g.Nq + n0 + r;
    a = __fmul_rn(a, scale);
    a = __fadd_rn(a, to_f32<T>(bias_h[n * g.Kh + m / g.Kw]));
    return __fadd_rn(a, to_f32<T>(bias_w[n * g.Kw + m % g.Kw]));
  });

  // softmax, a warp a row; P written, round(P) kept for the product with V
  for (int r = warp; r < n_rows; r += kWarps) {
    float* row = s + r * ss;
    float mx = -CUDART_INF_F;
    for (int m = lane; m < g.Nk; m += 32) mx = fmaxf(mx, row[m]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int m = lane; m < g.Nk; m += 32) {
      const float e = expf(row[m] - mx);
      row[m] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    float* prow = p ? p + (plane * g.Nq + n0 + r) * g.Nk : nullptr;
    for (int m = lane; m < g.Nk; m += 32) {
      const float pv = row[m] / sum;
      if (prow) prow[m] = pv;
      row[m] = round_to<T>(pv);
    }
  }
  rows_product_out<T>(s, ss, v, g, plane, n0, n_rows, chunk, 1.f, o);
}

// Forward, bf16, on the tensor cores (mma_bf16.cuh): o for 64 query rows of
// one head of one batch, four warps of 16 rows; P when p is not null. The
// rows' bias terms (bias_h as Kh values a row, bias_w as Kw) and each key's
// (m / Kw, m % Kw) sit in shared memory for the block. Two passes over the
// key tiles, K (and V) streaming two deep with cp.async: (a) the scores,
// bias added in registers, and a row's max and sum (online_softmax); (b) the scores
// again, P = exp(s - max) / sum written fp32 to p, and o += round(P) . V with
// the accumulators packed to bf16 as the A operand, then o = round(o).
template <int kD>
__global__ void __launch_bounds__(kTileThreads)
    pa_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const bf16* __restrict__ bias_h,
                      const bf16* __restrict__ bias_w, bf16* __restrict__ o,
                      float* __restrict__ p, Dims g, float scale, int vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int L = tile_ld<kD>(), kT = kTile * L;
  bf16* const ks = reinterpret_cast<bf16*>(smem_raw);  // K, buffers 0 and 1
  bf16* const vs = ks + 2 * kT;                         // V, buffers 0 and 1
  short2* const kidx = reinterpret_cast<short2*>(vs + 2 * kT);  // (m / Kw, m % Kw)
  bf16* const bhs = reinterpret_cast<bf16*>(kidx + g.Nk);         // (64, Kh)
  bf16* const bws = bhs + kTile * g.Kh;                            // (64, Kw)
  const int n0 = blockIdx.x * kTile;
  const long long plane = (long long)blockIdx.z * g.heads + blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gq = lane >> 2, t = lane & 3;
  const int rl = 16 * warp + gq;  // this thread's rows in the tile: rl, rl + 8
  const bf16 *kh = k + plane * g.Nk * g.hd, *vh = v + plane * g.Nk * g.hd;
  const int nt = (g.Nk + kTile - 1) / kTile;

  load_tile<kD>(ks, q + plane * g.Nq * g.hd, g.hd, n0, g.Nq, g.hd, vec);
  cp_async_commit();
  for (int m = threadIdx.x; m < g.Nk; m += kTileThreads)
    kidx[m] = make_short2(static_cast<short>(m / g.Kw), static_cast<short>(m % g.Kw));
  for (int i = threadIdx.x; i < kTile * g.Kh; i += kTileThreads) {
    const int r = i / g.Kh, n = n0 + r;
    bhs[i] = n < g.Nq ? bias_h[(plane * g.Nq + n) * g.Kh + i - r * g.Kh] : __float2bfloat16_rn(0.f);
  }
  for (int i = threadIdx.x; i < kTile * g.Kw; i += kTileThreads) {
    const int r = i / g.Kw, n = n0 + r;
    bws[i] = n < g.Nq ? bias_w[(plane * g.Nq + n) * g.Kw + i - r * g.Kw] : __float2bfloat16_rn(0.f);
  }
  cp_async_wait<0>();
  __syncthreads();
  unsigned qf[kD / 16][4];
  load_a<kD>(qf, ks + 16 * warp * L);
  __syncthreads();

  // the scores of a (16 x 16) block, keys m0 + 16 kk.., in place from their
  // fp32 products: the scale, then bias_h, then bias_w; -inf past Nk
  auto scores = [&](float (&s)[2][4], int m0, int kk) {
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const short2 ix = kidx[min(m0 + 16 * kk + 8 * j + 2 * t + c, g.Nk - 1)];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = rl + 8 * h;
          const float a = __fadd_rn(__fmul_rn(s[j][2 * h + c], scale),
                                    __bfloat162float(bhs[r * g.Kh + ix.x]));
          s[j][2 * h + c] = __fadd_rn(a, __bfloat162float(bws[r * g.Kw + ix.y]));
        }
      }
    if (m0 + 16 * kk + 16 > g.Nk) {
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (m0 + 16 * kk + 8 * j + 2 * t + (e & 1) >= g.Nk) s[j][e] = -CUDART_INF_F;
    }
  };

  // (a) max and sum, online
  float mx[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f};
  pipeline(
      nt,
      [&](int kt, int buf) {
        load_tile<kD>(ks + buf * kT, kh, g.hd, kt * kTile, g.Nk, g.hd, vec);
      },
      [&](int kt, int buf) {
        const int m0 = kt * kTile;
        float s[4][2][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) warp_abt_chunk<kD>(s[kk], qf, ks + buf * kT, kk);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) scores(s[kk], m0, kk);
        online_softmax(s, mx, l);
      });
  float inv[2], mxl[2];
  softmax_finish(mx, l, inv, mxl);

  // (b) P written, o = round(round(P) . V), 16 keys at a time
  float oacc[kD / 8][4];
  zero_acc<kD>(oacc);
  const bool pairs = (g.Nk & 1) == 0;  // P's rows start 8-byte aligned
  pipeline(
      nt,
      [&](int kt, int buf) {
        load_tile<kD>(ks + buf * kT, kh, g.hd, kt * kTile, g.Nk, g.hd, vec);
        load_tile<kD>(vs + buf * kT, vh, g.hd, kt * kTile, g.Nk, g.hd, vec);
      },
      [&](int kt, int buf) {
        const int m0 = kt * kTile;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          float s[2][4];
          warp_abt_chunk<kD>(s, qf, ks + buf * kT, kk);
          scores(s, m0, kk);
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              s[j][e] = prob(s[j][e], mxl[e >> 1], inv[e >> 1]);
          if (p) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int n = n0 + rl + 8 * h;
              if (n >= g.Nq) continue;
              float* prow = p + (plane * g.Nq + n) * g.Nk;
#pragma unroll
              for (int j = 0; j < 2; ++j) {
                const int m = m0 + 16 * kk + 8 * j + 2 * t;
                if (pairs && m < g.Nk) {
                  __stcs(reinterpret_cast<float2*>(prow + m),
                         make_float2(s[j][2 * h], s[j][2 * h + 1]));
                } else {
                  if (m < g.Nk) __stcs(prow + m, s[j][2 * h]);
                  if (m + 1 < g.Nk) __stcs(prow + m + 1, s[j][2 * h + 1]);
                }
              }
            }
          }
          unsigned pa[4];
          pack_a_chunk(pa, s);
          warp_ax_chunk<kD>(oacc, pa, vs + buf * kT, kk);
        }
      });
  store_frag_rows<kD>(o + plane * g.Nq * g.hd, g.hd, oacc, n0 + rl, g.Nq, g.hd, 1.f, vec);
}

// shared memory of pa_fwd_mma_kernel: K and V twice, the key indices and the
// rows' bias terms
template <int kD>
int fwd_mma_smem_bytes(const Dims& g) {
  return 4 * tile_bytes<kD>() + 4 * g.Nk + 2 * kTile * (g.Kh + g.Kw);
}

// Backward (1): dp, ds (to the scratch), the bias gradients and dq for 32
// query rows of one head of one batch.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    pa_bwd_dq_kernel(const T* __restrict__ k, const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ p, T* __restrict__ dq, float* __restrict__ dbias_h,
                     float* __restrict__ dbias_w, float* __restrict__ ds, Dims g, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int ss = round_up(g.Nk, kKc) + 1;
  float* s = smem;
  float* dos = s + kTq * ss;
  float* chunk = dos + kTq * kHs;
  const int n0 = blockIdx.x * kTq;
  const long long plane = (long long)blockIdx.z * g.heads + blockIdx.y;
  const int n_rows = min(kTq, g.Nq - n0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  load_rows<T>(dout, g.Nq, g.hd, plane, n0, kTq, dos);
  score_rows<T>(dos, v, g, plane, n_rows, s, ss, chunk, [](int, int, float a) { return a; });

  // ds = P * (dp - rowsum(dp * P)), a warp a row; its sums over the key
  // grid's columns (dbias_h) and rows (dbias_w); round(ds) kept for dq
  for (int r = warp; r < n_rows; r += kWarps) {
    float* row = s + r * ss;
    const long long n = plane * g.Nq + n0 + r;
    const float* prow = p + n * g.Nk;
    float rs = 0.f;
    for (int m = lane; m < g.Nk; m += 32) rs += __fmul_rn(row[m], prow[m]);
    rs = warp_sum(rs);
    for (int m = lane; m < g.Nk; m += 32) {
      const float d = __fmul_rn(prow[m], row[m] - rs);
      ds[n * g.Nk + m] = d;
      row[m] = d;
    }
    __syncwarp();
    for (int a = lane; a < g.Kh; a += 32) {
      float t = 0.f;
      for (int c = 0; c < g.Kw; ++c) t += row[a * g.Kw + c];
      dbias_h[n * g.Kh + a] = t;
    }
    for (int c = lane; c < g.Kw; c += 32) {
      float t = 0.f;
      for (int a = 0; a < g.Kh; ++a) t += row[a * g.Kw + c];
      dbias_w[n * g.Kw + c] = t;
    }
    __syncwarp();
    for (int m = lane; m < g.Nk; m += 32) row[m] = round_to<T>(row[m]);
  }
  rows_product_out<T>(s, ss, k, g, plane, n0, n_rows, chunk, scale, dq);
}

// Backward (2): dv = round(P)^T . do and dk = round(ds)^T . q * scale for 32
// keys of one head of one batch, summed over every query in query order.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    pa_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ dout,
                      const float* __restrict__ p, const float* __restrict__ ds,
                      T* __restrict__ dk, T* __restrict__ dv, Dims g, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* pb = smem;               // kQc x kTs
  float* dsb = pb + kQc * kTs;    // kQc x kTs
  float* dos = dsb + kQc * kTs;   // kQc x kHs
  float* qs = dos + kQc * kHs;    // kQc x kHs
  const int m0 = blockIdx.x * kTk;
  const long long plane = (long long)blockIdx.z * g.heads + blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float adv[4][4], adk[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) adv[i][j] = adk[i][j] = 0.f;

  for (int n0 = 0; n0 < g.Nq; n0 += kQc) {
    __syncthreads();  // the previous chunk consumed
    for (int idx = threadIdx.x; idx < kQc * kTk; idx += kThreads) {
      const int r = idx / kTk, c = idx - r * kTk;
      const int n = n0 + r, m = m0 + c;
      float a = 0.f, d = 0.f;
      if (n < g.Nq && m < g.Nk) {
        const long long at = (plane * g.Nq + n) * g.Nk + m;
        a = round_to<T>(p[at]);
        d = round_to<T>(ds[at]);
      }
      pb[r * kTs + c] = a;
      dsb[r * kTs + c] = d;
    }
    load_rows<T>(dout, g.Nq, g.hd, plane, n0, kQc, dos);
    load_rows<T>(q, g.Nq, g.hd, plane, n0, kQc, qs);
    __syncthreads();
    const int nc = min(kQc, g.Nq - n0);
#pragma unroll 2
    for (int r = 0; r < nc; ++r) {
      float pv[4], sv[4], dov[4], qv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = pb[r * kTs + warp + 8 * i];
        sv[i] = dsb[r * kTs + warp + 8 * i];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        dov[j] = dos[r * kHs + lane + 32 * j];
        qv[j] = qs[r * kHs + lane + 32 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          adv[i][j] = fmaf(pv[i], dov[j], adv[i][j]);
          adk[i][j] = fmaf(sv[i], qv[j], adk[i][j]);
        }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + warp + 8 * i;
    if (m >= g.Nk) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int d = lane + 32 * j;
      if (d >= g.hd) continue;
      const long long at = (plane * g.Nk + m) * g.hd + d;
      dv[at] = from_f32<T>(adv[i][j]);
      dk[at] = from_f32<T>(adk[i][j] * scale);
    }
  }
}

// ---- The backward's bf16 instantiation on the tensor cores ----
//
// K12's stored-P pair (global_attention.cu) on this layout, with the bias
// gradients in the rows kernel: dp of a (16 query x 16 key) block is dO rows
// (A) times V rows (B) in ascending 16-column steps on the same 64-grids in
// both kernels, and ds = P (dp - r) with the one r the rows kernel wrote, so
// a (query, key) pair gets the same ds bits in both and dq and dk are taken
// from the same round(ds).

// The largest dynamic shared memory a block may have (227 KB)
constexpr int kMaxSmemBytes = 232448;

// shared memory of the rows kernel without its bias accumulators: K and V,
// two buffers each, and two stages of the staged P plane
template <int kD>
constexpr int rows_mma_base_bytes() {
  return 4 * tile_bytes<kD>() + 2 * 4 * kPlaneFloats;
}

// Backward (1), bf16: dq and the bias gradients for 64 query rows of one
// head of one batch (a warp 16 of them), two passes over the key tiles in
// one pipeline of 2 nt steps, V (and K) and P's (64 x 64) tiles streaming
// two deep. (a) dp = dO . V^T and
// r = rowsum(dp * P), written to rsum (B, heads, Nq); (b) dp again and ds =
// P (dp - r) fp32 in registers, which the warp writes over its rows of the
// staged P tile and rounds to bf16 as the A operand of dq += round(ds) . K,
// 16 keys at a time; dq = round(dq * scale). Then, for each key tile, a lane
// owns each (row, key-grid row a) and each (row, key-grid column c) pair
// that the tile's keys touch and adds the tile's ds of it, in key order, to
// the row's accumulators: (Kh + Kw) floats a row in shared memory with
// acc_smem, else the block's own rows of dbias_h and dbias_w. No atomics.
template <int kD>
__global__ void __launch_bounds__(kTileThreads, 2)
    pa_bwd_rows_mma_kernel(const bf16* __restrict__ k, const bf16* __restrict__ v,
                           const bf16* __restrict__ dout, const float* __restrict__ p,
                           bf16* __restrict__ dq, float* __restrict__ dbias_h,
                           float* __restrict__ dbias_w, float* __restrict__ rsum, Dims g,
                           float scale, int vec, int acc_smem) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int L = tile_ld<kD>(), kT = kTile * L;
  bf16* const ks = reinterpret_cast<bf16*>(smem_raw);  // K, buffers 0 and 1
  bf16* const vs = ks + 2 * kT;                         // V, buffers 0 and 1
  float* const pl = reinterpret_cast<float*>(vs + 2 * kT);  // P, stages 0 and 1
  const int n0 = blockIdx.x * kTile;
  const long long plane = (long long)blockIdx.z * g.heads + blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gq = lane >> 2, t = lane & 3;
  const int rl = 16 * warp + gq;  // this thread's rows of the tile: rl, rl + 8
  const int rows = min(16, g.Nq - n0 - 16 * warp);  // this warp's real rows (<= 0: none)
  const bf16 *kh = k + plane * g.Nk * g.hd, *vh = v + plane * g.Nk * g.hd;
  const float* ph = p + plane * g.Nq * g.Nk;
  const int nt = (g.Nk + kTile - 1) / kTile;
  // this warp's rows of the bias accumulators (row r at wh + r * Kh, ww + r * Kw)
  const long long out_row = plane * g.Nq + n0 + 16 * warp;
  float* const wh = acc_smem ? pl + 2 * kPlaneFloats + 16 * warp * g.Kh : dbias_h + out_row * g.Kh;
  float* const ww = acc_smem ? pl + 2 * kPlaneFloats + kTile * g.Kh + 16 * warp * g.Kw
                             : dbias_w + out_row * g.Kw;
  for (int i = lane; i < rows * g.Kh; i += 32) wh[i] = 0.f;
  for (int i = lane; i < rows * g.Kw; i += 32) ww[i] = 0.f;

  // this warp's dO rows as A fragments, for the whole block
  unsigned df[kD / 16][4];
  load_tile<kD>(vs, dout + plane * g.Nq * g.hd, g.hd, n0, g.Nq, g.hd, vec);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  load_a<kD>(df, vs + 16 * warp * L);
  __syncthreads();

  float rs[2] = {0.f, 0.f}, r[2] = {0.f, 0.f};
  float dqa[kD / 8][4];
  zero_acc<kD>(dqa);
  pipeline(
      2 * nt,
      [&](int s, int buf) {  // steps nt.. are pass (b)'s, which also reads K
        const int kt = s < nt ? s : s - nt;
        if (s >= nt) load_tile<kD>(ks + buf * kT, kh, g.hd, kt * kTile, g.Nk, g.hd, vec);
        load_tile<kD>(vs + buf * kT, vh, g.hd, kt * kTile, g.Nk, g.hd, vec);
        load_plane(pl + buf * kPlaneFloats, ph, g.Nq, g.Nk, n0, kt * kTile);
      },
      [&](int s, int buf) {
        if (rows <= 0) return;
        float* st = pl + buf * kPlaneFloats;
        if (s < nt) {  // (a) r = rowsum(dp * P)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            float d[2][4];
            warp_abt_chunk<kD>(d, df, vs + buf * kT, kk);
#pragma unroll
            for (int j = 0; j < 2; ++j)
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const float2 pv = plane_pair(st, rl + 8 * h, 16 * kk + 8 * j + 2 * t);
                rs[h] = __fmaf_rn(d[j][2 * h], pv.x, rs[h]);
                rs[h] = __fmaf_rn(d[j][2 * h + 1], pv.y, rs[h]);
              }
          }
          return;
        }
        if (s == nt) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            r[h] = quad_sum(rs[h]);
            if (t == 0 && n0 + rl + 8 * h < g.Nq) rsum[plane * g.Nq + n0 + rl + 8 * h] = r[h];
          }
        }
        // (b) ds, the bias gradients and dq
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          float d[2][4];
          warp_abt_chunk<kD>(d, df, vs + buf * kT, kk);
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              float2* at =
                  reinterpret_cast<float2*>(st + (rl + 8 * h) * kPlaneLd + 16 * kk + 8 * j + 2 * t);
              const float2 pv = *at;
              d[j][2 * h] = __fmul_rn(pv.x, __fsub_rn(d[j][2 * h], r[h]));
              d[j][2 * h + 1] = __fmul_rn(pv.y, __fsub_rn(d[j][2 * h + 1], r[h]));
              *at = make_float2(d[j][2 * h], d[j][2 * h + 1]);
            }
          unsigned a[4];
          pack_a_chunk(a, d);
          warp_ax_chunk<kD>(dqa, a, ks + buf * kT, kk);
        }
        __syncwarp();
        // the tile's ds of this warp's rows, summed into the bias
        // accumulators: a lane takes the (row, bucket) pairs lane, lane + 32,
        // ... of each sum (the item index stepped without a division)
        const float* wds = st + 16 * warp * kPlaneLd;
        const int m0 = (s - nt) * kTile, kn = min(kTile, g.Nk - m0);
        // dbias_h: grid rows a0 .. a0 + na - 1, each a run of keys
        const int a0 = m0 / g.Kw, na = (m0 + kn - 1) / g.Kw - a0 + 1;
        const int dra = 32 / na, daa = 32 - dra * na;
        for (int rr = lane / na, ai = lane - rr * na; rr < rows;) {
          const int lo = max((a0 + ai) * g.Kw - m0, 0), hi = min((a0 + ai + 1) * g.Kw - m0, kn);
          const float* row = wds + rr * kPlaneLd;
          float sum = 0.f;
          for (int m = lo; m < hi; ++m) sum += row[m];
          wh[rr * g.Kh + a0 + ai] += sum;
          rr += dra;
          ai += daa;
          if (ai >= na) {
            ai -= na;
            ++rr;
          }
        }
        // dbias_w: the tile's first nc keys' grid columns, each every Kw keys
        const int nc = min(g.Kw, kn), w0 = m0 % g.Kw;
        const int drc = 32 / nc, dcc = 32 - drc * nc;
        for (int rr = lane / nc, c = lane - rr * nc; rr < rows;) {
          const float* row = wds + rr * kPlaneLd;
          float sum = 0.f;
          for (int m = c; m < kn; m += g.Kw) sum += row[m];
          ww[rr * g.Kw + (w0 + c < g.Kw ? w0 + c : w0 + c - g.Kw)] += sum;
          rr += drc;
          c += dcc;
          if (c >= nc) {
            c -= nc;
            ++rr;
          }
        }
      });
  store_frag_rows<kD>(dq + plane * g.Nq * g.hd, g.hd, dqa, n0 + rl, g.Nq, g.hd, scale, vec);
  if (acc_smem) {
    __syncwarp();
    for (int i = lane; i < rows * g.Kh; i += 32) dbias_h[out_row * g.Kh + i] = wh[i];
    for (int i = lane; i < rows * g.Kw; i += 32) dbias_w[out_row * g.Kw + i] = ww[i];
  }
}

// Backward (2), bf16: dv = round(P)^T . dO and dk = round(ds)^T . Q * scale
// for 64 keys of one head of one batch (a warp 16 of them), summed over
// every query tile in order. A warp holds its 16 keys of V as B fragments
// in registers; Q, dO, P and the rows kernel's r stream in 64-query tiles.
// For each 16 query rows it computes dp against its keys as the rows kernel
// does, forms round(P) and ds in registers, and transposes them (movmatrix)
// into the A operands of dv += P^T . dO and dk += ds^T . Q.
template <int kD>
__global__ void __launch_bounds__(kTileThreads, 2)
    pa_bwd_cols_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ v,
                           const bf16* __restrict__ dout, const float* __restrict__ p,
                           const float* __restrict__ rsum, bf16* __restrict__ dk,
                           bf16* __restrict__ dv, Dims g, float scale, int vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int L = tile_ld<kD>(), kT = kTile * L;
  constexpr int stage = kPlaneFloats + kTile;  // P, then r
  bf16* const qs = reinterpret_cast<bf16*>(smem_raw);  // Q, buffers 0 and 1
  bf16* const dos = qs + 2 * kT;                        // dO, buffers 0 and 1
  float* const pl = reinterpret_cast<float*>(dos + 2 * kT);  // P and r, stages 0 and 1
  const int m0 = blockIdx.x * kTile;
  const long long plane = (long long)blockIdx.z * g.heads + blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gq = lane >> 2, t = lane & 3;
  const int cl0 = 16 * warp;  // this warp's keys in the block: m0 + cl0 ..
  const bool live = m0 + cl0 < g.Nk;
  const bf16 *qh = q + plane * g.Nq * g.hd, *dh = dout + plane * g.Nq * g.hd;
  const float* ph = p + plane * g.Nq * g.Nk;
  const int nt = (g.Nq + kTile - 1) / kTile;

  float dva[kD / 8][4], dka[kD / 8][4];
  unsigned vf[kD / 16][4];
  zero_acc<kD>(dva);
  zero_acc<kD>(dka);
  load_b_global<kD>(vf, v + plane * g.Nk * g.hd, g.hd, m0 + cl0, g.Nk, g.hd, vec);
  pipeline(
      nt,
      [&](int it, int buf) {
        load_tile<kD>(qs + buf * kT, qh, g.hd, it * kTile, g.Nq, g.hd, vec);
        load_tile<kD>(dos + buf * kT, dh, g.hd, it * kTile, g.Nq, g.hd, vec);
        float* st = pl + buf * stage;
        load_plane(st, ph, g.Nq, g.Nk, it * kTile, m0);
        load_vec64(st + kPlaneFloats, rsum + plane * g.Nq + it * kTile, g.Nq - it * kTile);
      },
      [&](int it, int buf) {
        if (!live) return;
        const float* st = pl + buf * stage;
        const bf16 *qb = qs + buf * kT, *db = dos + buf * kT;
#pragma unroll
        for (int mq = 0; mq < 4; ++mq) {
          const int rl = 16 * mq + gq;  // this thread's rows of the tile: rl, rl + 8
          unsigned da[kD / 16][4];
          load_a<kD>(da, db + 16 * mq * L);
          float d[2][4], pb[2][4];
          warp_abt_frag<kD>(d, da, vf);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float r = st[kPlaneFloats + rl + 8 * h];
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const float2 pv = plane_pair(st, rl + 8 * h, cl0 + 8 * j + 2 * t);
              d[j][2 * h] = __fmul_rn(pv.x, __fsub_rn(d[j][2 * h], r));
              d[j][2 * h + 1] = __fmul_rn(pv.y, __fsub_rn(d[j][2 * h + 1], r));
              pb[j][2 * h] = pv.x;
              pb[j][2 * h + 1] = pv.y;
            }
          }
          unsigned pa[4], sa[4];
          pack_at_chunk(pa, pb);
          pack_at_chunk(sa, d);
          warp_ax_chunk<kD>(dva, pa, db, mq);
          warp_ax_chunk<kD>(dka, sa, qb, mq);
        }
      });
  const int m = m0 + cl0 + gq;
  store_frag_rows<kD>(dv + plane * g.Nk * g.hd, g.hd, dva, m, g.Nk, g.hd, 1.f, vec);
  store_frag_rows<kD>(dk + plane * g.Nk * g.hd, g.hd, dka, m, g.Nk, g.hd, scale, vec);
}

Dims dims(int B, int heads, int Nq, int Kh, int Kw, int hd) {
  Dims g;
  g.B = B;
  g.heads = heads;
  g.Nq = Nq;
  g.Kh = Kh;
  g.Kw = Kw;
  g.Nk = Kh * Kw;
  g.hd = hd;
  return g;
}

bool bad_dims(const Dims& g) {
  return g.Nq < 1 || g.Kh < 1 || g.Kw < 1 || g.Nk > kMaxNk || g.hd < 1 || g.hd > kMaxHd ||
         g.B < 1 || g.B > 65535 || g.heads < 1 || g.heads > 65535;
}

template <int kD>
cudaError_t launch_fwd_mma(const void* q, const void* k, const void* v, const void* bias_h,
                           const void* bias_w, void* o, float* p, const Dims& g, float scale,
                           int vec, cudaStream_t stream) {
  const int smem = fwd_mma_smem_bytes<kD>(g);
  cudaError_t err = cudaFuncSetAttribute(pa_fwd_mma_kernel<kD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((g.Nq + kTile - 1) / kTile, g.heads, g.B);
  pa_fwd_mma_kernel<kD><<<grid, kTileThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(bias_h), static_cast<const bf16*>(bias_w), static_cast<bf16*>(o),
      p, g, scale, vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, const void* bias_h,
                       const void* bias_w, void* o, float* p, const Dims& g, float scale,
                       int vec, cudaStream_t stream) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (g.hd <= 32) return launch_fwd_mma<32>(q, k, v, bias_h, bias_w, o, p, g, scale, vec, stream);
    if (g.hd <= 64) return launch_fwd_mma<64>(q, k, v, bias_h, bias_w, o, p, g, scale, vec, stream);
    if (g.hd <= 96) return launch_fwd_mma<96>(q, k, v, bias_h, bias_w, o, p, g, scale, vec, stream);
    return launch_fwd_mma<128>(q, k, v, bias_h, bias_w, o, p, g, scale, vec, stream);
  } else {
    const int smem = rows_smem_bytes(g.Nk);
    cudaError_t err =
        cudaFuncSetAttribute(pa_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((g.Nq + kTq - 1) / kTq, g.heads, g.B);
    pa_fwd_kernel<T><<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(bias_h), static_cast<const T*>(bias_w), static_cast<T*>(o), p, g,
        scale);
    return cudaGetLastError();
  }
}

template <int kD>
cudaError_t launch_bwd_mma(const void* q, const void* k, const void* v, const void* dout,
                           const float* p, void* dq, void* dk, void* dv, float* dbias_h,
                           float* dbias_w, float* rsum, const Dims& g, float scale, int vec,
                           cudaStream_t stream) {
  const bf16 *qb = static_cast<const bf16*>(q), *kb = static_cast<const bf16*>(k),
             *vb = static_cast<const bf16*>(v), *db = static_cast<const bf16*>(dout);
  // the bias accumulators in shared memory where they fit
  const int acc = 4 * kTile * (g.Kh + g.Kw);
  const int acc_smem = rows_mma_base_bytes<kD>() + acc <= kMaxSmemBytes;
  int smem = rows_mma_base_bytes<kD>() + (acc_smem ? acc : 0);
  cudaError_t err = cudaFuncSetAttribute(pa_bwd_rows_mma_kernel<kD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  pa_bwd_rows_mma_kernel<kD><<<dim3((g.Nq + kTile - 1) / kTile, g.heads, g.B), kTileThreads, smem,
                               stream>>>(kb, vb, db, p, static_cast<bf16*>(dq), dbias_h, dbias_w,
                                         rsum, g, scale, vec, acc_smem);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  smem = 4 * tile_bytes<kD>() + 2 * 4 * (kPlaneFloats + kTile);
  err = cudaFuncSetAttribute(pa_bwd_cols_mma_kernel<kD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  pa_bwd_cols_mma_kernel<kD><<<dim3((g.Nk + kTile - 1) / kTile, g.heads, g.B), kTileThreads, smem,
                               stream>>>(qb, vb, db, p, rsum, static_cast<bf16*>(dk),
                                         static_cast<bf16*>(dv), g, scale, vec);
  return cudaGetLastError();
}

// scratch: ds (like p) for fp32, the row statistic r (B, heads, Nq) for bf16
template <typename T>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, const void* dout,
                       const float* p, void* dq, void* dk, void* dv, float* dbias_h,
                       float* dbias_w, float* scratch, const Dims& g, float scale, int vec,
                       cudaStream_t stream) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (g.hd <= 32)
      return launch_bwd_mma<32>(q, k, v, dout, p, dq, dk, dv, dbias_h, dbias_w, scratch, g, scale,
                                vec, stream);
    if (g.hd <= 64)
      return launch_bwd_mma<64>(q, k, v, dout, p, dq, dk, dv, dbias_h, dbias_w, scratch, g, scale,
                                vec, stream);
    if (g.hd <= 96)
      return launch_bwd_mma<96>(q, k, v, dout, p, dq, dk, dv, dbias_h, dbias_w, scratch, g, scale,
                                vec, stream);
    return launch_bwd_mma<128>(q, k, v, dout, p, dq, dk, dv, dbias_h, dbias_w, scratch, g, scale,
                               vec, stream);
  } else {
    const int smem = rows_smem_bytes(g.Nk);
    cudaError_t err = cudaFuncSetAttribute(pa_bwd_dq_kernel<T>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid_q((g.Nq + kTq - 1) / kTq, g.heads, g.B);
    pa_bwd_dq_kernel<T><<<grid_q, kThreads, smem, stream>>>(
        static_cast<const T*>(k), static_cast<const T*>(v), static_cast<const T*>(dout), p,
        static_cast<T*>(dq), dbias_h, dbias_w, scratch, g, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(pa_bwd_dkv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               dkv_smem_bytes());
    if (err != cudaSuccess) return err;
    const dim3 grid_k((g.Nk + kTk - 1) / kTk, g.heads, g.B);
    pa_bwd_dkv_kernel<T><<<grid_k, kThreads, dkv_smem_bytes(), stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(dout), p, scratch, static_cast<T*>(dk),
        static_cast<T*>(dv), g, scale);
    return cudaGetLastError();
  }
}

}  // namespace

extern "C" {

const char* skinjax_pooled_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// bf16: 0 for float, 1 for bfloat16 (q, k, v, the biases and o share it). q
// (B, heads, Nq, hd), k and v (B, heads, Kh * Kw, hd), bias_h (B, heads, Nq,
// Kh), bias_w (B, heads, Nq, Kw), all contiguous. Writes o (B, heads, Nq, hd)
// and, when p is not null, P (B, heads, Nq, Kh * Kw) fp32.
int skinjax_pooled_attention_fwd(int bf16, const void* q, const void* k, const void* v,
                                 const void* bias_h, const void* bias_w, void* o, float* p, int B,
                                 int heads, int Nq, int Kh, int Kw, int hd, float scale,
                                 void* stream) {
  const Dims g = dims(B, heads, Nq, Kh, Kw, hd);
  if (bad_dims(g)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int vec = hd % 8 == 0 && aligned16(q) && aligned16(k) && aligned16(v) && aligned16(o);
  if (bf16)
    return launch_fwd<__nv_bfloat16>(q, k, v, bias_h, bias_w, o, p, g, scale, vec, s);
  return launch_fwd<float>(q, k, v, bias_h, bias_w, o, p, g, scale, vec, s);
}

// dout (B, heads, Nq, hd) like o; p the forward's P. Writes dq (like q), dk
// and dv (like k), dbias_h (B, heads, Nq, Kh) and dbias_w (B, heads, Nq, Kw)
// fp32, and the fp32 scratch: for float ds (like p), for bfloat16 the row
// statistic rowsum(dp * P) (B, heads, Nq).
int skinjax_pooled_attention_bwd(int bf16, const void* q, const void* k, const void* v,
                                 const void* dout, const float* p, void* dq, void* dk, void* dv,
                                 float* dbias_h, float* dbias_w, float* scratch, int B, int heads,
                                 int Nq, int Kh, int Kw, int hd, float scale, void* stream) {
  const Dims g = dims(B, heads, Nq, Kh, Kw, hd);
  if (bad_dims(g)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int vec = hd % 8 == 0 && aligned16(q) && aligned16(k) && aligned16(v) &&
                  aligned16(dout) && aligned16(dq) && aligned16(dk) && aligned16(dv);
  if (bf16)
    return launch_bwd<__nv_bfloat16>(q, k, v, dout, p, dq, dk, dv, dbias_h, dbias_w, scratch, g,
                                     scale, vec, s);
  return launch_bwd<float>(q, k, v, dout, p, dq, dk, dv, dbias_h, dbias_w, scratch, g, scale, vec,
                           s);
}

}  // extern "C"
