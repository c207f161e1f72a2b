// Global (full-sequence) multi-head attention core: the forward, the
// stored-probabilities backward and the recompute backward, for Hopper (sm_90a).
//
// It replaces the Pallas TPU kernel K12 of skinjax/ops/pallas/global_attention.py:
// the forward _fwd_core (kernel _fwd_kernel, with emit_p), the stored-P
// backward _bwd_p_core (kernel _bwd_p_kernel) and the recompute backward that
// its _ac_bwd takes above the stored-P limit, skinjax/ops/pallas/
// window_attention.py _bwd_core (kernel _bwd_core_kernel), which is also the
// backward core of K7's padded-window entry window_attention (_bwd_call, with
// the per-window mask: window b adds mask[b % n_win]; there B counts windows).
// q, k and v are (B, N, C) in the head-major channel layout
// (channel c belongs to head c / hd), each row at a stride of ld elements (C
// when contiguous, 3C for slices of a packed qkv projection). Per batch b and
// head h (hd = C / heads channels):
//
//   forward   s = (q.k^T) * scale (+ bias[h]) (+ mask[b % n_win]) (+ kmask[b] over the keys)
//             P = softmax(s) fp32, written to p (B, heads, N, N) when asked
//             o = round(round(P * pmult) . v)
//   backward  pb = round(P * pmult);  dv = round(pb^T . do)
//             dp = (do . v^T) * pmult;  ds = P * (dp - rowsum(dp * P))       fp32
//             dq = round((round(ds) . k) * scale);  dk = round((round(ds)^T . q) * scale)
//             dbias[h] = sum over b of ds (when a bias gradient is asked for)
//
// "round" is the cast to the input type (bf16 or fp32) where the Pallas kernel
// casts; every sum is fp32. The scale multiplies the fp32 product, in the
// forward before the bias and in the backward after the products, as the
// Pallas kernel does (its reference instead scales q in the input type).
// Both backwards round at the same points. The Pallas recompute kernel also
// emits of = pb . v, which _ac_bwd drops and _bwd_call reads; the recompute
// backward writes it when asked (without pmult).
//
// Layout. No TPU padding: a block masks its own ragged edge (N = 197 for
// ViT/BEiT at 224x224), and P is kept as (B, heads, N, N), not Mosaic's
// (groups, B, heads/group, Np, Np).
//
// Launches. Forward: one launch. bf16 (the main path under autocast):
// ga_fwd_mma_kernel, a block per (64 query rows, head, batch) on the tensor
// cores (below, after the recompute rows kernel, whose score code and steps
// it shares). fp32 (the card-vs-CPU and fp32 twin checks at 1e-4; TF32 would
// not hold them): ga_fwd_kernel, a block per (32 query rows, head, batch),
// which holds its 32 score rows in shared memory, streams K and then V
// through shared memory 128 keys at a time as fp32 FMAs on the CUDA cores,
// and does the softmax a warp a row. The Pallas backwards sum dk, dv over
// every query and dbias over the batch across their sequential grid; blocks
// here run in no order, so each backward is a few launches with no atomics.
//
// Stored-P backward, bf16 (the main path under autocast), on the tensor
// cores (no ds of size B.heads.N^2 in memory; one fp32 statistic a query
// row, r = rowsum(dp * P), (B, heads, N)): (1) ga_bwd_p_rows_mma_kernel, a
// block per (64 query rows, head, batch), makes two passes over the key
// tiles, (a) dp and r, which it writes, (b) dp again, ds in registers and
// dq; (2) ga_bwd_p_cols_mma_kernel, a block per (64 keys, head, batch or
// group of batches), computes each dp block in the rows kernel's operand
// and k-step order, so its ds is (1)'s bit for bit, and sums dv and dk over
// every query. Without a bias gradient (2) takes one batch; with one it
// walks a group of consecutive batches in order and sums the fp32 ds of its
// key columns into that group's dbias[h] plane, the previous batches' sum of
// each tile staged with the tile by cp.async; with more than one group, (3)
// ga_dbias_reduce_kernel adds the groups' planes in group order. The wrapper
// picks the groups (about one wave of (2)'s blocks; 4 of 8 batches at
// BEiT-large, 9.9 MB of planes where the fp32 ds is 79.5 MB). The fp32
// instantiation (the card-vs-CPU and fp32 twin checks at 1e-4) keeps the
// CUDA-core kernels: (1) ga_bwd_dq_kernel, a block per (32 query rows, head,
// batch), computes dp, ds (written to an fp32 scratch the size of P) and
// dq; (2) ga_bwd_dkv_kernel, a block per (32 keys, head, batch), sums dv and
// dk over all queries from P and ds; (3) with a bias gradient, dbias = the
// sum of ds over the batch in batch order.
//
// Recompute backward (no P and no ds of size B.heads.N^2 in memory; only
// three fp32 row statistics a query row, (3, B, heads, N)): (1) a rows
// kernel, a block per (query tile, head, batch), recomputes the scores and
// the softmax, writes each row's max, sum and rowsum(dp * P) (and, when
// asked, of = round(round(P) . v)), forms ds, which it rounds, and computes
// dq; (2) a cols kernel, a block per (key tile, head), recomputes its P and
// dp columns from q, k, v, do and those statistics, with the same products
// in the same order, so P is (1)'s bit for bit and ds the one dq was
// computed from, and sums dv and dk over every query. Without a bias
// gradient block (2) takes one batch (grid z = batch); with one it loops
// over a group of consecutive batches in order and owns its key columns of
// that group's dbias[h] plane, which it sums in device memory in batch
// order; with more than one group, (3) adds the groups' planes in group
// order (no atomics). The wrapper picks as many groups as fill the card
// (Swin-tiny's stage 0 at B=64: 4096 windows, 3 heads), each plane
// heads.N^2 fp32, their scratch within the stored-P limit; with one group
// the sum has the stored-P backward's order. The score of (query n, key m)
// adds the bias, the window mask and the key mask in that order.
//
// The recompute backward's bf16 instantiation (the main path under
// autocast) runs on the tensor cores: ga_bwd_rows_mma_kernel and
// ga_bwd_cols_mma_kernel, 64-row tiles, four warps of 16 rows, every
// product an mma.sync.m16n8k16 (bf16 operands from ldmatrix, fp32
// accumulators in registers), K/V (rows) or Q/dO (cols) tiles and the
// (64 x 64) fp32 tiles of the bias, mask and pmult planes streaming two deep
// through shared memory by cp.async. mma.sync rather than wgmma: a warp's 16
// rows keep the score tile, P, dp and ds in the accumulator registers, where
// the softmax, the masks and the rounding happen, and the packed bf16 result
// is the next product's A operand without a trip through shared memory;
// wgmma's 64-row warpgroup tiles would put those epilogues across four warps.
// The rows kernel makes two passes over the key tiles, (a) an online max,
// sum and rowsum(dp * exp(s - max)) (rescaled as the max grows; rowsum(dp *
// P) is the last over the sum) and (b) P, dp and ds, 16 keys at a time, with
// dq += round(ds) . K; the cols kernel holds its warp's 16 keys of K and V in
// registers and, for each 16 query rows, transposes the rounded pb and ds
// blocks in registers (movmatrix) into the A operands of pb^T . dO and
// ds^T . Q. Score side and column side use one operand order (A = query
// rows, B = key rows) and one k-step order, and one fp32 epilogue, so their
// P agree exactly; exp is the special-function unit's 2^x of a fused
// s * log2(e) - max * log2(e). The fp32 instantiation (the card-vs-CPU and
// fp32 twin checks at 1e-4) keeps ga_bwd_rows_kernel and ga_bwd_cols_kernel,
// fp32 FMAs on the CUDA cores: TF32 tensor cores would not hold 1e-4.
//
// What bounds it: at BEiT-large (B=32, N=197, C=1024, 16 heads) the forward
// moves ~134 MB (P's 79.5 MB of them) against 5.1 GFLOP, the stored-P backward
// ~172 MB against 10.2 GFLOP: on the bf16 tensor cores both are bound by bytes
// (~40 and ~51 us). The recompute backward at BERT-base (B=32, N=512, C=768,
// 12 heads) moves ~176 MB against ~64 GFLOP (five products): bound by
// operations (~65 us); its bf16 kernels compute nine (the scores three
// times, dp three times), and the staged pmult plane is read from L2 three
// times a (batch, head). The bf16 stored-P backward computes six products
// (dp three times) where the bound counts four, reads P three times (its
// rows kernel's second pass mostly from L2) and re-reads K and V once a
// query tile from L2; its rows and columns of 64 leave a quarter of the
// blocks near-idle at N = 197. The forward's fp32 kernel computes every
// product as fp32 FMAs on the CUDA cores from shared-memory tiles (4x4 and
// 4x2 outputs a thread), with 32 whole fp32 score rows a block in shared
// memory and an expf and a division an element: FMAs and shared-memory
// traffic bound it, not its bytes. The bf16 kernel computes the scores twice
// on the tensor cores (four products where the bound counts two), so that P
// is normalised before it is rounded, as the Pallas kernel rounds it; keeps
// the score tile, P and o in registers; streams K, V and the fp32 planes by
// cp.async (the bias by 16-byte copies, from rows that the wrapper pads to a
// multiple of 4 floats where N is not one: 4-byte copies, 32 a thread a tile,
// would bound the call at BEiT's N = 197); and writes P a row at a time from
// shared memory, 32 consecutive keys a store, with streaming
// stores. Its instructions bound it more than P's bytes. PERF.md records how
// far each is from its bound.
// Limits: N <= 1024 (the CUDA-core kernels keep whole score rows in shared
// memory), hd <= 64.
//
// C interface: each entry point launches on the given stream and returns
// cudaGetLastError() as an int (0 = success);
// skinjax_global_attention_error_string maps the code to its message.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>
#include <type_traits>

#include "mma_bf16.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxN = 1024;
constexpr int kMaxHd = 64;
constexpr int kHs = kMaxHd + 1;  // row stride of a (rows, head dim) tile in shared memory
constexpr int kTq = 32;          // query rows a block: the forward and the dq kernel
constexpr int kKc = 128;         // keys a chunk of K or V in shared memory
constexpr int kTk = 32;          // keys a block of the dk/dv kernel
constexpr int kQc = 64;          // query rows a chunk of the dk/dv kernel
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
  int B, N, C, heads, hd;
  long long ld;        // row stride of q, k and v in elements
  const float* wmask;  // the window mask (n_win, N, N) fp32, or null
  int n_win;           // batch b adds plane b % n_win of it
  int vec;             // the bf16 tensor-core kernels may copy 16 bytes at a time
  int bias_ld;         // row stride of the bias (heads, N, bias_ld) in floats, >= N
};

__host__ __device__ __forceinline__ int round_up(int x, int m) { return (x + m - 1) / m * m; }

// The score of query n and key m of head hi of batch b from the fp32 product
// a = q.k^T: every launch that computes a score computes it here, so that the
// recompute backward reproduces the forward's scores bit for bit.
__device__ __forceinline__ float score(float a, float scale, const float* __restrict__ bias,
                                       const float* __restrict__ kmask, const Dims& g, int hi,
                                       int b, int n, int m) {
  a = __fmul_rn(a, scale);
  if (bias) a = __fadd_rn(a, bias[((long long)hi * g.N + n) * g.bias_ld + m]);
  if (g.wmask) a = __fadd_rn(a, g.wmask[((long long)(b % g.n_win) * g.N + n) * g.N + m]);
  if (kmask) a = __fadd_rn(a, kmask[(long long)b * g.N + m]);
  return a;
}

// dp of query n and key m from the fp32 product a = do.v^T
__device__ __forceinline__ float dprob(float a, const float* __restrict__ pmult, const Dims& g,
                                       int n, int m) {
  return pmult ? __fmul_rn(a, pmult[(long long)n * g.N + m]) : a;
}

// A score row (N values) through exp in place, a warp a row: row[m] =
// exp(row[m] - max). Returns (max, sum); P = row[m] / sum. The recompute
// backward's column launch computes expf(s - max) / sum from the same max
// and sum, the same operations.
__device__ __forceinline__ float2 exp_row(float* row, int N, int lane) {
  float mx = -CUDART_INF_F;
  for (int m = lane; m < N; m += 32) mx = fmaxf(mx, row[m]);
  mx = warp_max(mx);
  float sum = 0.f;
  for (int m = lane; m < N; m += 32) {
    const float e = expf(row[m] - mx);
    row[m] = e;
    sum += e;
  }
  return make_float2(mx, warp_sum(sum));
}

// shared memory of the forward and the dq kernel: kTq score rows, a (kTq, hd)
// tile and a (kKc, hd) chunk
int rows_smem_bytes(int N) { return 4 * (kTq * (round_up(N, kKc) + 1) + kTq * kHs + kKc * kHs); }
constexpr int dkv_smem_bytes() { return 4 * (2 * kQc * kTs + 2 * kQc * kHs); }
// the recompute backward's column kernel: K and V tiles (kTk, hd), Q and dO
// chunks (kQc, hd), the pb and ds planes (kQc, kTk) and three row statistics
constexpr int cols_smem_bytes() {
  return 4 * (2 * kTk * kHs + 2 * kQc * kHs + 2 * kQc * kTs + 3 * kQc);
}

// Rows n0 .. n0 + count - 1 of head hi of batch b of x (rows at a stride of ld)
// as fp32 into dst (count x kHs); zeros past N and past hd.
template <typename T>
__device__ void load_rows(const T* __restrict__ x, long long ld, const Dims& g, int b, int hi,
                          int n0, int count, float* dst) {
  for (int idx = threadIdx.x; idx < count * kMaxHd; idx += kThreads) {
    const int r = idx / kMaxHd, d = idx - r * kMaxHd;
    const int n = n0 + r;
    dst[r * kHs + d] =
        (n < g.N && d < g.hd) ? to_f32<T>(x[((long long)b * g.N + n) * ld + hi * g.hd + d]) : 0.f;
  }
}

// acc[i][j] = sum over d < hd of a[warp + 8i][d] * bm[lane + 32j][d]: the
// (kTq x kKc) tile of a . bm^T
__device__ __forceinline__ void tile_abt(const float* a, const float* bm, int hd,
                                         float acc[4][4]) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < hd; ++d) {
    float av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = a[(warp + 8 * i) * kHs + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = bm[(lane + 32 * j) * kHs + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// acc[i][j] += sum over m < mc of s[(warp + 8i) * ss + m0 + m] * x[m][lane + 32j]:
// kTq score rows times a (kKc, hd) chunk of V or K; with kRoundS each s entry
// is rounded to T first
template <typename T, bool kRoundS>
__device__ __forceinline__ void rows_times_chunk(const float* s, int ss, int m0, int mc,
                                                 const float* x, float acc[4][2]) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll 4
  for (int m = 0; m < mc; ++m) {
    float av[4], xv[2];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      av[i] = s[(warp + 8 * i) * ss + m0 + m];
      if (kRoundS) av[i] = round_to<T>(av[i]);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) xv[j] = x[m * kHs + lane + 32 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) acc[i][j] = fmaf(av[i], xv[j], acc[i][j]);
  }
}

// s[r][m] = rows . (chunk of x)^T for every real row and key, the product
// passed through f(r, m, value) first; x streamed kKc keys at a time
template <typename T, typename F>
__device__ void score_rows(const float* rows, const T* __restrict__ x, long long ld,
                           const Dims& g, int b, int hi, int n_rows, float* s, int ss,
                           float* chunk, F f) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int m0 = 0; m0 < g.N; m0 += kKc) {
    __syncthreads();  // rows loaded; the previous chunk consumed
    load_rows<T>(x, ld, g, b, hi, m0, kKc, chunk);
    __syncthreads();
    float acc[4][4];
    tile_abt(rows, chunk, g.hd, acc);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = warp + 8 * i;
      if (r >= n_rows) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int m = m0 + lane + 32 * j;
        if (m < g.N) s[r * ss + m] = f(r, m, acc[i][j]);
      }
    }
  }
  __syncthreads();
}

// out rows n0 + warp + 8i, channels lane + 32j of head hi: acc = s . x (with
// kRoundS, round(s) . x), x streamed kKc keys at a time, written as
// round(acc * mul)
template <typename T, bool kRoundS = false>
__device__ void rows_product_out(const float* s, int ss, const T* __restrict__ x, long long ld,
                                 const Dims& g, int b, int hi, int n0, int n_rows, float* chunk,
                                 float mul, T* __restrict__ out) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i][0] = acc[i][1] = 0.f;
  for (int m0 = 0; m0 < g.N; m0 += kKc) {
    __syncthreads();  // s complete; the previous chunk consumed
    load_rows<T>(x, ld, g, b, hi, m0, kKc, chunk);
    __syncthreads();
    rows_times_chunk<T, kRoundS>(s, ss, m0, min(kKc, g.N - m0), chunk, acc);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = warp + 8 * i;
    if (r >= n_rows) continue;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int d = lane + 32 * j;
      if (d < g.hd)
        out[((long long)b * g.N + n0 + r) * g.C + hi * g.hd + d] = from_f32<T>(acc[i][j] * mul);
    }
  }
}

// Forward: o for 32 query rows of one head of one batch; P when p is not null.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    ga_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  const float* __restrict__ bias, const float* __restrict__ kmask,
                  const float* __restrict__ pmult, T* __restrict__ o, float* __restrict__ p,
                  Dims g, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int N = g.N;
  const int ss = round_up(N, kKc) + 1;
  float* s = smem;
  float* qs = s + kTq * ss;
  float* chunk = qs + kTq * kHs;
  const int n0 = blockIdx.x * kTq, hi = blockIdx.y, b = blockIdx.z;
  const int n_rows = min(kTq, N - n0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  load_rows<T>(q, g.ld, g, b, hi, n0, kTq, qs);
  score_rows<T>(qs, k, g.ld, g, b, hi, n_rows, s, ss, chunk, [&](int r, int m, float a) {
    return score(a, scale, bias, kmask, g, hi, b, n0 + r, m);
  });

  // softmax, a warp a row; P written before pmult, then round(P * pmult) kept
  for (int r = warp; r < n_rows; r += kWarps) {
    float* row = s + r * ss;
    const long long n = n0 + r;
    const float sum = exp_row(row, N, lane).y;
    float* prow = p ? p + (((long long)b * g.heads + hi) * N + n) * N : nullptr;
    const float* mrow = pmult ? pmult + n * N : nullptr;
    for (int m = lane; m < N; m += 32) {
      float pv = row[m] / sum;
      if (prow) prow[m] = pv;
      if (mrow) pv = __fmul_rn(pv, mrow[m]);
      row[m] = round_to<T>(pv);
    }
  }
  rows_product_out<T>(s, ss, v, g.ld, g, b, hi, n0, n_rows, chunk, 1.f, o);
}

// Backward (1): dp, ds (to the scratch) and dq for 32 query rows of one head
// of one batch.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    ga_bwd_dq_kernel(const T* __restrict__ k, const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ p, const float* __restrict__ pmult,
                     T* __restrict__ dq, float* __restrict__ ds, Dims g, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int N = g.N;
  const int ss = round_up(N, kKc) + 1;
  float* s = smem;
  float* dos = s + kTq * ss;
  float* chunk = dos + kTq * kHs;
  const int n0 = blockIdx.x * kTq, hi = blockIdx.y, b = blockIdx.z;
  const int n_rows = min(kTq, N - n0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  load_rows<T>(dout, g.C, g, b, hi, n0, kTq, dos);
  score_rows<T>(dos, v, g.ld, g, b, hi, n_rows, s, ss, chunk, [&](int r, int m, float a) {
    return dprob(a, pmult, g, n0 + r, m);
  });

  // ds = P * (dp - rowsum(dp * P)), a warp a row; round(ds) kept for dq
  for (int r = warp; r < n_rows; r += kWarps) {
    float* row = s + r * ss;
    const long long at = (((long long)b * g.heads + hi) * N + n0 + r) * N;
    const float* prow = p + at;
    float rs = 0.f;
    for (int m = lane; m < N; m += 32) rs += __fmul_rn(row[m], prow[m]);
    rs = warp_sum(rs);
    for (int m = lane; m < N; m += 32) {
      const float d = __fmul_rn(prow[m], row[m] - rs);
      ds[at + m] = d;
      row[m] = round_to<T>(d);
    }
  }
  rows_product_out<T>(s, ss, k, g.ld, g, b, hi, n0, n_rows, chunk, scale, dq);
}

// Backward (2): dv = round(P * pmult)^T . do and dk = round(ds)^T . q * scale
// for 32 keys of one head of one batch, summed over every query.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    ga_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ dout,
                      const float* __restrict__ p, const float* __restrict__ pmult,
                      const float* __restrict__ ds, T* __restrict__ dk, T* __restrict__ dv,
                      Dims g, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* pb = smem;               // kQc x kTs
  float* dsb = pb + kQc * kTs;    // kQc x kTs
  float* dos = dsb + kQc * kTs;   // kQc x kHs
  float* qs = dos + kQc * kHs;    // kQc x kHs
  const int N = g.N;
  const int m0 = blockIdx.x * kTk, hi = blockIdx.y, b = blockIdx.z;
  const long long plane = ((long long)b * g.heads + hi) * N;  // first row of (b, hi) in p and ds
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float adv[4][2], adk[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i) adv[i][0] = adv[i][1] = adk[i][0] = adk[i][1] = 0.f;

  for (int n0 = 0; n0 < N; n0 += kQc) {
    __syncthreads();  // the previous chunk consumed
    for (int idx = threadIdx.x; idx < kQc * kTk; idx += kThreads) {
      const int r = idx / kTk, c = idx - r * kTk;
      const int n = n0 + r, m = m0 + c;
      float a = 0.f, d = 0.f;
      if (n < N && m < N) {
        const long long at = (plane + n) * N + m;
        a = p[at];
        if (pmult) a = __fmul_rn(a, pmult[(long long)n * N + m]);
        a = round_to<T>(a);
        d = round_to<T>(ds[at]);
      }
      pb[r * kTs + c] = a;
      dsb[r * kTs + c] = d;
    }
    load_rows<T>(dout, g.C, g, b, hi, n0, kQc, dos);
    load_rows<T>(q, g.ld, g, b, hi, n0, kQc, qs);
    __syncthreads();
    const int nc = min(kQc, N - n0);
#pragma unroll 4
    for (int r = 0; r < nc; ++r) {
      float pv[4], sv[4], dv_[2], qv[2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = pb[r * kTs + warp + 8 * i];
        sv[i] = dsb[r * kTs + warp + 8 * i];
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        dv_[j] = dos[r * kHs + lane + 32 * j];
        qv[j] = qs[r * kHs + lane + 32 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          adv[i][j] = fmaf(pv[i], dv_[j], adv[i][j]);
          adk[i][j] = fmaf(sv[i], qv[j], adk[i][j]);
        }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + warp + 8 * i;
    if (m >= N) continue;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int d = lane + 32 * j;
      if (d >= g.hd) continue;
      const long long at = ((long long)b * N + m) * g.C + hi * g.hd + d;
      dv[at] = from_f32<T>(adv[i][j]);
      dk[at] = from_f32<T>(adk[i][j] * scale);
    }
  }
}

// Backward (3): dbias[i] = sum over the batch of ds[b][i], in batch order.
__global__ void ga_dbias_reduce_kernel(const float* __restrict__ ds, float* __restrict__ out,
                                    int batch, long long count) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  float a = 0.f;
  for (int b = 0; b < batch; ++b) a += ds[(long long)b * count + i];
  out[i] = a;
}

// Recompute backward (1): for 32 query rows of one head of one batch, the
// scores and the softmax as the forward computes them, each row's max and
// sum (stats[0], stats[1]), of = round(round(P) . v) when of is not null (no
// pmult), rowsum(dp * P) (stats[2]), ds, and dq. stats is (3, B, heads, N)
// fp32.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    ga_bwd_rows_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                       const T* __restrict__ dout, const float* __restrict__ bias,
                       const float* __restrict__ kmask, const float* __restrict__ pmult,
                       T* __restrict__ dq, T* __restrict__ of, float* __restrict__ stats, Dims g,
                       float scale) {
  extern __shared__ __align__(16) float smem[];
  const int N = g.N;
  const int ss = round_up(N, kKc) + 1;
  float* s = smem;
  float* tile = s + kTq * ss;  // q rows, then do rows
  float* chunk = tile + kTq * kHs;
  const int n0 = blockIdx.x * kTq, hi = blockIdx.y, b = blockIdx.z;
  const int n_rows = min(kTq, N - n0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long plane = (long long)g.B * g.heads * N;  // one statistic
  const long long row0 = ((long long)b * g.heads + hi) * N + n0;

  load_rows<T>(q, g.ld, g, b, hi, n0, kTq, tile);
  score_rows<T>(tile, k, g.ld, g, b, hi, n_rows, s, ss, chunk, [&](int r, int m, float a) {
    return score(a, scale, bias, kmask, g, hi, b, n0 + r, m);
  });
  for (int r = warp; r < n_rows; r += kWarps) {  // P in place of the scores
    float* row = s + r * ss;
    const float2 ms = exp_row(row, N, lane);
    for (int m = lane; m < N; m += 32) row[m] = row[m] / ms.y;
    if (lane == 0) {
      stats[row0 + r] = ms.x;
      stats[plane + row0 + r] = ms.y;
    }
  }
  if (of) rows_product_out<T, true>(s, ss, v, g.ld, g, b, hi, n0, n_rows, chunk, 1.f, of);
  __syncthreads();  // the q tile consumed
  load_rows<T>(dout, g.C, g, b, hi, n0, kTq, tile);

  // pass 1: rsum = rowsum(dp * P), dp streamed kKc keys at a time; each warp
  // owns rows warp + 8i
  float part[4] = {0.f, 0.f, 0.f, 0.f};
  for (int m0 = 0; m0 < N; m0 += kKc) {
    __syncthreads();
    load_rows<T>(v, g.ld, g, b, hi, m0, kKc, chunk);
    __syncthreads();
    float acc[4][4];
    tile_abt(tile, chunk, g.hd, acc);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = warp + 8 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int m = m0 + lane + 32 * j;
        if (r < n_rows && m < N)
          part[i] += __fmul_rn(dprob(acc[i][j], pmult, g, n0 + r, m), s[r * ss + m]);
      }
    }
  }
  float rsum[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    rsum[i] = warp_sum(part[i]);
    if (lane == 0 && warp + 8 * i < n_rows) stats[2 * plane + row0 + warp + 8 * i] = rsum[i];
  }

  // pass 2: ds = P * (dp - rsum), rounded, in place of P
  for (int m0 = 0; m0 < N; m0 += kKc) {
    __syncthreads();
    load_rows<T>(v, g.ld, g, b, hi, m0, kKc, chunk);
    __syncthreads();
    float acc[4][4];
    tile_abt(tile, chunk, g.hd, acc);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = warp + 8 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int m = m0 + lane + 32 * j;
        if (r < n_rows && m < N) {
          float* at = s + r * ss + m;
          const float dp = dprob(acc[i][j], pmult, g, n0 + r, m);
          *at = round_to<T>(__fmul_rn(*at, __fsub_rn(dp, rsum[i])));
        }
      }
    }
  }
  rows_product_out<T>(s, ss, k, g.ld, g, b, hi, n0, n_rows, chunk, scale, dq);
}

// Recompute backward (2): dv = round(P * pmult)^T . do and dk = round(ds)^T .
// q * scale for 32 keys of one head, summed over every query, for b_count
// batches from blockIdx.z * b_count in order (the last group may be shorter).
// P and ds are recomputed from the statistics of (1): the score and dp of (n,
// m) as sums over the head's channels in channel order, the order of
// tile_abt, so they equal (1)'s and the forward's. With dbias, plane
// blockIdx.z of dbias (groups, heads, N, N) gets [hi][n][m] = the sum of ds
// over the group's batches in order (the block owns its key columns).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    ga_bwd_cols_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                       const T* __restrict__ dout, const float* __restrict__ bias,
                       const float* __restrict__ kmask, const float* __restrict__ pmult,
                       const float* __restrict__ stats, T* __restrict__ dk, T* __restrict__ dv,
                       float* __restrict__ dbias, Dims g, float scale, int b_count) {
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;                 // kTk x kHs
  float* vs = ks + kTk * kHs;       // kTk x kHs
  float* qs = vs + kTk * kHs;       // kQc x kHs
  float* dos = qs + kQc * kHs;      // kQc x kHs
  float* pb = dos + kQc * kHs;      // kQc x kTs
  float* dsb = pb + kQc * kTs;      // kQc x kTs
  float* st = dsb + kQc * kTs;      // 3 x kQc: max, sum, rowsum(dp * P)
  const int N = g.N;
  const int m0 = blockIdx.x * kTk, hi = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long plane = (long long)g.B * g.heads * N;
  const int m = m0 + lane;  // the key of this thread's P and ds entries
  const int b0 = blockIdx.z * b_count, b1 = min(g.B, b0 + b_count);
  if (dbias) dbias += (long long)blockIdx.z * g.heads * N * N;

  for (int b = b0; b < b1; ++b) {
    __syncthreads();  // the previous batch's tiles consumed
    load_rows<T>(k, g.ld, g, b, hi, m0, kTk, ks);
    load_rows<T>(v, g.ld, g, b, hi, m0, kTk, vs);
    float adv[4][2], adk[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) adv[i][0] = adv[i][1] = adk[i][0] = adk[i][1] = 0.f;

    for (int n0 = 0; n0 < N; n0 += kQc) {
      __syncthreads();  // the previous chunk consumed
      load_rows<T>(q, g.ld, g, b, hi, n0, kQc, qs);
      load_rows<T>(dout, g.C, g, b, hi, n0, kQc, dos);
      for (int idx = threadIdx.x; idx < 3 * kQc; idx += kThreads) {
        const int which = idx / kQc, r = idx - which * kQc;
        st[idx] = n0 + r < N
                      ? stats[which * plane + ((long long)b * g.heads + hi) * N + n0 + r]
                      : 0.f;
      }
      __syncthreads();
      // the (kQc, kTk) planes: this thread's key m, rows warp + 8i
#pragma unroll 2
      for (int i = 0; i < kQc / kWarps; ++i) {
        const int r = warp + kWarps * i, n = n0 + r;
        float a = 0.f, d = 0.f;
        if (n < N && m < N) {
          float sv = 0.f, dp = 0.f;
          for (int c = 0; c < g.hd; ++c) {
            sv = fmaf(qs[r * kHs + c], ks[lane * kHs + c], sv);
            dp = fmaf(dos[r * kHs + c], vs[lane * kHs + c], dp);
          }
          const float p = expf(score(sv, scale, bias, kmask, g, hi, b, n, m) - st[r]) /
                          st[kQc + r];
          const float ds = __fmul_rn(p, __fsub_rn(dprob(dp, pmult, g, n, m), st[2 * kQc + r]));
          if (dbias) {
            float* at = dbias + ((long long)hi * N + n) * N + m;
            *at = (b == b0 ? 0.f : *at) + ds;
          }
          a = round_to<T>(pmult ? __fmul_rn(p, pmult[(long long)n * N + m]) : p);
          d = round_to<T>(ds);
        }
        pb[r * kTs + lane] = a;
        dsb[r * kTs + lane] = d;
      }
      __syncthreads();
      const int nc = min(kQc, N - n0);
#pragma unroll 4
      for (int r = 0; r < nc; ++r) {
        float pv[4], sv[4], dv_[2], qv[2];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pv[i] = pb[r * kTs + warp + 8 * i];
          sv[i] = dsb[r * kTs + warp + 8 * i];
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          dv_[j] = dos[r * kHs + lane + 32 * j];
          qv[j] = qs[r * kHs + lane + 32 * j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            adv[i][j] = fmaf(pv[i], dv_[j], adv[i][j]);
            adk[i][j] = fmaf(sv[i], qv[j], adk[i][j]);
          }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int mm = m0 + warp + 8 * i;
      if (mm >= N) continue;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int d = lane + 32 * j;
        if (d >= g.hd) continue;
        const long long at = ((long long)b * N + mm) * g.C + hi * g.hd + d;
        dv[at] = from_f32<T>(adv[i][j]);
        dk[at] = from_f32<T>(adk[i][j] * scale);
      }
    }
  }
}

// ---- The recompute backward's bf16 instantiation on the tensor cores ----
//
// Every product runs as mma.sync.m16n8k16 (bf16 operands, fp32 accumulators
// in registers; mma_bf16.cuh). A block is four warps. Tiles of 64 rows of K
// and V (rows kernel) or of Q and dO (cols kernel) stream two deep through
// shared memory with cp.async, and with them the (64 x 64) fp32 tiles of the
// bias, window mask and pmult planes, the 64 keys' kmask and (cols kernel)
// the 64 rows' statistics, so no score-side operand is read from device
// memory inside the products' loop. Both kernels compute a (16 query x 16
// key) block of scores as warp_abt_chunk(A = Q rows, B = K rows) and of dp as
// warp_abt_chunk(A = dO rows, B = V rows), 16-column steps in ascending
// order, with query and key tiles on the same 64-grid, and finish them with
// the same fp32 code (scores_chunk, dprob_chunk, prob): a (query, key) pair
// gets the same bits in both, so the cols kernel's P and ds are the rows
// kernel's.

// Where each staged operand of a tile step sits in a stage of shared memory
// (fp32 offsets; -1 where absent)
struct Stage {
  int bias, mask, pmult, kmask, stats, floats;
};

__host__ __device__ inline Stage stage_layout(bool bias, bool mask, bool pmult, bool kmask,
                                              bool stats) {
  Stage s;
  int o = 0;
  s.bias = bias ? o : -1;
  o += bias ? kPlaneFloats : 0;
  s.mask = mask ? o : -1;
  o += mask ? kPlaneFloats : 0;
  s.pmult = pmult ? o : -1;
  o += pmult ? kPlaneFloats : 0;
  s.kmask = kmask ? o : -1;
  o += kmask ? kTile : 0;
  s.stats = stats ? o : -1;
  o += stats ? 3 * kTile : 0;
  s.floats = o;
  return s;
}

// A stage's planes for query rows r0.. and keys c0.. of head hi of batch b
__device__ __forceinline__ void load_stage(float* st, const Stage& ly, const float* bias,
                                           const float* kmask, const float* pmult, const Dims& g,
                                           int hi, int b, int r0, int c0) {
  const long long nn = (long long)g.N * g.N;
  if (ly.bias >= 0)
    load_plane(st + ly.bias, bias + hi * g.N * (long long)g.bias_ld, g.N, g.N, r0, c0, g.bias_ld);
  if (ly.mask >= 0) load_plane(st + ly.mask, g.wmask + (b % g.n_win) * nn, g.N, g.N, r0, c0);
  if (ly.pmult >= 0) load_plane(st + ly.pmult, pmult, g.N, g.N, r0, c0);
  if (ly.kmask >= 0) load_vec64(st + ly.kmask, kmask + (long long)b * g.N + c0, g.N - c0);
}

// x[j][e] op= the staged plane p at (local row rl + 8 (e / 2), local column
// cl0 + 8 j + 2 t + e % 2), pairs read as float2
template <bool kMul>
__device__ __forceinline__ void plane_chunk(float (&x)[2][4], const float* p, int rl, int cl0) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float2 v = *reinterpret_cast<const float2*>(p + (rl + 8 * h) * kPlaneLd + cl0 +
                                                        8 * j + 2 * t);
      x[j][2 * h] = kMul ? __fmul_rn(x[j][2 * h], v.x) : __fadd_rn(x[j][2 * h], v.x);
      x[j][2 * h + 1] = kMul ? __fmul_rn(x[j][2 * h + 1], v.y) : __fadd_rn(x[j][2 * h + 1], v.y);
    }
}

// The scores of a (16 x 16) block in place from its fp32 products, as score()
// computes them: the scale, then the bias, the window mask and the key mask;
// -inf for keys at or past local column kend (N - the tile's first key)
__device__ __forceinline__ void scores_chunk(float (&s)[2][4], float scale, const float* st,
                                             const Stage& ly, int rl, int cl0, int kend) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = __fmul_rn(s[j][e], scale);
  if (ly.bias >= 0) plane_chunk<false>(s, st + ly.bias, rl, cl0);
  if (ly.mask >= 0) plane_chunk<false>(s, st + ly.mask, rl, cl0);
  if (ly.kmask >= 0) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float2 v = *reinterpret_cast<const float2*>(st + ly.kmask + cl0 + 8 * j + 2 * t);
      s[j][0] = __fadd_rn(s[j][0], v.x);
      s[j][1] = __fadd_rn(s[j][1], v.y);
      s[j][2] = __fadd_rn(s[j][2], v.x);
      s[j][3] = __fadd_rn(s[j][3], v.y);
    }
  }
  if (kend < cl0 + 16) {
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (cl0 + 8 * j + 2 * t + (e & 1) >= kend) s[j][e] = -CUDART_INF_F;
  }
}

// dp of a (16 x 16) block in place from its fp32 products (past N the dO or
// V rows are zeros, and so is the staged pmult)
__device__ __forceinline__ void dprob_chunk(float (&d)[2][4], const float* st, const Stage& ly,
                                            int rl, int cl0) {
  if (ly.pmult >= 0) plane_chunk<true>(d, st + ly.pmult, rl, cl0);
}

// shared memory of the bf16 kernels: K and V (rows kernel) or Q and dO (cols
// kernel), two buffers each, and two stages of staged planes
template <int kD>
int rows_mma_smem_bytes(const Stage& ly) {
  return 4 * tile_bytes<kD>() + 2 * 4 * ly.floats;
}

template <int kD>
int cols_mma_smem_bytes(const Stage& ly) {
  return 4 * tile_bytes<kD>() + 2 * 4 * ly.floats;
}

// Recompute backward (1), bf16: for 64 query rows of one head of one batch
// (a warp 16 of them), two passes over the key tiles. (a) The scores and dp,
// and a row's running max m, sum l of exp(s - m) and sum r of
// dp * exp(s - m), each rescaled by exp(m_old - m) when the max grows; then
// stats = (m, l, r / l), the last being rowsum(dp * P). (b) P, dp,
// ds = P (dp - rowsum) rounded to bf16 in registers as the A operand of
// dq += ds . K (and with kOf, of += round(P) . V), 16 keys at a time;
// dq = round(dq * scale).
template <int kD, bool kOf>
__global__ void __launch_bounds__(kTileThreads, 3)
    ga_bwd_rows_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                           const bf16* __restrict__ v, const bf16* __restrict__ dout,
                           const float* __restrict__ bias, const float* __restrict__ kmask,
                           const float* __restrict__ pmult, bf16* __restrict__ dq,
                           bf16* __restrict__ of, float* __restrict__ stats, Dims g, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int L = tile_ld<kD>(), kT = kTile * L;
  bf16* const ks = reinterpret_cast<bf16*>(smem_raw);  // K, buffers 0 and 1
  bf16* const vs = ks + 2 * kT;                         // V, buffers 0 and 1
  float* const pl = reinterpret_cast<float*>(vs + 2 * kT);  // staged planes, stages 0 and 1
  const Stage ly = stage_layout(bias, g.wmask, pmult, kmask, false);
  const int N = g.N;
  const int n0 = blockIdx.x * kTile, hi = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gq = lane >> 2, t = lane & 3;
  const int rl = 16 * warp + gq;  // this thread's rows of the tile: rl, rl + 8
  const long long head = (long long)b * N * g.ld + hi * g.hd;
  const bf16 *kh = k + head, *vh = v + head;
  const int nt = (N + kTile - 1) / kTile;

  // this warp's q and do rows as A fragments, for the whole block
  unsigned qf[kD / 16][4], df[kD / 16][4];
  load_tile<kD>(ks, q + head, g.ld, n0, N, g.hd, g.vec);
  load_tile<kD>(vs, dout + (long long)b * N * g.C + hi * g.hd, g.C, n0, N, g.hd, g.vec);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  load_a<kD>(qf, ks + 16 * warp * L);
  load_a<kD>(df, vs + 16 * warp * L);
  __syncthreads();

  auto load = [&](int kt, int buf) {
    load_tile<kD>(ks + buf * kT, kh, g.ld, kt * kTile, N, g.hd, g.vec);
    load_tile<kD>(vs + buf * kT, vh, g.ld, kt * kTile, N, g.hd, g.vec);
    load_stage(pl + buf * ly.floats, ly, bias, kmask, pmult, g, hi, b, n0, kt * kTile);
  };

  // (a) online max, sum and rowsum(dp * exp(s - max)), 32 keys at a time
  float mx[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f}, rs[2] = {0.f, 0.f};
  pipeline(nt, load, [&](int kt, int buf) {
    const float* st = pl + buf * ly.floats;
    const int kend = N - kt * kTile;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float s[2][2][4], d[2][2][4];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        warp_abt_chunk<kD>(s[u], qf, ks + buf * kT, 2 * half + u);
        warp_abt_chunk<kD>(d[u], df, vs + buf * kT, 2 * half + u);
      }
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        scores_chunk(s[u], scale, st, ly, rl, 16 * (2 * half + u), kend);
        dprob_chunk(d[u], st, ly, rl, 16 * (2 * half + u));
      }
      float sc[2], sd[2] = {0.f, 0.f};
      online_softmax(s, mx, l, sc, [&](int h, int u, int j, int c, float e) {
        sd[h] += __fmul_rn(d[u][j][2 * h + c], e);
      });
#pragma unroll
      for (int h = 0; h < 2; ++h) rs[h] = rs[h] * sc[h] + sd[h];
    }
  });
  const long long plane = (long long)g.B * g.heads * N;  // one statistic
  const long long row0 = ((long long)b * g.heads + hi) * N + n0;
  float inv[2], mxl[2];
  softmax_finish(mx, l, inv, mxl);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    rs[h] = __fmul_rn(quad_sum(rs[h]), inv[h]);
    if (t == 0 && n0 + rl + 8 * h < N) {
      stats[row0 + rl + 8 * h] = mx[h];
      stats[plane + row0 + rl + 8 * h] = l[h];
      stats[2 * plane + row0 + rl + 8 * h] = rs[h];
    }
  }

  // (b) ds and dq (and of), 16 keys at a time
  float dqa[kD / 8][4], oacc[kOf ? kD / 8 : 1][4];
  zero_acc<kD>(dqa);
  if constexpr (kOf) zero_acc<kD>(oacc);
  pipeline(nt, load, [&](int kt, int buf) {
    const float* st = pl + buf * ly.floats;
    const bf16 *kb = ks + buf * kT, *vb = vs + buf * kT;
    const int kend = N - kt * kTile;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      float s[2][4], d[2][4];
      warp_abt_chunk<kD>(s, qf, kb, kk);
      warp_abt_chunk<kD>(d, df, vb, kk);
      scores_chunk(s, scale, st, ly, rl, 16 * kk, kend);
      dprob_chunk(d, st, ly, rl, 16 * kk);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = prob(s[j][e], mxl[e >> 1], inv[e >> 1]);
          d[j][e] = __fmul_rn(s[j][e], __fsub_rn(d[j][e], rs[e >> 1]));
        }
      unsigned a[4];
      if constexpr (kOf) {
        pack_a_chunk(a, s);
        warp_ax_chunk<kD>(oacc, a, vb, kk);
      }
      pack_a_chunk(a, d);
      warp_ax_chunk<kD>(dqa, a, kb, kk);
    }
  });
  const long long out0 = (long long)b * N * g.C + hi * g.hd;
  if constexpr (kOf) store_frag_rows<kD>(of + out0, g.C, oacc, n0 + rl, N, g.hd, 1.f, g.vec);
  store_frag_rows<kD>(dq + out0, g.C, dqa, n0 + rl, N, g.hd, scale, g.vec);
}

// Forward, bf16, on the tensor cores: o for 64 query rows of one head of one
// batch (a warp 16 of them), and P when p is not null. This warp's Q rows sit
// in registers as A fragments; K (and, in (b), V) tiles of 64 keys and the
// staged bias and kmask (and, in (b), pmult) tiles stream two deep by
// cp.async, a pipeline for each of the two passes. (a) The scores and a
// row's online max m and sum l of exp(s - m), in the recompute rows kernel's
// steps (32 keys a step) and its online_softmax and softmax_finish, so m and
// l are its bits for the same inputs; (b) the scores again, P = prob(s)
// before pmult, then round(P * pmult) packed in registers as the A operand
// of o += . V, 16 keys at a time; o = round(o). A warp stages its 16 rows of a tile's P in shared
// memory (over its rows of the staged bias tile, which it has read by then,
// or in a plane of their own) and writes them a row at a time, 32
// consecutive keys a store, with streaming stores.
template <int kD>
__global__ void __launch_bounds__(kTileThreads, 4)
    ga_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const float* __restrict__ bias,
                      const float* __restrict__ kmask, const float* __restrict__ pmult,
                      bf16* __restrict__ o, float* __restrict__ p, Dims g, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int L = tile_ld<kD>(), kT = kTile * L;
  bf16* const ks = reinterpret_cast<bf16*>(smem_raw);  // K, buffers 0 and 1
  bf16* const vs = ks + 2 * kT;                         // V, buffers 0 and 1
  float* const pl = reinterpret_cast<float*>(vs + 2 * kT);  // staged planes, stages 0 and 1
  const Stage ly = stage_layout(bias, false, pmult, kmask, false);
  Stage la = ly;  // pass (a) stages no pmult
  la.pmult = -1;
  const int N = g.N;
  const int n0 = blockIdx.x * kTile, hi = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gq = lane >> 2, t = lane & 3;
  const int rl = 16 * warp + gq;  // this thread's rows of the tile: rl, rl + 8
  const long long head = (long long)b * N * g.ld + hi * g.hd;
  const bf16 *kh = k + head, *vh = v + head;
  const int nt = (N + kTile - 1) / kTile;
  float* const ph = p ? p + ((long long)b * g.heads + hi) * N * N : nullptr;

  unsigned qf[kD / 16][4];  // this warp's q rows as A fragments, for the whole block
  load_tile<kD>(ks, q + head, g.ld, n0, N, g.hd, g.vec);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  load_a<kD>(qf, ks + 16 * warp * L);
  __syncthreads();

  float mx[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f}, inv[2], mxl[2];
  float oacc[kD / 8][4];
  zero_acc<kD>(oacc);
  auto load_a_step = [&](int kt, int buf) {
    load_tile<kD>(ks + buf * kT, kh, g.ld, kt * kTile, N, g.hd, g.vec);
    load_stage(pl + buf * ly.floats, la, bias, kmask, pmult, g, hi, b, n0, kt * kTile);
  };
  auto load_b_step = [&](int kt, int buf) {
    load_tile<kD>(ks + buf * kT, kh, g.ld, kt * kTile, N, g.hd, g.vec);
    load_tile<kD>(vs + buf * kT, vh, g.ld, kt * kTile, N, g.hd, g.vec);
    load_stage(pl + buf * ly.floats, ly, bias, kmask, pmult, g, hi, b, n0, kt * kTile);
  };
  // (a) online max and sum, 32 keys at a time
  auto pass_a = [&](int kt, int buf) {
    const float* st = pl + buf * ly.floats;
    const int kend = N - kt * kTile;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float sc2[2][2][4];
#pragma unroll
      for (int u = 0; u < 2; ++u) warp_abt_chunk<kD>(sc2[u], qf, ks + buf * kT, 2 * half + u);
#pragma unroll
      for (int u = 0; u < 2; ++u)
        scores_chunk(sc2[u], scale, st, ly, rl, 16 * (2 * half + u), kend);
      online_softmax(sc2, mx, l);
    }
  };
  // (b) P, and o += round(P * pmult) . V, 16 keys at a time
  auto pass_b = [&](int kt, int buf) {
    float* const st = pl + buf * ly.floats;
    const int m0 = kt * kTile, kend = N - m0;
    float* const pst = ly.bias >= 0 ? st + ly.bias : pl + 2 * ly.floats;  // P's staging rows
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      float sc[2][4];
      warp_abt_chunk<kD>(sc, qf, ks + buf * kT, kk);
      scores_chunk(sc, scale, st, ly, rl, 16 * kk, kend);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] = prob(sc[j][e], mxl[e >> 1], inv[e >> 1]);
      if (ph) {
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            *reinterpret_cast<float2*>(pst + (rl + 8 * h) * kPlaneLd + 16 * kk + 8 * j + 2 * t) =
                make_float2(sc[j][2 * h], sc[j][2 * h + 1]);
      }
      if (ly.pmult >= 0) plane_chunk<true>(sc, st + ly.pmult, rl, 16 * kk);
      unsigned a[4];
      pack_a_chunk(a, sc);
      warp_ax_chunk<kD>(oacc, a, vs + buf * kT, kk);
    }
    if (ph) {  // this warp's 16 rows of the tile's P, a row at a time
      __syncwarp();
      const int rows = min(16, N - n0 - 16 * warp);
      for (int r = 0; r < rows; ++r) {
        float* prow = ph + (long long)(n0 + 16 * warp + r) * N + m0;
        const float* srow = pst + (16 * warp + r) * kPlaneLd;
        if (lane < kend) __stcs(prow + lane, srow[lane]);
        if (lane + 32 < kend) __stcs(prow + lane + 32, srow[lane + 32]);
      }
    }
  };
  pipeline(nt, load_a_step, pass_a);
  softmax_finish(mx, l, inv, mxl);
  pipeline(nt, load_b_step, pass_b);
  store_frag_rows<kD>(o + (long long)b * N * g.C + hi * g.hd, g.C, oacc, n0 + rl, N, g.hd, 1.f,
                      g.vec);
}

// shared memory of ga_fwd_mma_kernel: K and V, two buffers each, two stages
// of staged planes and, when P is written without a staged bias tile to
// stage it in, a plane for it
template <int kD>
int fwd_mma_smem_bytes(const Stage& ly, bool p) {
  return 4 * tile_bytes<kD>() + 2 * 4 * ly.floats + (p && ly.bias < 0 ? 4 * kPlaneFloats : 0);
}

// Recompute backward (2), bf16: dv = round(P * pmult)^T . do and dk =
// round(ds)^T . q * scale for 64 keys of one head (a warp 16 of them),
// summed over every query tile, for b_count batches from blockIdx.z *
// b_count in order. A warp holds its 16 keys of K and V as B fragments in
// registers for the batch. For each 16 query rows of a tile, it recomputes
// the scores and dp of those rows against its keys, forms P and ds in
// registers from the rows kernel's statistics (and the dbias plane's
// entries, as ga_bwd_cols_kernel does), and transposes the rounded pb and ds
// blocks in registers (movmatrix) into the A operands of dv += pb^T . dO and
// dk += ds^T . Q. The warps share the streamed tiles and nothing else.
template <int kD>
__global__ void __launch_bounds__(kTileThreads, 3)
    ga_bwd_cols_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                           const bf16* __restrict__ v, const bf16* __restrict__ dout,
                           const float* __restrict__ bias, const float* __restrict__ kmask,
                           const float* __restrict__ pmult, const float* __restrict__ stats,
                           bf16* __restrict__ dk, bf16* __restrict__ dv,
                           float* __restrict__ dbias, Dims g, float scale, int b_count) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int L = tile_ld<kD>(), kT = kTile * L;
  bf16* const qs = reinterpret_cast<bf16*>(smem_raw);  // Q, buffers 0 and 1
  bf16* const dos = qs + 2 * kT;                        // dO, buffers 0 and 1
  float* const pl = reinterpret_cast<float*>(dos + 2 * kT);  // staged, stages 0 and 1
  const Stage ly = stage_layout(bias, g.wmask, pmult, kmask, true);
  const int N = g.N;
  const int m0 = blockIdx.x * kTile, hi = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gq = lane >> 2, t = lane & 3;
  const int cl0 = 16 * warp;  // this warp's keys in the block: m0 + cl0 ..
  const int kend = N - m0;
  const long long plane = (long long)g.B * g.heads * N;
  const int b0 = blockIdx.z * b_count, b1 = min(g.B, b0 + b_count);
  const int nt = (N + kTile - 1) / kTile;
  if (dbias) dbias += (long long)blockIdx.z * g.heads * N * N;

  for (int b = b0; b < b1; ++b) {
    const long long head = (long long)b * N * g.ld + hi * g.hd;
    const long long dhead = (long long)b * N * g.C + hi * g.hd;
    const long long row0 = ((long long)b * g.heads + hi) * N;
    float dva[kD / 8][4], dka[kD / 8][4];
    unsigned kf[kD / 16][4], vf[kD / 16][4];
    zero_acc<kD>(dva);
    zero_acc<kD>(dka);
    load_b_global<kD>(kf, k + head, g.ld, m0 + cl0, N, g.hd, g.vec);
    load_b_global<kD>(vf, v + head, g.ld, m0 + cl0, N, g.hd, g.vec);
    pipeline(
        nt,
        [&](int it, int buf) {
          load_tile<kD>(qs + buf * kT, q + head, g.ld, it * kTile, N, g.hd, g.vec);
          load_tile<kD>(dos + buf * kT, dout + dhead, g.C, it * kTile, N, g.hd, g.vec);
          float* st = pl + buf * ly.floats;
          load_stage(st, ly, bias, kmask, pmult, g, hi, b, it * kTile, m0);
          for (int w = 0; w < 3; ++w)
            load_vec64(st + ly.stats + w * kTile, stats + w * plane + row0 + it * kTile,
                       N - it * kTile);
        },
        [&](int it, int buf) {
          const float* st = pl + buf * ly.floats;
          const bf16 *qb = qs + buf * kT, *db = dos + buf * kT;
          const int n0 = it * kTile;
#pragma unroll
          for (int mq = 0; mq < 4; ++mq) {
            const int rl = 16 * mq + gq;  // this thread's rows of the tile: rl, rl + 8
            float mxl[2], inv[2], rs[2];
            bool row_ok[2];
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              row_ok[h] = n0 + rl + 8 * h < N;
              mxl[h] = st[ly.stats + rl + 8 * h] * kLog2e;
              inv[h] = 1.f / (row_ok[h] ? st[ly.stats + kTile + rl + 8 * h] : 1.f);
              rs[h] = st[ly.stats + 2 * kTile + rl + 8 * h];
            }
            unsigned qa[kD / 16][4], da[kD / 16][4];
            load_a<kD>(qa, qb + 16 * mq * L);
            load_a<kD>(da, db + 16 * mq * L);
            float s[2][4], d[2][4];
            warp_abt_frag<kD>(s, qa, kf);
            warp_abt_frag<kD>(d, da, vf);
            scores_chunk(s, scale, st, ly, rl, cl0, kend);
            float2 pm[2][2] = {};  // pmult at (row rl + 8 h, keys of block j), read once
            if (ly.pmult >= 0) {
#pragma unroll
              for (int j = 0; j < 2; ++j)
#pragma unroll
                for (int h = 0; h < 2; ++h)
                  pm[j][h] = *reinterpret_cast<const float2*>(
                      st + ly.pmult + (rl + 8 * h) * kPlaneLd + cl0 + 8 * j + 2 * t);
            }
            // s becomes pb, d becomes ds; both 0 past N
#pragma unroll
            for (int j = 0; j < 2; ++j)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int h = e >> 1;
                const bool ok = row_ok[h] && cl0 + 8 * j + 2 * t + (e & 1) < kend;
                const float pmv = (e & 1) ? pm[j][h].y : pm[j][h].x;
                const float p = prob(s[j][e], mxl[h], inv[h]);
                const float dp = ly.pmult >= 0 ? __fmul_rn(d[j][e], pmv) : d[j][e];
                d[j][e] = ok ? __fmul_rn(p, __fsub_rn(dp, rs[h])) : 0.f;
                s[j][e] = !ok ? 0.f : ly.pmult >= 0 ? __fmul_rn(p, pmv) : p;
              }
            if (dbias) {
#pragma unroll
              for (int j = 0; j < 2; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                  const int h = e >> 1, c = cl0 + 8 * j + 2 * t + (e & 1);
                  if (row_ok[h] && c < kend) {
                    float* at = dbias + ((long long)hi * N + n0 + rl + 8 * h) * N + m0 + c;
                    *at = (b == b0 ? 0.f : *at) + d[j][e];
                  }
                }
            }
            // (keys x queries) A fragments of pb^T and ds^T: the transposed
            // 8 x 8 blocks (queries g / g + 8, keys of block j)
            unsigned pa[4], sa[4];
            pack_at_chunk(pa, s);
            pack_at_chunk(sa, d);
            warp_ax_chunk<kD>(dva, pa, db, mq);
            warp_ax_chunk<kD>(dka, sa, qb, mq);
          }
        });
    const int m = m0 + cl0 + gq;
    store_frag_rows<kD>(dv + dhead, g.C, dva, m, N, g.hd, 1.f, g.vec);
    store_frag_rows<kD>(dk + dhead, g.C, dka, m, N, g.hd, scale, g.vec);
  }
}

// ---- The stored-P backward's bf16 instantiation on the tensor cores ----
//
// The recompute pair above with the score recompute replaced by reading P:
// the forward's P (and pmult) stream as (64 x 64) fp32 planes beside the
// V/K (rows kernel) or Q/dO (cols kernel) tiles, so no score is computed and
// no ds leaves registers. Both kernels compute dp of a (16 query x 16 key)
// block as dO rows (A) times V rows (B) in ascending 16-column steps, on the
// same 64-grids, times pmult, and ds = P (dp - r) with the one r the rows
// kernel wrote: a (query, key) pair gets the same ds bits in both, so dq
// and dk are taken from the same round(ds).

// shared memory of a stored-P kernel: two bf16 tiles, two buffers each, and
// two stages of `planes` staged fp32 planes plus `extra` floats
template <int kD>
int p_mma_smem_bytes(int planes, int extra) {
  return 4 * tile_bytes<kD>() + 2 * 4 * (planes * kPlaneFloats + extra);
}

// Stored-P backward (1), bf16: dq for 64 query rows of one head of one batch
// (a warp 16 of them), two passes over the key tiles in one pipeline of 2 nt
// steps, V (and K) and P's (and pmult's) (64 x 64) tiles streaming two deep.
// (a) dp = (dO . V^T) * pmult and r = rowsum(dp * P), written to rsum (B,
// heads, N); (b) dp again, ds = P (dp - r) fp32 in registers, rounded to bf16
// as the A operand of dq += round(ds) . K, 16 keys at a time; dq = round(dq *
// scale). A warp whose rows are all past N only joins the loads.
template <int kD>
__global__ void __launch_bounds__(kTileThreads, 3)
    ga_bwd_p_rows_mma_kernel(const bf16* __restrict__ k, const bf16* __restrict__ v,
                             const bf16* __restrict__ dout, const float* __restrict__ p,
                             const float* __restrict__ pmult, bf16* __restrict__ dq,
                             float* __restrict__ rsum, Dims g, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int L = tile_ld<kD>(), kT = kTile * L;
  bf16* const ks = reinterpret_cast<bf16*>(smem_raw);  // K, buffers 0 and 1
  bf16* const vs = ks + 2 * kT;                         // V, buffers 0 and 1
  float* const pl = reinterpret_cast<float*>(vs + 2 * kT);  // P (and pmult), stages 0 and 1
  const int stage = (pmult ? 2 : 1) * kPlaneFloats;
  const int N = g.N;
  const int n0 = blockIdx.x * kTile, hi = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gq = lane >> 2, t = lane & 3;
  const int rl = 16 * warp + gq;  // this thread's rows of the tile: rl, rl + 8
  const bool live = n0 + 16 * warp < N;
  const long long head = (long long)b * N * g.ld + hi * g.hd;
  const long long row0 = ((long long)b * g.heads + hi) * N;
  const bf16 *kh = k + head, *vh = v + head;
  const float* ph = p + row0 * N;
  const int nt = (N + kTile - 1) / kTile;

  // this warp's dO rows as A fragments, for the whole block
  unsigned df[kD / 16][4];
  load_tile<kD>(vs, dout + (long long)b * N * g.C + hi * g.hd, g.C, n0, N, g.hd, g.vec);
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
        if (s >= nt) load_tile<kD>(ks + buf * kT, kh, g.ld, kt * kTile, N, g.hd, g.vec);
        load_tile<kD>(vs + buf * kT, vh, g.ld, kt * kTile, N, g.hd, g.vec);
        float* st = pl + buf * stage;
        load_plane(st, ph, N, N, n0, kt * kTile);
        if (pmult) load_plane(st + kPlaneFloats, pmult, N, N, n0, kt * kTile);
      },
      [&](int s, int buf) {
        if (!live) return;
        const float* st = pl + buf * stage;
        if (s == nt) {  // (a) done: r
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            r[h] = quad_sum(rs[h]);
            if (t == 0 && n0 + rl + 8 * h < N) rsum[row0 + n0 + rl + 8 * h] = r[h];
          }
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          // dp of keys 16 kk .. 16 kk + 15 of the tile, times the staged pmult
          float d[2][4];
          warp_abt_chunk<kD>(d, df, vs + buf * kT, kk);
          if (pmult) plane_chunk<true>(d, st + kPlaneFloats, rl, 16 * kk);
          if (s < nt) {  // (a)
#pragma unroll
            for (int j = 0; j < 2; ++j)
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const float2 pv = plane_pair(st, rl + 8 * h, 16 * kk + 8 * j + 2 * t);
                rs[h] = __fmaf_rn(d[j][2 * h], pv.x, rs[h]);
                rs[h] = __fmaf_rn(d[j][2 * h + 1], pv.y, rs[h]);
              }
          } else {  // (b)
#pragma unroll
            for (int j = 0; j < 2; ++j)
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const float2 pv = plane_pair(st, rl + 8 * h, 16 * kk + 8 * j + 2 * t);
                d[j][2 * h] = __fmul_rn(pv.x, __fsub_rn(d[j][2 * h], r[h]));
                d[j][2 * h + 1] = __fmul_rn(pv.y, __fsub_rn(d[j][2 * h + 1], r[h]));
              }
            unsigned a[4];
            pack_a_chunk(a, d);
            warp_ax_chunk<kD>(dqa, a, ks + buf * kT, kk);
          }
        }
      });
  store_frag_rows<kD>(dq + (long long)b * N * g.C + hi * g.hd, g.C, dqa, n0 + rl, N, g.hd, scale,
                      g.vec);
}

// Stored-P backward (2), bf16: dv = round(P * pmult)^T . dO and dk =
// round(ds)^T . Q * scale for 64 keys of one head (a warp 16 of them),
// summed over every query tile, for b_count batches from blockIdx.z *
// b_count in order, in one pipeline over (batch, query tile). Q, dO, P,
// pmult and the rows kernel's r stream in 64-query tiles; a warp holds its
// 16 keys of V as B fragments in registers, loading the next batch's at the
// end of a batch's last tile.
// For each 16 query rows it computes dp against its keys as the rows kernel
// does, forms pb and ds in registers, and transposes them (movmatrix) into
// the A operands of dv += pb^T . dO and dk += ds^T . Q. With dbias, plane
// blockIdx.z of dbias (groups, heads, nt x nt tiles of 64 x 64) gets the sum
// of the fp32 ds over the group's batches in order, tile (query tile, key
// tile) at ((z * heads + hi) * nt + it) * nt + kt (the block owns its key
// tile's column of tiles): the previous batches' sum of a tile streams in
// with it (one more staged plane; with one key tile, where the next
// batch's tile would be staged before this one's is written, the thread
// reads back what it wrote), and the new sum goes out as float2 stores.
template <int kD>
__global__ void __launch_bounds__(kTileThreads, 3)
    ga_bwd_p_cols_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ v,
                             const bf16* __restrict__ dout, const float* __restrict__ p,
                             const float* __restrict__ pmult, const float* __restrict__ rsum,
                             bf16* __restrict__ dk, bf16* __restrict__ dv,
                             float* __restrict__ dbias, Dims g, float scale, int b_count) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int L = tile_ld<kD>(), kT = kTile * L, kTileFloats = kTile * kTile;
  bf16* const qs = reinterpret_cast<bf16*>(smem_raw);  // Q, buffers 0 and 1
  bf16* const dos = qs + 2 * kT;                        // dO, buffers 0 and 1
  const int N = g.N;
  const int nt = (N + kTile - 1) / kTile;
  // stages 0 and 1: P, (pmult,) (dbias's running sum,) r
  float* const pl = reinterpret_cast<float*>(dos + 2 * kT);
  const bool staged = dbias && nt > 1;
  const int o_pm = kPlaneFloats, o_db = o_pm + (pmult ? kPlaneFloats : 0);
  const int o_r = o_db + (staged ? kPlaneFloats : 0), stage = o_r + kTile;
  const int m0 = blockIdx.x * kTile, hi = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gq = lane >> 2, t = lane & 3;
  const int cl0 = 16 * warp;  // this warp's keys in the block: m0 + cl0 ..
  const int kend = N - m0;
  const bool live = cl0 < kend;
  const int b0 = blockIdx.z * b_count, b1 = min(g.B, b0 + b_count);
  // this block's column of dbias tiles: tile it at dbt + it * nt * kTileFloats
  float* const dbt =
      dbias ? dbias + (((long long)blockIdx.z * g.heads + hi) * nt * nt + blockIdx.x) * kTileFloats
            : nullptr;

  float dva[kD / 8][4], dka[kD / 8][4];
  unsigned vf[kD / 16][4];
  if (live)
    load_b_global<kD>(vf, v + (long long)b0 * N * g.ld + hi * g.hd, g.ld, m0 + cl0, N, g.hd,
                      g.vec);
  pipeline(
      (b1 - b0) * nt,
      [&](int s, int buf) {
        const int b = b0 + s / nt, it = s % nt, n0 = it * kTile;
        const long long row0 = ((long long)b * g.heads + hi) * N;
        load_tile<kD>(qs + buf * kT, q + (long long)b * N * g.ld + hi * g.hd, g.ld, n0, N, g.hd,
                      g.vec);
        load_tile<kD>(dos + buf * kT, dout + (long long)b * N * g.C + hi * g.hd, g.C, n0, N,
                      g.hd, g.vec);
        float* st = pl + buf * stage;
        load_plane(st, p + row0 * N, N, N, n0, m0);
        if (pmult) load_plane(st + o_pm, pmult, N, N, n0, m0);
        if (staged && b > b0)
          load_plane(st + o_db, dbt + (long long)it * nt * kTileFloats, kTile, kTile, 0, 0);
        load_vec64(st + o_r, rsum + row0 + n0, N - n0);
      },
      [&](int s, int buf) {
        if (!live) return;
        const int b = b0 + s / nt, it = s % nt, n0 = it * kTile;
        const long long dhead = (long long)b * N * g.C + hi * g.hd;
        if (it == 0) {
          zero_acc<kD>(dva);
          zero_acc<kD>(dka);
        }
        const float* st = pl + buf * stage;
        const bf16 *qb = qs + buf * kT, *db = dos + buf * kT;
        float* const tile = dbias ? dbt + (long long)it * nt * kTileFloats : nullptr;
#pragma unroll
        for (int mq = 0; mq < 4; ++mq) {
          const int rl = 16 * mq + gq;  // this thread's rows of the tile: rl, rl + 8
          unsigned da[kD / 16][4];
          load_a<kD>(da, db + 16 * mq * L);
          float d[2][4], pb[2][4];
          warp_abt_frag<kD>(d, da, vf);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float r = st[o_r + rl + 8 * h];
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const int c = cl0 + 8 * j + 2 * t;
              const float2 pv = plane_pair(st, rl + 8 * h, c);
              float2 pm = make_float2(1.f, 1.f);
              if (pmult) {
                pm = plane_pair(st + o_pm, rl + 8 * h, c);
                d[j][2 * h] = __fmul_rn(d[j][2 * h], pm.x);
                d[j][2 * h + 1] = __fmul_rn(d[j][2 * h + 1], pm.y);
              }
              d[j][2 * h] = __fmul_rn(pv.x, __fsub_rn(d[j][2 * h], r));
              d[j][2 * h + 1] = __fmul_rn(pv.y, __fsub_rn(d[j][2 * h + 1], r));
              pb[j][2 * h] = pmult ? __fmul_rn(pv.x, pm.x) : pv.x;
              pb[j][2 * h + 1] = pmult ? __fmul_rn(pv.y, pm.y) : pv.y;
            }
          }
          if (dbias) {  // past N, ds is 0: the padded tiles take it as it is
#pragma unroll
            for (int j = 0; j < 2; ++j)
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const int c = cl0 + 8 * j + 2 * t;
                float2* at = reinterpret_cast<float2*>(tile + (rl + 8 * h) * kTile + c);
                const float2 old = b == b0 ? make_float2(0.f, 0.f)
                                   : staged ? plane_pair(st + o_db, rl + 8 * h, c)
                                            : *at;
                *at = make_float2(old.x + d[j][2 * h], old.y + d[j][2 * h + 1]);
              }
          }
          unsigned pa[4], sa[4];
          pack_at_chunk(pa, pb);
          pack_at_chunk(sa, d);
          warp_ax_chunk<kD>(dva, pa, db, mq);
          warp_ax_chunk<kD>(dka, sa, qb, mq);
        }
        if (it == nt - 1) {
          const int m = m0 + cl0 + gq;
          store_frag_rows<kD>(dv + dhead, g.C, dva, m, N, g.hd, 1.f, g.vec);
          store_frag_rows<kD>(dk + dhead, g.C, dka, m, N, g.hd, scale, g.vec);
          if (b + 1 < b1)  // the next batch's V fragments, in flight over the step's barrier
            load_b_global<kD>(vf, v + (long long)(b + 1) * N * g.ld + hi * g.hd, g.ld, m0 + cl0,
                              N, g.hd, g.vec);
        }
      });
}

// Stored-P backward (3), bf16: dbias[h][n][m] = the sum over the groups, in
// group order, of the (groups, heads, nt x nt tiles of 64 x 64) planes of
// ga_bwd_p_cols_mma_kernel
__global__ void ga_dbias_tiles_kernel(const float* __restrict__ part, float* __restrict__ out,
                                      int groups, int heads, int N) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)heads * N * N) return;
  const int m = static_cast<int>(i % N), n = static_cast<int>(i / N % N);
  const long long hi = i / ((long long)N * N);
  const int nt = (N + kTile - 1) / kTile;
  const long long per = (long long)heads * nt * nt * kTile * kTile;  // floats a group
  const float* x = part + ((hi * nt + n / kTile) * nt + m / kTile) * kTile * kTile +
                   (n % kTile) * kTile + m % kTile;
  float a = 0.f;
  for (int z = 0; z < groups; ++z) a += x[z * per];
  out[i] = a;
}

Dims dims(int B, int N, int C, int heads, long long ld) {
  Dims g;
  g.B = B;
  g.N = N;
  g.C = C;
  g.heads = heads;
  g.hd = C / heads;
  g.ld = ld;
  g.wmask = nullptr;
  g.n_win = 1;
  g.vec = 0;
  g.bias_ld = N;
  return g;
}

bool bad_dims(const Dims& g) {
  return g.N < 1 || g.N > kMaxN || g.heads < 1 || g.C % g.heads != 0 || g.hd > kMaxHd ||
         g.ld < g.C || g.B < 1 || g.B > 65535 || g.heads > 65535 || g.n_win < 1 ||
         g.B % g.n_win != 0;
}

template <int kD>
cudaError_t launch_fwd_mma(const void* q, const void* k, const void* v, const float* bias,
                           const float* kmask, const float* pmult, void* o, float* p,
                           const Dims& g, float scale, cudaStream_t stream) {
  const int smem = fwd_mma_smem_bytes<kD>(stage_layout(bias, false, pmult, kmask, false), p);
  cudaError_t err = cudaFuncSetAttribute(ga_fwd_mma_kernel<kD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((g.N + kTile - 1) / kTile, g.heads, g.B);
  ga_fwd_mma_kernel<kD><<<grid, kTileThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      bias, kmask, pmult, static_cast<bf16*>(o), p, g, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, const float* bias,
                       const float* kmask, const float* pmult, void* o, float* p, const Dims& g,
                       float scale, cudaStream_t stream) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    return g.hd <= 32 ? launch_fwd_mma<32>(q, k, v, bias, kmask, pmult, o, p, g, scale, stream)
                      : launch_fwd_mma<64>(q, k, v, bias, kmask, pmult, o, p, g, scale, stream);
  } else {
    const int smem = rows_smem_bytes(g.N);
    cudaError_t err =
        cudaFuncSetAttribute(ga_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((g.N + kTq - 1) / kTq, g.heads, g.B);
    ga_fwd_kernel<T><<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), bias, kmask,
        pmult, static_cast<T*>(o), p, g, scale);
    return cudaGetLastError();
  }
}

// the stored-P backward's two kernels on the tensor cores (bf16), kD columns
// a head (hd <= kD, zero-padded); the bias gradient summed over n_groups
// groups of b_count batches into planes
template <int kD>
cudaError_t launch_bwd_mma(const void* q, const void* k, const void* v, const void* dout,
                           const float* p, const float* pmult, void* dq, void* dk, void* dv,
                           float* rsum, float* planes, int n_groups, int b_count, const Dims& g,
                           float scale, cudaStream_t stream) {
  const bf16 *qb = static_cast<const bf16*>(q), *kb = static_cast<const bf16*>(k),
             *vb = static_cast<const bf16*>(v), *db = static_cast<const bf16*>(dout);
  int smem = p_mma_smem_bytes<kD>(pmult ? 2 : 1, 0);
  cudaError_t err = cudaFuncSetAttribute(ga_bwd_p_rows_mma_kernel<kD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int tiles = (g.N + kTile - 1) / kTile;
  ga_bwd_p_rows_mma_kernel<kD><<<dim3(tiles, g.heads, g.B), kTileThreads, smem, stream>>>(
      kb, vb, db, p, pmult, static_cast<bf16*>(dq), rsum, g, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const bool staged = planes && tiles > 1;
  smem = p_mma_smem_bytes<kD>((pmult ? 2 : 1) + (staged ? 1 : 0), kTile);
  err = cudaFuncSetAttribute(ga_bwd_p_cols_mma_kernel<kD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  ga_bwd_p_cols_mma_kernel<kD><<<dim3(tiles, g.heads, n_groups), kTileThreads, smem, stream>>>(
      qb, vb, db, p, pmult, rsum, static_cast<bf16*>(dk), static_cast<bf16*>(dv), planes, g,
      scale, b_count);
  return cudaGetLastError();
}

// scratch: ds (B, heads, N, N) for fp32, the row statistic r (B, heads, N)
// for bf16; dbias_partial: the bf16 groups' planes
template <typename T>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, const void* dout,
                       const float* p, const float* pmult, void* dq, void* dk, void* dv,
                       float* scratch, float* dbias, float* dbias_partial, int groups,
                       const Dims& g, float scale, cudaStream_t stream) {
  const long long count = (long long)g.heads * g.N * g.N;
  const unsigned reduce_blocks = (unsigned)((count + kThreads - 1) / kThreads);
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    // with a bias gradient a block sums its key columns over a group of
    // consecutive batches, each group into a plane of its own
    const int b_count = dbias ? (g.B + groups - 1) / groups : 1;
    const int n_groups = (g.B + b_count - 1) / b_count;
    float* planes = dbias ? dbias_partial : nullptr;
    cudaError_t err =
        g.hd <= 32 ? launch_bwd_mma<32>(q, k, v, dout, p, pmult, dq, dk, dv, scratch, planes,
                                        n_groups, b_count, g, scale, stream)
                   : launch_bwd_mma<64>(q, k, v, dout, p, pmult, dq, dk, dv, scratch, planes,
                                        n_groups, b_count, g, scale, stream);
    if (err != cudaSuccess || !dbias) return err;
    // (3) the groups' planes summed in group order, into dbias's layout
    ga_dbias_tiles_kernel<<<reduce_blocks, kThreads, 0, stream>>>(dbias_partial, dbias, n_groups,
                                                                  g.heads, g.N);
    return cudaGetLastError();
  } else {
    const int smem = rows_smem_bytes(g.N);
    cudaError_t err = cudaFuncSetAttribute(ga_bwd_dq_kernel<T>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid_q((g.N + kTq - 1) / kTq, g.heads, g.B);
    ga_bwd_dq_kernel<T><<<grid_q, kThreads, smem, stream>>>(
        static_cast<const T*>(k), static_cast<const T*>(v), static_cast<const T*>(dout), p, pmult,
        static_cast<T*>(dq), scratch, g, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(ga_bwd_dkv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               dkv_smem_bytes());
    if (err != cudaSuccess) return err;
    const dim3 grid_k((g.N + kTk - 1) / kTk, g.heads, g.B);
    ga_bwd_dkv_kernel<T><<<grid_k, kThreads, dkv_smem_bytes(), stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(dout), p, pmult, scratch,
        static_cast<T*>(dk), static_cast<T*>(dv), g, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess || !dbias) return err;
    ga_dbias_reduce_kernel<<<reduce_blocks, kThreads, 0, stream>>>(scratch, dbias, g.B, count);
    return cudaGetLastError();
  }
}

// the recompute backward's two kernels on the tensor cores (bf16), kD
// columns a head (hd <= kD, zero-padded)
template <int kD, bool kOf>
cudaError_t launch_rows_mma(const bf16* q, const bf16* k, const bf16* v, const bf16* dout,
                            const float* bias, const float* kmask, const float* pmult, void* dq,
                            void* of, float* stats, const Dims& g, float scale,
                            cudaStream_t stream) {
  const int smem = rows_mma_smem_bytes<kD>(stage_layout(bias, g.wmask, pmult, kmask, false));
  cudaError_t err = cudaFuncSetAttribute(ga_bwd_rows_mma_kernel<kD, kOf>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((g.N + kTile - 1) / kTile, g.heads, g.B);
  ga_bwd_rows_mma_kernel<kD, kOf><<<grid, kTileThreads, smem, stream>>>(
      q, k, v, dout, bias, kmask, pmult, static_cast<bf16*>(dq), static_cast<bf16*>(of), stats,
      g, scale);
  return cudaGetLastError();
}

template <int kD>
cudaError_t launch_recompute_mma(const void* q, const void* k, const void* v, const void* dout,
                                 const float* bias, const float* kmask, const float* pmult,
                                 void* dq, void* dk, void* dv, void* of, float* stats,
                                 float* planes, int n_groups, int b_count, const Dims& g,
                                 float scale, cudaStream_t stream) {
  const bf16 *qb = static_cast<const bf16*>(q), *kb = static_cast<const bf16*>(k),
             *vb = static_cast<const bf16*>(v), *db = static_cast<const bf16*>(dout);
  cudaError_t err =
      of ? launch_rows_mma<kD, true>(qb, kb, vb, db, bias, kmask, pmult, dq, of, stats, g, scale,
                                     stream)
         : launch_rows_mma<kD, false>(qb, kb, vb, db, bias, kmask, pmult, dq, of, stats, g, scale,
                                      stream);
  if (err != cudaSuccess) return err;
  const int smem = cols_mma_smem_bytes<kD>(stage_layout(bias, g.wmask, pmult, kmask, true));
  err = cudaFuncSetAttribute(ga_bwd_cols_mma_kernel<kD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((g.N + kTile - 1) / kTile, g.heads, n_groups);
  ga_bwd_cols_mma_kernel<kD><<<grid, kTileThreads, smem, stream>>>(
      qb, kb, vb, db, bias, kmask, pmult, stats, static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      planes, g, scale, b_count);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd_recompute(const void* q, const void* k, const void* v, const void* dout,
                                 const float* bias, const float* kmask, const float* pmult,
                                 void* dq, void* dk, void* dv, void* of, float* stats,
                                 float* dbias, float* dbias_partial, int groups, const Dims& g,
                                 float scale, cudaStream_t stream) {
  // with a bias gradient a block sums its key columns over a group of
  // consecutive batches, each group into a plane of its own
  const int b_count = dbias ? (g.B + groups - 1) / groups : 1;
  const int n_groups = (g.B + b_count - 1) / b_count;
  float* planes = dbias && n_groups > 1 ? dbias_partial : dbias;
  cudaError_t err;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    err = g.hd <= 32 ? launch_recompute_mma<32>(q, k, v, dout, bias, kmask, pmult, dq, dk, dv, of,
                                                stats, planes, n_groups, b_count, g, scale, stream)
                     : launch_recompute_mma<64>(q, k, v, dout, bias, kmask, pmult, dq, dk, dv, of,
                                                stats, planes, n_groups, b_count, g, scale, stream);
  } else {
    const int smem = rows_smem_bytes(g.N);
    err = cudaFuncSetAttribute(ga_bwd_rows_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return err;
    const dim3 grid_q((g.N + kTq - 1) / kTq, g.heads, g.B);
    ga_bwd_rows_kernel<T><<<grid_q, kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(dout), bias, kmask, pmult, static_cast<T*>(dq), static_cast<T*>(of),
        stats, g, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(ga_bwd_cols_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               cols_smem_bytes());
    if (err != cudaSuccess) return err;
    const dim3 grid_k((g.N + kTk - 1) / kTk, g.heads, n_groups);
    ga_bwd_cols_kernel<T><<<grid_k, kThreads, cols_smem_bytes(), stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(dout), bias, kmask, pmult, stats, static_cast<T*>(dk),
        static_cast<T*>(dv), planes, g, scale, b_count);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess || !dbias || n_groups == 1) return err;
  // (3) the groups' planes summed in group order
  const long long count = (long long)g.heads * g.N * g.N;
  ga_dbias_reduce_kernel<<<(unsigned)((count + kThreads - 1) / kThreads), kThreads, 0, stream>>>(
      dbias_partial, dbias, n_groups, count);
  return cudaGetLastError();
}

// whether the bf16 tensor-core kernels may copy 16 bytes at a time
bool vec_ok(const Dims& g, const void* q, const void* k, const void* v, const void* dout,
            const void* dq, const void* dk, const void* dv) {
  return g.ld % 8 == 0 && g.C % 8 == 0 && g.hd % 8 == 0 && aligned16(q) && aligned16(k) &&
         aligned16(v) && aligned16(dout) && aligned16(dq) && aligned16(dk) && aligned16(dv);
}

}  // namespace

extern "C" {

const char* skinjax_global_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// bf16: 0 for float, 1 for bfloat16 (q, k, v and o share it). q, k, v (B, N, C)
// with rows at a stride of ld elements and unit channel stride; bias (heads,
// N, bias_ld) with bias_ld >= N (bfloat16; float takes bias_ld = N), kmask
// (B, N), pmult (N, N), each fp32 or null. Writes o (B, N, C) contiguous and,
// when p is not null, P (B, heads, N, N) fp32.
int skinjax_global_attention_fwd(int bf16, const void* q, const void* k, const void* v,
                                 long long ld, const float* bias, int bias_ld, const float* kmask,
                                 const float* pmult, void* o, float* p, int B, int N, int C,
                                 int heads, float scale, void* stream) {
  Dims g = dims(B, N, C, heads, ld);
  if (bad_dims(g) || (bias && (bias_ld < N || (!bf16 && bias_ld != N))))
    return static_cast<int>(cudaErrorInvalidValue);
  if (bias) g.bias_ld = bias_ld;
  g.vec = g.ld % 8 == 0 && g.C % 8 == 0 && g.hd % 8 == 0 && aligned16(q) && aligned16(k) &&
          aligned16(v) && aligned16(o);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) return launch_fwd<__nv_bfloat16>(q, k, v, bias, kmask, pmult, o, p, g, scale, s);
  return launch_fwd<float>(q, k, v, bias, kmask, pmult, o, p, g, scale, s);
}

// dout (B, N, C) contiguous like o; p the forward's P. Writes dq, dk, dv (B,
// N, C) contiguous, the fp32 scratch (for float: ds (B, heads, N, N); for
// bfloat16: the row statistic rowsum(dp * P) (B, heads, N)) and, when dbias
// is not null, dbias (heads, N, N) fp32: for bfloat16 summed in groups of
// ceil(B / groups) batches (1 <= groups <= B) into dbias_partial, a (groups,
// heads, Np, Np) fp32 scratch with Np = N rounded up to 64 (tiles of 64 x
// 64), then over the groups; for float over the whole batch in order
// (groups and dbias_partial unused).
int skinjax_global_attention_bwd(int bf16, const void* q, const void* k, const void* v,
                                 long long ld, const void* dout, const float* p,
                                 const float* pmult, void* dq, void* dk, void* dv, float* scratch,
                                 float* dbias, float* dbias_partial, int groups, int B, int N,
                                 int C, int heads, float scale, void* stream) {
  Dims g = dims(B, N, C, heads, ld);
  if (bad_dims(g) || groups < 1 || groups > B) return static_cast<int>(cudaErrorInvalidValue);
  g.vec = vec_ok(g, q, k, v, dout, dq, dk, dv);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch_bwd<__nv_bfloat16>(q, k, v, dout, p, pmult, dq, dk, dv, scratch, dbias,
                                     dbias_partial, groups, g, scale, s);
  return launch_bwd<float>(q, k, v, dout, p, pmult, dq, dk, dv, scratch, dbias, dbias_partial,
                           groups, g, scale, s);
}

// The recompute backward: the forward's inputs (bias for the scores, null
// or not, whatever dbias is; mask (n_win, N, N) fp32 or null, B a multiple
// of n_win) and dout as for skinjax_global_attention_bwd. Writes dq, dk, dv
// (B, N, C) contiguous, of (B, N, C) when of is not null (pmult must be null
// then), the row statistics stats (3, B, heads, N) fp32 and, when dbias is
// not null, dbias (heads, N, N) fp32, summed in groups of ceil(B / groups)
// batches (1 <= groups <= B; with more than one group, dbias_partial is a
// (groups, heads, N, N) fp32 scratch).
int skinjax_global_attention_bwd_recompute(int bf16, const void* q, const void* k, const void* v,
                                           long long ld, const void* dout, const float* bias,
                                           const float* kmask, const float* pmult,
                                           const float* mask, int n_win, void* dq, void* dk,
                                           void* dv, void* of, float* stats, float* dbias,
                                           float* dbias_partial, int groups, int B, int N, int C,
                                           int heads, float scale, void* stream) {
  Dims g = dims(B, N, C, heads, ld);
  g.wmask = mask;
  g.n_win = mask ? n_win : 1;
  if (bad_dims(g) || groups < 1 || groups > B || (of && pmult))
    return static_cast<int>(cudaErrorInvalidValue);
  g.vec = vec_ok(g, q, k, v, dout, dq, dk, dv) && (!of || aligned16(of));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch_bwd_recompute<__nv_bfloat16>(q, k, v, dout, bias, kmask, pmult, dq, dk, dv, of,
                                               stats, dbias, dbias_partial, groups, g, scale, s);
  return launch_bwd_recompute<float>(q, k, v, dout, bias, kmask, pmult, dq, dk, dv, of, stats,
                                     dbias, dbias_partial, groups, g, scale, s);
}

}  // extern "C"
