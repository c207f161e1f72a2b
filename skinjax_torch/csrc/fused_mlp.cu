// The fused token MLP, fc1 -> activation -> fc2, with its recompute backward,
// for Hopper (sm_90a): exact-erf GELU with biases (CoaT-lite's serial blocks)
// and bias-free StarReLU (CAFormer's MetaFormer blocks), one source templated
// on the activation.
//
// It replaces the Pallas TPU kernels of skinjax/ops/pallas/fused_mlp.py:
//   K9   mlp_gelu: _fwd_core (kernel _fwd_kernel) and _bwd_core (_bwd_kernel)
//   K10  mlp_star: _star_fwd_core (_star_fwd_kernel) and _star_bwd_core
//        (_star_bwd_kernel)
// x is (T, D), w1 (D, H), w2 (H, D2), all contiguous in the input type (bf16
// or fp32); K9's b1 (H,) and b2 (D2,) are in that type too, K10's s and b are
// fp32 scalars. Per token row:
//
//   forward   pre = x.w1 (+ b1)                                          fp32
//             K9:  h = round(gelu(pre))        gelu(p) = p/2 (1 + erf(p/sqrt 2))
//             K10: r = max(pre, 0); h = round((s r) r + b)
//             y = round(h.w2 (+ b2))
//   backward  pre and h recomputed as above (K10: h = round(s (r r) + b))
//             dw2 = sum_t h^T dy;  db2 = sum_t dy                          fp32
//             dh = dy.w2^T                                               fp32
//             K9:  dpre = dh * (Phi(pre) + pre phi(pre));  db1 = sum_t dpre
//             K10: ds = sum dh r^2;  db = sum dh;  dpre = dh * ((2 s) r)
//             dw1 = sum_t x^T round(dpre);  dx = round(round(dpre).w1^T)
//
// "round" is the cast to the input type where the Pallas kernel casts; every
// sum is fp32. The elementwise steps use __fmul_rn/__fadd_rn, so nvcc does not
// contract them into FMAs and they round where the plain twin rounds.
//
// Layout and launches. The TPU kernel keeps w1 and w2 whole in VMEM and walks
// a sequential grid of token tiles, carrying dW in scratch. Neither holds
// here: CAFormer-b36's stage-3 w1 is 768 x 3072 (4.7 MB in bf16), and blocks
// run in no order.
//   forward, bf16: mlp_fwd_wgmma_kernel (the section "forward, bf16" below),
//             a block of two warpgroups per 64 token rows: its x rows taken
//             once, then 128-wide hidden chunks, pre from wgmma with its
//             fp32 accumulators in registers, the activation on that
//             fragment, round(h) through one swizzled shared-memory tile, and
//             h.w2 added to y's fp32 accumulators, which stay in registers
//             (y's columns split over the two warpgroups, and over blocks
//             above 512 columns), every tile by TMA; nothing of the (T, H)
//             plane reaches device memory. Where the blocks are too few to
//             fill the card (a small batch), or two splits turn one and a
//             half waves into three shorter ones, the hidden chunks are split
//             over blocks too: each writes fp32 partials, and a second launch
//             sums them in split order (+ b2);
//   forward, fp32: mlp_fwd_kernel, a block per 32 token rows keeps its
//             (32, D2) fp32 output in shared memory and loops over 64-wide
//             hidden chunks (pre from 64-wide K slices of x and w1, the
//             activation, then the chunk's h.w2 added slice by slice), with
//             the same hidden split;
//   backward, bf16: five products on the tensor cores (the section "backward,
//             bf16" below): one launch computes pre and dh once and writes
//             round(h) and round(dpre) as (T, H) planes into the call's
//             scratch, then dx, dw1 and dw2 are tiled products of those
//             planes, and a last launch sums every partial in a fixed order;
//   backward, fp32 (held at 1e-4, which TF32 products would not meet):
//             (1) dx: a block per 32 token rows (and hidden split), as the
//             forward, with pre and dh both recomputed for each hidden chunk
//             and round(dpre).w1^T summed into a (32, D) fp32 tile;
//             (2) dW: a block per (hidden chunk of hw = 16, 32 or 64 columns,
//             token segment) walks its segment tw = 32, 64 or 128 rows at a
//             time (the largest hw x tw whose tiles fit), recomputes
//             pre and dh for its columns, and sums x^T dpre and h^T dy into
//             (D, hw) and (hw, D2) fp32 tiles in shared memory, the column
//             sums of dpre (db1), of dy (db2, the chunk-0 blocks) and the
//             per-thread ds/db terms; it writes them as the segment's
//             partials;
//             (3) a reduction sums the partials over the segments in segment
//             order.
// No atomics: every sum runs in an order fixed by the shapes, so two calls on
// the same inputs give bit-identical results. skinjax_fused_mlp_scratch
// sizes each call's scratch.
// Padding: rows past T (or past a segment), columns past D, H or D2 load as
// zeros; zero dy rows make dh and dpre exactly 0, so they add nothing to any
// gradient.
//
// What bounds it: at CAFormer-b36's stage 0 at B=32 (T = 100352, D = 128,
// H = 512, bf16) the forward does 26.3 GFLOP against 51 MB of x and y, so the
// tensor cores bound it (~27 us at 989 TFLOP/s), and the backward 66 GFLOP.
// The bf16 forward and backward compute on wgmma (warpgroup products from
// 128-byte-swizzled shared-memory tiles) with their accumulators in
// registers; a forward block brings all of w1 and w2 from L2 once per 64
// token rows (~4 MB at CAFormer-b36's stage 2), in steps whose barrier and
// bookkeeping, at 8 warps an SM, cost more than their products (PERF.md).
// fp32 products run as plain fp32 FMAs. The forward's tiles come by TMA, the
// backward's by cp.async: PERF.md records how far each kernel is from its
// bound. D, H and D2 are multiples of 16, and D, D2 <= 1024 (the fp32 dW
// tiles fit shared memory).
//
// C interface: each entry point launches on the given stream and returns
// cudaGetLastError() as an int (0 = success); skinjax_fused_mlp_error_string
// maps the code to its message.

#include <cuda.h>  // CUtensorMap and its enums (the encoder comes from the runtime)
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <initializer_list>
#include <type_traits>

#include "mma_bf16.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTm = 32;  // token rows a block of the fp32 forward and dx kernels
constexpr int kHc = 64;  // hidden columns a chunk of the fp32 forward and dx kernels
constexpr int kKc = 64;  // K slice of a streamed product
constexpr int kNc = 64;  // output columns a slice of a streamed product
constexpr int kFpad = 4; // fp32 row padding of a shared-memory tile (16 bytes)
constexpr int kMaxSmem = 227 * 1024;  // dynamic shared memory a block may have on sm_90

enum Act { kGelu = 0, kStar = 1 };

constexpr float kInvSqrt2 = 0.7071067811865476f;
constexpr float kInvSqrt2Pi = 0.3989422804014327f;

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ float to_f32<bf16>(bf16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

__host__ __device__ __forceinline__ int round_up(int x, int m) { return (x + m - 1) / m * m; }

// row padding of a T tile in shared memory: 16 bytes
template <typename T>
__host__ __device__ constexpr int tpad() {
  return 16 / static_cast<int>(sizeof(T));
}

__device__ __forceinline__ float gelu(float p) {
  return __fmul_rn(__fmul_rn(p, 0.5f), __fadd_rn(1.0f, erff(__fmul_rn(p, kInvSqrt2))));
}

// dst[r * ldd + c] = src[(r0 + r) * lds + c0 + c] for r < R, c < C; zero where
// r0 + r >= rows or c0 + c >= cols. In flight (cp.async) until the caller
// waits for its group. 16-byte vectors: C, c0, lds and cols are multiples of
// 16 / sizeof(T), and src and dst rows are 16-byte aligned. (mma_bf16.cuh's
// load_tile is the attention kernels' fixed 64-row bf16 form.)
template <typename T>
__device__ void load_slice(T* __restrict__ dst, int ldd, const T* __restrict__ src, int lds, int r0,
                           int rows, int c0, int cols, int R, int C) {
  constexpr int V = 16 / sizeof(T);
  const int vecs = C / V;
  for (int i = threadIdx.x; i < R * vecs; i += kThreads) {
    const int r = i / vecs, c = (i - r * vecs) * V;
    if (r0 + r < rows && c0 + c < cols)
      cp_async16(dst + r * ldd + c, src + (long long)(r0 + r) * lds + c0 + c);
    else
      *reinterpret_cast<uint4*>(dst + r * ldd + c) = make_uint4(0u, 0u, 0u, 0u);
  }
}

__device__ void zero_f32(float* __restrict__ p, int n) {
  for (int i = threadIdx.x; i < n; i += kThreads) p[i] = 0.f;
}

// C (M x N, fp32, row-major, ldc) += A (M x K) . B (K x N), all fp32 in
// shared memory. A(m, k) = a[m * lda + k] when A_ROW, else a[k * lda + m];
// B(k, n) = b[k * ldb + n] when B_ROW, else b[n * ldb + k]. Each thread takes
// output elements, one FMA chain over k each. (The bf16 products run on
// wgmma, below.)
template <bool A_ROW, bool B_ROW>
__device__ void block_mma(float* __restrict__ c, int ldc, const float* __restrict__ a, int lda,
                          const float* __restrict__ b, int ldb, int M, int N, int K) {
  for (int i = threadIdx.x; i < M * N; i += kThreads) {
    const int m = i / N, n = i - m * N;
    float s = c[m * ldc + n];
    for (int k = 0; k < K; ++k) {
      const float av = A_ROW ? a[m * lda + k] : a[k * lda + m];
      const float bv = B_ROW ? b[k * ldb + n] : b[n * ldb + k];
      s = fmaf(av, bv, s);
    }
    c[m * ldc + n] = s;
  }
}

struct Dims {
  int T, D, H, D2;
};

// what the activation reads: K9's b1 (in the input type), K10's s and b (fp32
// scalars on the card, read once a block)
template <typename T>
struct ActPtrs {
  const T* b1;
  const float* s;
  const float* b;
};

template <typename T>
struct ActArgs {
  const T* b1;
  float s, b;
};

template <typename T>
__device__ __forceinline__ ActArgs<T> act_args(const ActPtrs<T>& p) {
  return ActArgs<T>{p.b1, p.s ? __ldg(p.s) : 0.f, p.b ? __ldg(p.b) : 0.f};
}

// K9's b1 of hidden column j as fp32 (K10: 0, unused)
template <typename T, int ACT>
__device__ __forceinline__ float b1_at(const ActArgs<T>& a, int j) {
  if constexpr (ACT == kGelu) return to_f32<T>(a.b1[j]);
  return 0.f;
}

// pre-activation p of a hidden column (fp32 product; K9 adds its bias b1,
// from b1_at) -> h
template <typename T, int ACT>
__device__ __forceinline__ float fwd_act(float p, float b1, const ActArgs<T>& a) {
  if constexpr (ACT == kGelu) {
    return gelu(__fadd_rn(p, b1));
  } else {
    const float r = fmaxf(p, 0.f);
    return __fadd_rn(__fmul_rn(__fmul_rn(a.s, r), r), a.b);
  }
}

// Two of each staging buffer: xs[b] (rows x kKc: an x or dy slice) and ws[b]
// (kKc x kKc at most: a weight slice).
template <typename T>
struct Stage {
  T* xs[2];
  T* ws[2];
};

// pre = x.w1[:, h0:h0 + hw] for rows t0 .. t0 + R - 1 (rows >= row_end load as
// zeros), streamed through xs (R x kKc) and ws (kKc x hw). Zeroes pre first.
// Ends with a barrier.
template <typename T>
__device__ void product_pre(float* pre, int ldp, const Stage<T>& st, const T* x, const T* w1,
                            const Dims& g, int t0, int row_end, int h0, int hw, int R) {
  constexpr int P = tpad<T>();
  zero_f32(pre, R * ldp);
  pipeline(
      (g.D + kKc - 1) / kKc,
      [&](int k, int b) {
        load_slice(st.xs[b], kKc + P, x, g.D, t0, row_end, k * kKc, g.D, R, kKc);
        load_slice(st.ws[b], hw + P, w1, g.H, k * kKc, g.D, h0, g.H, kKc, hw);
      },
      [&](int, int b) {
        block_mma<true, true>(pre, ldp, st.xs[b], kKc + P, st.ws[b], hw + P, R, hw, kKc);
      });
}

// dh = dy.w2[h0:h0 + hw, :]^T for rows t0 .. t0 + R - 1, streamed through xs
// (R x kKc) and ws (hw x kKc, read as the transposed B). Zeroes dh first. Ends
// with a barrier.
template <typename T>
__device__ void product_dh(float* dh, int ldp, const Stage<T>& st, const T* dy, const T* w2,
                           const Dims& g, int t0, int row_end, int h0, int hw, int R) {
  constexpr int P = tpad<T>();
  zero_f32(dh, R * ldp);
  pipeline(
      (g.D2 + kKc - 1) / kKc,
      [&](int k, int b) {
        load_slice(st.xs[b], kKc + P, dy, g.D2, t0, row_end, k * kKc, g.D2, R, kKc);
        load_slice(st.ws[b], kKc + P, w2, g.D2, h0, g.H, k * kKc, g.D2, hw, kKc);
      },
      [&](int, int b) {
        block_mma<true, false>(dh, ldp, st.xs[b], kKc + P, st.ws[b], kKc + P, R, hw, kKc);
      });
}

// The kTm rows r0 .. of a block's fp32 output tile (ld ldo) as the result:
// (+ bias) and rounded into out (T, N) when the block covers every hidden
// column (gridDim.y == 1); else as fp32 partials into part[blockIdx.y] (T, N),
// which mlp_split_reduce_kernel sums.
template <typename T, bool BIAS>
__device__ void store_rows(const float* acc, int ldo, const T* __restrict__ bias,
                           T* __restrict__ out, float* __restrict__ part, int rows, int N, int r0) {
  for (int i = threadIdx.x; i < kTm * N; i += kThreads) {
    const int r = i / N, c = i - r * N;
    if (r0 + r >= rows) continue;
    const long long at = (long long)(r0 + r) * N + c;
    float v = acc[r * ldo + c];
    if (gridDim.y > 1) {
      part[blockIdx.y * (long long)rows * N + at] = v;
      continue;
    }
    if constexpr (BIAS) v = __fadd_rn(v, to_f32<T>(bias[c]));
    out[at] = from_f32<T>(v);
  }
}

// out[i] = round(sum over the splits, in order, of part[split][i] (+ bias));
// n = rows x cols
template <typename T, bool BIAS>
__global__ void mlp_split_reduce_kernel(const float* __restrict__ part, const T* __restrict__ bias,
                                        T* __restrict__ out, int splits, long long n, int cols) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float v = part[i];
  for (int k = 1; k < splits; ++k) v += part[k * n + i];
  if constexpr (BIAS) v = __fadd_rn(v, to_f32<T>(bias[i % cols]));
  out[i] = from_f32<T>(v);
}

// ---------------------------------------------------------------------------
// forward, fp32: a block per (kTm token rows, hidden split)
// ---------------------------------------------------------------------------

int fwd_smem_bytes(int D2, int tsize) {
  const int P = 16 / tsize;
  return 4 * kTm * (round_up(D2, kNc) + kFpad) + 4 * kTm * (kHc + kFpad) +
         tsize * (3 * kTm * (kHc + P) + 2 * kKc * (kHc + P));
}

template <typename T, int ACT>
__global__ void __launch_bounds__(kThreads)
    mlp_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w1, ActPtrs<T> ap,
                   const T* __restrict__ w2, const T* __restrict__ b2, T* __restrict__ y,
                   float* __restrict__ part, Dims g, int split_cols) {
  constexpr int P = tpad<T>();
  const ActArgs<T> act = act_args(ap);
  extern __shared__ __align__(128) unsigned char smem[];
  const int ldo = round_up(g.D2, kNc) + kFpad;
  float* acc = reinterpret_cast<float*>(smem);  // kTm x ldo: the output tile
  float* pre = acc + kTm * ldo;                  // kTm x (kHc + kFpad)
  T* hs = reinterpret_cast<T*>(pre + kTm * (kHc + kFpad));  // kTm x (kHc + P)
  T* stage = hs + kTm * (kHc + P);  // two kTm x (kKc + P), then two kKc x (kHc + P)
  const Stage<T> st{{stage, stage + kTm * (kKc + P)},
                    {stage + 2 * kTm * (kKc + P), stage + 2 * kTm * (kKc + P) + kKc * (kHc + P)}};
  const int r0 = blockIdx.x * kTm, h_begin = static_cast<int>(blockIdx.y) * split_cols;
  const int h_end = min(g.H, h_begin + split_cols);

  zero_f32(acc, kTm * ldo);
  for (int h0 = h_begin; h0 < h_end; h0 += kHc) {
    product_pre<T>(pre, kHc + kFpad, st, x, w1, g, r0, g.T, h0, kHc, kTm);
    for (int i = threadIdx.x; i < kTm * kHc; i += kThreads) {
      const int r = i / kHc, c = i - r * kHc;
      float h = 0.f;
      if (h0 + c < g.H)
        h = fwd_act<T, ACT>(pre[r * (kHc + kFpad) + c], b1_at<T, ACT>(act, h0 + c), act);
      hs[r * (kHc + P) + c] = from_f32<T>(h);
    }
    // acc[:, n0:n0 + kNc] += h . w2[h0:h0 + kHc, n0:n0 + kNc], slice by slice
    pipeline(
        (g.D2 + kNc - 1) / kNc,
        [&](int n, int b) {
          load_slice(st.ws[b], kNc + P, w2, g.D2, h0, g.H, n * kNc, g.D2, kHc, kNc);
        },
        [&](int n, int b) {
          block_mma<true, true>(acc + n * kNc, ldo, hs, kHc + P, st.ws[b], kNc + P, kTm, kNc,
                                   kHc);
        });
  }
  store_rows<T, ACT == kGelu>(acc, ldo, b2, y, part, g.T, g.D2, r0);
}

// ---------------------------------------------------------------------------
// backward (1): dx, a block per (kTm token rows, hidden split)
// ---------------------------------------------------------------------------

int dx_smem_bytes(int D, int tsize) {
  const int P = 16 / tsize;
  return 4 * kTm * (round_up(D, kNc) + kFpad) + 8 * kTm * (kHc + kFpad) +
         tsize * (3 * kTm * (kHc + P) + 2 * kKc * (kHc + P));
}

// dpre of a hidden column from its pre-activation p (fp32 product), dh and
// b1 (b1_at); K10 also returns r^2 for ds
template <typename T, int ACT>
__device__ __forceinline__ float bwd_act(float p, float dh, float b1, const ActArgs<T>& a,
                                         float* h, float* r2) {
  if constexpr (ACT == kGelu) {
    // gelu(p) and dgelu(p) with one erf: the same roundings as theirs
    p = __fadd_rn(p, b1);
    const float onep = __fadd_rn(1.0f, erff(__fmul_rn(p, kInvSqrt2)));
    *h = __fmul_rn(__fmul_rn(p, 0.5f), onep);
    *r2 = 0.f;
    const float pdf = __fmul_rn(expf(__fmul_rn(__fmul_rn(-0.5f, p), p)), kInvSqrt2Pi);
    return __fmul_rn(dh, __fadd_rn(__fmul_rn(0.5f, onep), __fmul_rn(p, pdf)));
  } else {
    const float r = fmaxf(p, 0.f);
    *r2 = __fmul_rn(r, r);
    *h = __fadd_rn(__fmul_rn(a.s, *r2), a.b);
    return __fmul_rn(dh, __fmul_rn(__fmul_rn(2.f, a.s), r));
  }
}

template <typename T, int ACT>
__global__ void __launch_bounds__(kThreads)
    mlp_bwd_dx_kernel(const T* __restrict__ x, const T* __restrict__ dy, const T* __restrict__ w1,
                      ActPtrs<T> ap, const T* __restrict__ w2, T* __restrict__ dx,
                      float* __restrict__ part, Dims g, int split_cols) {
  constexpr int P = tpad<T>();
  const ActArgs<T> act = act_args(ap);
  extern __shared__ __align__(128) unsigned char smem[];
  const int ldo = round_up(g.D, kNc) + kFpad;
  float* acc = reinterpret_cast<float*>(smem);  // kTm x ldo: the dx tile
  float* pre = acc + kTm * ldo;                  // kTm x (kHc + kFpad)
  float* dh = pre + kTm * (kHc + kFpad);         // kTm x (kHc + kFpad)
  T* ps = reinterpret_cast<T*>(dh + kTm * (kHc + kFpad));  // kTm x (kHc + P): round(dpre)
  T* stage = ps + kTm * (kHc + P);  // two kTm x (kKc + P), then two 64 x (64 + P)
  const Stage<T> st{{stage, stage + kTm * (kKc + P)},
                    {stage + 2 * kTm * (kKc + P), stage + 2 * kTm * (kKc + P) + kKc * (kHc + P)}};
  const int r0 = blockIdx.x * kTm, h_begin = static_cast<int>(blockIdx.y) * split_cols;
  const int h_end = min(g.H, h_begin + split_cols);

  zero_f32(acc, kTm * ldo);
  for (int h0 = h_begin; h0 < h_end; h0 += kHc) {
    product_pre<T>(pre, kHc + kFpad, st, x, w1, g, r0, g.T, h0, kHc, kTm);
    product_dh<T>(dh, kHc + kFpad, st, dy, w2, g, r0, g.T, h0, kHc, kTm);
    for (int i = threadIdx.x; i < kTm * kHc; i += kThreads) {
      const int r = i / kHc, c = i - r * kHc;
      float h, r2, d = 0.f;
      if (h0 + c < g.H)
        d = bwd_act<T, ACT>(pre[r * (kHc + kFpad) + c], dh[r * (kHc + kFpad) + c],
                            b1_at<T, ACT>(act, h0 + c), act, &h, &r2);
      ps[r * (kHc + P) + c] = from_f32<T>(d);
    }
    // dx += round(dpre) . w1[n0:n0 + kNc, h0:h0 + kHc]^T, slice by slice
    pipeline(
        (g.D + kNc - 1) / kNc,
        [&](int n, int b) {
          load_slice(st.ws[b], kHc + P, w1, g.H, n * kNc, g.D, h0, g.H, kNc, kHc);
        },
        [&](int n, int b) {
          block_mma<true, false>(acc + n * kNc, ldo, ps, kHc + P, st.ws[b], kHc + P, kTm, kNc,
                                    kHc);
        });
  }
  store_rows<T, false>(acc, ldo, nullptr, dx, part, g.T, g.D, r0);
}

// ---------------------------------------------------------------------------
// backward (2): the weight gradients' partials, a block per (hidden chunk,
// token segment); (3) their reduction
// ---------------------------------------------------------------------------

struct Plan {
  int splits;    // hidden splits of the fp32 forward and dx kernels (1: no partials)
  int split_cols;  // hidden columns a split (a multiple of kHc)
  int hw;        // hidden columns a chunk of the dW kernel (0: the widths do not fit)
  int tw;        // token rows a step of the dW kernel
  int chunks;    // H / hw, rounded up
  int seg_rows;  // token rows a segment (a multiple of tw)
  int segments;
  long long L0;  // D.H + H.D2 + H + D2: the floats of one segment's partials before ds/db
  long long L;   // L0 + 2 chunks: one segment's partials
};

int dw_smem_bytes(int D, int D2, int hw, int tw, int tsize) {
  const int P = 16 / tsize;
  return 4 * (round_up(D, kKc) * (hw + kFpad) + hw * (round_up(D2, kNc) + kFpad) +
              2 * tw * (hw + kFpad) + round_up(D2, kNc) + 2 * kWarps) +
         tsize * (2 * tw * (hw + P) + 2 * tw * (kKc + P) + 2 * kKc * (kKc + P));
}

Plan make_plan(const Dims& g, int tsize, int sms) {
  Plan p;
  // the dW kernel's (hidden columns, token rows) a step: the largest product
  // whose tiles fit (each block's barrier-separated steps are the cost; a
  // larger step does more tensor-core work between barriers)
  const int shapes[][2] = {{64, 128}, {64, 64}, {32, 128}, {32, 64}, {16, 128},
                           {16, 64},  {32, 32}, {16, 32}};
  p.hw = 0;
  p.tw = 32;
  for (const auto& hwtw : shapes)
    if (g.H % hwtw[0] == 0 && dw_smem_bytes(g.D, g.D2, hwtw[0], hwtw[1], tsize) <= kMaxSmem) {
      p.hw = hwtw[0];
      p.tw = hwtw[1];
      break;
    }
  const int hw = p.hw > 0 ? p.hw : 16;
  p.chunks = (g.H + hw - 1) / hw;
  const int want = (2 * sms + p.chunks - 1) / p.chunks;  // segments for ~2 blocks an SM
  const int tiles = (g.T + p.tw - 1) / p.tw;
  const int segs = want < tiles ? want : tiles;
  p.seg_rows = ((tiles + segs - 1) / segs) * p.tw;
  p.segments = (g.T + p.seg_rows - 1) / p.seg_rows;
  p.L0 = (long long)g.D * g.H + (long long)g.H * g.D2 + g.H + g.D2;
  p.L = p.L0 + 2LL * p.chunks;
  // the fp32 forward and dx kernels: as many hidden splits as fill one wave of
  // blocks where the token tiles alone do not (few tokens, as at B=1; more
  // splits than that measured slower at CAFormer-b36's stage 2)
  const int row_blocks = (g.T + kTm - 1) / kTm, hchunks = (g.H + kHc - 1) / kHc;
  int want_splits = (sms + row_blocks - 1) / row_blocks;
  want_splits = want_splits < 1 ? 1 : (want_splits > hchunks ? hchunks : want_splits);
  p.split_cols = ((hchunks + want_splits - 1) / want_splits) * kHc;
  p.splits = (g.H + p.split_cols - 1) / p.split_cols;
  return p;
}

// the fp32 scratch (floats) of a forward (split partials) or a backward (the
// dW partials, then the dx split partials)
long long scratch_floats(const Plan& p, const Dims& g, bool backward) {
  const long long split = p.splits > 1 ? (long long)p.splits * g.T * (backward ? g.D : g.D2) : 0;
  return backward ? p.segments * p.L + split : split;
}

// block-wide sum of v in a fixed order (warp shuffles, then warp 0 over the
// warps); red holds kWarps floats. Every thread gets the sum.
__device__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
  for (int w = 0; w < kWarps; ++w) s += red[w];
  return s;
}

template <typename T, int ACT>
__global__ void __launch_bounds__(kThreads)
    mlp_bwd_dw_kernel(const T* __restrict__ x, const T* __restrict__ dy, const T* __restrict__ w1,
                      ActPtrs<T> ap, const T* __restrict__ w2, float* __restrict__ part, Dims g,
                      Plan plan) {
  constexpr int P = tpad<T>();
  const ActArgs<T> act = act_args(ap);
  extern __shared__ __align__(128) unsigned char smem[];
  const int hw = plan.hw, tw = plan.tw, chunk = blockIdx.x, seg = blockIdx.y;
  const int h0 = chunk * hw;
  const int t_begin = seg * plan.seg_rows;
  const int t_end = min(g.T, t_begin + plan.seg_rows);
  const int Dp = round_up(g.D, kKc), ld2 = round_up(g.D2, kNc) + kFpad, ldp = hw + kFpad;
  float* acc1 = reinterpret_cast<float*>(smem);  // Dp x ldp: dw1[:, h0:h0 + hw]
  float* acc2 = acc1 + Dp * ldp;                  // hw x ld2: dw2[h0:h0 + hw, :]
  float* pre = acc2 + hw * ld2;                   // tw x ldp
  float* dh = pre + tw * ldp;                     // tw x ldp, then dpre
  float* b2acc = dh + tw * ldp;                   // round_up(D2, kNc): db2 (chunk 0)
  float* red = b2acc + round_up(g.D2, kNc);       // kWarps
  T* hs = reinterpret_cast<T*>(red + 2 * kWarps);  // tw x (hw + P): round(h)
  T* ps = hs + tw * (hw + P);                      // tw x (hw + P): round(dpre)
  T* stage = ps + tw * (hw + P);  // two tw x (kKc + P), then two kKc x (kKc + P)
  const Stage<T> st{{stage, stage + tw * (kKc + P)},
                    {stage + 2 * tw * (kKc + P), stage + 2 * tw * (kKc + P) + kKc * (kKc + P)}};

  zero_f32(acc1, Dp * ldp);
  zero_f32(acc2, hw * ld2);
  zero_f32(b2acc, round_up(g.D2, kNc));
  float col = 0.f, ds = 0.f, db = 0.f;  // db1 of column threadIdx.x (< hw); K10's terms
  for (int t0 = t_begin; t0 < t_end; t0 += tw) {
    product_pre<T>(pre, ldp, st, x, w1, g, t0, t_end, h0, hw, tw);
    product_dh<T>(dh, ldp, st, dy, w2, g, t0, t_end, h0, hw, tw);
    for (int i = threadIdx.x; i < tw * hw; i += kThreads) {
      const int r = i / hw, c = i - r * hw;
      float h = 0.f, r2 = 0.f, d = 0.f;
      const float dhv = dh[r * ldp + c];
      if (h0 + c < g.H)
        d = bwd_act<T, ACT>(pre[r * ldp + c], dhv, b1_at<T, ACT>(act, h0 + c), act, &h, &r2);
      if constexpr (ACT == kStar) {
        ds = __fadd_rn(ds, __fmul_rn(dhv, r2));
        db = __fadd_rn(db, dhv);
      }
      hs[r * (hw + P) + c] = from_f32<T>(h);
      ps[r * (hw + P) + c] = from_f32<T>(d);
      dh[r * ldp + c] = d;
    }
    __syncthreads();
    if (threadIdx.x < hw)
      for (int r = 0; r < tw; ++r) col = __fadd_rn(col, dh[r * ldp + threadIdx.x]);
    // dw1[m0:m0 + kKc, chunk] += x[:, m0:m0 + kKc]^T . round(dpre)
    pipeline(
        (g.D + kKc - 1) / kKc,
        [&](int m, int b) {
          load_slice(st.xs[b], kKc + P, x, g.D, t0, t_end, m * kKc, g.D, tw, kKc);
        },
        [&](int m, int b) {
          block_mma<false, true>(acc1 + m * kKc * ldp, ldp, st.xs[b], kKc + P, ps, hw + P, kKc,
                                    hw, tw);
        });
    // dw2[chunk, n0:n0 + kNc] += round(h)^T . dy[:, n0:n0 + kNc]; db2 in chunk 0
    pipeline(
        (g.D2 + kNc - 1) / kNc,
        [&](int n, int b) {
          load_slice(st.xs[b], kNc + P, dy, g.D2, t0, t_end, n * kNc, g.D2, tw, kNc);
        },
        [&](int n, int b) {
          const T* ys = st.xs[b];
          if (chunk == 0 && threadIdx.x < kNc) {
            float s = b2acc[n * kNc + threadIdx.x];
            for (int r = 0; r < tw; ++r)
              s = __fadd_rn(s, to_f32<T>(ys[r * (kNc + P) + threadIdx.x]));
            b2acc[n * kNc + threadIdx.x] = s;
          }
          block_mma<false, true>(acc2 + n * kNc, ld2, hs, hw + P, ys, kNc + P, hw, kNc, tw);
        });
  }
  ds = block_sum(ds, red);
  db = block_sum(db, red);

  float* out = part + seg * plan.L;
  for (int i = threadIdx.x; i < g.D * hw; i += kThreads) {
    const int d = i / hw, c = i - d * hw;
    if (h0 + c < g.H) out[(long long)d * g.H + h0 + c] = acc1[d * ldp + c];
  }
  float* out2 = out + (long long)g.D * g.H;
  for (int i = threadIdx.x; i < hw * g.D2; i += kThreads) {
    const int c = i / g.D2, n = i - c * g.D2;
    if (h0 + c < g.H) out2[(long long)(h0 + c) * g.D2 + n] = acc2[c * ld2 + n];
  }
  float* outb1 = out2 + (long long)g.H * g.D2;
  if (threadIdx.x < hw && h0 + threadIdx.x < g.H) outb1[h0 + threadIdx.x] = col;
  if (chunk == 0)
    for (int n = threadIdx.x; n < g.D2; n += kThreads) outb1[g.H + n] = b2acc[n];
  if (threadIdx.x == 0) {
    out[plan.L0 + 2 * chunk] = ds;
    out[plan.L0 + 2 * chunk + 1] = db;
  }
}

// out[i] = sum over segments of part[seg][i] for i < L0, in segment order;
// out[L0 + j] = sum over segments, then chunks, of the ds (j = 0) and db
// (j = 1) partials
__global__ void mlp_bwd_reduce_kernel(const float* __restrict__ part, float* __restrict__ out,
                                      Plan plan) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < plan.L0) {
    float s = 0.f;
    for (int k = 0; k < plan.segments; ++k) s += part[k * plan.L + i];
    out[i] = s;
  }
  if (i < 2) {
    float s = 0.f;
    for (int k = 0; k < plan.segments; ++k)
      for (int c = 0; c < plan.chunks; ++c) s += part[k * plan.L + plan.L0 + 2 * c + i];
    out[plan.L0 + i] = s;
  }
}

// ---------------------------------------------------------------------------
// backward, bf16, on the tensor cores: five products, accumulators in
// registers (wgmma: warpgroup matrix multiply-accumulate from shared memory)
//   (A) mlp_bwd_act_wgmma_kernel: a block per (128 token rows, 64 hidden
//       columns) computes pre = x.w1 and dh = dy.w2^T once each, applies the
//       activation in registers, writes round(h) and round(dpre) as bf16
//       (T, H) planes, and per-block partials of db1 (from the fp32 dpre)
//       or of K10's ds and db (from fp32 terms);
//   (B) mlp_bwd_dx_wgmma_kernel: dx = round(round(dpre).w1^T), a block per
//       (128 token rows, 128 columns of D);
//   (C) mlp_bwd_dw_wgmma_kernel: dw1 = x^T.round(dpre) and dw2 =
//       round(h)^T.dy, a block per (128 x 128 output tile, token segment);
//       the token rows are split into segments only where the output tiles
//       are too few to fill the card, each writing fp32 partials; the dw2
//       blocks of hidden rows 0..127 also sum dy's columns (db2) from the
//       staged tiles;
//   (D) mlp_bwd_colsum_kernel: every partial summed over its rows in a
//       fixed order (contiguous row ranges, then the ranges in order).
// Operand tiles are 64 deep (one 128-byte swizzle row of bf16) and stream
// through a ring of cp.async stages (wgmma_ring), one barrier a step. No
// TMA: the loads are plain cp.async into the swizzled layout. No atomics:
// two calls give the same bits.
// ---------------------------------------------------------------------------

constexpr int kActM = 128, kActN = 64;  // (A): token rows x hidden columns a block
constexpr int kGemm = 128;              // (B), (C): output rows and columns a block

// Where the bf16 backward's scratch goes (floats; each part 16-byte aligned):
// the two (T, H) bf16 planes, the db1 partials (a row per token tile of
// (A)), K10's (ds, db) partials (a pair per block of (A)), the db2 partials
// (a row per segment of (C)), and the dW partials (segments x (D.H + H.D2),
// only where the tokens are split)
struct Bf16Plan {
  int act_m, act_n;    // (A)'s grid: token tiles, hidden tiles
  int tiles1, tiles2;  // (C)'s output tiles of dw1 and of dw2
  int segments, seg_rows;
  long long b1, sb, b2, dw, total;  // offsets (the planes at 0) and size
};

long long round4(long long n) { return (n + 3) / 4 * 4; }

Bf16Plan make_bf16_plan(const Dims& g, int sms) {
  Bf16Plan p;
  p.act_m = (g.T + kActM - 1) / kActM;
  p.act_n = (g.H + kActN - 1) / kActN;
  const int dt = (g.D + kGemm - 1) / kGemm, ht = (g.H + kGemm - 1) / kGemm;
  p.tiles1 = dt * ((g.H + kGemm - 1) / kGemm);
  p.tiles2 = ht * ((g.D2 + kGemm - 1) / kGemm);
  // token segments for about two blocks an SM where the tiles are few
  constexpr int kSegStep = 64;  // token rows a step of (C)
  const int tiles = p.tiles1 + p.tiles2, steps = (g.T + kSegStep - 1) / kSegStep;
  int want = (2 * sms + tiles / 2) / tiles;
  want = want < 1 ? 1 : (want > steps ? steps : want);
  p.seg_rows = (steps + want - 1) / want * kSegStep;
  p.segments = (g.T + p.seg_rows - 1) / p.seg_rows;
  const long long L = (long long)g.D * g.H + (long long)g.H * g.D2;
  p.b1 = round4((long long)g.T * g.H);  // two bf16 planes
  p.sb = p.b1 + round4((long long)p.act_m * g.H);
  p.b2 = p.sb + round4(2LL * p.act_m * p.act_n);
  p.dw = p.b2 + round4((long long)p.segments * g.D2);
  p.total = p.dw + (p.segments > 1 ? p.segments * L : 0);
  return p;
}

// d (the warpgroup's 64 x N fp32 accumulator fragment: warp w holds rows
// 16 w + g and 16 w + g + 8, d[4 j + 2 e + u] at row 16 w + g + 8 e, column
// 8 j + 2 t + u) += A (64 x 16) . B (16 x N), both read from shared memory
// through their descriptors; TA and TB: 1 where the operand is MN-major
// (transposed), 0 where K-major
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], unsigned long long da,
                                                 unsigned long long db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
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
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// (scale_d = 0: d = A . B, the old d ignored)
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], unsigned long long da,
                                                 unsigned long long db, int scale_d = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n192k16(float (&d)[96], unsigned long long da,
                                                 unsigned long long db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, %96, %97, p, 1, 1, %99, %100;\n}\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], unsigned long long da,
                                                 unsigned long long db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, %131, %132;\n}\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// d += A . B through the widest product of a 64 x 64 NB fragment (NB 64-column
// blocks: m64n(64 NB)k16), d laid out as wgmma_m64n128k16's
template <int NB, int TA, int TB>
__device__ __forceinline__ void wgmma_m64nk16(float (&d)[32 * NB], unsigned long long da,
                                              unsigned long long db) {
  if constexpr (NB == 1) wgmma_m64n64k16<TA, TB>(d, da, db);
  else if constexpr (NB == 2) wgmma_m64n128k16<TA, TB>(d, da, db);
  else if constexpr (NB == 3) wgmma_m64n192k16<TA, TB>(d, da, db);
  else wgmma_m64n256k16<TA, TB>(d, da, db);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// makes this thread's shared-memory writes (cp.async, st.shared) visible to
// the async proxy that wgmma reads through
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// ties the accumulators to the surrounding wgmma instructions, so that the
// compiler moves no access to them across an issue or a wait
template <int N>
__device__ __forceinline__ void wgmma_hold(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// A wgmma shared-memory descriptor with 128-byte swizzling: the start
// address and the leading and stride byte offsets, in 16-byte units
__device__ __forceinline__ unsigned long long wgmma_desc(unsigned addr, unsigned lbo,
                                                         unsigned sbo) {
  return (unsigned long long)((addr & 0x3FFFFu) >> 4) | ((unsigned long long)(lbo >> 4) << 16) |
         ((unsigned long long)(sbo >> 4) << 32) | (1ull << 62);
}

// dst (1024-byte aligned) = R rows x 64 bf16 (128 bytes a row) of the
// row-major src (row stride lds) from row r0 and column c0, zero at rows >=
// rows and columns >= cols, in the 128-byte swizzle wgmma reads: row r at r
// * 128 bytes, its 16-byte chunk c at chunk c ^ (r % 8); cp.async
template <int R, int NT>
__device__ __forceinline__ void stage_sw128(unsigned char* __restrict__ dst,
                                            const bf16* __restrict__ src, long long lds, int r0,
                                            int rows, int c0, int cols) {
  static_assert((R * 8) % NT == 0, "chunks a thread");
#pragma unroll
  for (int j = 0; j < R * 8 / NT; ++j) {
    const int i = threadIdx.x + j * NT;
    const int r = i >> 3, c = i & 7;
    unsigned char* d = dst + r * 128 + ((c ^ (r & 7)) << 4);
    if (r0 + r < rows && c0 + 8 * c < cols)
      cp_async16(d, src + (long long)(r0 + r) * lds + c0 + 8 * c);
    else
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
  }
}

// (B) and (C) on wgmma: a block of two warpgroups takes a 128 x 128 output
// tile, each warpgroup 64 rows (m64n128k16, 64 fp32 accumulators a thread);
// 128 x 64 bf16 operand tiles (16 KB each) stream kWgStages deep by
// cp.async, one barrier and one committed group of four wgmma a step
constexpr int kWgThreads = 256;
constexpr int kWgBk = 64;  // K depth of a step: one 128-byte swizzle row
constexpr int kWgStages = 3;  // (B), (C): loads two steps ahead, groups done within a step
constexpr int kWgOperand = 128 * kWgBk * 2;  // bytes of one operand's tile
constexpr int kWgSmem = kWgStages * 2 * kWgOperand + 1024;  // + the 1024-byte alignment

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024u - (smem_u32(p) & 1023u)) & 1023u);
}

// steps of load(step, slot), then compute(step, slot), which issues and
// commits one wgmma group, over an S-deep ring whose loads run AHEAD steps
// ahead. Each step's tiles are fenced for the async proxy before the
// barrier; where AHEAD <= S - 2 one wgmma group stays in flight past its
// step (the slot being loaded is then neither this step's nor the last
// one's), else each group completes within its step. The buffers are free
// when it returns.
template <int S, int AHEAD, typename Load, typename Compute>
__device__ __forceinline__ void wgmma_ring(int steps, Load load, Compute compute) {
  static_assert(AHEAD >= 1 && AHEAD <= S - 1, "ring depth");
#pragma unroll
  for (int s = 0; s < AHEAD; ++s) {
    if (s < steps) load(s, s);
    cp_async_commit();
  }
  for (int k = 0; k < steps; ++k) {
    cp_async_wait<AHEAD - 1>();
    fence_async_smem();
    __syncthreads();
    const int next = k + AHEAD;
    if (next < steps) load(next, next % S);
    cp_async_commit();
    compute(k, k % S);
    wgmma_wait<AHEAD <= S - 2 ? 1 : 0>();
  }
  wgmma_wait<0>();
  cp_async_wait<0>();
  __syncthreads();
}

// ---------------------------------------------------------------------------
// forward, bf16, on the tensor cores: mlp_fwd_wgmma_kernel
//   A block of two warpgroups takes 64 token rows, the hidden columns of its
//   split (all of them unless the batch is small) and a slice of y's columns
//   (all of them up to 512). Its x rows are staged once, whole (64 x D,
//   K-major). Then for each chunk of 128 hidden columns:
//     pre: warpgroup w computes pre[:, 64 w .. 64 w + 63] = x . w1[:, chunk]
//          (m64n64k16, w1 MN-major), 32 fp32 accumulators a thread;
//     the activation on that fragment in registers (K9: + b1, erf GELU; K10:
//          StarReLU), round(h) into the chunk's (64 x 128) swizzled bf16 tile;
//     y:   warpgroup w adds h . w2[chunk, its 64 NB columns] to its 32 NB fp32
//          accumulators (m64n(64 NB)k16, h K-major, w2 MN-major).
//   Every tile comes by TMA (tensor maps of x, w1 and w2, 128-byte swizzle,
//   zeros past the edges), which one thread requests: each step brings a
//   slice of w1 (FwdCfg::kPr rows) or of w2 (kYk rows), up to kSlot bytes,
//   into a ring of kFwdStages stages, two steps ahead, its arrival counted on
//   the stage's mbarrier; one wgmma group stays in flight past its step. A
//   step costs a barrier and its bookkeeping at 8 warps an SM, which bound the
//   kernel more than its products, so the steps are large: 32 KB from D = 256
//   up to D = 512, where they fit beside x's rows; 16 KB below D = 256, where
//   two blocks an SM fit, and above D = 512. The weights
//   come from L2 once per 64 token rows (~4 MB at CAFormer-b36's stage 2).
//   The epilogue adds K9's b2 and casts once, or writes fp32 partials where
//   the hidden columns are split.
// ---------------------------------------------------------------------------

constexpr int kFwdM = 64;       // token rows a block
constexpr int kFwdHc = 128;     // hidden columns a chunk: 64 a warpgroup
constexpr int kFwdMaxNb = 4;    // 64-column y blocks a warpgroup: 128 accumulators a thread
constexpr int kFwdStages = 4;

// a step's size (BIG: 32 KB, else 16 KB): the rows of w1 a pre step (kPr:
// two 64-column blocks) and of w2 a y step (kYk: 2 NB 64-column blocks, a
// multiple of 16 up to the 128 of a chunk)
template <int NB, bool BIG>
struct FwdCfg {
  static constexpr int kSlot = BIG ? 32768 : 16384;
  static constexpr int kPr = kSlot / (2 * 64 * 2);
  static constexpr int kYk = kSlot / (2 * NB * 64 * 2) / 16 * 16;
  static_assert(kYk >= 16 && kFwdHc % kYk == 0, "y steps tile a chunk");
};

// the ring, round(h), x (rows padded to a multiple of the pre step's), then
// the kFwdStages + 1 mbarriers (+ the 1024-byte alignment)
int fwd_wgmma_smem(int D, bool big) {
  const int slot = big ? 32768 : 16384, pr = slot / 256;
  return 1024 + kFwdStages * slot + 2 * 8192 + 128 * round_up(D, pr) + 128;
}

// The bf16 forward's grid: hidden splits, y column slices, the 64-column
// blocks a warpgroup takes and the step size
struct FwdPlan {
  int splits, split_cols, slices, nb;
  bool big;
};

FwdPlan make_fwd_plan(const Dims& g, int sms) {
  FwdPlan p;
  const int nb64 = (g.D2 + 63) / 64;
  p.slices = (nb64 + 2 * kFwdMaxNb - 1) / (2 * kFwdMaxNb);
  p.nb = (nb64 + 2 * p.slices - 1) / (2 * p.slices);
  // 16 KB steps below D = 256, where two blocks an SM fit beside small x
  // tiles (measured faster there, and slower from D = 256 on)
  p.big = g.D >= 256 && fwd_wgmma_smem(g.D, true) <= kMaxSmem;
  // hidden splits where the blocks of the token tiles and slices fill less
  // than half the SMs (a small batch); else two where they cut the waves
  // times the chunks a block by a fifth (one and a half waves become three
  // of half the work), which pays for the partials' sum
  const int blocks = ((g.T + kFwdM - 1) / kFwdM) * p.slices;
  const int chunks = (g.H + kFwdHc - 1) / kFwdHc;
  int want = sms / blocks;
  if (want <= 1) {
    const int waves1 = (blocks + sms - 1) / sms, waves2 = (2 * blocks + sms - 1) / sms;
    want = chunks > 1 && 5 * waves2 * ((chunks + 1) / 2) <= 4 * waves1 * chunks ? 2 : 1;
  }
  want = want > chunks ? chunks : want;
  p.split_cols = ((chunks + want - 1) / want) * kFwdHc;
  p.splits = (g.H + p.split_cols - 1) / p.split_cols;
  return p;
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// this thread's arrival on bar, which then also waits for bytes of copies
__device__ __forceinline__ void mbar_expect_tx(unsigned long long* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// until bar's phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
  asm volatile(
      "{\n.reg .pred done;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// the box of map at (column c0, row r0) into dst by TMA, counted on bar
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int c0, int r0,
                                         unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, "
      "{%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<unsigned long long>(map)), "r"(c0), "r"(r0), "r"(smem_u32(bar))
      : "memory");
}

template <int ACT, int NB, bool BIG>
__global__ void __launch_bounds__(kWgThreads, NB <= 2 ? 2 : 1)
    mlp_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_x,
                         const __grid_constant__ CUtensorMap tm_w1,
                         const __grid_constant__ CUtensorMap tm_w2, ActPtrs<bf16> ap,
                         const bf16* __restrict__ b2, bf16* __restrict__ y,
                         float* __restrict__ part, Dims g, int split_cols) {
  using Cfg = FwdCfg<NB, BIG>;
  constexpr int S = kFwdStages, kPr = Cfg::kPr, kYk = Cfg::kYk, kSlot = Cfg::kSlot;
  constexpr int kYsteps = kFwdHc / kYk;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* const ring = align1024(smem_raw);
  unsigned char* const hs = ring + S * kSlot;  // round(h): two 64 x 64 blocks
  unsigned char* const xs = hs + 2 * 8192;     // x: a 64 x 64 block per 64 of D
  const int psteps = (g.D + kPr - 1) / kPr;    // pre steps a chunk
  const int xblocks = psteps * (kPr / 64);     // past D: zeros
  // the ring's S mbarriers, then x's
  unsigned long long* const bars = reinterpret_cast<unsigned long long*>(xs + xblocks * 8192);
  const ActArgs<bf16> act = act_args(ap);
  const int t0 = blockIdx.x * kFwdM, h_begin = static_cast<int>(blockIdx.y) * split_cols;
  const int h_end = min(g.H, h_begin + split_cols);
  const int warp = threadIdx.x >> 5, wg = warp >> 2, wi = warp & 3, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int c0 = blockIdx.z * 128 * NB;  // the block's first y column
  const int cw = c0 + 64 * NB * wg;      // this warpgroup's
  const int chunks = (h_end - h_begin + kFwdHc - 1) / kFwdHc;
  const int per = psteps + kYsteps, steps = chunks * per;

  if (threadIdx.x == 0) {
    for (int i = 0; i <= S; ++i) mbar_init(bars + i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // thread 0 requests the steps in order: pre steps 0.. then y steps 0.. of
  // each chunk; its cursor (chunk's hidden start, step in the chunk, slot)
  int ld_h0 = h_begin, ld_i = 0, ld_slot = 0, ld_left = steps;
  auto issue = [&]() {
    unsigned long long* const bar = bars + ld_slot;
    unsigned char* const a = ring + ld_slot * kSlot;
    if (ld_i < psteps) {  // w1 rows kPr i.., hidden columns ld_h0..ld_h0 + 127
      mbar_expect_tx(bar, kSlot);
      tma_load(a, &tm_w1, ld_h0, kPr * ld_i, bar);
      tma_load(a + kPr * 128, &tm_w1, ld_h0 + 64, kPr * ld_i, bar);
    } else {  // w2 rows ld_h0 + kYk j.., the block's y columns
      mbar_expect_tx(bar, 2 * NB * kYk * 128);
#pragma unroll
      for (int b = 0; b < 2 * NB; ++b)
        tma_load(a + b * kYk * 128, &tm_w2, c0 + 64 * b, ld_h0 + kYk * (ld_i - psteps), bar);
    }
    ld_slot = ld_slot + 1 == S ? 0 : ld_slot + 1;
    if (++ld_i == per) {
      ld_i = 0;
      ld_h0 += kFwdHc;
    }
    --ld_left;
  };
  if (threadIdx.x == 0) {
    mbar_expect_tx(bars + S, xblocks * 8192);  // the x rows
    for (int kb = 0; kb < xblocks; ++kb) tma_load(xs + kb * 8192, &tm_x, 64 * kb, t0, bars + S);
    for (int k = 0; k < S - 2 && ld_left > 0; ++k) issue();
  }
  float pre[32], acc[32 * NB];
#pragma unroll
  for (int i = 0; i < 32; ++i) pre[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32 * NB; ++i) acc[i] = 0.f;
  mbar_wait(bars + S, 0);

  // a step: its stage's data arrived; after the barrier every warpgroup has
  // waited for the wgmma group of two steps back, so the stage thread 0
  // fills now is free. Returns the stage's shared-memory address.
  int slot = 0;
  unsigned phase = 0;
  auto begin_step = [&]() {
    mbar_wait(bars + slot, phase);
    __syncthreads();
    if (threadIdx.x == 0 && ld_left > 0) issue();
    return smem_u32(ring + slot * kSlot);
  };
  auto end_step = [&]() {
    wgmma_wait<1>();
    if (++slot == S) {
      slot = 0;
      phase ^= 1;
    }
  };

  // one loop over the steps, one place that issues wgmma: with the pre and y
  // products in loops of their own, ptxas serialized every wgmma (C7515)
  int hc = h_begin, i = 0;  // the chunk's first hidden column, the step in the chunk
  unsigned b1r[8];  // K9: this thread's b1 pairs of the chunk (K10: zeros, unused)
  for (int k = 0; k < steps; ++k) {
    const unsigned a = begin_step();
    wgmma_hold(pre);
    wgmma_hold(acc);
    wgmma_fence();
    if (i < psteps) {
      // a chunk's first product overwrites pre (scale-d 0): no other
      // instruction writes the accumulators inside the loop
      const unsigned xa = smem_u32(xs + i * (kPr / 64) * 8192);
#pragma unroll
      for (int q = 0; q < kPr / 16; ++q)
        wgmma_m64n64k16<0, 1>(pre, wgmma_desc(xa + (q >> 2) * 8192 + 32 * (q & 3), 16, 1024),
                              wgmma_desc(a + wg * kPr * 128 + 2048 * q, kPr * 128, 1024),
                              i > 0 || q > 0);
    } else {
#pragma unroll
      for (int q = 0; q < kYk / 16; ++q) {
        const int r = (i - psteps) * kYk + 16 * q;  // the chunk's hidden row
        wgmma_m64nk16<NB, 0, 1>(
            acc, wgmma_desc(smem_u32(hs) + (r >> 6) * 8192 + 32 * ((r >> 4) & 3), 16, 1024),
            wgmma_desc(a + wg * NB * kYk * 128 + 2048 * q, kYk * 128, 1024));
      }
    }
    wgmma_commit();
    if (i == 0) {  // K9: the chunk's b1 pairs, read before the pre steps
      const int hw0 = hc + 64 * wg;
#pragma unroll
      for (int jn = 0; jn < 8; ++jn) {
        const int j = hw0 + 8 * jn + 2 * tq;
        b1r[jn] = ACT == kGelu && j < g.H ? *reinterpret_cast<const unsigned*>(act.b1 + j) : 0u;
      }
    }
    if (i == psteps - 1) {
      wgmma_wait<0>();
      wgmma_hold(pre);
      // every warpgroup has waited for its products: the last chunk's y
      // steps no longer read hs
      __syncthreads();
      // round(act(pre)) into this warpgroup's block of hs (0 past H)
      const int hw0 = hc + 64 * wg;
      unsigned char* const hb = hs + wg * 8192;
#pragma unroll
      for (int jn = 0; jn < 8; ++jn) {
        const int j = hw0 + 8 * jn + 2 * tq;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = 16 * wi + gq + 8 * e, q = 4 * jn + 2 * e;
          const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&b1r[jn]));
          const float v0 = j < g.H ? fwd_act<bf16, ACT>(pre[q], b.x, act) : 0.f;
          const float v1 = j + 1 < g.H ? fwd_act<bf16, ACT>(pre[q + 1], b.y, act) : 0.f;
          *reinterpret_cast<unsigned*>(hb + r * 128 + ((jn ^ (r & 7)) << 4) + 4 * tq) =
              pack_bf16(v0, v1);
        }
      }
      fence_async_smem();  // for the y steps' wgmma, after the next barrier
    }
    end_step();
    if (++i == per) {
      i = 0;
      hc += kFwdHc;
    }
  }
  wgmma_wait<0>();
  wgmma_hold(acc);

#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int row = t0 + 16 * wi + gq + 8 * e;
    if (row >= g.T) continue;
#pragma unroll
    for (int j = 0; j < 8 * NB; ++j) {
      const int n = cw + 8 * j + 2 * tq;
      if (n >= g.D2) continue;
      float v0 = acc[4 * j + 2 * e], v1 = acc[4 * j + 2 * e + 1];
      if (gridDim.y > 1) {
        *reinterpret_cast<float2*>(part + ((long long)blockIdx.y * g.T + row) * g.D2 + n) =
            make_float2(v0, v1);
        continue;
      }
      if constexpr (ACT == kGelu) {
        v0 = __fadd_rn(v0, __bfloat162float(b2[n]));
        v1 = __fadd_rn(v1, __bfloat162float(b2[n + 1]));
      }
      *reinterpret_cast<unsigned*>(y + (long long)row * g.D2 + n) = pack_bf16(v0, v1);
    }
  }
}

// (A) on wgmma: a block of two warpgroups takes 128 token rows x 64 hidden
// columns, each warpgroup 64 rows: pre = x.w1 over D (x K-major, the w1
// slice MN-major), then dh = dy.w2^T over D2 (dy and the w2 slice K-major),
// m64n64k16 into 32 + 32 fp32 accumulators a thread; then the activation,
// the planes and the partials as the section's header says
constexpr int kWgActA = kActM * kWgBk * 2;  // x or dy tile: 16 KB
constexpr int kWgActB = kActN * kWgBk * 2;  // w1 or w2 tile: 8 KB
constexpr int kWgActStages = 4;  // (A): loads two steps ahead, one group in flight
constexpr int kWgActSmem = kWgActStages * (kWgActA + kWgActB) + 1024;
// the planes on their way out: 128 x 64 bf16 tiles at a row stride of 16
// bytes more, so a warp's 4-byte writes (eight rows of one column pair) fall
// on distinct banks; each thread then copies 16-byte row chunks
constexpr int kPlaneTileLd = kActN + 8;

template <int ACT>
__global__ void __launch_bounds__(kWgThreads, 2)
    mlp_bwd_act_wgmma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dy,
                             const bf16* __restrict__ w1, ActPtrs<bf16> ap,
                             const bf16* __restrict__ w2, bf16* __restrict__ hplane,
                             bf16* __restrict__ pplane, float* __restrict__ b1part,
                             float* __restrict__ sbpart, Dims g) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* const sm = align1024(smem_raw);
  const ActArgs<bf16> act = act_args(ap);
  const int h0 = blockIdx.x * kActN, t0 = blockIdx.y * 128;
  const int warp = threadIdx.x >> 5, wg = warp >> 2, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;
  float pre[32], dh[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) pre[i] = dh[i] = 0.f;
  const int sd = (g.D + kWgBk - 1) / kWgBk, sd2 = (g.D2 + kWgBk - 1) / kWgBk;
  wgmma_ring<kWgActStages, 2>(
      sd + sd2,
      [&](int s, int slot) {
        unsigned char* a = sm + slot * (kWgActA + kWgActB);
        if (s < sd) {
          stage_sw128<128, kWgThreads>(a, x, g.D, t0, g.T, s * kWgBk, g.D);
          stage_sw128<kWgBk, kWgThreads>(a + kWgActA, w1, g.H, s * kWgBk, g.D, h0, g.H);
        } else {
          const int k0 = (s - sd) * kWgBk;
          stage_sw128<128, kWgThreads>(a, dy, g.D2, t0, g.T, k0, g.D2);
          stage_sw128<kActN, kWgThreads>(a + kWgActA, w2, g.D2, h0, g.H, k0, g.D2);
        }
      },
      [&](int s, int slot) {
        const unsigned a = smem_u32(sm + slot * (kWgActA + kWgActB)), ra = a + wg * 8192;
        wgmma_hold(pre);
        wgmma_hold(dh);
        wgmma_fence();
        if (s < sd) {
#pragma unroll
          for (int k = 0; k < kWgBk / 16; ++k)
            wgmma_m64n64k16<0, 1>(pre, wgmma_desc(ra + 32 * k, 16, 1024),
                                  wgmma_desc(a + kWgActA + 2048 * k, 8192, 1024));
        } else {
#pragma unroll
          for (int k = 0; k < kWgBk / 16; ++k)
            wgmma_m64n64k16<0, 0>(dh, wgmma_desc(ra + 32 * k, 16, 1024),
                                  wgmma_desc(a + kWgActA + 32 * k, 16, 1024));
        }
        wgmma_commit();
      });
  wgmma_hold(pre);
  wgmma_hold(dh);

  // the activation in registers; rows past T have dy = 0, so dh = dpre = 0
  // there, and columns past H have w2 = 0: neither adds to a partial.
  // round(h) and round(dpre) go to the staging tiles hs and ps (the ring is
  // free here)
  bf16* const hs = reinterpret_cast<bf16*>(sm);
  bf16* const ps = hs + 128 * kPlaneTileLd;
  float col[8][2] = {}, ds = 0.f, db = 0.f, bias[8][2];
#pragma unroll
  for (int jn = 0; jn < 8; ++jn)
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int j = h0 + 8 * jn + 2 * tq + u;
      bias[jn][u] = j < g.H ? b1_at<bf16, ACT>(act, j) : 0.f;
    }
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int r = 16 * warp + gq + 8 * e;
#pragma unroll
    for (int jn = 0; jn < 8; ++jn) {
      const int c = 8 * jn + 2 * tq, j = h0 + c;
      float hv[2] = {0.f, 0.f}, dp[2] = {0.f, 0.f};
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const float d = dh[4 * jn + 2 * e + u];
        float r2 = 0.f;
        if (j + u < g.H)
          dp[u] = bwd_act<bf16, ACT>(pre[4 * jn + 2 * e + u], d, bias[jn][u], act, &hv[u], &r2);
        if constexpr (ACT == kStar) {
          ds = __fadd_rn(ds, __fmul_rn(d, r2));
          db = __fadd_rn(db, d);
        } else {
          col[jn][u] = __fadd_rn(col[jn][u], dp[u]);
        }
      }
      *reinterpret_cast<unsigned*>(hs + r * kPlaneTileLd + c) = pack_bf16(hv[0], hv[1]);
      *reinterpret_cast<unsigned*>(ps + r * kPlaneTileLd + c) = pack_bf16(dp[0], dp[1]);
    }
  }
  __syncthreads();
  // rows < T and columns < H of the tiles, 16 bytes (8 columns) a copy
  constexpr int kChunks = kActN / 8;
  for (int i = threadIdx.x; i < 2 * 128 * kChunks; i += kWgThreads) {
    const int plane = i / (128 * kChunks), k = i - plane * 128 * kChunks;
    const int r = k / kChunks, c = (k - r * kChunks) * 8;
    if (t0 + r < g.T && h0 + c < g.H) {
      const bf16* from = (plane ? ps : hs) + r * kPlaneTileLd + c;
      bf16* to = (plane ? pplane : hplane) + (long long)(t0 + r) * g.H + h0 + c;
      *reinterpret_cast<uint4*>(to) = *reinterpret_cast<const uint4*>(from);
    }
  }

  float* red = reinterpret_cast<float*>(ps + 128 * kPlaneTileLd);
  if constexpr (ACT == kStar) {
    static_assert(kWgThreads == kThreads, "block_sum's warps");
    ds = block_sum(ds, red);
    db = block_sum(db, red);
    if (threadIdx.x == 0) {
      const long long at = 2LL * ((long long)blockIdx.y * gridDim.x + blockIdx.x);
      sbpart[at] = ds;
      sbpart[at + 1] = db;
    }
  } else {
    // db1: the column sums over the warp's rows (shuffles over g), then over
    // the eight warps (16 rows each) in order
#pragma unroll
    for (int jn = 0; jn < 8; ++jn)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        float v = col[jn][u];
        v += __shfl_xor_sync(0xffffffffu, v, 4);
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        if (gq == 0) red[warp * kActN + 8 * jn + 2 * tq + u] = v;
      }
    __syncthreads();
    if (threadIdx.x < kActN && h0 + threadIdx.x < g.H) {
      float v = red[threadIdx.x];
      for (int w = 1; w < kWgThreads / 32; ++w) v += red[w * kActN + threadIdx.x];
      b1part[(long long)blockIdx.y * g.H + h0 + threadIdx.x] = v;
    }
  }
}

__global__ void __launch_bounds__(kWgThreads, 2)
    mlp_bwd_dx_wgmma_kernel(const bf16* __restrict__ pplane, const bf16* __restrict__ w1,
                            bf16* __restrict__ dx, Dims g) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* const sm = align1024(smem_raw);
  const int n0 = blockIdx.x * 128, t0 = blockIdx.y * 128;
  const int wg = threadIdx.x >> 7, wi = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  // round(dpre) (tokens x hidden) and w1 (D x hidden): both K-major
  wgmma_ring<kWgStages, 2>(
      (g.H + kWgBk - 1) / kWgBk,
      [&](int s, int slot) {
        unsigned char* a = sm + slot * 2 * kWgOperand;
        stage_sw128<128, kWgThreads>(a, pplane, g.H, t0, g.T, s * kWgBk, g.H);
        stage_sw128<128, kWgThreads>(a + kWgOperand, w1, g.H, n0, g.D, s * kWgBk, g.H);
      },
      [&](int, int slot) {
        const unsigned a = smem_u32(sm + slot * 2 * kWgOperand);
        wgmma_hold(acc);
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < kWgBk / 16; ++k)
          wgmma_m64n128k16<0, 0>(acc, wgmma_desc(a + wg * 8192 + 32 * k, 16, 1024),
                                 wgmma_desc(a + kWgOperand + 32 * k, 16, 1024));
        wgmma_commit();
      });
  wgmma_hold(acc);
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int row = t0 + 64 * wg + 16 * wi + gq + 8 * e;
    if (row >= g.T) continue;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int n = n0 + 8 * j + 2 * tq;
      if (n < g.D)
        *reinterpret_cast<unsigned*>(dx + (long long)row * g.D + n) =
            pack_bf16(acc[4 * j + 2 * e], acc[4 * j + 2 * e + 1]);
    }
  }
}

__global__ void __launch_bounds__(kWgThreads, 2)
    mlp_bwd_dw_wgmma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dy,
                            const bf16* __restrict__ hplane, const bf16* __restrict__ pplane,
                            float* __restrict__ out, float* __restrict__ dwpart,
                            float* __restrict__ b2part, Dims g, int tiles1, int seg_rows) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* const sm = align1024(smem_raw);
  // dw1 = x^T.round(dpre) (D x H) for tiles below tiles1, else dw2 =
  // round(h)^T.dy (H x D2); both operands MN-major (tokens are K)
  const bool first = static_cast<int>(blockIdx.x) < tiles1;
  const int tile = first ? blockIdx.x : blockIdx.x - tiles1;
  const int M = first ? g.D : g.H, N = first ? g.H : g.D2;
  const bf16* A = first ? x : hplane;
  const bf16* B = first ? pplane : dy;
  const int tiles_n = (N + 127) / 128;
  const int m0 = (tile / tiles_n) * 128, n0 = (tile % tiles_n) * 128;
  const int t_begin = blockIdx.y * seg_rows, t_end = min(g.T, t_begin + seg_rows);
  const int wg = threadIdx.x >> 7, wi = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;
  // db2: the dw2 blocks of hidden rows 0..127 sum dy's columns from the
  // staged tiles, thread (column, half) over its 32 rows of each step
  const bool colsum = b2part != nullptr && !first && m0 == 0;
  const int cs_col = threadIdx.x & 127, cs_half = threadIdx.x >> 7;
  float cs = 0.f;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  // a tile is two 64-column blocks of kWgBk token rows (8 KB each)
  wgmma_ring<kWgStages, 2>(
      (t_end - t_begin + kWgBk - 1) / kWgBk,
      [&](int s, int slot) {
        unsigned char* a = sm + slot * 2 * kWgOperand;
        const int r0 = t_begin + s * kWgBk;
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          stage_sw128<kWgBk, kWgThreads>(a + b * 8192, A, M, r0, t_end, m0 + 64 * b, M);
          stage_sw128<kWgBk, kWgThreads>(a + kWgOperand + b * 8192, B, N, r0, t_end,
                                         n0 + 64 * b, N);
        }
      },
      [&](int, int slot) {
        unsigned char* a = sm + slot * 2 * kWgOperand;
        const unsigned sa = smem_u32(a);
        wgmma_hold(acc);
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < kWgBk / 16; ++k)
          wgmma_m64n128k16<1, 1>(acc, wgmma_desc(sa + wg * 8192 + 2048 * k, 8192, 1024),
                                 wgmma_desc(sa + kWgOperand + 2048 * k, 8192, 1024));
        wgmma_commit();
        if (colsum) {
          const unsigned char* bt = a + kWgOperand + (cs_col >> 6) * 8192;
          const int c = cs_col & 63;
          for (int r = 32 * cs_half; r < 32 * cs_half + 32; ++r)
            cs += __bfloat162float(*reinterpret_cast<const bf16*>(
                bt + r * 128 + (((c >> 3) ^ (r & 7)) << 4) + 2 * (c & 7)));
        }
      });
  wgmma_hold(acc);
  const long long L = (long long)g.D * g.H + (long long)g.H * g.D2;
  float* dst = (gridDim.y == 1 ? out : dwpart + blockIdx.y * L) +
               (first ? 0 : (long long)g.D * g.H);
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int m = m0 + 64 * wg + 16 * wi + gq + 8 * e;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int n = n0 + 8 * j + 2 * tq;
      if (n < N)
        *reinterpret_cast<float2*>(dst + (long long)m * N + n) =
            make_float2(acc[4 * j + 2 * e], acc[4 * j + 2 * e + 1]);
    }
  }
  if (colsum) {
    float* red = reinterpret_cast<float*>(sm);  // the ring is free here
    if (cs_half) red[cs_col] = cs;
    __syncthreads();
    if (!cs_half && n0 + cs_col < N)
      b2part[(long long)blockIdx.y * g.D2 + n0 + cs_col] = cs + red[cs_col];
  }
}

// dst[i] = sum over r < rows of src[r * n + i]. Columns go in units of four
// (float4) where n % 4 == 0, else one by one. A block takes cpb units and
// kThreads / cpb fixed, contiguous row ranges of at least 8 rows (as many as
// fit, up to 256 / cpb_min with cpb_min units = 128 bytes a row), each
// summed in ascending order, then the ranges in order.
struct ColSum {
  const float* src;
  float* dst;
  long long n;
  int rows;
};

constexpr int kMaxColSums = 4;

struct ColSums {
  ColSum job[kMaxColSums];
  int jobs;
  unsigned first[kMaxColSums + 1];  // each job's first block
};

// units a block of a column sum takes (a power of two dividing kThreads)
__host__ __device__ inline int colsum_cpb(long long n, int rows) {
  const long long units = n % 4 == 0 ? n / 4 : n;
  int cpb = n % 4 == 0 ? 8 : 32;
  while (cpb > 1 && cpb / 2 >= units) cpb /= 2;
  int groups = 1;
  while (groups * 2 <= kThreads / cpb && groups * 2 * 8 <= rows) groups *= 2;
  return kThreads / groups;
}

__host__ __device__ inline long long colsum_blocks(const ColSum& job) {
  const long long units = job.n % 4 == 0 ? job.n / 4 : job.n;
  const int cpb = colsum_cpb(job.n, job.rows);
  return (units + cpb - 1) / cpb;
}

__global__ void __launch_bounds__(kThreads) mlp_bwd_colsum_kernel(ColSums c) {
  __shared__ float4 red[kThreads];
  int j = 0;
  while (j + 1 < c.jobs && blockIdx.x >= c.first[j + 1]) ++j;
  const ColSum job = c.job[j];
  const bool vec = job.n % 4 == 0;
  const long long units = vec ? job.n / 4 : job.n;
  const int cpb = colsum_cpb(job.n, job.rows);
  const int groups = kThreads / cpb, lane = threadIdx.x % cpb, grp = threadIdx.x / cpb;
  const long long u = (long long)(blockIdx.x - c.first[j]) * cpb + lane;
  const int chunk = (job.rows + groups - 1) / groups;
  const int r_begin = grp * chunk, r_end = min(job.rows, r_begin + chunk);
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  if (u < units) {
    if (vec) {
      const float4* src = reinterpret_cast<const float4*>(job.src) + u;
#pragma unroll 4
      for (int r = r_begin; r < r_end; ++r) {
        const float4 v = src[(long long)r * units];
        s.x += v.x;
        s.y += v.y;
        s.z += v.z;
        s.w += v.w;
      }
    } else {
#pragma unroll 4
      for (int r = r_begin; r < r_end; ++r) s.x += job.src[(long long)r * job.n + u];
    }
  }
  red[threadIdx.x] = s;
  __syncthreads();
  if (grp == 0 && u < units) {
    float4 t = red[lane];
    for (int w = 1; w < groups; ++w) {
      const float4 v = red[w * cpb + lane];
      t.x += v.x;
      t.y += v.y;
      t.z += v.z;
      t.w += v.w;
    }
    if (vec)
      reinterpret_cast<float4*>(job.dst)[u] = t;
    else
      job.dst[u] = t.x;
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

bool bad_dims(const Dims& g) {
  return g.T < 1 || g.D < 16 || g.H < 16 || g.D2 < 16 || g.D % 16 || g.H % 16 || g.D2 % 16 ||
         g.D > 1024 || g.D2 > 1024;
}

int sm_count() {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

template <typename K>
cudaError_t set_smem(K kernel, int bytes) {
  if (bytes > kMaxSmem) return cudaErrorInvalidConfiguration;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// sums a split launch's partials into out (T, N) (+ bias); nothing to do
// without a split
template <typename T, bool BIAS>
cudaError_t reduce_splits(int splits, const float* part, const void* bias, void* out, int rows,
                          int N, cudaStream_t stream) {
  if (splits == 1) return cudaSuccess;
  const long long n = (long long)rows * N;
  mlp_split_reduce_kernel<T, BIAS><<<static_cast<unsigned>((n + kThreads - 1) / kThreads),
                                     kThreads, 0, stream>>>(
      part, static_cast<const T*>(bias), static_cast<T*>(out), splits, n, N);
  return cudaGetLastError();
}

// cuTensorMapEncodeTiled, found through the runtime's entry-point lookup
// (nothing links against libcuda); null where it is not found
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    const bool ok = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                     cudaEnableDefault, &found) == cudaSuccess &&
                    found == cudaDriverEntryPointSuccess;
    return ok ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// map: the row-major bf16 matrix (rows x cols) at base in boxes of box_rows
// rows x 64 columns (128 bytes), 128-byte swizzled as wgmma reads them, zeros
// past the edges
bool tensor_map(CUtensorMap* map, const void* base, int rows, int cols, int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (!fn) return false;
  const cuuint64_t dim[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t stride[1] = {static_cast<cuuint64_t>(cols) * sizeof(bf16)};
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dim, stride, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the bf16 forward at NB 64-column y blocks a warpgroup and BIG (32 KB)
// steps or 16 KB ones, then its split sum
template <int ACT, int NB, bool BIG>
cudaError_t launch_fwd_wgmma(const bf16* x, const bf16* w1, const ActPtrs<bf16>& act,
                             const bf16* w2, const bf16* b2, bf16* y, float* part,
                             const FwdPlan& plan, const Dims& g, cudaStream_t stream) {
  using Cfg = FwdCfg<NB, BIG>;
  CUtensorMap tm_x, tm_w1, tm_w2;
  if (!tensor_map(&tm_x, x, g.T, g.D, kFwdM) || !tensor_map(&tm_w1, w1, g.D, g.H, Cfg::kPr) ||
      !tensor_map(&tm_w2, w2, g.H, g.D2, Cfg::kYk))
    return cudaErrorNotSupported;
  const int smem = fwd_wgmma_smem(g.D, BIG);
  cudaError_t err = set_smem(mlp_fwd_wgmma_kernel<ACT, NB, BIG>, smem);
  if (err != cudaSuccess) return err;
  mlp_fwd_wgmma_kernel<ACT, NB, BIG><<<dim3((g.T + kFwdM - 1) / kFwdM, plan.splits, plan.slices),
                                       kWgThreads, smem, stream>>>(
      tm_x, tm_w1, tm_w2, act, b2, y, part, g, plan.split_cols);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return reduce_splits<bf16, ACT == kGelu>(plan.splits, part, b2, y, g.T, g.D2, stream);
}

template <int ACT, bool BIG>
cudaError_t launch_fwd_nb(const bf16* x, const bf16* w1, const ActPtrs<bf16>& act,
                          const bf16* w2, const bf16* b2, bf16* y, float* part,
                          const FwdPlan& plan, const Dims& g, cudaStream_t stream) {
  switch (plan.nb) {
    case 1: return launch_fwd_wgmma<ACT, 1, BIG>(x, w1, act, w2, b2, y, part, plan, g, stream);
    case 2: return launch_fwd_wgmma<ACT, 2, BIG>(x, w1, act, w2, b2, y, part, plan, g, stream);
    case 3: return launch_fwd_wgmma<ACT, 3, BIG>(x, w1, act, w2, b2, y, part, plan, g, stream);
    default: return launch_fwd_wgmma<ACT, 4, BIG>(x, w1, act, w2, b2, y, part, plan, g, stream);
  }
}

template <typename T, int ACT>
cudaError_t launch_fwd(const void* x, const void* w1, const void* b1, const float* s,
                       const float* b, const void* w2, const void* b2, void* y, float* part,
                       const Dims& g, cudaStream_t stream) {
  ActPtrs<T> act{static_cast<const T*>(b1), s, b};
  if constexpr (std::is_same<T, bf16>::value) {
    const FwdPlan plan = make_fwd_plan(g, sm_count());
    const auto* xb = static_cast<const bf16*>(x);
    const auto* w1b = static_cast<const bf16*>(w1);
    const auto* w2b = static_cast<const bf16*>(w2);
    const auto* b2b = static_cast<const bf16*>(b2);
    auto* yb = static_cast<bf16*>(y);
    if (plan.big)
      return launch_fwd_nb<ACT, true>(xb, w1b, act, w2b, b2b, yb, part, plan, g, stream);
    return launch_fwd_nb<ACT, false>(xb, w1b, act, w2b, b2b, yb, part, plan, g, stream);
  } else {
    const Plan plan = make_plan(g, sizeof(T), sm_count());
    const int smem = fwd_smem_bytes(g.D2, sizeof(T));
    cudaError_t err = set_smem(mlp_fwd_kernel<T, ACT>, smem);
    if (err != cudaSuccess) return err;
    mlp_fwd_kernel<T, ACT><<<dim3((g.T + kTm - 1) / kTm, plan.splits), kThreads, smem, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(w1), act, static_cast<const T*>(w2),
        static_cast<const T*>(b2), static_cast<T*>(y), part, g, plan.split_cols);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    return reduce_splits<T, ACT == kGelu>(plan.splits, part, b2, y, g.T, g.D2, stream);
  }
}

// the bf16 backward: (A), then (B) and (C), then (D); part is the scratch of
// make_bf16_plan's size
template <int ACT>
cudaError_t launch_bwd_bf16(const bf16* x, const bf16* dy, const bf16* w1, const bf16* b1,
                           const float* s, const float* b, const bf16* w2, bf16* dx, float* part,
                           float* out, const Dims& g, cudaStream_t stream) {
  const Bf16Plan plan = make_bf16_plan(g, sm_count());
  bf16* hplane = reinterpret_cast<bf16*>(part);
  bf16* pplane = hplane + (long long)g.T * g.H;
  float* b1part = part + plan.b1;
  float* sbpart = part + plan.sb;
  float* b2part = part + plan.b2;
  cudaError_t err = set_smem(mlp_bwd_act_wgmma_kernel<ACT>, kWgActSmem);
  if (err != cudaSuccess) return err;
  mlp_bwd_act_wgmma_kernel<ACT><<<dim3(plan.act_n, plan.act_m), kWgThreads, kWgActSmem,
                                  stream>>>(
      x, dy, w1, ActPtrs<bf16>{b1, s, b}, w2, hplane, pplane, b1part, sbpart, g);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = set_smem(mlp_bwd_dx_wgmma_kernel, kWgSmem);
  if (err != cudaSuccess) return err;
  mlp_bwd_dx_wgmma_kernel<<<dim3((g.D + 127) / 128, (g.T + 127) / 128), kWgThreads, kWgSmem,
                            stream>>>(pplane, w1, dx, g);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = set_smem(mlp_bwd_dw_wgmma_kernel, kWgSmem);
  if (err != cudaSuccess) return err;
  mlp_bwd_dw_wgmma_kernel<<<dim3(plan.tiles1 + plan.tiles2, plan.segments), kWgThreads, kWgSmem,
                            stream>>>(x, dy, hplane, pplane, out, part + plan.dw,
                                      ACT == kGelu ? b2part : nullptr, g, plan.tiles1,
                                      plan.seg_rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // the fixed-order sums: dW over segments (where split), then K9's db1 over
  // (A)'s token tiles and db2 over segments, or K10's ds and db over (A)'s
  // blocks
  const long long L = (long long)g.D * g.H + (long long)g.H * g.D2;
  ColSums c{};
  c.jobs = 0;
  if (plan.segments > 1) c.job[c.jobs++] = ColSum{part + plan.dw, out, L, plan.segments};
  if (ACT == kGelu) {
    c.job[c.jobs++] = ColSum{b1part, out + L, g.H, plan.act_m};
    c.job[c.jobs++] = ColSum{b2part, out + L + g.H, g.D2, plan.segments};
  } else {
    c.job[c.jobs++] = ColSum{sbpart, out + L + g.H + g.D2, 2, plan.act_m * plan.act_n};
  }
  unsigned blocks = 0;
  for (int j = 0; j < c.jobs; ++j) {
    c.first[j] = blocks;
    blocks += static_cast<unsigned>(colsum_blocks(c.job[j]));
  }
  c.first[c.jobs] = blocks;
  mlp_bwd_colsum_kernel<<<blocks, kThreads, 0, stream>>>(c);
  return cudaGetLastError();
}

template <typename T, int ACT>
cudaError_t launch_bwd(const void* x, const void* dy, const void* w1, const void* b1,
                       const float* s, const float* b, const void* w2, void* dx, float* part,
                       float* out, const Dims& g, cudaStream_t stream) {
  if constexpr (std::is_same<T, bf16>::value)
    return launch_bwd_bf16<ACT>(static_cast<const bf16*>(x), static_cast<const bf16*>(dy),
                               static_cast<const bf16*>(w1), static_cast<const bf16*>(b1), s, b,
                               static_cast<const bf16*>(w2), static_cast<bf16*>(dx), part, out, g,
                               stream);
  else {
    const Plan plan = make_plan(g, sizeof(T), sm_count());
    float* dx_part = part + plan.segments * plan.L;
    ActPtrs<T> act{static_cast<const T*>(b1), s, b};
    int smem = dx_smem_bytes(g.D, sizeof(T));
    cudaError_t err = set_smem(mlp_bwd_dx_kernel<T, ACT>, smem);
    if (err != cudaSuccess) return err;
    mlp_bwd_dx_kernel<T, ACT><<<dim3((g.T + kTm - 1) / kTm, plan.splits), kThreads, smem,
                                stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(dy), static_cast<const T*>(w1), act,
        static_cast<const T*>(w2), static_cast<T*>(dx), dx_part, g, plan.split_cols);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    err = reduce_splits<T, false>(plan.splits, dx_part, nullptr, dx, g.T, g.D, stream);
    if (err != cudaSuccess) return err;
    if (plan.hw == 0) return cudaErrorInvalidValue;
    smem = dw_smem_bytes(g.D, g.D2, plan.hw, plan.tw, sizeof(T));
    err = set_smem(mlp_bwd_dw_kernel<T, ACT>, smem);
    if (err != cudaSuccess) return err;
    mlp_bwd_dw_kernel<T, ACT><<<dim3(plan.chunks, plan.segments), kThreads, smem, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(dy), static_cast<const T*>(w1), act,
        static_cast<const T*>(w2), part, g, plan);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    mlp_bwd_reduce_kernel<<<static_cast<unsigned>((plan.L0 + kThreads - 1) / kThreads), kThreads,
                            0, stream>>>(part, out, plan);
    return cudaGetLastError();
  }
}

Dims dims(int T, int D, int H, int D2) {
  Dims g;
  g.T = T;
  g.D = D;
  g.H = H;
  g.D2 = D2;
  return g;
}

}  // namespace

extern "C" {

const char* skinjax_fused_mlp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The fp32 scratch of a forward (backward = 0) or a backward call: writes
// its size in floats to *floats. Forward: splits x T x D2 partials where the
// hidden columns are split (else 0; the bf16 and fp32 kernels split
// differently). Backward, fp32: the dW kernel's segments x (D.H + H.D2 + H +
// D2 + 2 chunks) partials, then splits x T x D dx partials; bf16: the hidden
// planes and partials of make_bf16_plan.
int skinjax_fused_mlp_scratch(int bf16_in, int backward, int T, int D, int H, int D2,
                              long long* floats) {
  const Dims g = dims(T, D, H, D2);
  if (bad_dims(g)) return static_cast<int>(cudaErrorInvalidValue);
  if (bf16_in && backward) {
    *floats = make_bf16_plan(g, sm_count()).total;
  } else if (bf16_in) {
    const FwdPlan p = make_fwd_plan(g, sm_count());
    *floats = p.splits > 1 ? (long long)p.splits * T * D2 : 0;
  } else {
    *floats = scratch_floats(make_plan(g, 4, sm_count()), g, backward != 0);
  }
  return 0;
}

// bf16_in: 0 for float, 1 for bfloat16 (x, the weights, b1, b2 and y share
// it). x (T, D), w1 (D, H), b1 (H,), w2 (H, D2), b2 (D2,), contiguous. Writes
// y (T, D2); part is the scratch of skinjax_fused_mlp_scratch's size.
int skinjax_mlp_gelu_fwd(int bf16_in, const void* x, const void* w1, const void* b1,
                         const void* w2, const void* b2, void* y, float* part, int T, int D,
                         int H, int D2, void* stream) {
  const Dims g = dims(T, D, H, D2);
  if (bad_dims(g)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16_in)
    return launch_fwd<bf16, kGelu>(x, w1, b1, nullptr, nullptr, w2, b2, y, part, g, st);
  return launch_fwd<float, kGelu>(x, w1, b1, nullptr, nullptr, w2, b2, y, part, g, st);
}

// dy (T, D2) like y. Writes dx (T, D) like x and out, fp32: dw1 (D, H), dw2
// (H, D2), db1 (H,), db2 (D2,) and two unused floats, one after the other;
// part is the scratch of skinjax_fused_mlp_scratch's size.
int skinjax_mlp_gelu_bwd(int bf16_in, const void* x, const void* dy, const void* w1,
                         const void* b1, const void* w2, void* dx, float* part, float* out, int T,
                         int D, int H, int D2, void* stream) {
  const Dims g = dims(T, D, H, D2);
  if (bad_dims(g)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16_in)
    return launch_bwd<bf16, kGelu>(x, dy, w1, b1, nullptr, nullptr, w2, dx, part, out, g, st);
  return launch_bwd<float, kGelu>(x, dy, w1, b1, nullptr, nullptr, w2, dx, part, out, g, st);
}

// As skinjax_mlp_gelu_fwd without biases; s and b point to StarReLU's fp32
// scalars on the card.
int skinjax_mlp_star_fwd(int bf16_in, const void* x, const void* w1, const float* s,
                         const float* b, const void* w2, void* y, float* part, int T, int D,
                         int H, int D2, void* stream) {
  const Dims g = dims(T, D, H, D2);
  if (bad_dims(g)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16_in) return launch_fwd<bf16, kStar>(x, w1, nullptr, s, b, w2, nullptr, y, part, g, st);
  return launch_fwd<float, kStar>(x, w1, nullptr, s, b, w2, nullptr, y, part, g, st);
}

// As skinjax_mlp_gelu_bwd; out holds dw1, dw2, H + D2 unused floats, ds, db.
int skinjax_mlp_star_bwd(int bf16_in, const void* x, const void* dy, const void* w1,
                         const float* s, const float* b, const void* w2, void* dx, float* part,
                         float* out, int T, int D, int H, int D2, void* stream) {
  const Dims g = dims(T, D, H, D2);
  if (bad_dims(g)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16_in)
    return launch_bwd<bf16, kStar>(x, dy, w1, nullptr, s, b, w2, dx, part, out, g, st);
  return launch_bwd<float, kStar>(x, dy, w1, nullptr, s, b, w2, dx, part, out, g, st);
}

}  // extern "C"
