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
// run in no order. So the weights stream through shared memory in 64 x 64
// slices, and nothing of the (T, H) hidden plane reaches device memory:
//   forward   a block per 32 token rows keeps its (32, D2) fp32 output in
//             shared memory, loops over 64-wide hidden chunks (pre for the
//             chunk from 64-wide K slices of x and w1, the activation, then
//             the chunk's h.w2 added to the output slice by slice). Where
//             the token tiles are too few to fill the card (a small batch),
//             the hidden chunks are split over blocks too: each writes fp32
//             partials, and a second launch sums them in split order (+ b2);
//   backward  (1) dx: a block per 32 token rows (and hidden split), as the
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
// the same inputs give bit-identical gradients. The scratch of (2) is
// segments x (D.H + H.D2 + H + D2 + 2 H/hw) fp32, with segments chosen so
// that chunks x segments is about twice the number of SMs; a split forward or
// dx adds splits x T x D2 (or D) fp32, splits only where T / 32 is below
// the number of SMs.
// Padding: rows past T (or past a segment), columns past D, H or D2 load as
// zeros; zero dy rows make dh and dpre exactly 0, so they add nothing to any
// gradient.
//
// What bounds it: at CAFormer-b36's stage 0 at B=32 (T = 100352, D = 128,
// H = 512, bf16) the forward does 26.3 GFLOP against 51 MB of x and y, so the
// tensor cores bound it (~27 us at 989 TFLOP/s), and the backward 66 GFLOP.
// This first version computes bf16 products on the tensor cores through
// nvcuda::wmma 16x16x16 fragments with fp32 accumulation, from shared-memory
// tiles, with the accumulators in shared memory; fp32 products run as plain
// fp32 FMAs. The 64-wide slices stream two deep (cp.async: the next slice's
// tiles are in flight while the block computes on this one's). No TMA or
// wgmma: PERF.md records how far each kernel is from its bound. D, H and D2
// are multiples of 16, and D, D2 <= 1024 (the dW tiles fit shared memory).
//
// C interface: each entry point launches on the given stream and returns
// cudaGetLastError() as an int (0 = success); skinjax_fused_mlp_error_string
// maps the code to its message.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <initializer_list>
#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTm = 32;  // token rows a block of the forward and dx kernels
constexpr int kHc = 64;  // hidden columns a chunk of the forward and dx kernels
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

__device__ __forceinline__ float dgelu(float p) {
  const float cdf = __fmul_rn(0.5f, __fadd_rn(1.0f, erff(__fmul_rn(p, kInvSqrt2))));
  const float pdf = __fmul_rn(expf(__fmul_rn(__fmul_rn(-0.5f, p), p)), kInvSqrt2Pi);
  return __fadd_rn(cdf, __fmul_rn(p, pdf));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// dst[r * ldd + c] = src[(r0 + r) * lds + c0 + c] for r < R, c < C; zero where
// r0 + r >= rows or c0 + c >= cols. In flight (cp.async) until the caller
// waits for its group. 16-byte vectors: C, c0, lds and cols are multiples of
// 16 / sizeof(T), and src and dst rows are 16-byte aligned.
template <typename T>
__device__ void load_tile(T* __restrict__ dst, int ldd, const T* __restrict__ src, int lds, int r0,
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

// steps of load(k, buffer) then compute(k, buffer), two buffers deep: step
// k + 1's tiles are in flight while step k computes. Every compute starts
// after a barrier that follows its tiles' arrival, and the loop ends with a
// barrier, so the buffers and the computed tile are free afterwards.
template <typename Load, typename Compute>
__device__ void pipeline(int steps, Load load, Compute compute) {
  load(0, 0);
  cp_async_commit();
  for (int k = 0; k < steps; ++k) {
    if (k + 1 < steps) {
      load(k + 1, (k + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    compute(k, k & 1);
    __syncthreads();
  }
}

__device__ void zero_f32(float* __restrict__ p, int n) {
  for (int i = threadIdx.x; i < n; i += kThreads) p[i] = 0.f;
}

// C (M x N, fp32, row-major, ldc) += A (M x K) . B (K x N), all in shared
// memory. A(m, k) = a[m * lda + k] when A_ROW, else a[k * lda + m]; B(k, n) =
// b[k * ldb + n] when B_ROW, else b[n * ldb + k]. M, N and K are multiples of
// 16. bf16: each warp takes 16x16 output tiles through wmma fragments; fp32:
// each thread takes output elements, one FMA chain over k each.
template <typename T, bool A_ROW, bool B_ROW>
__device__ void block_mma(float* __restrict__ c, int ldc, const T* __restrict__ a, int lda,
                          const T* __restrict__ b, int ldb, int M, int N, int K) {
  if constexpr (std::is_same<T, bf16>::value) {
    using namespace nvcuda;
    using LA = typename std::conditional<A_ROW, wmma::row_major, wmma::col_major>::type;
    using LB = typename std::conditional<B_ROW, wmma::row_major, wmma::col_major>::type;
    const int warp = threadIdx.x >> 5;
    const int tiles_n = N / 16, tiles = (M / 16) * tiles_n;
    for (int t = warp; t < tiles; t += kWarps) {
      const int m0 = (t / tiles_n) * 16, n0 = (t - (t / tiles_n) * tiles_n) * 16;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::load_matrix_sync(acc, c + m0 * ldc + n0, ldc, wmma::mem_row_major);
      for (int k0 = 0; k0 < K; k0 += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, LA> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, LB> fb;
        wmma::load_matrix_sync(fa, A_ROW ? a + m0 * lda + k0 : a + k0 * lda + m0, lda);
        wmma::load_matrix_sync(fb, B_ROW ? b + k0 * ldb + n0 : b + n0 * ldb + k0, ldb);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(c + m0 * ldc + n0, acc, ldc, wmma::mem_row_major);
    }
  } else {
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

// pre-activation p of hidden column j (fp32 product + K9's bias) -> h
template <typename T, int ACT>
__device__ __forceinline__ float fwd_act(float p, int j, const ActArgs<T>& a) {
  if constexpr (ACT == kGelu) {
    return gelu(__fadd_rn(p, to_f32<T>(a.b1[j])));
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
        load_tile(st.xs[b], kKc + P, x, g.D, t0, row_end, k * kKc, g.D, R, kKc);
        load_tile(st.ws[b], hw + P, w1, g.H, k * kKc, g.D, h0, g.H, kKc, hw);
      },
      [&](int, int b) {
        block_mma<T, true, true>(pre, ldp, st.xs[b], kKc + P, st.ws[b], hw + P, R, hw, kKc);
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
        load_tile(st.xs[b], kKc + P, dy, g.D2, t0, row_end, k * kKc, g.D2, R, kKc);
        load_tile(st.ws[b], kKc + P, w2, g.D2, h0, g.H, k * kKc, g.D2, hw, kKc);
      },
      [&](int, int b) {
        block_mma<T, true, false>(dh, ldp, st.xs[b], kKc + P, st.ws[b], kKc + P, R, hw, kKc);
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
// forward: a block per (kTm token rows, hidden split)
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
      const float h =
          h0 + c < g.H ? fwd_act<T, ACT>(pre[r * (kHc + kFpad) + c], h0 + c, act) : 0.f;
      hs[r * (kHc + P) + c] = from_f32<T>(h);
    }
    // acc[:, n0:n0 + kNc] += h . w2[h0:h0 + kHc, n0:n0 + kNc], slice by slice
    pipeline(
        (g.D2 + kNc - 1) / kNc,
        [&](int n, int b) {
          load_tile(st.ws[b], kNc + P, w2, g.D2, h0, g.H, n * kNc, g.D2, kHc, kNc);
        },
        [&](int n, int b) {
          block_mma<T, true, true>(acc + n * kNc, ldo, hs, kHc + P, st.ws[b], kNc + P, kTm, kNc,
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

// dpre of hidden column j from its pre-activation p (fp32 product) and dh;
// K10 also returns r^2 for ds
template <typename T, int ACT>
__device__ __forceinline__ float bwd_act(float p, float dh, int j, const ActArgs<T>& a, float* h,
                                         float* r2) {
  if constexpr (ACT == kGelu) {
    p = __fadd_rn(p, to_f32<T>(a.b1[j]));
    *h = gelu(p);
    *r2 = 0.f;
    return __fmul_rn(dh, dgelu(p));
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
        d = bwd_act<T, ACT>(pre[r * (kHc + kFpad) + c], dh[r * (kHc + kFpad) + c], h0 + c, act,
                            &h, &r2);
      ps[r * (kHc + P) + c] = from_f32<T>(d);
    }
    // dx += round(dpre) . w1[n0:n0 + kNc, h0:h0 + kHc]^T, slice by slice
    pipeline(
        (g.D + kNc - 1) / kNc,
        [&](int n, int b) {
          load_tile(st.ws[b], kHc + P, w1, g.H, n * kNc, g.D, h0, g.H, kNc, kHc);
        },
        [&](int n, int b) {
          block_mma<T, true, false>(acc + n * kNc, ldo, ps, kHc + P, st.ws[b], kHc + P, kTm, kNc,
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
  int splits;    // hidden splits of the forward and dx kernels (1: no partials)
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
  // the forward and dx kernels: as many hidden splits as fill one wave of
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
      if (h0 + c < g.H) d = bwd_act<T, ACT>(pre[r * ldp + c], dhv, h0 + c, act, &h, &r2);
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
          load_tile(st.xs[b], kKc + P, x, g.D, t0, t_end, m * kKc, g.D, tw, kKc);
        },
        [&](int m, int b) {
          block_mma<T, false, true>(acc1 + m * kKc * ldp, ldp, st.xs[b], kKc + P, ps, hw + P, kKc,
                                    hw, tw);
        });
    // dw2[chunk, n0:n0 + kNc] += round(h)^T . dy[:, n0:n0 + kNc]; db2 in chunk 0
    pipeline(
        (g.D2 + kNc - 1) / kNc,
        [&](int n, int b) {
          load_tile(st.xs[b], kNc + P, dy, g.D2, t0, t_end, n * kNc, g.D2, tw, kNc);
        },
        [&](int n, int b) {
          const T* ys = st.xs[b];
          if (chunk == 0 && threadIdx.x < kNc) {
            float s = b2acc[n * kNc + threadIdx.x];
            for (int r = 0; r < tw; ++r)
              s = __fadd_rn(s, to_f32<T>(ys[r * (kNc + P) + threadIdx.x]));
            b2acc[n * kNc + threadIdx.x] = s;
          }
          block_mma<T, false, true>(acc2 + n * kNc, ld2, hs, hw + P, ys, kNc + P, hw, kNc, tw);
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
cudaError_t reduce_splits(const Plan& plan, const float* part, const void* bias, void* out,
                          int rows, int N, cudaStream_t stream) {
  if (plan.splits == 1) return cudaSuccess;
  const long long n = (long long)rows * N;
  mlp_split_reduce_kernel<T, BIAS><<<static_cast<unsigned>((n + kThreads - 1) / kThreads),
                                     kThreads, 0, stream>>>(
      part, static_cast<const T*>(bias), static_cast<T*>(out), plan.splits, n, N);
  return cudaGetLastError();
}

template <typename T, int ACT>
cudaError_t launch_fwd(const void* x, const void* w1, const void* b1, const float* s,
                       const float* b, const void* w2, const void* b2, void* y, float* part,
                       const Dims& g, cudaStream_t stream) {
  const Plan plan = make_plan(g, sizeof(T), sm_count());
  const int smem = fwd_smem_bytes(g.D2, sizeof(T));
  cudaError_t err = set_smem(mlp_fwd_kernel<T, ACT>, smem);
  if (err != cudaSuccess) return err;
  ActPtrs<T> act{static_cast<const T*>(b1), s, b};
  mlp_fwd_kernel<T, ACT><<<dim3((g.T + kTm - 1) / kTm, plan.splits), kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1), act, static_cast<const T*>(w2),
      static_cast<const T*>(b2), static_cast<T*>(y), part, g, plan.split_cols);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return reduce_splits<T, ACT == kGelu>(plan, part, b2, y, g.T, g.D2, stream);
}

template <typename T, int ACT>
cudaError_t launch_bwd(const void* x, const void* dy, const void* w1, const void* b1,
                       const float* s, const float* b, const void* w2, void* dx, float* part,
                       float* out, const Dims& g, cudaStream_t stream) {
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
  err = reduce_splits<T, false>(plan, dx_part, nullptr, dx, g.T, g.D, stream);
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
// hidden columns are split (else 0). Backward: the dW kernel's segments x
// (D.H + H.D2 + H + D2 + 2 chunks) partials, then splits x T x D dx partials.
int skinjax_fused_mlp_scratch(int bf16_in, int backward, int T, int D, int H, int D2,
                              long long* floats) {
  const Dims g = dims(T, D, H, D2);
  if (bad_dims(g)) return static_cast<int>(cudaErrorInvalidValue);
  *floats = scratch_floats(make_plan(g, bf16_in ? 2 : 4, sm_count()), g, backward != 0);
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
