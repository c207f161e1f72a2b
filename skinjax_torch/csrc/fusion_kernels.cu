// Fusion-stage kernels of the serving path, for Hopper (sm_90a).
//
// They replace the four Pallas TPU kernels of
// skinjax/ops/pallas/fusion_kernels.py that the fused serving engine runs:
//
//   K1  skinjax_seq1_attention       <- seq1_attention        (out_proj(v_proj(kv)))
//   K2  skinjax_gated_residual_seq1  <- gated_residual_seq1   (LN(g*attn + (1-g)*q))
//   K4  skinjax_metablock_film       <- metablock_film        (sigmoid(tanh(v*LN(u@Wf)) + LN(u@Wg)))
//   K3  skinjax_mlp_head             <- mlp_head              (Dense-LN-ReLU x2, Dense)
//
// All attention in the fusion stage runs at sequence length 1, where softmax
// over one key is exactly 1, so each block is a short chain of matrix
// products with LayerNorm between them on (B, D) rows.
//
// What bounds them: at B <= 32 and D = 512 each D x D fp32 weight is 1 MB and
// is used for at most 32 rows, i.e. at most 16 FLOP per byte read, far below
// the card's ~295 FLOP/byte balance point. Reading the weights bounds them,
// not arithmetic. K4's two (Du, Vd) matrices are the largest: 8.4 MB at
// Du = 512, Vd = 2048 (MetaBlock on ResNet-50's raw 2048-wide feature).
//
// Design of K2-K4 (first, simple version): one thread block per tile of ROWS
// batch rows. The block keeps the whole chain in shared memory and
// registers, as the TPU kernels keep it in VMEM: no intermediate goes to
// device memory, and each weight element is read once per block and used for
// all ROWS rows. Weights are fp32 in (in, out) layout, read with one output
// column per thread so that a warp reads 128 contiguous bytes of a weight
// row. Accumulation is fp32. The activation type T (float or __nv_bfloat16)
// is a template parameter; values are rounded to T at exactly the points
// where the Pallas kernels cast to the activation dtype, and the output is T.
// For K4 a split over blocks needs a LayerNorm over all Vd columns of a row,
// which one block no longer holds: a second launch or a thread-block cluster
// reducing in distributed shared memory. At B = 1 one SM streams all 8.4 MB.
//
// K1 (seq1_cluster_kernel) is one thread-block cluster per tile of up to 32
// rows, so that at every served batch (B = 1, 8, 32) each weight element is
// read once per call and the reads are spread over the cluster's SMs. A
// cluster has D / 32 CTAs (16 at D = 512, the largest Hopper allows, as a
// non-portable size); CTA c owns output columns [32c, 32c + 32) of both
// products. At entry it asks for its (D, 32) slices of Wv and Wo by cp.async
// into shared memory, all 128 KB in flight at once: Wo's arrives while the
// first product runs. In each product the 16 warps split K; a lane owns 4
// columns of 8 rows where the tile has 8 or 32 (each 16-byte shared-memory
// read feeds 16 or 32 multiply-adds), and the warps' partial sums are added
// in a fixed order in shared memory (no atomics: two calls give the same
// bits). The CTA rounds its columns of v to T and keeps them in T; after a
// cluster barrier every CTA copies the whole v rows from its peers' shared
// memory (distributed shared memory, cluster.map_shared_rank; 16-byte reads,
// all in flight at once) and computes its columns of out, waiting on the
// second half of a split cluster barrier only before it exits. Nothing goes
// to device memory between the two products. Other widths (D not a multiple
// of 64, above 512, or a weight not 16-byte aligned), and cards that cannot
// place one such cluster (skinjax_seq1_cluster_count), keep the one-block
// design (seq1_attention_kernel). ops/fusion_kernels.py seq1_attention_plan
// chooses the route and the rows a tile; skinjax_seq1_attention only checks
// them.
//
// C interface: every entry point launches on the given stream and returns
// cudaGetLastError() as an int (0 = success); skinjax_error_string maps the
// code to its message.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma_bf16.cuh"  // cp_async16, cp_async_commit, cp_async_wait, aligned16

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr float kLnEps = 1e-5f;  // torch nn.LayerNorm default (fusion_kernels.py LN_EPS)
constexpr int kDefaultSmem = 48 * 1024;

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
  return __float2bfloat16(x);  // round to nearest even, as astype(bfloat16)
}

// x rounded to the activation type and widened back: the astype(dtype) points.
template <typename T>
__device__ __forceinline__ float round_act(float x) {
  return to_f32<T>(from_f32<T>(x));
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

// Rows [row0, row0 + nrows) of a (B, K) activation into shared fp32 (ROWS, K);
// the rows past nrows are zero so the products below stay finite.
template <int ROWS, typename T>
__device__ void load_rows(const T* __restrict__ x, int row0, int nrows, int K,
                          float* __restrict__ xs) {
  for (int i = threadIdx.x; i < ROWS * K; i += blockDim.x) {
    const int r = i / K;
    xs[i] = r < nrows ? to_f32<T>(x[(size_t)row0 * K + i]) : 0.f;
  }
}

template <int ROWS, typename T>
__device__ void store_rows(const float* __restrict__ ys, int row0, int nrows, int N,
                           T* __restrict__ y) {
  for (int i = threadIdx.x; i < nrows * N; i += blockDim.x)
    y[(size_t)row0 * N + i] = from_f32<T>(ys[i]);
}

// ys[r, n] = sum_k xs[r, k] * W[k, n] + b[n] for the ROWS rows of the tile.
// W is (K, N) row-major fp32. For wide outputs each thread owns output
// columns and walks k, so a warp reads 32 neighbouring floats of one weight
// row and the activation is a shared-memory broadcast. For narrow outputs
// (the classifier layer) a warp owns an output and its lanes split k.
template <int ROWS>
__device__ void dense(const float* __restrict__ xs, int K, const float* __restrict__ W,
                      const float* __restrict__ b, int N, float* __restrict__ ys) {
  if (N >= 2 * kWarps) {
    for (int n = threadIdx.x; n < N; n += blockDim.x) {
      float acc[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) acc[r] = 0.f;
      const float* w = W + n;
#pragma unroll 8
      for (int k = 0; k < K; ++k) {
        const float wk = __ldg(w + (size_t)k * N);
#pragma unroll
        for (int r = 0; r < ROWS; ++r) acc[r] = fmaf(xs[r * K + k], wk, acc[r]);
      }
      const float bn = __ldg(b + n);
#pragma unroll
      for (int r = 0; r < ROWS; ++r) ys[r * N + n] = acc[r] + bn;
    }
  } else {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    for (int n = warp; n < N; n += blockDim.x / 32) {
      float acc[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) acc[r] = 0.f;
      for (int k = lane; k < K; k += 32) {
        const float wk = __ldg(W + (size_t)k * N + n);
#pragma unroll
        for (int r = 0; r < ROWS; ++r) acc[r] = fmaf(xs[r * K + k], wk, acc[r]);
      }
#pragma unroll
      for (int r = 0; r < ROWS; ++r) acc[r] = warp_sum(acc[r]);
      if (lane == 0) {
        const float bn = __ldg(b + n);
#pragma unroll
        for (int r = 0; r < ROWS; ++r) ys[r * N + n] = acc[r] + bn;
      }
    }
  }
}

// In place on the ROWS rows of xs (ROWS, N): LN(x) * gamma + beta, then ReLU
// if asked, then rounded to T. Warp r owns row r. Mean first, then the mean
// of squared deviations, as _ln in the Pallas module computes them.
template <int ROWS, typename T>
__device__ void layer_norm_rows(float* __restrict__ xs, int N, const float* __restrict__ gamma,
                                const float* __restrict__ beta, bool relu) {
  static_assert(ROWS <= kWarps, "one warp per row");
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp >= ROWS) return;
  float* x = xs + warp * N;
  float s = 0.f;
  for (int k = lane; k < N; k += 32) s += x[k];
  const float mu = warp_sum(s) / N;
  float q = 0.f;
  for (int k = lane; k < N; k += 32) {
    const float d = x[k] - mu;
    q = fmaf(d, d, q);
  }
  const float rstd = rsqrtf(warp_sum(q) / N + kLnEps);
  for (int k = lane; k < N; k += 32) {
    float y = (x[k] - mu) * rstd * __ldg(gamma + k) + __ldg(beta + k);
    if (relu) y = fmaxf(y, 0.f);
    x[k] = round_act<T>(y);
  }
}

template <int ROWS, typename T>
__device__ void round_rows(float* __restrict__ xs, int n) {
  for (int i = threadIdx.x; i < ROWS * n; i += blockDim.x) xs[i] = round_act<T>(xs[i]);
}

// K1: out = (round_T(kv @ Wv + bv)) @ Wo + bo.  Shared: 2 * ROWS * D floats.
template <typename T, int ROWS>
__global__ void __launch_bounds__(kThreads)
    seq1_attention_kernel(const T* __restrict__ kv, const float* __restrict__ wv,
                          const float* __restrict__ bv, const float* __restrict__ wo,
                          const float* __restrict__ bo, T* __restrict__ out, int B, int D) {
  extern __shared__ float smem[];
  float* xs = smem;             // kv, then the output
  float* vs = smem + ROWS * D;  // v
  const int row0 = blockIdx.x * ROWS;
  const int nrows = min(ROWS, B - row0);
  load_rows<ROWS>(kv, row0, nrows, D, xs);
  __syncthreads();
  dense<ROWS>(xs, D, wv, bv, D, vs);
  __syncthreads();
  round_rows<ROWS, T>(vs, D);
  __syncthreads();
  dense<ROWS>(vs, D, wo, bo, D, xs);
  __syncthreads();
  store_rows<ROWS>(xs, row0, nrows, D, out);
}

constexpr int kSliceCols = 32;  // output columns a CTA of K1's cluster owns

// The row stride of the tile's rows in shared memory: K + 4 floats, so that
// the four rows a warp reads at once fall on different banks.
__host__ __device__ constexpr int slice_ld(int K) { return K + 4; }

// The CTA's share of one product: the sums over warp w's share of k (the 16
// warps split K, K % 64 == 0), in a fixed order, of xs[r, k] * ws[k, c] for
// the tile's ROWS rows (xs, row stride slice_ld(K)) and the (K, 32) slice ws
// of a weight, both in shared memory, into part[w, r, c]. At 8 and 32 rows a
// lane owns 4 columns (from 4 (lane % 8)) of 8 rows, so that each 16-byte
// read of xs or ws feeds 16 or 32 multiply-adds; at 8 rows the warp's four
// groups of 8 lanes take every fourth step of 4 k and add their sums by
// shuffles. At 1 row a lane owns one column, k ascending. part may be ws's own
// storage: the block synchronizes before writing it.
template <int ROWS>
__device__ __forceinline__ void slice_product(const float* __restrict__ xs, int K,
                                              const float* ws, float* part) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int kw = K / kWarps, k0 = warp * kw, ldx = slice_ld(K);
  if constexpr (ROWS < 8) {
    float acc[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) acc[r] = 0.f;
#pragma unroll 4
    for (int k = k0; k < k0 + kw; k += 4) {
      float w[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) w[j] = ws[(k + j) * kSliceCols + lane];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float4 x = *reinterpret_cast<const float4*>(xs + r * ldx + k);
        acc[r] = fmaf(x.x, w[0], acc[r]);
        acc[r] = fmaf(x.y, w[1], acc[r]);
        acc[r] = fmaf(x.z, w[2], acc[r]);
        acc[r] = fmaf(x.w, w[3], acc[r]);
      }
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < ROWS; ++r) part[(warp * ROWS + r) * kSliceCols + lane] = acc[r];
  } else {
    static_assert(ROWS % 8 == 0 && ROWS <= 32, "8 rows a lane, at most 4 groups of rows");
    constexpr int kRg = ROWS / 8;  // groups of rows: 1 (8 rows) or 4 (32)
    constexpr int kKs = 4 / kRg;   // lanes that split the warp's k: 4 or 1
    const int c0 = lane % 8 * 4, rg = lane / 8 % kRg, ks = lane / (8 * kRg);
    float acc[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;
#pragma unroll 2
    for (int k = k0 + 4 * ks; k < k0 + kw; k += 4 * kKs) {
      float4 w[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        w[j] = *reinterpret_cast<const float4*>(ws + (k + j) * kSliceCols + c0);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 x = *reinterpret_cast<const float4*>(xs + (rg + kRg * i) * ldx + k);
        const float xk[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[i][0] = fmaf(xk[j], w[j].x, acc[i][0]);
          acc[i][1] = fmaf(xk[j], w[j].y, acc[i][1]);
          acc[i][2] = fmaf(xk[j], w[j].z, acc[i][2]);
          acc[i][3] = fmaf(xk[j], w[j].w, acc[i][3]);
        }
      }
    }
    // the kKs lanes' sums of each element, a butterfly over ks's lane bits:
    // the two lanes of a pair add the same two values, so both hold the same bits
#pragma unroll
    for (int off = 8 * kRg; off < 32; off *= 2)
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][c] += __shfl_xor_sync(0xffffffffu, acc[i][c], off);
    __syncthreads();
    if (ks == 0) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
        *reinterpret_cast<float4*>(part + (warp * ROWS + rg + kRg * i) * kSliceCols + c0) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    }
  }
}

// The warps' partial sums of element i = (r, c) of the slice, added in a
// fixed pairwise order (warp w with w + 8, then w + 4, ...), plus the bias
// (the slice's 32 values, in shared memory).
template <int ROWS>
__device__ __forceinline__ float slice_sum(const float* __restrict__ part, int i,
                                           const float* __restrict__ b) {
  static_assert(kWarps == 16, "four levels of pairs");
  float s[kWarps];
#pragma unroll
  for (int w = 0; w < kWarps; ++w) s[w] = part[w * ROWS * kSliceCols + i];
#pragma unroll
  for (int w = 0; w < 8; ++w) s[w] += s[w + 8];
#pragma unroll
  for (int w = 0; w < 4; ++w) s[w] += s[w + 4];
  s[0] += s[2];
  s[1] += s[3];
  return (s[0] + s[1]) + b[i % kSliceCols];
}

// 16 bytes of T (4 floats or 8 bf16) widened to fp32 into dst (16-byte aligned).
template <typename T>
__device__ __forceinline__ void widen16(uint4 u, float* __restrict__ dst);
template <>
__device__ __forceinline__ void widen16<float>(uint4 u, float* __restrict__ dst) {
  *reinterpret_cast<uint4*>(dst) = u;
}
template <>
__device__ __forceinline__ void widen16<__nv_bfloat16>(uint4 u, float* __restrict__ dst) {
  // a bf16's bits are the top half of its float's
  *reinterpret_cast<float4*>(dst) =
      make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                  __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
  *reinterpret_cast<float4*>(dst + 4) =
      make_float4(__uint_as_float(u.z << 16), __uint_as_float(u.z & 0xffff0000u),
                  __uint_as_float(u.w << 16), __uint_as_float(u.w & 0xffff0000u));
}

// A cluster barrier in two halves: arrive (release) early, wait (acquire)
// later, so that the CTA works in between.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// A weight's (D, 32) column slice from column col0 into shared memory by
// cp.async, as one commit group.
__device__ __forceinline__ void load_slice(float* __restrict__ dst, const float* __restrict__ w,
                                           int D, int col0) {
  for (int i = threadIdx.x; i < D * (kSliceCols / 4); i += kThreads) {
    const int k = i / (kSliceCols / 4), c = i % (kSliceCols / 4) * 4;
    cp_async16(dst + k * kSliceCols + c, w + (size_t)k * D + col0 + c);
  }
  cp_async_commit();
}

// Shared memory of K1's cluster kernel, in floats: the Wv slice (its
// storage then holds the partial sums), the Wo slice, the tile's rows, this
// CTA's columns of v (in T; room for floats), the slices of both biases.
// 196.8 KB at D = 512, ROWS = 32.
__host__ __device__ constexpr int seq1_cluster_smem_floats(int D, int rows) {
  return (D * kSliceCols > kWarps * rows * kSliceCols ? D * kSliceCols
                                                      : kWarps * rows * kSliceCols) +
         D * kSliceCols + rows * slice_ld(D) + rows * kSliceCols + 2 * kSliceCols;
}

// K1 on a cluster of D / 32 CTAs: CTA blockIdx.x owns columns [32 x, 32 x + 32),
// blockIdx.y is the tile of ROWS rows.
template <typename T, int ROWS>
__global__ void __launch_bounds__(kThreads)
    seq1_cluster_kernel(const T* __restrict__ kv, const float* __restrict__ wv,
                        const float* __restrict__ bv, const float* __restrict__ wo,
                        const float* __restrict__ bo, T* __restrict__ out, int B, int D) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ float4 smem4[];
  float* wvs = reinterpret_cast<float*>(smem4);  // (D, 32) slice of Wv, then the partial sums
  float* wos = wvs + max(D, kWarps * ROWS) * kSliceCols;  // (D, 32) slice of Wo
  float* xs = wos + D * kSliceCols;  // (ROWS, D) at stride slice_ld(D): kv, then the rounded v
  T* vs = reinterpret_cast<T*>(xs + ROWS * slice_ld(D));  // (ROWS, 32): its columns of v, in T
  float* bs = xs + ROWS * slice_ld(D) + ROWS * kSliceCols;  // (2, 32): its slices of bv, bo
  const int ldx = slice_ld(D);
  const int col0 = blockIdx.x * kSliceCols;
  const int row0 = blockIdx.y * ROWS;
  const int nrows = min(ROWS, B - row0);
  {
    // the tile's rows first, so that they do not queue behind the slices:
    // thread k loads column k (D <= kThreads) of every row at once
    const int k = threadIdx.x;
    float x[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
      x[r] = k < D && r < nrows ? to_f32<T>(kv[(size_t)(row0 + r) * D + k]) : 0.f;
    const float b = k < kSliceCols       ? __ldg(bv + col0 + k)
                    : k < 2 * kSliceCols ? __ldg(bo + col0 + k - kSliceCols)
                                         : 0.f;
    load_slice(wvs, wv, D, col0);
    load_slice(wos, wo, D, col0);  // arrives while the first product runs
    if (k < D) {
#pragma unroll
      for (int r = 0; r < ROWS; ++r) xs[r * ldx + k] = x[r];
    }
    if (k < 2 * kSliceCols) bs[k] = b;
  }
  cp_async_wait<1>();
  __syncthreads();
  slice_product<ROWS>(xs, D, wvs, wvs);
  __syncthreads();
  for (int i = threadIdx.x; i < ROWS * kSliceCols; i += kThreads)
    vs[i] = from_f32<T>(slice_sum<ROWS>(wvs, i, bs));
  cluster.sync();
  {  // the whole v rows, from every CTA's columns (its shared memory), in T:
     // all of a thread's 16-byte reads from its peers in flight at once, then
     // its stores, widened to fp32
    constexpr int kVec = 16 / sizeof(T);           // elements a read
    constexpr int kChunks = kSliceCols / kVec;     // reads a row of a peer's v
    constexpr int kGather = (16 * ROWS * kChunks + kThreads - 1) / kThreads;
    const int n = (int)cluster.num_blocks() * ROWS * kChunks;
    uint4 v[kGather];
#pragma unroll
    for (int j = 0; j < kGather; ++j) {
      const int i = threadIdx.x + j * kThreads;
      const int c = i % kChunks * kVec, r = i / kChunks % ROWS, p = i / (kChunks * ROWS);
      if (i < n)
        v[j] = *reinterpret_cast<const uint4*>(cluster.map_shared_rank(vs, p) +
                                               r * kSliceCols + c);
    }
#pragma unroll
    for (int j = 0; j < kGather; ++j) {
      const int i = threadIdx.x + j * kThreads;
      const int c = i % kChunks * kVec, r = i / kChunks % ROWS, p = i / (kChunks * ROWS);
      if (i < n) widen16<T>(v[j], xs + r * ldx + p * kSliceCols + c);
    }
  }
  cluster_arrive();  // this CTA has read its peers' v
  cp_async_wait<0>();
  __syncthreads();  // xs and wos are complete
  slice_product<ROWS>(xs, D, wos, wvs);
  __syncthreads();
  for (int i = threadIdx.x; i < nrows * kSliceCols; i += kThreads)
    out[(size_t)(row0 + i / kSliceCols) * D + col0 + i % kSliceCols] =
        from_f32<T>(slice_sum<ROWS>(wvs, i, bs + kSliceCols));
  cluster_wait();  // no CTA leaves while a peer may still read its v
}

// K2: g = sigmoid(q @ Wg + bg); attn = K1(kv);
//     out = LN(g * attn + (1 - g) * q) * gamma + beta.  Shared: 4 * ROWS * D floats.
template <typename T, int ROWS>
__global__ void __launch_bounds__(kThreads)
    gated_residual_kernel(const T* __restrict__ q, const T* __restrict__ kv,
                          const float* __restrict__ wv, const float* __restrict__ bv,
                          const float* __restrict__ wo, const float* __restrict__ bo,
                          const float* __restrict__ wg, const float* __restrict__ bg,
                          const float* __restrict__ gamma, const float* __restrict__ beta,
                          T* __restrict__ out, int B, int D) {
  extern __shared__ float smem[];
  float* qs = smem;                 // q (fp32 upcast)
  float* ks = smem + ROWS * D;      // kv, then the gate pre-activation
  float* vs = smem + 2 * ROWS * D;  // v
  float* att = smem + 3 * ROWS * D;  // attn, then the blend and its LN
  const int row0 = blockIdx.x * ROWS;
  const int nrows = min(ROWS, B - row0);
  load_rows<ROWS>(q, row0, nrows, D, qs);
  load_rows<ROWS>(kv, row0, nrows, D, ks);
  __syncthreads();
  dense<ROWS>(ks, D, wv, bv, D, vs);
  __syncthreads();
  round_rows<ROWS, T>(vs, D);
  __syncthreads();
  dense<ROWS>(vs, D, wo, bo, D, att);
  dense<ROWS>(qs, D, wg, bg, D, ks);
  __syncthreads();
  for (int i = threadIdx.x; i < ROWS * D; i += blockDim.x) {
    const float g = sigmoid(ks[i]);
    att[i] = g * att[i] + (1.f - g) * qs[i];
  }
  __syncthreads();
  layer_norm_rows<ROWS, T>(att, D, gamma, beta, false);
  __syncthreads();
  store_rows<ROWS>(att, row0, nrows, D, out);
}

// K4: t1 = LN(u @ Wf + bf) * gf + hf;  t2 = LN(u @ Wg + bg) * gg + hg  (both fp32,
//     never rounded, as in the Pallas kernel);
//     out = round_T(sigmoid(tanh(v * t1) + t2)).  Shared: ROWS * (Du + 2 * Vd) floats.
template <typename T, int ROWS>
__global__ void __launch_bounds__(kThreads)
    metablock_film_kernel(const T* __restrict__ v, const T* __restrict__ u,
                          const float* __restrict__ wf, const float* __restrict__ bf,
                          const float* __restrict__ gf, const float* __restrict__ hf,
                          const float* __restrict__ wg, const float* __restrict__ bg,
                          const float* __restrict__ gg, const float* __restrict__ hg,
                          T* __restrict__ out, int B, int Du, int Vd) {
  extern __shared__ float smem[];
  float* us = smem;            // u (fp32 upcast)
  float* t1 = us + ROWS * Du;  // u @ Wf + bf, then its LN
  float* t2 = t1 + ROWS * Vd;  // u @ Wg + bg, then its LN
  const int row0 = blockIdx.x * ROWS;
  const int nrows = min(ROWS, B - row0);
  load_rows<ROWS>(u, row0, nrows, Du, us);
  __syncthreads();
  dense<ROWS>(us, Du, wf, bf, Vd, t1);
  dense<ROWS>(us, Du, wg, bg, Vd, t2);
  __syncthreads();
  // rounding to float is the identity: the modulators stay fp32
  layer_norm_rows<ROWS, float>(t1, Vd, gf, hf, false);
  layer_norm_rows<ROWS, float>(t2, Vd, gg, hg, false);
  __syncthreads();
  const T* vr = v + (size_t)row0 * Vd;
  T* o = out + (size_t)row0 * Vd;
  for (int i = threadIdx.x; i < nrows * Vd; i += blockDim.x)
    o[i] = from_f32<T>(sigmoid(tanhf(to_f32<T>(vr[i]) * t1[i]) + t2[i]));
}

// K3: h1 = round_T(relu(LN(x @ W1 + b1)));  h2 = round_T(relu(LN(h1 @ W2 + b2)));
//     out = h2 @ W3 + b3.  Shared: ROWS * (K1 + N1 + N2 + N3) floats.
template <typename T, int ROWS>
__global__ void __launch_bounds__(kThreads)
    mlp_head_kernel(const T* __restrict__ x, const float* __restrict__ w1,
                    const float* __restrict__ b1, const float* __restrict__ g1,
                    const float* __restrict__ h1b, const float* __restrict__ w2,
                    const float* __restrict__ b2, const float* __restrict__ g2,
                    const float* __restrict__ h2b, const float* __restrict__ w3,
                    const float* __restrict__ b3, T* __restrict__ out, int B, int K1, int N1,
                    int N2, int N3) {
  extern __shared__ float smem[];
  float* xs = smem;
  float* h1 = xs + ROWS * K1;
  float* h2 = h1 + ROWS * N1;
  float* ys = h2 + ROWS * N2;
  const int row0 = blockIdx.x * ROWS;
  const int nrows = min(ROWS, B - row0);
  load_rows<ROWS>(x, row0, nrows, K1, xs);
  __syncthreads();
  dense<ROWS>(xs, K1, w1, b1, N1, h1);
  __syncthreads();
  layer_norm_rows<ROWS, T>(h1, N1, g1, h1b, true);
  __syncthreads();
  dense<ROWS>(h1, N1, w2, b2, N2, h2);
  __syncthreads();
  layer_norm_rows<ROWS, T>(h2, N2, g2, h2b, true);
  __syncthreads();
  dense<ROWS>(h2, N2, w3, b3, N3, ys);
  __syncthreads();
  store_rows<ROWS>(ys, row0, nrows, N3, out);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= kDefaultSmem) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// Batch rows per block: one at the smallest batches, where the block count
// cannot fill the card anyway and every extra row is wasted arithmetic; four
// above, so that each weight element read serves four rows.
inline int rows_for(int B) { return B < 4 ? 1 : 4; }

template <typename T, int ROWS>
cudaError_t seq1_attention_launch(const void* kv, const float* wv, const float* bv,
                                  const float* wo, const float* bo, void* out, int B, int D,
                                  cudaStream_t stream) {
  const size_t smem = 2 * (size_t)ROWS * D * sizeof(float);
  cudaError_t err = allow_smem(seq1_attention_kernel<T, ROWS>, smem);
  if (err != cudaSuccess) return err;
  seq1_attention_kernel<T, ROWS><<<(B + ROWS - 1) / ROWS, kThreads, smem, stream>>>(
      static_cast<const T*>(kv), wv, bv, wo, bo, static_cast<T*>(out), B, D);
  return cudaGetLastError();
}

// Widths K1's cluster kernel takes: D a multiple of 64 (16 warps split K four
// at a time) up to 512 (at most 16 CTAs of 32 columns). The route itself is
// chosen in ops/fusion_kernels.py seq1_attention_plan; the entry point only
// checks it.
inline bool seq1_cluster_shapes(int D) { return D % 64 == 0 && D >= 64 && D <= 512; }

// The cluster kernel's attributes (its shared memory, a cluster above the
// portable 8 CTAs) and launch configuration for a grid of `tiles` tiles.
template <typename T, int ROWS>
cudaError_t seq1_cluster_config(int D, int tiles, cudaLaunchConfig_t& cfg,
                                cudaLaunchAttribute& cluster) {
  const auto kernel = seq1_cluster_kernel<T, ROWS>;
  const int ranks = D / kSliceCols;
  const size_t smem = seq1_cluster_smem_floats(D, ROWS) * sizeof(float);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess && ranks > 8)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = ranks;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cfg = {};
  cfg.gridDim = dim3(ranks, tiles);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  return err;
}

// How many of the cluster kernel's clusters the current device holds at
// once: 0 where a CTA's shared memory is beyond a block's, or where no
// cluster of D / 32 such CTAs can be placed (a smaller card, a MIG slice).
template <typename T, int ROWS>
cudaError_t seq1_cluster_count(int D, int* count) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  *count = 0;
  if (seq1_cluster_smem_floats(D, ROWS) * sizeof(float) > (size_t)optin) return cudaSuccess;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute cluster;
  err = seq1_cluster_config<T, ROWS>(D, 1, cfg, cluster);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveClusters(count, seq1_cluster_kernel<T, ROWS>, &cfg);
}

template <typename T, int ROWS>
cudaError_t seq1_cluster_launch(const void* kv, const float* wv, const float* bv,
                                const float* wo, const float* bo, void* out, int B, int D,
                                cudaStream_t stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute cluster;
  cudaError_t err = seq1_cluster_config<T, ROWS>(D, (B + ROWS - 1) / ROWS, cfg, cluster);
  if (err != cudaSuccess) return err;
  cfg.stream = stream;
  err = cudaLaunchKernelEx(&cfg, seq1_cluster_kernel<T, ROWS>, static_cast<const T*>(kv), wv,
                           bv, wo, bo, static_cast<T*>(out), B, D);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// K1 on the route the caller chose: the cluster kernel (cluster != 0) at
// rows 1, 8 or 32 a tile, or the one-block kernel at rows 1 or 4; any other
// route is refused.
template <typename T>
cudaError_t seq1_attention_route(int cluster, int rows, const void* kv, const float* wv,
                                 const float* bv, const float* wo, const float* bo, void* out,
                                 int B, int D, cudaStream_t s) {
  if (cluster) {
    if (!seq1_cluster_shapes(D)) return cudaErrorInvalidValue;
    if (!aligned16(wv) || !aligned16(wo)) return cudaErrorMisalignedAddress;
    switch (rows) {
      case 1: return seq1_cluster_launch<T, 1>(kv, wv, bv, wo, bo, out, B, D, s);
      case 8: return seq1_cluster_launch<T, 8>(kv, wv, bv, wo, bo, out, B, D, s);
      case 32: return seq1_cluster_launch<T, 32>(kv, wv, bv, wo, bo, out, B, D, s);
      default: return cudaErrorInvalidValue;
    }
  }
  switch (rows) {
    case 1: return seq1_attention_launch<T, 1>(kv, wv, bv, wo, bo, out, B, D, s);
    case 4: return seq1_attention_launch<T, 4>(kv, wv, bv, wo, bo, out, B, D, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, int ROWS>
cudaError_t gated_residual_launch(const void* q, const void* kv, const float* wv,
                                  const float* bv, const float* wo, const float* bo,
                                  const float* wg, const float* bg, const float* gamma,
                                  const float* beta, void* out, int B, int D,
                                  cudaStream_t stream) {
  const size_t smem = 4 * (size_t)ROWS * D * sizeof(float);
  cudaError_t err = allow_smem(gated_residual_kernel<T, ROWS>, smem);
  if (err != cudaSuccess) return err;
  gated_residual_kernel<T, ROWS><<<(B + ROWS - 1) / ROWS, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kv), wv, bv, wo, bo, wg, bg, gamma, beta,
      static_cast<T*>(out), B, D);
  return cudaGetLastError();
}

template <typename T, int ROWS>
cudaError_t metablock_film_launch(const void* v, const void* u, const float* wf,
                                  const float* bf, const float* gf, const float* hf,
                                  const float* wg, const float* bg, const float* gg,
                                  const float* hg, void* out, int B, int Du, int Vd,
                                  cudaStream_t stream) {
  const size_t smem = (size_t)ROWS * (Du + 2 * Vd) * sizeof(float);
  cudaError_t err = allow_smem(metablock_film_kernel<T, ROWS>, smem);
  if (err != cudaSuccess) return err;
  metablock_film_kernel<T, ROWS><<<(B + ROWS - 1) / ROWS, kThreads, smem, stream>>>(
      static_cast<const T*>(v), static_cast<const T*>(u), wf, bf, gf, hf, wg, bg, gg, hg,
      static_cast<T*>(out), B, Du, Vd);
  return cudaGetLastError();
}

template <typename T, int ROWS>
cudaError_t mlp_head_launch(const void* x, const float* w1, const float* b1, const float* g1,
                            const float* h1, const float* w2, const float* b2, const float* g2,
                            const float* h2, const float* w3, const float* b3, void* out, int B,
                            int K1, int N1, int N2, int N3, cudaStream_t stream) {
  const size_t smem = (size_t)ROWS * (K1 + N1 + N2 + N3) * sizeof(float);
  cudaError_t err = allow_smem(mlp_head_kernel<T, ROWS>, smem);
  if (err != cudaSuccess) return err;
  mlp_head_kernel<T, ROWS><<<(B + ROWS - 1) / ROWS, kThreads, smem, stream>>>(
      static_cast<const T*>(x), w1, b1, g1, h1, w2, b2, g2, h2, w3, b3, static_cast<T*>(out), B,
      K1, N1, N2, N3);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* skinjax_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// act_bf16: 0 for float activations, 1 for bfloat16. Weights are fp32 (in, out).
// cluster and rows: the route, as ops/fusion_kernels.py seq1_attention_plan
// chooses it (seq1_attention_route).
int skinjax_seq1_attention(int act_bf16, int cluster, int rows, const void* kv, const float* wv,
                           const float* bv, const float* wo, const float* bo, void* out, int B,
                           int D, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (act_bf16)
    return seq1_attention_route<__nv_bfloat16>(cluster, rows, kv, wv, bv, wo, bo, out, B, D, s);
  return seq1_attention_route<float>(cluster, rows, kv, wv, bv, wo, bo, out, B, D, s);
}

// *count: how many clusters of K1's cluster kernel at width D and `rows` rows
// a tile the current device holds at once (seq1_cluster_count).
int skinjax_seq1_cluster_count(int act_bf16, int rows, int D, int* count) {
  if (!seq1_cluster_shapes(D)) return static_cast<int>(cudaErrorInvalidValue);
  const bool bf16 = act_bf16 != 0;
  switch (rows) {
    case 1: return bf16 ? seq1_cluster_count<__nv_bfloat16, 1>(D, count)
                        : seq1_cluster_count<float, 1>(D, count);
    case 8: return bf16 ? seq1_cluster_count<__nv_bfloat16, 8>(D, count)
                        : seq1_cluster_count<float, 8>(D, count);
    case 32: return bf16 ? seq1_cluster_count<__nv_bfloat16, 32>(D, count)
                         : seq1_cluster_count<float, 32>(D, count);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int skinjax_gated_residual_seq1(int act_bf16, const void* q, const void* kv, const float* wv,
                                const float* bv, const float* wo, const float* bo,
                                const float* wg, const float* bg, const float* gamma,
                                const float* beta, void* out, int B, int D, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool one = rows_for(B) == 1;
  if (act_bf16)
    return one ? gated_residual_launch<__nv_bfloat16, 1>(q, kv, wv, bv, wo, bo, wg, bg, gamma,
                                                         beta, out, B, D, s)
               : gated_residual_launch<__nv_bfloat16, 4>(q, kv, wv, bv, wo, bo, wg, bg, gamma,
                                                         beta, out, B, D, s);
  return one ? gated_residual_launch<float, 1>(q, kv, wv, bv, wo, bo, wg, bg, gamma, beta, out,
                                               B, D, s)
             : gated_residual_launch<float, 4>(q, kv, wv, bv, wo, bo, wg, bg, gamma, beta, out,
                                               B, D, s);
}

int skinjax_metablock_film(int act_bf16, const void* v, const void* u, const float* wf,
                           const float* bf, const float* gf, const float* hf, const float* wg,
                           const float* bg, const float* gg, const float* hg, void* out, int B,
                           int Du, int Vd, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool one = rows_for(B) == 1;
  if (act_bf16)
    return one ? metablock_film_launch<__nv_bfloat16, 1>(v, u, wf, bf, gf, hf, wg, bg, gg, hg,
                                                         out, B, Du, Vd, s)
               : metablock_film_launch<__nv_bfloat16, 4>(v, u, wf, bf, gf, hf, wg, bg, gg, hg,
                                                         out, B, Du, Vd, s);
  return one ? metablock_film_launch<float, 1>(v, u, wf, bf, gf, hf, wg, bg, gg, hg, out, B, Du,
                                               Vd, s)
             : metablock_film_launch<float, 4>(v, u, wf, bf, gf, hf, wg, bg, gg, hg, out, B, Du,
                                               Vd, s);
}

int skinjax_mlp_head(int act_bf16, const void* x, const float* w1, const float* b1,
                     const float* g1, const float* h1, const float* w2, const float* b2,
                     const float* g2, const float* h2, const float* w3, const float* b3,
                     void* out, int B, int K1, int N1, int N2, int N3, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool one = rows_for(B) == 1;
  if (act_bf16)
    return one ? mlp_head_launch<__nv_bfloat16, 1>(x, w1, b1, g1, h1, w2, b2, g2, h2, w3, b3,
                                                   out, B, K1, N1, N2, N3, s)
               : mlp_head_launch<__nv_bfloat16, 4>(x, w1, b1, g1, h1, w2, b2, g2, h2, w3, b3,
                                                   out, B, K1, N1, N2, N3, s);
  return one ? mlp_head_launch<float, 1>(x, w1, b1, g1, h1, w2, b2, g2, h2, w3, b3, out, B, K1,
                                         N1, N2, N3, s)
             : mlp_head_launch<float, 4>(x, w1, b1, g1, h1, w2, b2, g2, h2, w3, b3, out, B, K1,
                                         N1, N2, N3, s);
}

}  // extern "C"
