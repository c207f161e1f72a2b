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
// The one-block design (K1-K4 at widths their cluster kernels do not take):
// one thread block per tile of ROWS batch rows. The block keeps the whole
// chain in shared memory and registers, as the TPU kernels keep it in VMEM:
// no intermediate goes to device memory, and each weight element is read once
// per block and used for all ROWS rows. Weights are fp32 in (in, out) layout,
// read with one output column per thread so that a warp reads 128 contiguous
// bytes of a weight row. Accumulation is fp32. The activation type T (float or
// __nv_bfloat16) is a template parameter; values are rounded to T at exactly
// the points where the Pallas kernels cast to the activation dtype, and the
// output is T. At B = 1 one SM streams every weight.
//
// The cluster design (K1-K4 at the served widths): one thread-block cluster
// per tile of rows, so that at every served batch each weight element is read
// once or twice per call and the reads are spread over the cluster's SMs (16
// at the served widths, the largest Hopper allows, as a non-portable size).
// CTA c owns some output columns of every product of the block and asks for
// its column slices of the weights by cp.async into shared memory. In each
// product each warp owns 32 (or 16) of the CTA's columns and a share of K; a
// lane owns 4 columns of 8 rows where the tile has 8, 16 or 32 rows (each
// 16-byte shared-memory read feeds 16 or 32 multiply-adds), and the warps'
// partial sums are added in a fixed order in shared memory (no atomics: two
// calls give the same bits). One set of building blocks serves all four
// kernels: load_cols, slice_step, slice_part, slice_sum, gather_columns,
// row_stats, cluster_config / cluster_count / cluster_launch.
//
//   K1 (seq1_cluster_kernel, rows 1, 8 or 32 a tile): D / 32 CTAs of 32
//   columns; both (D, 32) slices in flight at once, Wo's arriving while the
//   first product runs. Each CTA rounds its columns of v to T and keeps them
//   in T; after a cluster barrier every CTA copies the whole v rows from its
//   peers' shared memory (distributed shared memory, cluster.map_shared_rank;
//   16-byte reads, all in flight at once) and computes its columns of out.
//   K2 (gated_residual_cluster_kernel, rows 1, 8 or 16): the same layout for
//   all three products; Wv's and Wg's slices first, v shared as K1 shares it
//   while the gate product runs, Wo's slice into Wv's storage once v's sums
//   are taken (q's rows beside kv's take the room that caps its tile at 16
//   rows). K4 (metablock_film_cluster_kernel, rows 1, 8 or 32): Vd / W CTAs
//   of W = 32, 64 or 128 columns of both modulators; a CTA's (Du, 2W) slice
//   (8.4 MB over 16 CTAs at Vd = 2048 is 512 KB a CTA) streams in K-chunks of
//   32 KB through a ring of 4 stages, the sums kept in registers over the
//   chunks. K3 (mlp_head_cluster_kernel, rows 1, 8, 16 or 32): N1 / 32 CTAs
//   of 32 columns of fc1 and 16 of fc2 (N2 = N1 / 2); a CTA's (K1, 32) slice
//   of W1 (128 KB at K1 = 1024, 256 KB at 2048) streams through K4's ring and
//   its (N1, 16) slice of W2 follows as the ring's next chunk, arriving while
//   fc1 runs; h1's columns, rounded to T, are shared as K1 shares v; fc2 runs
//   on 16-column warps (slice_step's 16-column form); each CTA multiplies its
//   16 columns of h2 by its 16 rows of W3 into rank 0's shared memory, which
//   adds the CTAs' partial sums in rank order. x's fp32 rows beside the ring
//   cap its tile at 16 rows at K1 = 1024 and 8 at 2048. At the flagship's
//   2.6 MB of weights, B = 1, a CTA reads 160 KB where the one-block kernel
//   read all of it on one SM.
//
// The LayerNorms of K2, K3 and K4 need each row's statistics over all
// columns, which no CTA holds: each CTA writes its rows' partial sums into its
// shared memory, and after a cluster barrier every CTA adds all of them in
// rank order (the same bits in every CTA); then the centred squares the same
// way (two passes, as _ln; row_stats). Nothing goes to device memory between
// the products; a CTA waits on the second half of a split cluster barrier
// before it arrives on the next and before it exits, so that no peer reads
// its shared memory after it left. Other widths, weights not 16-byte aligned,
// and cards that cannot place one such cluster (the *_cluster_count queries)
// keep the one-block kernels. ops/fusion_kernels.py chooses each call's route
// and rows a tile (seq1_attention_plan, gated_residual_plan,
// metablock_film_plan, mlp_head_plan); the entry points only check them.
//
// C interface: every entry point launches on the given stream and returns
// cudaGetLastError() as an int (0 = success); skinjax_error_string maps the
// code to its message.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "mma_bf16.cuh"  // cp_async16, cp_async_commit, cp_async_wait, aligned16

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr float kLnEps = 1e-5f;  // torch nn.LayerNorm default (fusion_kernels.py LN_EPS)
constexpr int kDefaultSmem = 48 * 1024;
constexpr size_t kMaxSmem = 227 * 1024;  // a block's shared memory on Hopper (opt-in)

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

// ---------------------------------------------------------------------------
// Building blocks of the cluster kernels (K1-K4). A CTA owns some output
// columns of a tile's products; each warp owns 32 of them (a column group) and
// a share of k, so that a product is one pass of the CTA's 16 warps over its
// weight slice in shared memory, with the warps' partial sums added in a fixed
// order (no atomics: two calls give the same bits).
// ---------------------------------------------------------------------------

constexpr int kSliceCols = 32;  // output columns of a warp's share of a product
constexpr int kMaxRanks = 16;   // CTAs a cluster may hold (non-portable above 8)

// The row stride of the tile's rows in shared memory: K + 4 floats, so that
// the four rows a warp reads at once fall on different banks.
__host__ __device__ constexpr int slice_ld(int K) { return K + 4; }

// A lane's sums of its warp's 32 columns over the tile's ROWS rows: at 8, 16
// and 32 rows 4 columns (from 4 (lane % 8)) of 8 rows, at fewer rows one
// column (the lane's).
template <int ROWS>
struct SliceAcc {
  float a[ROWS < 8 ? ROWS : 32];
};

template <int ROWS>
__device__ __forceinline__ void slice_zero(SliceAcc<ROWS>& acc) {
#pragma unroll
  for (int i = 0; i < (ROWS < 8 ? ROWS : 32); ++i) acc.a[i] = 0.f;
}

// One warp's share of a product: acc += xs[r, k0 + k] * ws[k, c] for k in
// [0, kw) (kw % 4 == 0), over the tile's ROWS rows (xs, row stride ldx) and
// the warp's NC = 32 or 16 columns of weight rows in shared memory (ws, row
// stride ldw). Called once for a whole slice, or once a chunk of a slice
// streamed in K-chunks, the sums staying in registers. At 8, 16 and 32 rows
// each 16-byte read of xs or ws feeds 16 or 32 multiply-adds; the lanes a
// row's columns leave over take every 2nd, 4th or 8th step of 4 k
// (slice_part adds their sums). At fewer rows a lane owns a column, and at
// 16 columns the two halves of the warp take every other step.
template <int ROWS, int NC = kSliceCols>
__device__ __forceinline__ void slice_step(const float* __restrict__ xs, int ldx, int k0, int kw,
                                           const float* ws, int ldw, SliceAcc<ROWS>& acc) {
  static_assert(NC == 32 || NC == 16, "32 or 16 columns a warp");
  const int lane = threadIdx.x % 32;
  if constexpr (ROWS < 8) {
    constexpr int kKs = 32 / NC;  // lanes that split k: 1 or 2
    const int c = lane % NC, ks = NC == 32 ? 0 : lane / NC;
#pragma unroll 4
    for (int k = 4 * ks; k < kw; k += 4 * kKs) {
      float w[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) w[j] = ws[(k + j) * ldw + c];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float4 x = *reinterpret_cast<const float4*>(xs + r * ldx + k0 + k);
        acc.a[r] = fmaf(x.x, w[0], acc.a[r]);
        acc.a[r] = fmaf(x.y, w[1], acc.a[r]);
        acc.a[r] = fmaf(x.z, w[2], acc.a[r]);
        acc.a[r] = fmaf(x.w, w[3], acc.a[r]);
      }
    }
  } else {
    static_assert(ROWS == 8 || ROWS == 16 || ROWS == 32, "8 rows a lane, 1, 2 or 4 groups of rows");
    constexpr int kCq = NC / 4;              // lanes across the columns, 4 each: 8 or 4
    constexpr int kRg = ROWS / 8;            // groups of rows: 1 (8 rows), 2 (16) or 4 (32)
    constexpr int kKs = 32 / (kCq * kRg);    // lanes that split the warp's k: 8, 4, 2 or 1
    const int c0 = lane % kCq * 4, rg = lane / kCq % kRg, ks = lane / (kCq * kRg);
    // one step at a time: unrolled twice, the next step's loads kept K3's
    // 16- and 32-row bf16 kernels above 128 registers (spills)
#pragma unroll 1
    for (int k = 4 * ks; k < kw; k += 4 * kKs) {
      float4 w[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) w[j] = *reinterpret_cast<const float4*>(ws + (k + j) * ldw + c0);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 x = *reinterpret_cast<const float4*>(xs + (rg + kRg * i) * ldx + k0 + k);
        const float xk[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc.a[4 * i + 0] = fmaf(xk[j], w[j].x, acc.a[4 * i + 0]);
          acc.a[4 * i + 1] = fmaf(xk[j], w[j].y, acc.a[4 * i + 1]);
          acc.a[4 * i + 2] = fmaf(xk[j], w[j].z, acc.a[4 * i + 2]);
          acc.a[4 * i + 3] = fmaf(xk[j], w[j].w, acc.a[4 * i + 3]);
        }
      }
    }
  }
}

// A warp's sums into its slot of the partial-sum planes: row r, column c at
// part[(slot * ROWS + r) * ldp + c], part offset to the warp's NC columns.
// The lanes that split k first add their sums, a butterfly over ks's lane
// bits: the two lanes of a pair add the same two values, so both hold the
// same bits. part may be the weights' own storage: the block synchronizes
// before writing it.
template <int ROWS, int NC = kSliceCols>
__device__ __forceinline__ void slice_part(SliceAcc<ROWS>& acc, float* part, int slot, int ldp) {
  const int lane = threadIdx.x % 32;
  if constexpr (ROWS < 8) {
#pragma unroll
    for (int off = NC; off < 32; off *= 2)
#pragma unroll
      for (int r = 0; r < ROWS; ++r) acc.a[r] += __shfl_xor_sync(0xffffffffu, acc.a[r], off);
    __syncthreads();
    if (lane < NC) {
#pragma unroll
      for (int r = 0; r < ROWS; ++r) part[(slot * ROWS + r) * ldp + lane] = acc.a[r];
    }
  } else {
    constexpr int kCq = NC / 4, kRg = ROWS / 8;
    const int c0 = lane % kCq * 4, rg = lane / kCq % kRg, ks = lane / (kCq * kRg);
#pragma unroll
    for (int off = kCq * kRg; off < 32; off *= 2)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc.a[i] += __shfl_xor_sync(0xffffffffu, acc.a[i], off);
    __syncthreads();
    if (ks == 0) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
        *reinterpret_cast<float4*>(part + (slot * ROWS + rg + kRg * i) * ldp + c0) =
            make_float4(acc.a[4 * i], acc.a[4 * i + 1], acc.a[4 * i + 2], acc.a[4 * i + 3]);
    }
  }
}

// The NS slots' partial sums of element i of a tile (planes `stride` floats
// apart), added in a fixed pairwise order (slot s with s + NS / 2, then
// s + NS / 4, ...).
template <int NS>
__device__ __forceinline__ float slice_sum(const float* __restrict__ part, int i, int stride) {
  static_assert(NS == 2 || NS == 4 || NS == 8 || NS == 16, "up to four levels of pairs");
  float s[NS];
#pragma unroll
  for (int w = 0; w < NS; ++w) s[w] = part[w * stride + i];
  if constexpr (NS == 16) {
#pragma unroll
    for (int w = 0; w < 8; ++w) s[w] += s[w + 8];
  }
  if constexpr (NS >= 8) {
#pragma unroll
    for (int w = 0; w < 4; ++w) s[w] += s[w + 4];
  }
  if constexpr (NS >= 4) {
    s[0] += s[2];
    s[1] += s[3];
  }
  return s[0] + s[1];
}

// Rows [k0, k0 + kc) of a weight's columns [col0, col0 + N) (fp32, row stride
// ldw) into dst (row stride ld) by cp.async, 16 bytes a copy; the caller
// commits the group.
template <int N>
__device__ __forceinline__ void load_cols(float* __restrict__ dst, int ld,
                                          const float* __restrict__ w, int ldw, int col0, int k0,
                                          int kc) {
  for (int i = threadIdx.x; i < kc * (N / 4); i += kThreads) {
    const int k = i / (N / 4), c = i % (N / 4) * 4;
    cp_async16(dst + k * ld + c, w + (size_t)(k0 + k) * ldw + col0 + c);
  }
}

// Thread k's column (K <= kThreads) of the tile's rows [row0, row0 + nrows)
// of a (B, K) activation, widened to fp32, into registers (0 past nrows), so
// that the loads are in flight while the CTA asks for its slices; put_rows
// stores them at stride slice_ld(K).
template <int ROWS, typename T>
__device__ __forceinline__ void fetch_rows(const T* __restrict__ x, int row0, int nrows, int K,
                                           float (&reg)[ROWS]) {
  const int k = threadIdx.x;
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
    reg[r] = k < K && r < nrows ? to_f32<T>(x[(size_t)(row0 + r) * K + k]) : 0.f;
}

template <int ROWS>
__device__ __forceinline__ void put_rows(const float (&reg)[ROWS], int K, float* __restrict__ xs) {
  const int k = threadIdx.x;
  if (k < K) {
#pragma unroll
    for (int r = 0; r < ROWS; ++r) xs[r * slice_ld(K) + k] = reg[r];
  }
}

// The tile's rows [row0, row0 + nrows) of a (B, K) activation, widened to
// fp32, into xs (ROWS, K) at row stride ldx (0 past nrows), for any K: eight
// loads a thread in flight before their stores.
template <int ROWS, typename T>
__device__ __forceinline__ void load_tile(const T* __restrict__ x, int row0, int nrows, int K,
                                          float* __restrict__ xs, int ldx) {
  constexpr int kBatch = 8;
  for (int i0 = threadIdx.x; i0 < ROWS * K; i0 += kBatch * kThreads) {
    float v[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int i = i0 + j * kThreads;
      v[j] = i < nrows * K ? to_f32<T>(x[(size_t)row0 * K + i]) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int i = i0 + j * kThreads;
      if (i < ROWS * K) xs[i / K * ldx + i % K] = v[j];
    }
  }
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

// The whole rows of a product whose 32-column slices the cluster's CTAs hold
// in T (vs, (ROWS, 32) in each CTA's shared memory; distributed shared
// memory), widened to fp32 into xs (row stride ldx): all of a thread's
// 16-byte reads from its peers in flight at once, then its stores. The peers
// must have written vs (a cluster barrier) and must not leave before this CTA
// has read it.
template <typename T, int ROWS>
__device__ __forceinline__ void gather_columns(cg::cluster_group& cluster, const T* vs,
                                               float* __restrict__ xs, int ldx) {
  constexpr int kVec = 16 / sizeof(T);        // elements a read
  constexpr int kChunks = kSliceCols / kVec;  // reads a row of a peer's columns
  constexpr int kGather = (kMaxRanks * ROWS * kChunks + kThreads - 1) / kThreads;
  const int n = (int)cluster.num_blocks() * ROWS * kChunks;
  uint4 v[kGather];
#pragma unroll
  for (int j = 0; j < kGather; ++j) {
    const int i = threadIdx.x + j * kThreads;
    const int c = i % kChunks * kVec, r = i / kChunks % ROWS, p = i / (kChunks * ROWS);
    if (i < n)
      v[j] = *reinterpret_cast<const uint4*>(cluster.map_shared_rank(vs, p) + r * kSliceCols + c);
  }
#pragma unroll
  for (int j = 0; j < kGather; ++j) {
    const int i = threadIdx.x + j * kThreads;
    const int c = i % kChunks * kVec, r = i / kChunks % ROWS, p = i / (kChunks * ROWS);
    if (i < n) widen16<T>(v[j], xs + r * ldx + p * kSliceCols + c);
  }
}

// Shared memory of row_stats, in floats: its scratch (2 + kMaxRanks) * NL * ROWS,
// then mu and rs.
__host__ __device__ constexpr int row_stats_floats(int nl, int rows) {
  return (4 + kMaxRanks) * nl * rows;
}

// Each tile row's mean and 1 / sqrt(var + eps) for NL LayerNorms over N
// columns, of which each CTA of the cluster holds W: this CTA's columns of
// norm l are hs[r, l W .. l W + W) (row stride ldh). Two passes, as _ln
// computes them: every CTA writes its rows' partial sums into its shared
// memory; after a cluster barrier it reads all of them from its peers in rank
// order (distributed shared memory) and adds them in that order, so that
// every CTA holds the same bits; then the centred squares the same way. On
// return mu[l ROWS + r] and rs[l ROWS + r] hold the statistics, and, with
// kArrive, this CTA has arrived on a cluster barrier (it has read its peers'
// sums): it waits on it (cluster_wait) before it exits. Without kArrive the
// caller's next cluster barrier, which every CTA reaches only after these
// reads, guards the sums: st is not written again, and no CTA exits, before
// it.
template <int ROWS, int NL, int W, bool kArrive = true>
__device__ void row_stats(cg::cluster_group& cluster, const float* __restrict__ hs, int ldh,
                          int N, float* __restrict__ st) {
  constexpr int kN = NL * ROWS;
  float* sums = st;             // this CTA's partial sums of its columns
  float* squares = st + kN;     // this CTA's partial sums of the centred squares
  float* got = st + 2 * kN;     // (ranks, kN): the peers' sums
  float* mu = got + kMaxRanks * kN;
  float* rs = mu + kN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ranks = (int)cluster.num_blocks();
  for (int j = warp; j < kN; j += kWarps) {
    const float* h = hs + j % ROWS * ldh + j / ROWS * W;
    float s = 0.f;
#pragma unroll
    for (int c = lane; c < W; c += 32) s += h[c];
    s = warp_sum(s);
    if (lane == 0) sums[j] = s;
  }
  cluster.sync();
  for (int i = threadIdx.x; i < ranks * kN; i += kThreads)
    got[i] = cluster.map_shared_rank(sums, i / kN)[i % kN];
  __syncthreads();
  if (threadIdx.x < kN) {
    float s = 0.f;
    for (int p = 0; p < ranks; ++p) s += got[p * kN + threadIdx.x];
    mu[threadIdx.x] = s / N;
  }
  __syncthreads();
  for (int j = warp; j < kN; j += kWarps) {
    const float* h = hs + j % ROWS * ldh + j / ROWS * W;
    const float m = mu[j];
    float q = 0.f;
#pragma unroll
    for (int c = lane; c < W; c += 32) {
      const float d = h[c] - m;
      q = fmaf(d, d, q);
    }
    q = warp_sum(q);
    if (lane == 0) squares[j] = q;
  }
  cluster.sync();
  for (int i = threadIdx.x; i < ranks * kN; i += kThreads)
    got[i] = cluster.map_shared_rank(squares, i / kN)[i % kN];
  if constexpr (kArrive) cluster_arrive();  // this CTA has read its peers' sums
  __syncthreads();
  if (threadIdx.x < kN) {
    float q = 0.f;
    for (int p = 0; p < ranks; ++p) q += got[p * kN + threadIdx.x];
    rs[threadIdx.x] = rsqrtf(q / N + kLnEps);
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// K1 on a cluster
// ---------------------------------------------------------------------------

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
  const int warp = threadIdx.x / 32, kw = D / kWarps;
  {
    // the tile's rows first, so that they do not queue behind the slices
    float x[ROWS];
    fetch_rows<ROWS>(kv, row0, nrows, D, x);
    const int k = threadIdx.x;
    const float b = k < kSliceCols       ? __ldg(bv + col0 + k)
                    : k < 2 * kSliceCols ? __ldg(bo + col0 + k - kSliceCols)
                                         : 0.f;
    load_cols<kSliceCols>(wvs, kSliceCols, wv, D, col0, 0, D);
    cp_async_commit();
    // Wo's slice arrives while the first product runs
    load_cols<kSliceCols>(wos, kSliceCols, wo, D, col0, 0, D);
    cp_async_commit();
    put_rows<ROWS>(x, D, xs);
    if (k < 2 * kSliceCols) bs[k] = b;
  }
  SliceAcc<ROWS> acc;
  cp_async_wait<1>();
  __syncthreads();
  slice_zero(acc);
  slice_step<ROWS>(xs, ldx, warp * kw, kw, wvs + warp * kw * kSliceCols, kSliceCols, acc);
  slice_part<ROWS>(acc, wvs, warp, kSliceCols);
  __syncthreads();
  for (int i = threadIdx.x; i < ROWS * kSliceCols; i += kThreads)
    vs[i] = from_f32<T>(slice_sum<kWarps>(wvs, i, ROWS * kSliceCols) + bs[i % kSliceCols]);
  cluster.sync();
  gather_columns<T, ROWS>(cluster, vs, xs, ldx);
  cluster_arrive();  // this CTA has read its peers' v
  cp_async_wait<0>();
  __syncthreads();  // xs and wos are complete
  slice_zero(acc);
  slice_step<ROWS>(xs, ldx, warp * kw, kw, wos + warp * kw * kSliceCols, kSliceCols, acc);
  slice_part<ROWS>(acc, wvs, warp, kSliceCols);
  __syncthreads();
  for (int i = threadIdx.x; i < nrows * kSliceCols; i += kThreads)
    out[(size_t)(row0 + i / kSliceCols) * D + col0 + i % kSliceCols] =
        from_f32<T>(slice_sum<kWarps>(wvs, i, ROWS * kSliceCols) + bs[kSliceCols + i % kSliceCols]);
  cluster_wait();  // no CTA leaves while a peer may still read its v
}

// ---------------------------------------------------------------------------
// K2 on a cluster
// ---------------------------------------------------------------------------

// Shared memory of K2's cluster kernel, in floats: the Wv slice (then its
// partial sums, then Wo's slice and attn's partial sums), the Wg slice (then
// the gate's partial sums), q's rows, kv's rows (then v's), this CTA's
// columns of v (in T; room for floats) and of the gate (then the blend), the
// slices of bv, bo, bg, gamma and beta, the row statistics. 198.4 KB at
// D = 512, ROWS = 16.
__host__ __device__ constexpr int grb_cluster_smem_floats(int D, int rows) {
  return 2 * (D > kWarps * rows ? D : kWarps * rows) * kSliceCols + 2 * rows * slice_ld(D) +
         2 * rows * kSliceCols + 5 * kSliceCols + row_stats_floats(1, rows);
}

// K2 on a cluster of D / 32 CTAs: CTA blockIdx.x owns columns [32 x, 32 x + 32)
// of all three products and of the output, blockIdx.y is the tile of ROWS
// rows. Wv's and Wg's slices are asked for first; v's columns, rounded to T,
// are shared as K1 shares them while the gate product runs; Wo's slice comes
// into Wv's storage once v's sums are taken; the LayerNorm's row statistics
// go through two exchanges in distributed shared memory (row_stats).
template <typename T, int ROWS>
__global__ void __launch_bounds__(kThreads)
    gated_residual_cluster_kernel(const T* __restrict__ q, const T* __restrict__ kv,
                                  const float* __restrict__ wv, const float* __restrict__ bv,
                                  const float* __restrict__ wo, const float* __restrict__ bo,
                                  const float* __restrict__ wg, const float* __restrict__ bg,
                                  const float* __restrict__ gamma, const float* __restrict__ beta,
                                  T* __restrict__ out, int B, int D) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ float4 smem4[];
  const int slice = max(D, kWarps * ROWS) * kSliceCols;
  float* was = reinterpret_cast<float*>(smem4);  // Wv's slice, its sums, Wo's slice, attn's sums
  float* wgs = was + slice;                      // Wg's slice, then the gate's sums
  float* qs = wgs + slice;                       // (ROWS, D) at stride slice_ld(D): q
  float* xs = qs + ROWS * slice_ld(D);           // the same: kv, then the rounded v
  T* vs = reinterpret_cast<T*>(xs + ROWS * slice_ld(D));  // (ROWS, 32): its columns of v, in T
  float* hs = xs + ROWS * slice_ld(D) + ROWS * kSliceCols;  // (ROWS, 32): the gate, then the blend
  float* ps = hs + ROWS * kSliceCols;  // (5, 32): its slices of bv, bo, bg, gamma, beta
  float* st = ps + 5 * kSliceCols;     // row_stats
  const int ldx = slice_ld(D);
  const int col0 = blockIdx.x * kSliceCols;
  const int row0 = blockIdx.y * ROWS;
  const int nrows = min(ROWS, B - row0);
  const int warp = threadIdx.x / 32, kw = D / kWarps;
  {
    float xq[ROWS], xk[ROWS];
    fetch_rows<ROWS>(q, row0, nrows, D, xq);
    fetch_rows<ROWS>(kv, row0, nrows, D, xk);
    const int k = threadIdx.x;
    const float* src = k < kSliceCols       ? bv
                       : k < 2 * kSliceCols ? bo
                       : k < 3 * kSliceCols ? bg
                       : k < 4 * kSliceCols ? gamma
                                            : beta;
    const float p = k < 5 * kSliceCols ? __ldg(src + col0 + k % kSliceCols) : 0.f;
    load_cols<kSliceCols>(was, kSliceCols, wv, D, col0, 0, D);
    cp_async_commit();
    load_cols<kSliceCols>(wgs, kSliceCols, wg, D, col0, 0, D);
    cp_async_commit();
    put_rows<ROWS>(xq, D, qs);
    put_rows<ROWS>(xk, D, xs);
    if (k < 5 * kSliceCols) ps[k] = p;
  }
  SliceAcc<ROWS> acc;
  // v = round_T(kv @ Wv + bv): its columns, for the peers
  cp_async_wait<1>();
  __syncthreads();
  slice_zero(acc);
  slice_step<ROWS>(xs, ldx, warp * kw, kw, was + warp * kw * kSliceCols, kSliceCols, acc);
  slice_part<ROWS>(acc, was, warp, kSliceCols);
  __syncthreads();
  for (int i = threadIdx.x; i < ROWS * kSliceCols; i += kThreads)
    vs[i] = from_f32<T>(slice_sum<kWarps>(was, i, ROWS * kSliceCols) + ps[i % kSliceCols]);
  __syncthreads();  // every warp has read Wv's partial sums
  load_cols<kSliceCols>(was, kSliceCols, wo, D, col0, 0, D);  // arrives while the gate runs
  cp_async_commit();
  cluster_arrive();  // its columns of v are written
  // g = sigmoid(q @ Wg + bg)
  cp_async_wait<1>();
  __syncthreads();
  slice_zero(acc);
  slice_step<ROWS>(qs, ldx, warp * kw, kw, wgs + warp * kw * kSliceCols, kSliceCols, acc);
  slice_part<ROWS>(acc, wgs, warp, kSliceCols);
  __syncthreads();
  for (int i = threadIdx.x; i < ROWS * kSliceCols; i += kThreads)
    hs[i] = sigmoid(slice_sum<kWarps>(wgs, i, ROWS * kSliceCols) +
                    ps[2 * kSliceCols + i % kSliceCols]);
  cluster_wait();  // every CTA's columns of v
  gather_columns<T, ROWS>(cluster, vs, xs, ldx);
  cp_async_wait<0>();
  __syncthreads();  // xs and Wo's slice are complete
  // attn = v @ Wo + bo; the blend g * attn + (1 - g) * q
  slice_zero(acc);
  slice_step<ROWS>(xs, ldx, warp * kw, kw, was + warp * kw * kSliceCols, kSliceCols, acc);
  slice_part<ROWS>(acc, was, warp, kSliceCols);
  __syncthreads();
  for (int i = threadIdx.x; i < ROWS * kSliceCols; i += kThreads) {
    const int r = i / kSliceCols, c = i % kSliceCols;
    const float a = slice_sum<kWarps>(was, i, ROWS * kSliceCols) + ps[kSliceCols + c];
    const float g = hs[i];
    hs[i] = g * a + (1.f - g) * qs[r * ldx + col0 + c];
  }
  __syncthreads();
  // the LayerNorm over all D columns of each row
  row_stats<ROWS, 1, kSliceCols>(cluster, hs, kSliceCols, D, st);
  const float* mu = st + (2 + kMaxRanks) * ROWS;
  const float* rs = mu + ROWS;
  for (int i = threadIdx.x; i < nrows * kSliceCols; i += kThreads) {
    const int r = i / kSliceCols, c = i % kSliceCols;
    out[(size_t)(row0 + r) * D + col0 + c] = from_f32<T>(
        (hs[i] - mu[r]) * rs[r] * ps[3 * kSliceCols + c] + ps[4 * kSliceCols + c]);
  }
  cluster_wait();  // no CTA leaves while a peer may still read its sums
}

// ---------------------------------------------------------------------------
// K4 on a cluster
// ---------------------------------------------------------------------------

constexpr int kStageFloats = 8192;  // a stage of K4's ring: 32 KB of weight rows
constexpr int kStages = 4;          // stages of the ring (3 in flight)

// Shared memory of K4's cluster kernel, in floats: the ring of weight chunks
// (then the partial sums and the tile of both products), u's rows, the
// slices of the biases, gains and shifts, the row statistics. 200.5 KB at
// Du = 512, 256 columns a CTA, 32 rows.
__host__ __device__ constexpr int film_cluster_smem_floats(int Du, int cols, int rows) {
  return kStages * kStageFloats + rows * slice_ld(Du) + 3 * cols + row_stats_floats(2, rows);
}

// K4 on a cluster of Vd / (COLS / 2) CTAs: CTA blockIdx.x owns COLS / 2
// columns of both modulators, as one (Du, COLS) slice (Wf's columns, then
// Wg's), blockIdx.y is the tile of ROWS rows. The slice streams in chunks of
// kStageFloats / COLS weight rows through a ring of kStages stages (cp.async,
// one group a chunk, kStages - 1 in flight); each of the COLS / 32 column
// groups of warps splits a chunk's rows 16 a warp, the sums staying in
// registers over the chunks. Both LayerNorms' row statistics go through two
// exchanges in distributed shared memory (row_stats); v's columns are read
// into registers before them, and each CTA writes its columns of out.
template <typename T, int ROWS, int COLS>
__global__ void __launch_bounds__(kThreads)
    metablock_film_cluster_kernel(const T* __restrict__ v, const T* __restrict__ u,
                                  const float* __restrict__ wf, const float* __restrict__ bf,
                                  const float* __restrict__ gf, const float* __restrict__ hf,
                                  const float* __restrict__ wg, const float* __restrict__ bg,
                                  const float* __restrict__ gg, const float* __restrict__ hg,
                                  T* __restrict__ out, int B, int Du, int Vd) {
  constexpr int W = COLS / 2;                     // columns of each modulator
  constexpr int kSplit = kWarps * kSliceCols / COLS;  // warps that split a column group's k
  constexpr int kChunk = kStageFloats / COLS;     // weight rows a stage
  constexpr int kKw = kChunk / kSplit;            // a warp's rows of a chunk: 16
  constexpr int kV = (ROWS * W + kThreads - 1) / kThreads;  // v's elements a thread
  static_assert(COLS == 64 || COLS == 128 || COLS == 256, "32, 64 or 128 columns a modulator");
  static_assert(kSplit * ROWS * COLS + ROWS * COLS <= kStages * kStageFloats,
                "the partial sums and the tile fit in the ring");
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);  // the chunks, then the partial sums
  float* ts = ring + kSplit * ROWS * COLS;        // (ROWS, COLS): u @ [Wf Wg] + [bf bg]
  float* xs = ring + kStages * kStageFloats;      // (ROWS, Du) at stride slice_ld(Du): u
  float* ps = xs + ROWS * slice_ld(Du);  // (3, COLS): biases, gains, shifts (f's, then g's)
  float* st = ps + 3 * COLS;             // row_stats
  const int ldx = slice_ld(Du);
  const int col0 = blockIdx.x * W;
  const int row0 = blockIdx.y * ROWS;
  const int nrows = min(ROWS, B - row0);
  const int warp = threadIdx.x / 32;
  const int grp = warp / kSplit, slot = warp % kSplit;
  const int chunks = Du / kChunk;
  const auto load_chunk = [&](int j) {  // chunk j into its stage, as one group (empty past the end)
    if (j < chunks) {
      float* dst = ring + j % kStages * kStageFloats;
      load_cols<W>(dst, COLS, wf, Vd, col0, j * kChunk, kChunk);
      load_cols<W>(dst + W, COLS, wg, Vd, col0, j * kChunk, kChunk);
    }
    cp_async_commit();
  };
  {
    float x[ROWS];
    fetch_rows<ROWS>(u, row0, nrows, Du, x);
    for (int j = 0; j < kStages - 1; ++j) load_chunk(j);
    put_rows<ROWS>(x, Du, xs);
    for (int i = threadIdx.x; i < 3 * COLS; i += kThreads) {
      const int which = i / COLS, c = i % COLS;
      const bool g = c >= W;
      const float* src = which == 0 ? (g ? bg : bf) : which == 1 ? (g ? gg : gf) : (g ? hg : hf);
      ps[i] = __ldg(src + col0 + c % W);
    }
  }
  SliceAcc<ROWS> acc;
  slice_zero(acc);
  for (int j = 0; j < chunks; ++j) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // chunk j is in; every warp is done with chunk j - 1's stage
    load_chunk(j + kStages - 1);
    slice_step<ROWS>(xs, ldx, j * kChunk + slot * kKw, kKw,
                     ring + j % kStages * kStageFloats + slot * kKw * COLS + grp * kSliceCols,
                     COLS, acc);
  }
  cp_async_wait<0>();
  slice_part<ROWS>(acc, ring + grp * kSliceCols, slot, COLS);
  __syncthreads();
  for (int i = threadIdx.x; i < ROWS * COLS; i += kThreads)
    ts[i] = slice_sum<kSplit>(ring, i, ROWS * COLS) + ps[i % COLS];
  __syncthreads();
  T vr[kV];  // its columns of v, in flight during the exchanges
#pragma unroll
  for (int j = 0; j < kV; ++j) {
    const int i = threadIdx.x + j * kThreads, r = i / W;
    if (i < ROWS * W && r < nrows) vr[j] = v[(size_t)(row0 + r) * Vd + col0 + i % W];
  }
  // both LayerNorms over all Vd columns of each row: the modulators stay fp32
  row_stats<ROWS, 2, W>(cluster, ts, COLS, Vd, st);
  const float* mu = st + (2 + kMaxRanks) * 2 * ROWS;
  const float* rs = mu + 2 * ROWS;
#pragma unroll
  for (int j = 0; j < kV; ++j) {
    const int i = threadIdx.x + j * kThreads, r = i / W, c = i % W;
    if (i < ROWS * W && r < nrows) {
      const float t1 = (ts[r * COLS + c] - mu[r]) * rs[r] * ps[COLS + c] + ps[2 * COLS + c];
      const float t2 = (ts[r * COLS + W + c] - mu[ROWS + r]) * rs[ROWS + r] * ps[COLS + W + c] +
                       ps[2 * COLS + W + c];
      out[(size_t)(row0 + r) * Vd + col0 + c] =
          from_f32<T>(sigmoid(tanhf(to_f32<T>(vr[j]) * t1) + t2));
    }
  }
  cluster_wait();  // no CTA leaves while a peer may still read its sums
}

// ---------------------------------------------------------------------------
// K3 on a cluster
// ---------------------------------------------------------------------------

constexpr int kHeadCols2 = kSliceCols / 2;  // fc2's columns a CTA: N2 = N1 / 2 over N1 / 32 CTAs
constexpr int kHeadMaxOut = 32;             // fc_out's columns (N3) the cluster kernel takes
// a CTA's parameters: its slices of b1, g1, h1b (32 each) and of b2, g2, h2b
// (16 each), then b3, then its (16, N3) rows of W3
constexpr int kHeadB3 = 3 * kSliceCols + 3 * kHeadCols2;
constexpr int kHeadW3 = kHeadB3 + kHeadMaxOut;
constexpr int kHeadParams = kHeadW3 + kHeadCols2 * kHeadMaxOut;

// Shared memory of K3's cluster kernel, in floats: the ring (fc1's chunks, W2's
// slice as the chunk after them, the partial sums beside it; in rank 0 at the
// end every CTA's partial sums of fc_out), the tile's rows (x, then the
// gathered h1), this CTA's sums of fc1 (then of fc2, then its columns of
// h2), its columns of h1 (in T; room for floats), the parameters' slices, the
// row statistics. 200.2 KB at K1 = 1024, N1 = 512, 16 rows; 197.4 KB at
// K1 = 2048, 8 rows.
__host__ __device__ constexpr int mlp_head_cluster_smem_floats(int K1, int N1, int rows) {
  return kStages * kStageFloats + rows * slice_ld(K1 > N1 ? K1 : N1) + 2 * rows * kSliceCols +
         kHeadParams + row_stats_floats(1, rows);
}

// K3 on a cluster of N1 / 32 CTAs: CTA blockIdx.x owns 32 columns of fc1 and
// 16 of fc2, blockIdx.y is the tile of ROWS rows. Its (K1, 32) slice of W1
// streams in chunks of 256 rows through K4's ring (cp.async, one group a
// chunk, kStages - 1 in flight), each warp taking 16 rows of a chunk, the
// sums in registers over the chunks; its (N1, 16) slice of W2 follows as the
// ring's next chunk, so that it arrives while fc1 runs. LN1's row statistics
// through row_stats; its columns of h1, rounded to T, shared as K1 shares v
// (gather_columns); fc2 on the 16 columns; LN2 the same way; then each CTA's
// 16 columns of h2 times its 16 rows of W3 into rank 0's shared memory, which
// adds the CTAs' partial sums in rank order, adds b3 and writes the tile's
// rows of out.
template <typename T, int ROWS>
__global__ void __launch_bounds__(kThreads)
    mlp_head_cluster_kernel(const T* __restrict__ x, const float* __restrict__ w1,
                            const float* __restrict__ b1, const float* __restrict__ g1,
                            const float* __restrict__ h1b, const float* __restrict__ w2,
                            const float* __restrict__ b2, const float* __restrict__ g2,
                            const float* __restrict__ h2b, const float* __restrict__ w3,
                            const float* __restrict__ b3, T* __restrict__ out, int B, int K1,
                            int N1, int N2, int N3) {
  constexpr int kChunk = kStageFloats / kSliceCols;  // W1's rows a stage: 256
  constexpr int kKw = kChunk / kWarps;               // a warp's rows of a chunk: 16
  static_assert(kWarps * ROWS * kSliceCols <= 2 * kStageFloats, "the partial sums fit in 2 stages");
  static_assert(kMaxRanks * ROWS * kHeadMaxOut <= kStages * kStageFloats, "fc_out's sums fit");
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);
  float* xs = ring + kStages * kStageFloats;  // (ROWS, K1) at stride slice_ld(K1): x, then h1
  float* hs = xs + ROWS * slice_ld(K1 > N1 ? K1 : N1);  // (ROWS, 32): fc1's sums; (ROWS, 16): fc2's, h2
  T* vs = reinterpret_cast<T*>(hs + ROWS * kSliceCols);  // (ROWS, 32): its columns of h1, in T
  float* ps = hs + 2 * ROWS * kSliceCols;  // the parameters (b3 at kHeadB3, W3's rows at kHeadW3)
  float* st = ps + kHeadParams;            // row_stats
  const float* mu = st + (2 + kMaxRanks) * ROWS;
  const float* rs = mu + ROWS;
  const int rank = blockIdx.x, col0 = rank * kSliceCols, col2 = rank * kHeadCols2;
  const int row0 = blockIdx.y * ROWS;
  const int nrows = min(ROWS, B - row0);
  const int warp = threadIdx.x / 32;
  const int ldx = slice_ld(K1), ldh = slice_ld(N1);
  const int chunks = (K1 + kChunk - 1) / kChunk;
  float* w2s = ring + chunks % kStages * kStageFloats;  // (N1, 16): W2's slice, the next chunk
  float* part = ring + (chunks % kStages >= 2 ? 0 : 2) * kStageFloats;  // two stages beside it
  const auto load_chunk = [&](int j) {  // chunk j into its stage, as one group (empty past W2's)
    float* dst = ring + j % kStages * kStageFloats;
    if (j < chunks)
      load_cols<kSliceCols>(dst, kSliceCols, w1, N1, col0, j * kChunk, min(kChunk, K1 - j * kChunk));
    else if (j == chunks)
      load_cols<kHeadCols2>(dst, kHeadCols2, w2, N2, col2, 0, N1);
    cp_async_commit();
  };
  for (int j = 0; j < kStages - 1; ++j) load_chunk(j);
  load_tile<ROWS>(x, row0, nrows, K1, xs, ldx);
  {
    const int i = threadIdx.x;
    if (i < 3 * kSliceCols) {
      const float* src = i < kSliceCols ? b1 : i < 2 * kSliceCols ? g1 : h1b;
      ps[i] = __ldg(src + col0 + i % kSliceCols);
    } else if (i < kHeadB3) {
      const int j = i - 3 * kSliceCols;
      const float* src = j < kHeadCols2 ? b2 : j < 2 * kHeadCols2 ? g2 : h2b;
      ps[i] = __ldg(src + col2 + j % kHeadCols2);
    } else if (i < kHeadB3 + N3) {
      ps[i] = __ldg(b3 + i - kHeadB3);
    }
    for (int k = i; k < kHeadCols2 * N3; k += kThreads)
      ps[kHeadW3 + k] = __ldg(w3 + (size_t)col2 * N3 + k);
  }
  // fc1: x @ W1 + b1, its 32 columns
  SliceAcc<ROWS> acc;
  slice_zero(acc);
  for (int j = 0; j < chunks; ++j) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // chunk j is in; every warp is done with chunk j - 1's stage
    load_chunk(j + kStages - 1);
    if (warp * kKw < K1 - j * kChunk)  // the last chunk may hold fewer rows (K1 % 16 == 0)
      slice_step<ROWS>(xs, ldx, j * kChunk + warp * kKw, kKw,
                       ring + j % kStages * kStageFloats + warp * kKw * kSliceCols, kSliceCols, acc);
  }
  slice_part<ROWS>(acc, part, warp, kSliceCols);
  __syncthreads();
  for (int i = threadIdx.x; i < ROWS * kSliceCols; i += kThreads)
    hs[i] = slice_sum<kWarps>(part, i, ROWS * kSliceCols) + ps[i % kSliceCols];
  __syncthreads();
  // h1 = round_T(relu(LN1)): its columns, for the peers
  row_stats<ROWS, 1, kSliceCols, false>(cluster, hs, kSliceCols, N1, st);
  for (int i = threadIdx.x; i < ROWS * kSliceCols; i += kThreads) {
    const int r = i / kSliceCols, c = i % kSliceCols;
    vs[i] = from_f32<T>(
        fmaxf((hs[i] - mu[r]) * rs[r] * ps[kSliceCols + c] + ps[2 * kSliceCols + c], 0.f));
  }
  cluster.sync();   // every CTA's columns of h1 are written (and its reads of LN1's sums done)
  gather_columns<T, ROWS>(cluster, vs, xs, ldh);
  cp_async_wait<0>();
  __syncthreads();  // h1's rows and W2's slice are complete
  // fc2: h1 @ W2 + b2, its 16 columns, each warp N1 / 16 rows of the slice
  const int kw2 = N1 / kWarps;
  slice_zero(acc);
  slice_step<ROWS, kHeadCols2>(xs, ldh, warp * kw2, kw2, w2s + warp * kw2 * kHeadCols2, kHeadCols2,
                               acc);
  slice_part<ROWS, kHeadCols2>(acc, part, warp, kHeadCols2);
  __syncthreads();
  for (int i = threadIdx.x; i < ROWS * kHeadCols2; i += kThreads)
    hs[i] = slice_sum<kWarps>(part, i, ROWS * kHeadCols2) + ps[3 * kSliceCols + i % kHeadCols2];
  __syncthreads();
  // h2 = round_T(relu(LN2)), in place
  row_stats<ROWS, 1, kHeadCols2, false>(cluster, hs, kHeadCols2, N2, st);
  for (int i = threadIdx.x; i < ROWS * kHeadCols2; i += kThreads) {
    const int r = i / kHeadCols2, c = i % kHeadCols2;
    hs[i] = round_act<T>(fmaxf((hs[i] - mu[r]) * rs[r] * ps[3 * kSliceCols + kHeadCols2 + c] +
                                   ps[3 * kSliceCols + 2 * kHeadCols2 + c],
                               0.f));
  }
  __syncthreads();
  // fc_out: its 16 columns of h2 times its 16 rows of W3, into rank 0's ring
  // (its fc2 is done: it has arrived on LN2's barriers)
  float* po = cluster.map_shared_rank(ring, 0) + rank * ROWS * N3;
  for (int i = threadIdx.x; i < ROWS * N3; i += kThreads) {
    const int r = i / N3, n = i % N3;
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < kHeadCols2; ++k)
      s = fmaf(hs[r * kHeadCols2 + k], ps[kHeadW3 + k * N3 + n], s);
    po[i] = s;
  }
  cluster.sync();  // every CTA's partial sums of fc_out are in rank 0 (and LN2's reads done)
  if (rank == 0) {
    const int ranks = (int)cluster.num_blocks();
    for (int i = threadIdx.x; i < nrows * N3; i += kThreads) {
      float s = ring[i];
      for (int q = 1; q < ranks; ++q) s += ring[q * ROWS * N3 + i];
      out[(size_t)row0 * N3 + i] = from_f32<T>(s + ps[kHeadB3 + i % N3]);
    }
  }
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

inline int tiles(int B, int rows) { return (B + rows - 1) / rows; }

// f(std::integral_constant<int, V>{}) for the one of Vs that v equals; any
// other value is refused (cudaErrorInvalidValue).
template <int... Vs, typename F>
cudaError_t dispatch(int v, F&& f) {
  cudaError_t err = cudaErrorInvalidValue;
  (void)((v == Vs ? (err = f(std::integral_constant<int, Vs>{}), true) : false) || ...);
  return err;
}

template <typename T>
struct Act {
  using type = T;
};

// f(Act<T>{}) for the activation type: bfloat16 where act_bf16, else float.
template <typename F>
cudaError_t by_act(int act_bf16, F&& f) {
  return act_bf16 ? f(Act<__nv_bfloat16>{}) : f(Act<float>{});
}

// A one-block kernel's launch: a block per tile of ROWS rows.
template <int ROWS, typename Kernel, typename... Args>
cudaError_t block_launch(Kernel kernel, int B, size_t smem, cudaStream_t stream, Args... args) {
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<tiles(B, ROWS), kThreads, smem, stream>>>(args...);
  return cudaGetLastError();
}

// A cluster kernel's attributes (its shared memory, a cluster above the
// portable 8 CTAs) and launch configuration: clusters of `ranks` CTAs along
// x, `tiles` of them along y.
template <typename Kernel>
cudaError_t cluster_config(Kernel kernel, int ranks, int tiles, size_t smem,
                           cudaLaunchConfig_t& cfg, cudaLaunchAttribute& cluster) {
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

// How many clusters of `ranks` CTAs of a cluster kernel the current device
// holds at once: 0 where a CTA's shared memory is beyond a block's, or where
// no such cluster can be placed (a smaller card, a MIG slice).
template <typename Kernel>
cudaError_t cluster_count(Kernel kernel, int ranks, size_t smem, int* count) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  *count = 0;
  if (smem > (size_t)optin) return cudaSuccess;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute cluster;
  err = cluster_config(kernel, ranks, 1, smem, cfg, cluster);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveClusters(count, kernel, &cfg);
}

template <typename Kernel, typename... Args>
cudaError_t cluster_launch(Kernel kernel, int ranks, int tiles, size_t smem, cudaStream_t stream,
                           Args... args) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute cluster;
  cudaError_t err = cluster_config(kernel, ranks, tiles, smem, cfg, cluster);
  if (err != cudaSuccess) return err;
  cfg.stream = stream;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// Widths K1's and K2's cluster kernels take: D a multiple of 64 (16 warps
// split K four at a time) up to 512 (at most 16 CTAs of 32 columns).
inline bool d_cluster_shapes(int D) { return D % 64 == 0 && D >= 64 && D <= 512; }

// The column split K4's cluster kernel takes: `ranks` CTAs (at most 16) of
// Vd / ranks = 32, 64 or 128 columns of each modulator, with Du a multiple of
// 128 (whole ring chunks) up to 512 (a thread a column of u); returns the
// columns of a CTA's slice (both modulators'), or 0 for a split it does not take.
inline int film_cluster_cols(int Du, int Vd, int ranks) {
  if (ranks < 1 || ranks > kMaxRanks || Vd % ranks != 0) return 0;
  if (Du % 128 != 0 || Du < 128 || Du > 512) return 0;
  const int w = Vd / ranks;
  return w == 32 || w == 64 || w == 128 ? 2 * w : 0;
}

// The routes are chosen in ops/fusion_kernels.py (seq1_attention_plan,
// gated_residual_plan, metablock_film_plan, mlp_head_plan): the cluster
// kernel (with its rows a tile: 1, 8 or 32; K2 1, 8 or 16; K3 1, 8, 16 or 32)
// or the one-block kernel (1 or 4 rows). The entry points below only check them: a route whose widths,
// rows or weights' alignment the kernel does not take is refused.

template <typename T>
cudaError_t seq1_attention_route(int cluster, int rows, const void* kv, const float* wv,
                                 const float* bv, const float* wo, const float* bo, void* out,
                                 int B, int D, cudaStream_t s) {
  const T* x = static_cast<const T*>(kv);
  T* y = static_cast<T*>(out);
  if (cluster) {
    if (!d_cluster_shapes(D)) return cudaErrorInvalidValue;
    if (!aligned16(wv) || !aligned16(wo)) return cudaErrorMisalignedAddress;
    return dispatch<1, 8, 32>(rows, [&](auto r) {
      constexpr int R = decltype(r)::value;
      return cluster_launch(seq1_cluster_kernel<T, R>, D / kSliceCols, tiles(B, R),
                            seq1_cluster_smem_floats(D, R) * sizeof(float), s, x, wv, bv, wo, bo,
                            y, B, D);
    });
  }
  return dispatch<1, 4>(rows, [&](auto r) {
    constexpr int R = decltype(r)::value;
    return block_launch<R>(seq1_attention_kernel<T, R>, B, 2 * (size_t)R * D * sizeof(float), s,
                           x, wv, bv, wo, bo, y, B, D);
  });
}

template <typename T>
cudaError_t gated_residual_route(int cluster, int rows, const void* q, const void* kv,
                                 const float* wv, const float* bv, const float* wo,
                                 const float* bo, const float* wg, const float* bg,
                                 const float* gamma, const float* beta, void* out, int B, int D,
                                 cudaStream_t s) {
  const T* xq = static_cast<const T*>(q);
  const T* xk = static_cast<const T*>(kv);
  T* y = static_cast<T*>(out);
  if (cluster) {
    if (!d_cluster_shapes(D)) return cudaErrorInvalidValue;
    if (!aligned16(wv) || !aligned16(wo) || !aligned16(wg)) return cudaErrorMisalignedAddress;
    return dispatch<1, 8, 16>(rows, [&](auto r) {
      constexpr int R = decltype(r)::value;
      return cluster_launch(gated_residual_cluster_kernel<T, R>, D / kSliceCols, tiles(B, R),
                            grb_cluster_smem_floats(D, R) * sizeof(float), s, xq, xk, wv, bv, wo,
                            bo, wg, bg, gamma, beta, y, B, D);
    });
  }
  return dispatch<1, 4>(rows, [&](auto r) {
    constexpr int R = decltype(r)::value;
    return block_launch<R>(gated_residual_kernel<T, R>, B, 4 * (size_t)R * D * sizeof(float), s,
                           xq, xk, wv, bv, wo, bo, wg, bg, gamma, beta, y, B, D);
  });
}

template <typename T>
cudaError_t metablock_film_route(int cluster, int rows, const void* v, const void* u,
                                 const float* wf, const float* bf, const float* gf,
                                 const float* hf, const float* wg, const float* bg,
                                 const float* gg, const float* hg, void* out, int B, int Du,
                                 int Vd, cudaStream_t s) {
  const T* xv = static_cast<const T*>(v);
  const T* xu = static_cast<const T*>(u);
  T* y = static_cast<T*>(out);
  if (cluster) {
    const int cols = film_cluster_cols(Du, Vd, cluster);
    if (cols == 0) return cudaErrorInvalidValue;
    if (!aligned16(wf) || !aligned16(wg)) return cudaErrorMisalignedAddress;
    return dispatch<1, 8, 32>(rows, [&](auto r) {
      constexpr int R = decltype(r)::value;
      return dispatch<64, 128, 256>(cols, [&](auto c) {
        constexpr int C = decltype(c)::value;
        return cluster_launch(metablock_film_cluster_kernel<T, R, C>, cluster, tiles(B, R),
                              film_cluster_smem_floats(Du, C, R) * sizeof(float), s, xv, xu, wf,
                              bf, gf, hf, wg, bg, gg, hg, y, B, Du, Vd);
      });
    });
  }
  return dispatch<1, 4>(rows, [&](auto r) {
    constexpr int R = decltype(r)::value;
    return block_launch<R>(metablock_film_kernel<T, R>, B,
                           (size_t)R * (Du + 2 * Vd) * sizeof(float), s, xv, xu, wf, bf, gf, hf,
                           wg, bg, gg, hg, y, B, Du, Vd);
  });
}

// Widths K3's cluster kernel takes: N1 a multiple of 64 up to 512 (N1 / 32
// CTAs of 32 columns of fc1 and 16 of fc2), N2 = N1 / 2, N3 up to 32, K1 a
// multiple of 32 at which a tile of 8 rows fits beside the ring.
inline bool head_cluster_shapes(int K1, int N1, int N2, int N3) {
  return d_cluster_shapes(N1) && 2 * N2 == N1 && N3 >= 1 && N3 <= kHeadMaxOut && K1 >= 32 &&
         K1 % 32 == 0 && mlp_head_cluster_smem_floats(K1, N1, 8) * sizeof(float) <= kMaxSmem;
}

template <typename T>
cudaError_t mlp_head_route(int cluster, int rows, const void* x, const float* w1, const float* b1,
                           const float* g1, const float* h1, const float* w2, const float* b2,
                           const float* g2, const float* h2, const float* w3, const float* b3,
                           void* out, int B, int K1, int N1, int N2, int N3, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  T* y = static_cast<T*>(out);
  if (cluster) {
    if (!head_cluster_shapes(K1, N1, N2, N3)) return cudaErrorInvalidValue;
    if (!aligned16(w1) || !aligned16(w2)) return cudaErrorMisalignedAddress;
    return dispatch<1, 8, 16, 32>(rows, [&](auto r) {
      constexpr int R = decltype(r)::value;
      return cluster_launch(mlp_head_cluster_kernel<T, R>, N1 / kSliceCols, tiles(B, R),
                            mlp_head_cluster_smem_floats(K1, N1, R) * sizeof(float), s, xt, w1, b1,
                            g1, h1, w2, b2, g2, h2, w3, b3, y, B, K1, N1, N2, N3);
    });
  }
  return dispatch<1, 4>(rows, [&](auto r) {
    constexpr int R = decltype(r)::value;
    return block_launch<R>(mlp_head_kernel<T, R>, B, (size_t)R * (K1 + N1 + N2 + N3) * sizeof(float),
                           s, xt, w1, b1, g1, h1, w2, b2, g2, h2, w3, b3, y, B, K1, N1, N2, N3);
  });
}

}  // namespace

extern "C" {

const char* skinjax_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// act_bf16: 0 for float activations, 1 for bfloat16. Weights are fp32 (in, out).
// cluster and rows: the route, as ops/fusion_kernels.py seq1_attention_plan
// chooses it (1: the cluster kernel, 0: the one-block kernel).
int skinjax_seq1_attention(int act_bf16, int cluster, int rows, const void* kv, const float* wv,
                           const float* bv, const float* wo, const float* bo, void* out, int B,
                           int D, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return by_act(act_bf16, [&](auto a) {
    using T = typename decltype(a)::type;
    return seq1_attention_route<T>(cluster, rows, kv, wv, bv, wo, bo, out, B, D, s);
  });
}

// *count: how many clusters of K1's cluster kernel at width D and `rows` rows
// a tile the current device holds at once (cluster_count).
int skinjax_seq1_cluster_count(int act_bf16, int rows, int D, int* count) {
  if (!d_cluster_shapes(D)) return static_cast<int>(cudaErrorInvalidValue);
  return by_act(act_bf16, [&](auto a) {
    using T = typename decltype(a)::type;
    return dispatch<1, 8, 32>(rows, [&](auto r) {
      constexpr int R = decltype(r)::value;
      return cluster_count(seq1_cluster_kernel<T, R>, D / kSliceCols,
                           seq1_cluster_smem_floats(D, R) * sizeof(float), count);
    });
  });
}

// cluster and rows: the route, as ops/fusion_kernels.py gated_residual_plan
// chooses it (1: the cluster kernel, 0: the one-block kernel).
int skinjax_gated_residual_seq1(int act_bf16, int cluster, int rows, const void* q,
                                const void* kv, const float* wv, const float* bv, const float* wo,
                                const float* bo, const float* wg, const float* bg,
                                const float* gamma, const float* beta, void* out, int B, int D,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return by_act(act_bf16, [&](auto a) {
    using T = typename decltype(a)::type;
    return gated_residual_route<T>(cluster, rows, q, kv, wv, bv, wo, bo, wg, bg, gamma, beta,
                                   out, B, D, s);
  });
}

// *count: how many clusters of K2's cluster kernel at width D and `rows` rows
// a tile the current device holds at once.
int skinjax_gated_residual_cluster_count(int act_bf16, int rows, int D, int* count) {
  if (!d_cluster_shapes(D)) return static_cast<int>(cudaErrorInvalidValue);
  return by_act(act_bf16, [&](auto a) {
    using T = typename decltype(a)::type;
    return dispatch<1, 8, 16>(rows, [&](auto r) {
      constexpr int R = decltype(r)::value;
      return cluster_count(gated_residual_cluster_kernel<T, R>, D / kSliceCols,
                           grb_cluster_smem_floats(D, R) * sizeof(float), count);
    });
  });
}

// cluster and rows: the route, as ops/fusion_kernels.py metablock_film_plan
// chooses it (cluster: the CTAs of a cluster, Vd / cluster columns of each
// modulator a CTA; 0: the one-block kernel).
int skinjax_metablock_film(int act_bf16, int cluster, int rows, const void* v, const void* u,
                           const float* wf, const float* bf, const float* gf, const float* hf,
                           const float* wg, const float* bg, const float* gg, const float* hg,
                           void* out, int B, int Du, int Vd, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return by_act(act_bf16, [&](auto a) {
    using T = typename decltype(a)::type;
    return metablock_film_route<T>(cluster, rows, v, u, wf, bf, gf, hf, wg, bg, gg, hg, out, B,
                                   Du, Vd, s);
  });
}

// *count: how many clusters of K4's cluster kernel (`cluster` CTAs, widths
// Du and Vd, `rows` rows a tile) the current device holds at once.
int skinjax_metablock_film_cluster_count(int act_bf16, int rows, int cluster, int Du, int Vd,
                                         int* count) {
  const int cols = film_cluster_cols(Du, Vd, cluster);
  if (cols == 0) return static_cast<int>(cudaErrorInvalidValue);
  return by_act(act_bf16, [&](auto a) {
    using T = typename decltype(a)::type;
    return dispatch<1, 8, 32>(rows, [&](auto r) {
      constexpr int R = decltype(r)::value;
      return dispatch<64, 128, 256>(cols, [&](auto c) {
        constexpr int C = decltype(c)::value;
        return cluster_count(metablock_film_cluster_kernel<T, R, C>, cluster,
                             film_cluster_smem_floats(Du, C, R) * sizeof(float), count);
      });
    });
  });
}

// cluster and rows: the route, as ops/fusion_kernels.py mlp_head_plan
// chooses it (1: the cluster kernel, 0: the one-block kernel).
int skinjax_mlp_head(int act_bf16, int cluster, int rows, const void* x, const float* w1,
                     const float* b1, const float* g1, const float* h1, const float* w2,
                     const float* b2, const float* g2, const float* h2, const float* w3,
                     const float* b3, void* out, int B, int K1, int N1, int N2, int N3,
                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return by_act(act_bf16, [&](auto a) {
    using T = typename decltype(a)::type;
    return mlp_head_route<T>(cluster, rows, x, w1, b1, g1, h1, w2, b2, g2, h2, w3, b3, out, B, K1,
                             N1, N2, N3, s);
  });
}

// *count: how many clusters of K3's cluster kernel (widths K1 -> N1 -> N2 ->
// N3, `rows` rows a tile) the current device holds at once.
int skinjax_mlp_head_cluster_count(int act_bf16, int rows, int K1, int N1, int N2, int N3,
                                   int* count) {
  if (!head_cluster_shapes(K1, N1, N2, N3)) return static_cast<int>(cudaErrorInvalidValue);
  return by_act(act_bf16, [&](auto a) {
    using T = typename decltype(a)::type;
    return dispatch<1, 8, 16, 32>(rows, [&](auto r) {
      constexpr int R = decltype(r)::value;
      return cluster_count(mlp_head_cluster_kernel<T, R>, N1 / kSliceCols,
                           mlp_head_cluster_smem_floats(K1, N1, R) * sizeof(float), count);
    });
  });
}

}  // extern "C"
