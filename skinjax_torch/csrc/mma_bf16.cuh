// Building blocks of the bf16 tensor-core attention kernels (sm_90a):
// global_attention.cu's forward and backwards, pooled_attention.cu's forward
// and backward, window_attention.cu's forward core, output projection and
// strip backward, and channel_attention.cu's bf16 kernels.
//
// A warp computes (16 rows x 16 keys) blocks of scores with
// mma.sync.m16n8k16 (bf16 operands, fp32 accumulators in registers), its
// operands brought from shared memory by ldmatrix; tiles of 64 rows (and the
// fp32 planes added to the scores) stream through shared memory two deep
// with cp.async. Fragment layouts (PTX ISA, "Matrix fragments for
// mma.m16n8k16"; g = lane / 4, t = lane % 4):
//   A (16 x 16, row major)  a0 (g, 2t..2t+1)  a1 (g+8, 2t..)  a2 (g, 8+2t..)  a3 (g+8, 8+2t..)
//   B (16 x 8, k x n)       b0 (k 2t..2t+1, n g)  b1 (k 8+2t.., n g)
//   C (16 x 8, fp32)        c0, c1 (g, 2t..2t+1)  c2, c3 (g+8, 2t..2t+1)
// so the accumulator of a score block, rounded to bf16 and packed in pairs,
// is the A operand of the next product (P.V, ds.K) without leaving
// registers, and movmatrix transposes it into the A operand of P^T.dO.
//
// A shared-memory tile holds 64 rows of kD bf16 at a row stride of kD + 8
// elements: 16 bytes of padding put the eight rows an ldmatrix phase reads on
// eight different 16-byte bank groups for kD = 32, 64, 96 and 128.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kTile = 64;          // rows (queries or keys) a tile
constexpr int kTileThreads = 128;  // four warps, 16 rows of a tile each

template <int kD>
__host__ __device__ constexpr int tile_ld() {
  return kD + 8;
}

template <int kD>
__host__ __device__ constexpr int tile_bytes() {
  return kTile * tile_ld<kD>() * 2;
}

// whether a pointer allows 16-byte copies
inline bool aligned16(const void* p) { return (reinterpret_cast<std::uintptr_t>(p) & 15) == 0; }

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(smem)), "l"(gmem));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(smem)), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// c += a . b on the tensor cores: a 16 x 16 and b 16 x 8 bf16, c 16 x 8 fp32
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x on the special-function unit (flush to zero; 2^-inf = 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

constexpr float kLog2e = 1.4426950408889634f;

// The transpose of an 8 x 8 bf16 block held as an accumulator pair (thread
// g, t holds row g, columns 2t..2t+1), in the same layout
__device__ __forceinline__ unsigned movmatrix_t(unsigned x) {
  unsigned y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
}

// two fp32 rounded to bf16 and packed, the lower column in the low half
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&h);
}

// dst (kTile x kD at row stride tile_ld<kD>()) = rows [r0, r0 + kTile) and
// columns [0, kD) of the row-major bf16 matrix src (row r at src + r * ld),
// zero at rows >= rows and columns >= cols. With vec the copies are 16-byte
// cp.async, in flight until the caller waits for its group (cols, ld and src
// must then be multiples of 8 elements and 16-byte aligned); else plain
// element copies.
template <int kD>
__device__ __forceinline__ void load_tile(bf16* __restrict__ dst, const bf16* __restrict__ src,
                                          long long ld, int r0, int rows, int cols, bool vec) {
  constexpr int L = tile_ld<kD>(), V = kD / 8;
  for (int i = threadIdx.x; i < kTile * V; i += kTileThreads) {
    const int r = i / V, c = (i - r * V) * 8;
    bf16* d = dst + r * L + c;
    const bf16* s = src + (long long)(r0 + r) * ld + c;
    if (r0 + r < rows && c < cols) {
      if (vec) {
        cp_async16(d, s);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) d[e] = c + e < cols ? s[e] : __float2bfloat16_rn(0.f);
      }
    } else {
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

// An fp32 plane tile in shared memory: 64 rows at a stride of kPlaneLd
// floats. A thread reads its score fragment's pairs as float2; the 8-float
// padding keeps each half-warp's 64-bit reads on distinct banks.
constexpr int kPlaneLd = kTile + 8;
constexpr int kPlaneFloats = kTile * kPlaneLd;

// dst (64 x kPlaneLd) = rows [r0, r0 + 64) and columns [c0, c0 + 64) of the
// row-major (rows x cols) fp32 plane src with rows ld floats apart (ld >=
// cols), zero outside it; in flight (cp.async) until the caller waits for its
// group: 16-byte copies when ld % 4 == 0 and src is 16-byte aligned, else
// 4-byte ones. A thread keeps one column (of 16 bytes or 4) and walks rows
// kTileThreads / 16 (or / 64) apart, a fixed count of steps (unrolled, fully
// or by 4), so a copy costs a compare and two pointer steps.
__device__ __forceinline__ void load_plane(float* __restrict__ dst, const float* __restrict__ src,
                                           int rows, int cols, int r0, int c0, int ld) {
  if ((ld & 3) == 0 && (reinterpret_cast<unsigned long long>(src) & 15) == 0) {
    constexpr int kStep = kTileThreads / 16;
    const int c = (threadIdx.x & 15) * 4, r = threadIdx.x >> 4;
    const bool in = c0 + c < cols;
    const float* s = src + (long long)(r0 + r) * ld + c0 + c;
    float* d = dst + r * kPlaneLd + c;
#pragma unroll
    for (int i = 0; i < kTile / kStep; ++i, s += (long long)kStep * ld, d += kStep * kPlaneLd) {
      if (in && r0 + r + i * kStep < rows)
        cp_async16(d, s);
      else
        *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  } else {
    constexpr int kStep = kTileThreads / 64;
    const int c = threadIdx.x & 63, r = threadIdx.x >> 6;
    const bool in = c0 + c < cols;
    const float* s = src + (long long)(r0 + r) * ld + c0 + c;
    float* d = dst + r * kPlaneLd + c;
#pragma unroll 4
    for (int i = 0; i < kTile / kStep; ++i, s += (long long)kStep * ld, d += kStep * kPlaneLd) {
      if (in && r0 + r + i * kStep < rows)
        cp_async4(d, s);
      else
        *d = 0.f;
    }
  }
}

// load_plane of a plane with rows cols floats apart
__device__ __forceinline__ void load_plane(float* __restrict__ dst, const float* __restrict__ src,
                                           int rows, int cols, int r0, int c0) {
  load_plane(dst, src, rows, cols, r0, c0, cols);
}

// The pair of a staged plane tile p at (local row rl, local columns c, c + 1)
__device__ __forceinline__ float2 plane_pair(const float* p, int rl, int c) {
  return *reinterpret_cast<const float2*>(p + rl * kPlaneLd + c);
}

// dst[i] = src[i] for i < count (count <= 64), zero up to 64; cp.async
__device__ __forceinline__ void load_vec64(float* __restrict__ dst, const float* __restrict__ src,
                                           int count) {
  for (int i = threadIdx.x; i < kTile; i += kTileThreads) {
    if (i < count)
      cp_async4(dst + i, src + i);
    else
      dst[i] = 0.f;
  }
}

// The A fragments of this warp's 16 rows of a tile (rows at a stride of
// tile_ld<kD>()), one set of four registers per 16 columns.
template <int kD>
__device__ __forceinline__ void load_a(unsigned (&a)[kD / 16][4], const bf16* rows) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int ks = 0; ks < kD / 16; ++ks)
    ldsm_x4(a[ks], rows + (lane & 15) * tile_ld<kD>() + 16 * ks + (lane >> 4) * 8);
}

// s[jj] = the 16 x 8 blocks 2 kk + jj of A . X^T: A this warp's 16 rows
// (fragments a), X keys 16 kk .. 16 kk + 15 of the tile xs; the sum over the
// kD columns runs in 16-column steps in ascending order, the same for every
// caller, so the same operands give the same bits
template <int kD>
__device__ __forceinline__ void warp_abt_chunk(float (&s)[2][4], const unsigned (&a)[kD / 16][4],
                                               const bf16* xs, int kk) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < 2; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
  for (int ks = 0; ks < kD / 16; ++ks) {
    unsigned b[4];
    ldsm_x4(b, xs + (16 * kk + (lane & 7) + ((lane >> 4) << 3)) * tile_ld<kD>() + 16 * ks +
                   ((lane >> 3) & 1) * 8);
    mma_bf16(s[0], a[ks], b[0], b[1]);
    mma_bf16(s[1], a[ks], b[2], b[3]);
  }
}

// The B fragments of keys key0 .. key0 + 15 for a . x^T, as warp_abt_chunk
// reads them from a tile (b[ks] holds its two 16 x 8 blocks of the 16-column
// step ks), read here from device memory: rows key0.. of the row-major bf16
// matrix src (row r at src + r * ld), zero at rows >= rows and columns >=
// cols; with vec (cols and ld even, src 4-byte aligned) as 32-bit pairs
template <int kD>
__device__ __forceinline__ void load_b_global(unsigned (&b)[kD / 16][4],
                                              const bf16* __restrict__ src, long long ld,
                                              int key0, int rows, int cols, bool vec) {
  const int lane = threadIdx.x & 31, gq = lane >> 2, t = lane & 3;
#pragma unroll
  for (int ks = 0; ks < kD / 16; ++ks)
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int r = key0 + gq + ((u >> 1) << 3), c = 16 * ks + ((u & 1) << 3) + 2 * t;
      const bf16* x = src + (long long)r * ld + c;
      unsigned w = 0u;
      if (r < rows && c < cols) {
        if (vec) {
          w = *reinterpret_cast<const unsigned*>(x);
        } else {
          __nv_bfloat162 pair;
          pair.x = x[0];
          pair.y = c + 1 < cols ? x[1] : __float2bfloat16_rn(0.f);
          w = *reinterpret_cast<const unsigned*>(&pair);
        }
      }
      b[ks][u] = w;
    }
}

// warp_abt_chunk with the B fragments already in registers (load_b_global):
// the same products in the same order
template <int kD>
__device__ __forceinline__ void warp_abt_frag(float (&s)[2][4], const unsigned (&a)[kD / 16][4],
                                              const unsigned (&b)[kD / 16][4]) {
#pragma unroll
  for (int j = 0; j < 2; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
  for (int ks = 0; ks < kD / 16; ++ks) {
    mma_bf16(s[0], a[ks], b[ks][0], b[ks][1]);
    mma_bf16(s[1], a[ks], b[ks][2], b[ks][3]);
  }
}

// The A fragment of 16 keys of a score-shaped tile held as the two
// accumulator blocks x: rounded to bf16 and packed
__device__ __forceinline__ void pack_a_chunk(unsigned (&a)[4], const float (&x)[2][4]) {
  a[0] = pack_bf16(x[0][0], x[0][1]);
  a[1] = pack_bf16(x[0][2], x[0][3]);
  a[2] = pack_bf16(x[1][0], x[1][1]);
  a[3] = pack_bf16(x[1][2], x[1][3]);
}

// acc (16 x kD) += A . X[16 kk .. 16 kk + 15]: A one 16-key fragment, X the
// (64 x kD) tile xs (B fragments by ldmatrix.trans)
template <int kD>
__device__ __forceinline__ void warp_ax_chunk(float (&acc)[kD / 8][4], const unsigned (&a)[4],
                                              const bf16* xs, int kk) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int jd = 0; jd < kD / 16; ++jd) {
    unsigned b[4];
    ldsm_x4_trans(b, xs + (16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8) * tile_ld<kD>() +
                         16 * jd + (lane >> 4) * 8);
    mma_bf16(acc[2 * jd], a, b[0], b[1]);
    mma_bf16(acc[2 * jd + 1], a, b[2], b[3]);
  }
}

// acc[2 kk + j] += a . X^T over the 16 columns 16 ks.. of the (32 x 32) tile xs
// at row stride tile_ld<32>() (X rows 16 kk + 8 j..: the output columns), as
// do = dy . Wproj_head^T takes a head's Wproj rows
__device__ __forceinline__ void warp_abt_step(float (&acc)[4][4], const unsigned (&a)[4],
                                              const bf16* xs, int ks) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    unsigned b[4];
    ldsm_x4(b, xs + (16 * kk + (lane & 7) + ((lane >> 4) << 3)) * tile_ld<32>() + 16 * ks +
                   ((lane >> 3) & 1) * 8);
    mma_bf16(acc[2 * kk], a, b[0], b[1]);
    mma_bf16(acc[2 * kk + 1], a, b[2], b[3]);
  }
}

// Steps of load(k, buffer) then compute(k, buffer), two buffers deep: step
// k + 1's tiles are in flight (cp.async) while step k computes. Every compute
// starts after a barrier that follows its tiles' arrival, and ends with one,
// so the buffers are free when the loop returns.
template <typename Load, typename Compute>
__device__ __forceinline__ void pipeline(int steps, Load load, Compute compute) {
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

// rows r and r + 8 of x (kD / 8 blocks of 16 x 8 accumulators), columns 8 jd +
// 2 t + {0, 1} below hd, rounded (times mul) to bf16 into out (row n at out +
// n * ldo); rows past N skipped
template <int kD>
__device__ __forceinline__ void store_frag_rows(bf16* __restrict__ out, long long ldo,
                                                const float (&x)[kD / 8][4], int r, int N,
                                                int hd, float mul, bool pairs) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int n = r + 8 * h;
    if (n >= N) continue;
    bf16* row = out + (long long)n * ldo;
#pragma unroll
    for (int jd = 0; jd < kD / 8; ++jd) {
      const int d = 8 * jd + 2 * t;
      const float a = x[jd][2 * h] * mul, c = x[jd][2 * h + 1] * mul;
      if (pairs && d < hd) {
        *reinterpret_cast<__nv_bfloat162*>(row + d) = __floats2bfloat162_rn(a, c);
      } else {
        if (d < hd) row[d] = __float2bfloat16_rn(a);
        if (d + 1 < hd) row[d + 1] = __float2bfloat16_rn(c);
      }
    }
  }
}

template <int kD>
__device__ __forceinline__ void zero_acc(float (&x)[kD / 8][4]) {
#pragma unroll
  for (int jd = 0; jd < kD / 8; ++jd) x[jd][0] = x[jd][1] = x[jd][2] = x[jd][3] = 0.f;
}

// The transposes of a (16 x 16) score-shaped block held as the two
// accumulator blocks x, rounded to bf16 and packed: the A fragment of its
// (16 keys x 16 queries) transpose, for x^T . X (movmatrix in registers)
__device__ __forceinline__ void pack_at_chunk(unsigned (&a)[4], const float (&x)[2][4]) {
  a[0] = movmatrix_t(pack_bf16(x[0][0], x[0][1]));
  a[1] = movmatrix_t(pack_bf16(x[1][0], x[1][1]));
  a[2] = movmatrix_t(pack_bf16(x[0][2], x[0][3]));
  a[3] = movmatrix_t(pack_bf16(x[1][2], x[1][3]));
}

// the largest of a row's values over the four threads of its quad
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

// the sum of a row's values over the four threads of its quad; every thread
// of the quad gets the same bits (a + b == b + a)
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// One step of the online softmax for this thread's two rows (h = 0: row g,
// h = 1: row g + 8) over U blocks of (16 x 16) scores s: each row's max m
// grows to the max over its quad, its sum becomes l * 2^((m_old - m) log2 e)
// plus the exponents 2^((s - m) log2 e) of the step, added in block, column
// order, and each exponent e also goes to f(h, u, j, c, e) in that order;
// sc[h] is the step's rescale 2^((m_old - m) log2 e). Every bf16 attention
// kernel's first pass over the keys takes this step and ends with
// softmax_finish, so that for the same scores their m and l are the same bits.
template <int U, typename F>
__device__ __forceinline__ void online_softmax(const float (&s)[U][2][4], float (&mx)[2],
                                               float (&l)[2], float (&sc)[2], F&& f) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float tm = -CUDART_INF_F;
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int j = 0; j < 2; ++j) tm = fmaxf(tm, fmaxf(s[u][j][2 * h], s[u][j][2 * h + 1]));
    const float mn = fmaxf(mx[h], quad_max(tm));
    const float mnl = mn * kLog2e;
    sc[h] = ex2(__fmaf_rn(mx[h], kLog2e, -mnl));
    float se = 0.f;
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float e = ex2(__fmaf_rn(s[u][j][2 * h + c], kLog2e, -mnl));
          se += e;
          f(h, u, j, c, e);
        }
    l[h] = l[h] * sc[h] + se;
    mx[h] = mn;
  }
}

// online_softmax with nothing more to do with an exponent
template <int U>
__device__ __forceinline__ void online_softmax(const float (&s)[U][2][4], float (&mx)[2],
                                               float (&l)[2]) {
  float sc[2];
  online_softmax(s, mx, l, sc, [](int, int, int, int, float) {});
}

// The end of the online softmax: l becomes the row's sum over its quad (the
// same bits in every thread of the quad), inv = 1 / l and mxl = m log2 e
__device__ __forceinline__ void softmax_finish(const float (&mx)[2], float (&l)[2],
                                               float (&inv)[2], float (&mxl)[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] = quad_sum(l[h]);
    inv[h] = 1.f / l[h];
    mxl[h] = mx[h] * kLog2e;
  }
}

// P from a score, its row's max times log2(e) and 1 / sum: the one
// expression every bf16 attention kernel uses
__device__ __forceinline__ float prob(float s, float mxl, float inv) {
  return __fmul_rn(ex2(__fmaf_rn(s, kLog2e, -mxl)), inv);
}

}  // namespace
