// BatchNorm's per-channel reductions for Hopper (sm_90a): the statistics of
// the forward and the two sums of the backward, one read of the activation
// each.
//
// It replaces the Pallas TPU kernel K6 of skinjax/ops/pallas/bn_kernels.py:
// bn_stats (body _stats_kernel) and bn_grad_stats (body _grad_stats_kernel).
// x (and dy) are M rows of C channels, each row C contiguous elements in the
// input type (bf16 or fp32): a channels_last conv map (N, H, W rows) or a
// token batch (B, N rows). Per channel c, summed in fp32 over every row:
//
//   stats       out[0][c] = sum x[r][c]        out[1][c] = sum x[r][c]^2
//   grad stats  out[0][c] = sum dy[r][c]       out[1][c] = sum dy[r][c] * x[r][c]
//
// Launches. The TPU kernel carries its fp32 sums from one grid step to the
// next, in order. Here blocks run in no order, so the sum is split in two
// launches with no atomics: (1) bn_partial_kernel, a block per (channel tile,
// row segment), reads its (segment x tile) slab, rows coalesced along C, each
// thread 16 bytes at a time (8 bf16 or 4 fp32 channels; one element where C
// or the pointer does not allow it) over every blockDim.y-th row of the
// segment, then adds its threads' sums over the rows in a fixed order and
// writes the segment's partial part[seg][2][C]; (2) bn_reduce_kernel, a warp
// lane per channel, adds the partials: warp w of a block takes segments w,
// w + 8, w + 16, ... in order, then the eight warps' sums are added in warp
// order. The segments and the order of every sum follow from (M, C) alone, so
// two calls on the same inputs give bit-identical sums.
//
// What bounds it: bytes. Stats read x once (at ResNet-50's first BN at B=128,
// 1,605,632 rows x 64 channels in bf16, 205.5 MB: 61.3 us at 3.35 TB/s),
// grad stats x and dy (122.7 us); 2 or 3 operations an element are nothing
// beside that. The design keeps ~1056 blocks in flight (8 a SM) so the loads
// fill the memory pipe, and the partials (n_seg x 2C floats, under 1 MB)
// stay in L2 for the second launch.
//
// C interface: each entry point launches on the given stream and returns
// cudaGetLastError() as an int (0 = success); skinjax_bn_error_string maps the
// code to its message.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxVec = 8;        // elements a thread loads at once (16 bytes of bf16)
constexpr int kReduceWarps = 8;   // warps of bn_reduce_kernel

// V consecutive elements as fp32: one 16-byte load where V fills 16 bytes
// (the caller guarantees the alignment), else V loads of one element.
template <typename T, int V>
struct Loader;

template <int V>
struct Loader<float, V> {
  static __device__ __forceinline__ void load(const float* p, float (&v)[V]) {
    if constexpr (V == 4) {
      const float4 u = *reinterpret_cast<const float4*>(p);
      v[0] = u.x;
      v[1] = u.y;
      v[2] = u.z;
      v[3] = u.w;
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) v[i] = p[i];
    }
  }
};

template <int V>
struct Loader<__nv_bfloat16, V> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float (&v)[V]) {
    if constexpr (V == 8) {
      const uint4 u = *reinterpret_cast<const uint4*>(p);
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(h[i]);
        v[2 * i] = f.x;
        v[2 * i + 1] = f.y;
      }
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) v[i] = __bfloat162float(p[i]);
    }
  }
};

// Block (blockIdx.x: a tile of blockDim.x channel vectors of V channels;
// blockIdx.y: rows [seg * seg_rows, min(M, (seg + 1) * seg_rows))). Thread
// (tx, ty) sums rows ty, ty + blockDim.y, ... of its V channels; the block
// then adds those per-thread sums over ty in order and writes
// part[seg][0][c] and part[seg][1][c].
template <typename T, int V, bool kGrad>
__global__ void __launch_bounds__(kThreads)
bn_partial_kernel(const T* __restrict__ x, const T* __restrict__ dy, float* __restrict__ part,
                  int M, int C, int seg_rows) {
  __shared__ float acc[kThreads * 2 * kMaxVec];
  const int tx = threadIdx.x, ty = threadIdx.y, TX = blockDim.x, TY = blockDim.y;
  const int nvec = C / V;
  const int cv = blockIdx.x * TX + tx;
  const long long r0 = static_cast<long long>(blockIdx.y) * seg_rows;
  const long long r1 = min(r0 + seg_rows, static_cast<long long>(M));
  float a[V], b[V];
#pragma unroll
  for (int i = 0; i < V; ++i) a[i] = b[i] = 0.f;
  if (cv < nvec) {
    const long long col = static_cast<long long>(cv) * V;
#pragma unroll 4
    for (long long r = r0 + ty; r < r1; r += TY) {
      float xv[V];
      Loader<T, V>::load(x + r * C + col, xv);
      if constexpr (kGrad) {
        float gv[V];
        Loader<T, V>::load(dy + r * C + col, gv);
#pragma unroll
        for (int i = 0; i < V; ++i) {
          a[i] += gv[i];
          b[i] = fmaf(gv[i], xv[i], b[i]);
        }
      } else {
#pragma unroll
        for (int i = 0; i < V; ++i) {
          a[i] += xv[i];
          b[i] = fmaf(xv[i], xv[i], b[i]);
        }
      }
    }
  }
  // acc[ty][tx][j]: j < V the first sum's channel j, j >= V the second's
  float* mine = acc + (ty * TX + tx) * 2 * V;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    mine[i] = a[i];
    mine[V + i] = b[i];
  }
  __syncthreads();
  const int tid = ty * TX + tx;
  float* out = part + static_cast<long long>(blockIdx.y) * 2 * C;
  for (int p = tid; p < TX * 2 * V; p += TX * TY) {
    const int ptx = p / (2 * V), j = p % (2 * V);
    const int c = (blockIdx.x * TX + ptx) * V + j % V;
    if (c >= C) continue;
    float s = 0.f;
    for (int t = 0; t < TY; ++t) s += acc[(t * TX + ptx) * 2 * V + j];
    out[(j < V ? 0 : C) + c] = s;
  }
}

// Block (blockIdx.x: 32 channels; blockIdx.y: which sum). Lane l of warp w
// adds part[seg][which][c] over seg = w, w + 8, ... in order; warp 0 then
// adds the eight warps' sums in warp order into out[which][c].
__global__ void __launch_bounds__(32 * kReduceWarps)
bn_reduce_kernel(const float* __restrict__ part, float* __restrict__ out, int C, int n_seg) {
  __shared__ float acc[kReduceWarps][32];
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
  const int c = blockIdx.x * 32 + lane, which = blockIdx.y;
  float s = 0.f;
  if (c < C) {
    const float* p = part + static_cast<long long>(which) * C + c;
#pragma unroll 8
    for (int seg = w; seg < n_seg; seg += kReduceWarps)
      s += p[static_cast<long long>(seg) * 2 * C];
  }
  acc[w][lane] = s;
  __syncthreads();
  if (w == 0 && c < C) {
    float t = 0.f;
#pragma unroll
    for (int i = 0; i < kReduceWarps; ++i) t += acc[i][lane];
    out[which * C + c] = t;
  }
}

template <typename T, int V, bool kGrad>
int launch(const void* x, const void* dy, float* part, float* out, int M, int C, int tx,
           int seg_rows, int n_seg, cudaStream_t stream) {
  const int nvec = C / V;
  const dim3 block(tx, kThreads / tx);
  const dim3 grid((nvec + tx - 1) / tx, n_seg);
  bn_partial_kernel<T, V, kGrad><<<grid, block, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), part, M, C, seg_rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  bn_reduce_kernel<<<dim3((C + 31) / 32, 2), 32 * kReduceWarps, 0, stream>>>(part, out, C, n_seg);
  return static_cast<int>(cudaGetLastError());
}

bool bad_args(int M, int C, int vec, int tx, int seg_rows, int n_seg) {
  if (M <= 0 || C <= 0 || seg_rows <= 0 || n_seg <= 0 || n_seg > 65535) return true;
  if (tx <= 0 || tx > 32 || kThreads % tx) return true;
  if (vec <= 0 || C % vec) return true;
  return static_cast<long long>(seg_rows) * (n_seg - 1) >= M ||
         static_cast<long long>(seg_rows) * n_seg < M;
}

template <bool kGrad>
int dispatch(int bf16, const void* x, const void* dy, float* part, float* out, int M, int C,
             int vec, int tx, int seg_rows, int n_seg, void* stream) {
  if (bad_args(M, C, vec, tx, seg_rows, n_seg)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    if (vec == 8)
      return launch<__nv_bfloat16, 8, kGrad>(x, dy, part, out, M, C, tx, seg_rows, n_seg, s);
    if (vec == 1)
      return launch<__nv_bfloat16, 1, kGrad>(x, dy, part, out, M, C, tx, seg_rows, n_seg, s);
  } else {
    if (vec == 4) return launch<float, 4, kGrad>(x, dy, part, out, M, C, tx, seg_rows, n_seg, s);
    if (vec == 1) return launch<float, 1, kGrad>(x, dy, part, out, M, C, tx, seg_rows, n_seg, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

const char* skinjax_bn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// bf16: 0 for float, 1 for bfloat16. x: M rows of C contiguous elements.
// vec: elements a thread loads at once (8 for bf16 or 4 for fp32 where C is
// a multiple and x is 16-byte aligned, else 1); tx: threads of a block along
// the channel vectors (a power of two <= 32); the rows split into n_seg
// segments of seg_rows. Scratch: part (n_seg, 2, C) fp32. Writes out (2, C)
// fp32: the sums of x and of x^2.
int skinjax_bn_stats(int bf16, const void* x, float* part, float* out, int M, int C, int vec,
                     int tx, int seg_rows, int n_seg, void* stream) {
  return dispatch<false>(bf16, x, x, part, out, M, C, vec, tx, seg_rows, n_seg, stream);
}

// As skinjax_bn_stats, with dy laid out as x (and 16-byte aligned where vec >
// 1); writes out (2, C): the sums of dy and of dy * x.
int skinjax_bn_grad_stats(int bf16, const void* x, const void* dy, float* part, float* out, int M,
                          int C, int vec, int tx, int seg_rows, int n_seg, void* stream) {
  return dispatch<true>(bf16, x, dy, part, out, M, C, vec, tx, seg_rows, n_seg, stream);
}

}  // extern "C"
