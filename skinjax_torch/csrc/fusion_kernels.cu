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
// Design (first, simple version): one thread block per tile of ROWS batch
// rows. The block keeps the whole chain in shared memory and registers, as
// the TPU kernels keep it in VMEM: no intermediate goes to device memory, and
// each weight element is read once per block and used for all ROWS rows.
// Weights are fp32 in (in, out) layout, read with one output column per
// thread so that a warp reads 128 contiguous bytes of a weight row.
// Accumulation is fp32. The activation type T (float or __nv_bfloat16) is a
// template parameter; values are rounded to T at exactly the points where the
// Pallas kernels cast to the activation dtype, and the output is T.
// wgmma, TMA and splitting a product across blocks are left for later work.
// For K4 the split needs a LayerNorm over all Vd columns of a row, which one
// block no longer holds: a second launch (products into a (B, Vd) fp32
// scratch over many blocks, then LN and the FiLM per row) or a thread-block
// cluster reducing in distributed shared memory. This first version keeps
// the one-block design of K1-K3, so at B = 1 one SM streams all 8.4 MB.
//
// C interface: every entry point launches on the given stream and returns
// cudaGetLastError() as an int (0 = success); skinjax_error_string maps the
// code to its message.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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
int skinjax_seq1_attention(int act_bf16, const void* kv, const float* wv, const float* bv,
                           const float* wo, const float* bo, void* out, int B, int D,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool one = rows_for(B) == 1;
  if (act_bf16)
    return one ? seq1_attention_launch<__nv_bfloat16, 1>(kv, wv, bv, wo, bo, out, B, D, s)
               : seq1_attention_launch<__nv_bfloat16, 4>(kv, wv, bv, wo, bo, out, B, D, s);
  return one ? seq1_attention_launch<float, 1>(kv, wv, bv, wo, bo, out, B, D, s)
             : seq1_attention_launch<float, 4>(kv, wv, bv, wo, bo, out, B, D, s);
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
