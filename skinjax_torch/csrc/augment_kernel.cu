// The color stage of the training augmentation, for Hopper (sm_90a).
//
// It replaces the Pallas TPU kernel K5 of skinjax/ops/pallas/augment_kernel.py
// (fused_color_stage, the body _color_kernel). Per pixel, in one pass:
//
//   coarse dropout (up to 5 square holes) -> RGB->HSV, shift, HSV->RGB ->
//   brightness/contrast -> ImageNet normalize -> cast to the output type
//
// Per-image parameters come from draw_color_params, outside the kernel:
//   fparams (B, 8) fp32  [do_dropout, do_hsv, hue, sat, val, do_bc, alpha, beta]
//   iparams (B, 12) int32 [n_holes, hole, ys0..ys4, xs0..xs4]
//
// What bounds it: ~80 fp32 operations per pixel against 12 bytes moved per
// pixel at bf16 in and out (3 channels read, 3 written), i.e. ~7 operations per
// byte, far below the card's balance point. Device-memory bandwidth bounds it:
// at B=128, 224x224, bf16 in and out it moves 77 MB, 23 us at 3.35 TB/s. One
// thread a pixel, with 2-byte loads, a division for the pixel's row, every
// parameter and hole test at every pixel and seven IEEE divisions, issues too
// many instructions to come near that bound; the design cuts them:
//
// - Grid (row bands, images): blockIdx.y is the image, and a block of
//   (ceil(W / 8) capped, rows) threads takes a band of rows, so y and x come
//   from the thread's indices without a division.
// - Vector I/O: a thread takes 8 consecutive pixels of a row, 24 values: three
//   16-byte loads and stores at bf16, six at fp32. Images stay interleaved
//   NHWC, as the training pipeline holds them. Widths that are not a multiple
//   of 8, or unaligned tensors, take the same kernel with scalar loads.
// - Per-image values (the shifts times their gates, alpha and beta, each
//   hole's mask factor inside and outside, the normalize's reciprocals) are
//   computed once per block into shared memory.
// - The mask is a product of five hole factors, each exactly 1 outside its
//   hole unless do_dropout is not finite. A thread finds once per row the
//   holes whose factor can differ from 1 there; where there are none (no
//   dropout, or a row that misses every hole) the mask is exactly 1 and the
//   tests are skipped. Skipping a factor of exactly 1 leaves the product's
//   bits unchanged.
// - The hue's branch reads two of (maxc - c) / delta for c = r, g, b: only
//   those two are divided. The normalize's three divisions by constant stds
//   are a product with the correctly rounded reciprocal and one fused
//   multiply-add correction (normalize()): equal to the IEEE quotient for
//   every value clip01 can return, checked on the card for all of them and
//   each std (skinjax_k5_division_check). The other divisions stay IEEE.
//
// Arithmetic: fp32 throughout, the operations of the plain twin
// (ops/augment_kernel.py fused_color_stage_plain) in its order, but for the
// two steps above that give the same bits by other means (the hue's chosen
// operands, the normalize), so the output is bit for bit the twin's.
// Products that feed a sum use __fmul_rn/__fadd_rn so
// the compiler cannot contract them into fused multiply-adds, division is IEEE
// (no fast math), the two floored modulos are x - floorf(x) (C's fmodf
// truncates), and the output rounds once, to nearest even, at the end.
//
// C interface: the entry point launches on the given stream and returns
// cudaGetLastError() as an int (0 = success); skinjax_augment_error_string
// maps the code to its message.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>

#include "mma_bf16.cuh"  // aligned16

namespace {

constexpr int kThreads = 256;  // at most, a block
constexpr int kMaxHoles = 5;
constexpr int kPix = 8;           // consecutive pixels of a row a thread takes at a time
constexpr int kVals = 3 * kPix;   // their channels

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

__device__ __forceinline__ float clip01(float x) { return fminf(fmaxf(x, 0.f), 1.f); }

// x mod 1 with the sign of the divisor, as jnp's % and torch.remainder
__device__ __forceinline__ float mod1(float x) { return __fsub_rn(x, floorf(x)); }

// ImageNet's mean and std of channel c (0, 1, 2: r, g, b)
__device__ __forceinline__ float channel_mean(int c) {
  return c == 0 ? 0.485f : (c == 1 ? 0.456f : 0.406f);
}
__device__ __forceinline__ float channel_std(int c) {
  return c == 0 ? 0.229f : (c == 1 ? 0.224f : 0.225f);
}

// (c - mean) / std for every c that clip01 returns, bit for bit the IEEE
// quotient: q = d * rstd (rstd = RN(1 / std)) corrected once by the fused
// multiply-add residual d - q * std. skinjax_k5_division_check holds it
// against __fdiv_rn on the card for every such c and each of the three stds.
__device__ __forceinline__ float normalize(float c, float mean, float std, float rstd) {
  const float d = __fsub_rn(c, mean);
  const float q = __fmul_rn(d, rstd);
  return __fmaf_rn(__fmaf_rn(-q, std, d), rstd, q);
}

// One image's parameters, computed once per block with the operations the
// per-pixel code used to repeat.
struct ImageParams {
  float f_in[kMaxHoles];   // hole i's mask factor at a pixel inside it: 1 - active_i
  float f_out[kMaxHoles];  // and outside it: 1 - 0 * active_i (1 unless active_i is not finite)
  int ys[kMaxHoles], xs[kMaxHoles], hole;
  unsigned active;   // holes whose factor inside differs from 1
  unsigned odd_out;  // holes whose factor outside differs from 1
  float hue, sat, val;  // the shifts times do_hsv
  float alpha, beta;    // brightness/contrast, gated
  float rstd[3];        // RN(1 / std) a channel
};

__device__ void image_params(const float* __restrict__ f, const int* __restrict__ ip,
                             ImageParams& p) {
  const float do_drop = f[0];
  const int n_holes = ip[0];
  p.hole = ip[1];
  p.active = 0;
  p.odd_out = 0;
#pragma unroll
  for (int i = 0; i < kMaxHoles; ++i) {
    const float active = __fmul_rn(i < n_holes ? 1.f : 0.f, do_drop);
    p.f_in[i] = __fsub_rn(1.f, __fmul_rn(1.f, active));
    p.f_out[i] = __fsub_rn(1.f, __fmul_rn(0.f, active));
    p.ys[i] = ip[2 + i];
    p.xs[i] = ip[7 + i];
    if (p.f_in[i] != 1.f) p.active |= 1u << i;
    if (p.f_out[i] != 1.f) p.odd_out |= 1u << i;
  }
  const float do_hsv = f[1];
  p.hue = __fmul_rn(f[2], do_hsv);
  p.sat = __fmul_rn(f[3], do_hsv);
  p.val = __fmul_rn(f[4], do_hsv);
  const float do_bc = f[5];
  p.alpha = __fadd_rn(1.f, __fmul_rn(__fsub_rn(f[6], 1.f), do_bc));
  p.beta = __fmul_rn(f[7], do_bc);
#pragma unroll
  for (int c = 0; c < 3; ++c) p.rstd[c] = __frcp_rn(channel_std(c));
}

// One pixel at column x of a row whose hole bits are yin (the holes that
// cover the row) and sel (the holes whose factor can differ from 1 on it):
// (r, g, b) in, the normalized channels out.
__device__ __forceinline__ void color_pixel(float& r, float& g, float& bl, int x, unsigned yin,
                                            unsigned sel, const ImageParams& p) {
  // ---- coarse dropout: the mask is exactly 0 or 1 ----------------------
  if (sel) {
    float mask = 1.f;
#pragma unroll
    for (int i = 0; i < kMaxHoles; ++i) {
      if (sel >> i & 1u) {
        const bool inside = (yin >> i & 1u) && x >= p.xs[i] && x < p.xs[i] + p.hole;
        mask = __fmul_rn(mask, inside ? p.f_in[i] : p.f_out[i]);
      }
    }
    r = __fmul_rn(r, mask);
    g = __fmul_rn(g, mask);
    bl = __fmul_rn(bl, mask);
  }

  // ---- RGB -> HSV --------------------------------------------------------
  const float maxc = fmaxf(fmaxf(r, g), bl);
  const float minc = fminf(fminf(r, g), bl);
  const float delta = maxc - minc;
  const float safe = fmaxf(delta, 1e-12f);
  float s = maxc > 0.f ? delta / fmaxf(maxc, 1e-12f) : 0.f;
  // h = bc - gc, 2 + rc - bc or 4 + gc - rc with cc = (maxc - c) / safe:
  // a and c are the two the branch reads
  const bool rmax = r == maxc, gmax = g == maxc;
  const float a = (maxc - (rmax ? bl : (gmax ? r : g))) / safe;
  const float c = (maxc - (rmax ? g : (gmax ? bl : r))) / safe;
  float h = rmax ? a - c : (gmax ? 2.f : 4.f) + a - c;
  h = delta == 0.f ? 0.f : mod1(h / 6.f);

  // ---- shift -------------------------------------------------------------
  h = mod1(__fadd_rn(h, p.hue));
  s = clip01(__fadd_rn(s, p.sat));
  const float v = clip01(__fadd_rn(maxc, p.val));

  // ---- HSV -> RGB --------------------------------------------------------
  const float h6 = __fmul_rn(h, 6.f);
  const float i6 = floorf(h6);
  const float fr = __fsub_rn(h6, i6);
  const float pp = __fmul_rn(v, __fsub_rn(1.f, s));
  const float q = __fmul_rn(v, __fsub_rn(1.f, __fmul_rn(s, fr)));
  const float t = __fmul_rn(v, __fsub_rn(1.f, __fmul_rn(s, __fsub_rn(1.f, fr))));
  const int sector = static_cast<int>(i6) % 6;  // h in [0, 1], so i6 in [0, 6]
  // sectors 0..5: (v, t, p) (q, v, p) (p, v, t) (p, q, v) (t, p, v) (v, p, q)
  const float ro = sector == 0 || sector == 5 ? v : sector == 1 ? q : sector == 4 ? t : pp;
  const float go = sector == 1 || sector == 2 ? v : sector == 0 ? t : sector == 3 ? q : pp;
  const float bo = sector == 3 || sector == 4 ? v : sector == 2 ? t : sector == 5 ? q : pp;

  // ---- brightness/contrast, normalize ------------------------------------
  r = normalize(clip01(__fadd_rn(__fmul_rn(ro, p.alpha), p.beta)), 0.485f, 0.229f, p.rstd[0]);
  g = normalize(clip01(__fadd_rn(__fmul_rn(go, p.alpha), p.beta)), 0.456f, 0.224f, p.rstd[1]);
  bl = normalize(clip01(__fadd_rn(__fmul_rn(bo, p.alpha), p.beta)), 0.406f, 0.225f, p.rstd[2]);
}

// A chunk's kVals channels: 16-byte loads and stores (src/dst 16-byte
// aligned), or the first n pixels' by scalar accesses (the rest read as 0 and
// not written).
__device__ __forceinline__ void load_chunk(const float* __restrict__ src, float (&v)[kVals]) {
#pragma unroll
  for (int j = 0; j < kVals / 4; ++j) {
    const float4 u = __ldg(reinterpret_cast<const float4*>(src) + j);
    v[4 * j] = u.x;
    v[4 * j + 1] = u.y;
    v[4 * j + 2] = u.z;
    v[4 * j + 3] = u.w;
  }
}

__device__ __forceinline__ void load_chunk(const __nv_bfloat16* __restrict__ src,
                                           float (&v)[kVals]) {
#pragma unroll
  for (int j = 0; j < kVals / 8; ++j) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(src) + j);
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // a bf16's bits are the top half of its float's
      v[8 * j + 2 * i] = __uint_as_float(w[i] << 16);
      v[8 * j + 2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
}

__device__ __forceinline__ void store_chunk(float* __restrict__ dst, const float (&v)[kVals]) {
#pragma unroll
  for (int j = 0; j < kVals / 4; ++j)
    reinterpret_cast<float4*>(dst)[j] = make_float4(v[4 * j], v[4 * j + 1], v[4 * j + 2],
                                                    v[4 * j + 3]);
}

__device__ __forceinline__ unsigned bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

__device__ __forceinline__ void store_chunk(__nv_bfloat16* __restrict__ dst,
                                            const float (&v)[kVals]) {
#pragma unroll
  for (int j = 0; j < kVals / 8; ++j) {
    unsigned w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w[i] = bf16_bits(v[8 * j + 2 * i]) | bf16_bits(v[8 * j + 2 * i + 1]) << 16;
    reinterpret_cast<uint4*>(dst)[j] = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

template <typename T>
__device__ __forceinline__ void load_part(const T* __restrict__ src, int n, float (&v)[kVals]) {
#pragma unroll
  for (int i = 0; i < kVals; ++i) v[i] = i < 3 * n ? to_f32<T>(src[i]) : 0.f;
}

template <typename T>
__device__ __forceinline__ void store_part(T* __restrict__ dst, int n, const float (&v)[kVals]) {
#pragma unroll
  for (int i = 0; i < kVals; ++i)
    if (i < 3 * n) dst[i] = from_f32<T>(v[i]);
}

// Block (tx, ty) of image blockIdx.y: row y = blockIdx.x * ty + threadIdx.y,
// chunks of 8 pixels from x = 8 * threadIdx.x in steps of 8 * tx. kVec: W is
// a multiple of 8 and img and out are 16-byte aligned.
template <typename Tin, typename Tout, bool kVec>
__global__ void __launch_bounds__(kThreads)
    color_stage_kernel(const Tin* __restrict__ img, const float* __restrict__ fparams,
                       const int* __restrict__ iparams, Tout* __restrict__ out, int H, int W) {
  __shared__ ImageParams ps;
  const int b = blockIdx.y;
  if (threadIdx.x == 0 && threadIdx.y == 0)
    image_params(fparams + (size_t)b * 8, iparams + (size_t)b * 12, ps);
  __syncthreads();
  const int y = blockIdx.x * blockDim.y + threadIdx.y;
  if (y >= H) return;
  unsigned yin = 0;
#pragma unroll
  for (int i = 0; i < kMaxHoles; ++i)
    if (y >= ps.ys[i] && y < ps.ys[i] + ps.hole) yin |= 1u << i;
  const unsigned sel = (yin & ps.active) | ps.odd_out;
  const size_t row = ((size_t)b * H + y) * W;
  for (int x0 = threadIdx.x * kPix; x0 < W; x0 += blockDim.x * kPix) {
    const size_t base = (row + x0) * 3;
    const int n = min(kPix, W - x0);
    float v[kVals];
    if constexpr (kVec)
      load_chunk(img + base, v);
    else
      load_part(img + base, n, v);
#pragma unroll
    for (int i = 0; i < kPix; ++i) color_pixel(v[3 * i], v[3 * i + 1], v[3 * i + 2], x0 + i, yin,
                                               sel, ps);
    if constexpr (kVec)
      store_chunk(out + base, v);
    else
      store_part(out + base, n, v);
  }
}

template <typename Tin, typename Tout, bool kVec>
cudaError_t launch_bands(const void* img, const float* fparams, const int* iparams, void* out,
                         int B, int H, int W, cudaStream_t stream) {
  const int tx = std::min((W + kPix - 1) / kPix, kThreads);
  const int ty = std::max(1, kThreads / tx);
  const dim3 block(tx, ty), grid((H + ty - 1) / ty, B);
  color_stage_kernel<Tin, Tout, kVec><<<grid, block, 0, stream>>>(
      static_cast<const Tin*>(img), fparams, iparams, static_cast<Tout*>(out), H, W);
  return cudaGetLastError();
}

template <typename Tin, typename Tout>
cudaError_t launch(const void* img, const float* fparams, const int* iparams, void* out, int B,
                   int H, int W, cudaStream_t stream) {
  if (W % kPix == 0 && aligned16(img) && aligned16(out))
    return launch_bands<Tin, Tout, true>(img, fparams, iparams, out, B, H, W, stream);
  return launch_bands<Tin, Tout, false>(img, fparams, iparams, out, B, H, W, stream);
}

// normalize() against the IEEE quotient for every float clip01 can return
// (the bit patterns 0 .. 0x3f800000, i.e. [0, 1], and -0) and each channel:
// bad[block * 3 + channel] counts the block's mismatches.
constexpr unsigned kClipValues = 0x3f800000u + 2;

__global__ void __launch_bounds__(kThreads) k5_division_check_kernel(int* __restrict__ bad) {
  __shared__ int counts[kThreads][3];
  float rstd[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) rstd[c] = __frcp_rn(channel_std(c));
  int n[3] = {0, 0, 0};
  for (unsigned u = blockIdx.x * kThreads + threadIdx.x; u < kClipValues;
       u += gridDim.x * kThreads) {
    const float x = u < kClipValues - 1 ? __uint_as_float(u) : -0.f;
#pragma unroll
    for (int c = 0; c < 3; ++c)
      n[c] += __float_as_uint(normalize(x, channel_mean(c), channel_std(c), rstd[c])) !=
              __float_as_uint(__fdiv_rn(__fsub_rn(x, channel_mean(c)), channel_std(c)));
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) counts[threadIdx.x][c] = n[c];
  __syncthreads();
  if (threadIdx.x < 3) {
    int total = 0;
    for (int t = 0; t < kThreads; ++t) total += counts[t][threadIdx.x];
    bad[blockIdx.x * 3 + threadIdx.x] = total;
  }
}

}  // namespace

extern "C" {

const char* skinjax_augment_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// in_bf16 / out_bf16: 0 for float, 1 for bfloat16. img and out are (B, H, W, 3)
// contiguous; fparams (B, 8) fp32, iparams (B, 12) int32; B <= 65535.
int skinjax_fused_color_stage(int in_bf16, int out_bf16, const void* img, const float* fparams,
                              const int* iparams, void* out, int B, int H, int W, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_bf16)
    return out_bf16 ? launch<__nv_bfloat16, __nv_bfloat16>(img, fparams, iparams, out, B, H, W, s)
                    : launch<__nv_bfloat16, float>(img, fparams, iparams, out, B, H, W, s);
  return out_bf16 ? launch<float, __nv_bfloat16>(img, fparams, iparams, out, B, H, W, s)
                  : launch<float, float>(img, fparams, iparams, out, B, H, W, s);
}

// bad: (blocks, 3) int32, each block's mismatches of normalize() a channel.
int skinjax_k5_division_check(int* bad, int blocks, void* stream) {
  k5_division_check_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(bad);
  return cudaGetLastError();
}

}  // extern "C"
