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
// What bounds it: ~60 fp32 operations per pixel against 12 bytes moved per
// pixel at bf16 in and out (3 channels read, 3 written), i.e. ~5 operations per
// byte, far below the card's balance point. Device-memory bandwidth bounds it:
// at B=128, 224x224, bf16 in and out it moves 77 MB, 23 us at 3.35 TB/s.
//
// Design (first, simple version): images stay interleaved NHWC, as the
// training pipeline holds them; the TPU kernel's planar transpose and its one
// program per image are not carried over. One thread per pixel reads its three
// channels and writes three, so a warp touches 32 neighbouring pixels (192
// contiguous bytes at bf16). The grid is (pixel tiles, images): at B=128,
// 224x224 that is 196 x 128 blocks of 256 threads, many waves over 132 SMs.
// The image's parameters are read once per thread from the (B, 8)/(B, 12)
// rows, which stay in L1/L2.
//
// Arithmetic: fp32 throughout, the same operations in the same order as the
// plain twin (ops/augment_kernel.py fused_color_stage_plain). Products that
// feed a sum use __fmul_rn/__fadd_rn so the compiler cannot contract them
// into fused multiply-adds, division is IEEE (no fast math), the two floored
// modulos are x - floorf(x) (C's fmodf truncates), and the output rounds once,
// to nearest even, at the end.
//
// C interface: the entry point launches on the given stream and returns
// cudaGetLastError() as an int (0 = success); skinjax_augment_error_string
// maps the code to its message.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxHoles = 5;

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

template <typename Tin, typename Tout>
__global__ void __launch_bounds__(kThreads)
    color_stage_kernel(const Tin* __restrict__ img, const float* __restrict__ fparams,
                       const int* __restrict__ iparams, Tout* __restrict__ out, int H, int W) {
  const int b = blockIdx.y;
  const int pix = blockIdx.x * kThreads + threadIdx.x;
  if (pix >= H * W) return;
  const int y = pix / W;
  const int x = pix - y * W;
  const float* f = fparams + (size_t)b * 8;
  const int* ip = iparams + (size_t)b * 12;
  const size_t base = ((size_t)b * H * W + pix) * 3;

  float r = to_f32<Tin>(img[base]);
  float g = to_f32<Tin>(img[base + 1]);
  float bl = to_f32<Tin>(img[base + 2]);

  // ---- coarse dropout: the mask is exactly 0 or 1 ----------------------
  const float do_drop = f[0];
  const int n_holes = ip[0];
  const int hole = ip[1];
  float mask = 1.f;
#pragma unroll
  for (int i = 0; i < kMaxHoles; ++i) {
    const int ys = ip[2 + i];
    const int xs = ip[7 + i];
    const bool inside = y >= ys && y < ys + hole && x >= xs && x < xs + hole;
    const float active = (i < n_holes ? 1.f : 0.f) * do_drop;
    mask = mask * (1.f - (inside ? 1.f : 0.f) * active);
  }
  r = r * mask;
  g = g * mask;
  bl = bl * mask;

  // ---- RGB -> HSV --------------------------------------------------------
  const float do_hsv = f[1];
  const float maxc = fmaxf(fmaxf(r, g), bl);
  const float minc = fminf(fminf(r, g), bl);
  const float delta = maxc - minc;
  const float safe = fmaxf(delta, 1e-12f);
  float s = maxc > 0.f ? delta / fmaxf(maxc, 1e-12f) : 0.f;
  const float rc = (maxc - r) / safe;
  const float gc = (maxc - g) / safe;
  const float bc = (maxc - bl) / safe;
  float h = r == maxc ? bc - gc : (g == maxc ? 2.f + rc - bc : 4.f + gc - rc);
  h = delta == 0.f ? 0.f : mod1(h / 6.f);

  // ---- shift -------------------------------------------------------------
  h = mod1(__fadd_rn(h, __fmul_rn(f[2], do_hsv)));
  s = clip01(__fadd_rn(s, __fmul_rn(f[3], do_hsv)));
  const float v = clip01(__fadd_rn(maxc, __fmul_rn(f[4], do_hsv)));

  // ---- HSV -> RGB --------------------------------------------------------
  const float h6 = __fmul_rn(h, 6.f);
  const float i6 = floorf(h6);
  const float fr = __fsub_rn(h6, i6);
  const float p = __fmul_rn(v, __fsub_rn(1.f, s));
  const float q = __fmul_rn(v, __fsub_rn(1.f, __fmul_rn(s, fr)));
  const float t = __fmul_rn(v, __fsub_rn(1.f, __fmul_rn(s, __fsub_rn(1.f, fr))));
  const int sector = static_cast<int>(i6) % 6;  // h in [0, 1], so i6 in [0, 6]
  float ro, go, bo;
  switch (sector) {
    case 0: ro = v; go = t; bo = p; break;
    case 1: ro = q; go = v; bo = p; break;
    case 2: ro = p; go = v; bo = t; break;
    case 3: ro = p; go = q; bo = v; break;
    case 4: ro = t; go = p; bo = v; break;
    default: ro = v; go = p; bo = q; break;
  }

  // ---- brightness/contrast, normalize, cast ------------------------------
  const float do_bc = f[5];
  const float alpha = __fadd_rn(1.f, __fmul_rn(__fsub_rn(f[6], 1.f), do_bc));
  const float beta = __fmul_rn(f[7], do_bc);
  out[base] = from_f32<Tout>((clip01(__fadd_rn(__fmul_rn(ro, alpha), beta)) - 0.485f) / 0.229f);
  out[base + 1] =
      from_f32<Tout>((clip01(__fadd_rn(__fmul_rn(go, alpha), beta)) - 0.456f) / 0.224f);
  out[base + 2] =
      from_f32<Tout>((clip01(__fadd_rn(__fmul_rn(bo, alpha), beta)) - 0.406f) / 0.225f);
}

template <typename Tin, typename Tout>
cudaError_t launch(const void* img, const float* fparams, const int* iparams, void* out, int B,
                   int H, int W, cudaStream_t stream) {
  const dim3 grid((H * W + kThreads - 1) / kThreads, B);
  color_stage_kernel<Tin, Tout><<<grid, kThreads, 0, stream>>>(
      static_cast<const Tin*>(img), fparams, iparams, static_cast<Tout*>(out), H, W);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* skinjax_augment_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// in_bf16 / out_bf16: 0 for float, 1 for bfloat16. img and out are (B, H, W, 3)
// contiguous; fparams (B, 8) fp32, iparams (B, 12) int32.
int skinjax_fused_color_stage(int in_bf16, int out_bf16, const void* img, const float* fparams,
                              const int* iparams, void* out, int B, int H, int W, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_bf16)
    return out_bf16 ? launch<__nv_bfloat16, __nv_bfloat16>(img, fparams, iparams, out, B, H, W, s)
                    : launch<__nv_bfloat16, float>(img, fparams, iparams, out, B, H, W, s);
  return out_bf16 ? launch<float, __nv_bfloat16>(img, fparams, iparams, out, B, H, W, s)
                  : launch<float, float>(img, fparams, iparams, out, B, H, W, s);
}

}  // extern "C"
