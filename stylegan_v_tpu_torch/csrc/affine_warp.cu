// Bilinear affine warp (K4), NCHW, for Hopper (sm_90a).
//
// Replaces stylegan_v_tpu/ops/grid_sample.py:affine_grid_sample, which the
// JAX package runs as an XLA gather (no Pallas kernel): it packs every
// pixel's 2x2 neighbourhood into [B, H*W, 4C] and gathers one packed row per
// output pixel. On this card that is two extra tensors of the canvas's size
// (about 0.6 GB each for the ADA warp at 16 videos x 9 channels on the
// 536^2 canvas, in float32). This kernel computes the same samples straight
// from the image:
//
//   y[n,c,oy,ox] = bilinear(x[n,c], taps of (oy, ox) under G_inv[n])
//
// with the geometry of affine_warp.cuh (reflect or zeros mode), a float32 sum
// and one rounding to the output dtype (float32, or bfloat16 to nearest
// even). The JAX package multiplies taps and weights in the payload dtype;
// in float32 the two agree to the bit, in bfloat16 this kernel is the more
// accurate.
//
// G_inv [N, 3, 3] float32 is read from device memory, so a call never waits
// on the host.
//
// Bound: memory. It reads 4 taps and writes 1 element per output and
// channel; neighbouring output pixels read neighbouring input pixels under
// any affine map of moderate scale, so the taps are served from L1 and L2.
// One thread computes one output pixel for every channel: the geometry (18
// flops and a mirror) is computed once and reused C times. A 3-D grid (ox in
// blocks of threads, oy, n) needs no integer division. Vector loads and
// shared-memory staging are later work.
//
// The C entry point launches on the given stream, does not synchronise,
// allocates nothing and returns cudaGetLastError().

#include "affine_warp.cuh"

namespace {

using namespace warp_geom;

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <typename T>
__global__ void affine_warp_kernel(const T* __restrict__ x, const float* __restrict__ G_inv,
                                   T* __restrict__ y, const int C, const int H, const int W,
                                   const int out_h, const int out_w, const bool zeros) {
  const int ox = blockIdx.x * blockDim.x + threadIdx.x;
  const int oy = blockIdx.y;
  const int n = blockIdx.z;
  if (ox >= out_w) return;
  const Taps t = taps_at(G_inv + 9 * n, ox, oy, H, W, out_h, out_w, zeros);
  const float omx = __fsub_rn(1.0f, t.wx), omy = __fsub_rn(1.0f, t.wy);
  const int64_t in_plane = (int64_t)H * W, out_plane = (int64_t)out_h * out_w;
  const T* src = x + (int64_t)n * C * in_plane;
  T* dst = y + (int64_t)n * C * out_plane + (int64_t)oy * out_w + ox;
  for (int c = 0; c < C; ++c, src += in_plane, dst += out_plane) {
    float v = 0.0f;
    if (t.inside) {
      const float top = __fadd_rn(__fmul_rn(load_f32(src + t.o00), omx),
                                  __fmul_rn(load_f32(src + t.o01), t.wx));
      const float bot = __fadd_rn(__fmul_rn(load_f32(src + t.o10), omx),
                                  __fmul_rn(load_f32(src + t.o11), t.wx));
      v = __fadd_rn(__fmul_rn(top, omy), __fmul_rn(bot, t.wy));
    }
    store(dst, v);
  }
}

template <typename T>
void launch(const void* x, const float* G_inv, void* y, int N, int C, int H, int W, int out_h,
            int out_w, bool zeros, cudaStream_t stream) {
  const int threads = out_w >= 128 ? 128 : 32 * ((out_w + 31) / 32);
  const dim3 grid((out_w + threads - 1) / threads, out_h, N);
  affine_warp_kernel<T><<<grid, threads, 0, stream>>>(
      static_cast<const T*>(x), G_inv, static_cast<T*>(y), C, H, W, out_h, out_w, zeros);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. mode: 0 = reflect, 1 = zeros. x is
// [N, C, H, W] and y [N, C, out_h, out_w], both contiguous; G_inv is
// [N, 3, 3] float32 on the device. N and out_h are at most 65535.
extern "C" int affine_warp(const void* x, const float* G_inv, void* y, int dtype, int mode,
                           int N, int C, int H, int W, int out_h, int out_w, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool zeros = mode == 1;
  if (mode != 0 && mode != 1) return (int)cudaErrorInvalidValue;
  if (dtype == 0) {
    launch<float>(x, G_inv, y, N, C, H, W, out_h, out_w, zeros, s);
  } else if (dtype == 1) {
    launch<__nv_bfloat16>(x, G_inv, y, N, C, H, W, out_h, out_w, zeros, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
