// The sampling geometry shared by the bilinear affine warp (K4,
// affine_warp.cu) and its adjoint (K4-bwd, affine_warp_bwd.cu).
//
// It is stylegan_v_tpu/ops/grid_sample.py:affine_grid_sample's, step for
// step, and ops/grid_sample.py:_sample_taps's in the port, with every float
// operation rounded on its own (the __f*_rn intrinsics forbid nvcc's fused
// multiply-adds), so the kernels sample exactly where the plain PyTorch
// version samples. For output pixel (oy, ox) of an out_h x out_w grid and an
// H x W input:
//
//   gx = (2 ox + 1) / out_w - 1                 (align_corners=False)
//   xin = (G00 gx + G01 gy) + G02               (G = G_inv, row-major [3,3])
//   px = ((xin + 1) W - 1) / 2
//   reflect: px mirrored into [-0.5, W - 0.5]   (grid_sample.py:_reflect_coords)
//   zeros:   the pixel counts only if -1 < px < W and -1 < py < H
//   x0 = clip(floor(px), 0, W - 1), x1 = min(x0 + 1, W - 1), wx = px - floor(px)
//
// and the same in y. wx comes from the unclipped floor, so for px in
// [-0.5, 0) the taps are pixels 0 and 1 with weights 1 - wx and wx, as the
// JAX package computes (not a true mirror). The value is
//
//   top = g00 (1 - wx) + g01 wx,  bot = g10 (1 - wx) + g11 wx,
//   out = top (1 - wy) + bot wy
//
// with g_ij = x[y_i][x_j], in float32.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace warp_geom {

__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// grid_sample.py:_reflect_coords; fmodf is exact and the sign fix is jnp.mod's.
__device__ __forceinline__ float reflect(float px, int size) {
  const float s = (float)size;
  const float u = __fadd_rn(px, 0.5f);
  const float period = 2.0f * s;
  float v = fmodf(u, period);
  if (v != 0.f && v < 0.f) v = __fadd_rn(v, period);
  v = __fsub_rn(s, fabsf(__fsub_rn(s, v)));
  return __fsub_rn(v, 0.5f);
}

// One output pixel's taps: element offsets within an H x W plane, weights,
// and whether it is inside (always, in reflect mode).
struct Taps {
  int o00, o01, o10, o11;
  float wx, wy;
  bool inside;
};

__device__ __forceinline__ float grid_coord(int o, int out) {
  return __fsub_rn(__fdiv_rn(__fadd_rn(2.0f * (float)o, 1.0f), (float)out), 1.0f);
}

__device__ __forceinline__ Taps taps_at(const float* __restrict__ G, int ox, int oy, int H,
                                        int W, int out_h, int out_w, bool zeros) {
  const float gx = grid_coord(ox, out_w), gy = grid_coord(oy, out_h);
  const float g00 = __ldg(G + 0), g01 = __ldg(G + 1), g02 = __ldg(G + 2);
  const float g10 = __ldg(G + 3), g11 = __ldg(G + 4), g12 = __ldg(G + 5);
  const float xin = __fadd_rn(__fadd_rn(__fmul_rn(g00, gx), __fmul_rn(g01, gy)), g02);
  const float yin = __fadd_rn(__fadd_rn(__fmul_rn(g10, gx), __fmul_rn(g11, gy)), g12);
  float px = __fdiv_rn(__fsub_rn(__fmul_rn(__fadd_rn(xin, 1.0f), (float)W), 1.0f), 2.0f);
  float py = __fdiv_rn(__fsub_rn(__fmul_rn(__fadd_rn(yin, 1.0f), (float)H), 1.0f), 2.0f);
  Taps t;
  if (zeros) {
    t.inside = px > -1.0f && px < (float)W && py > -1.0f && py < (float)H;
  } else {
    px = reflect(px, W);
    py = reflect(py, H);
    t.inside = true;
  }
  const float fx = floorf(px), fy = floorf(py);
  t.wx = __fsub_rn(px, fx);
  t.wy = __fsub_rn(py, fy);
  // clip in float first: in zeros mode px may lie far outside the int range
  const int x0 = (int)fminf(fmaxf(fx, 0.0f), (float)(W - 1));
  const int y0 = (int)fminf(fmaxf(fy, 0.0f), (float)(H - 1));
  const int x1 = min(x0 + 1, W - 1), y1 = min(y0 + 1, H - 1);
  t.o00 = y0 * W + x0;
  t.o01 = y0 * W + x1;
  t.o10 = y1 * W + x0;
  t.o11 = y1 * W + x1;
  return t;
}

}  // namespace warp_geom
