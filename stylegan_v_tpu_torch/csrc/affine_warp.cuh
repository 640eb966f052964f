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
// with g_ij = x[y_i][x_j], in float32. The halving multiplies by 0.5: the
// same correctly rounded value as a division by 2, in one instruction.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace warp_geom {

__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
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

// One output pixel's taps: their columns x0, x1 and rows y0, y1, element
// offsets within an H x W plane, weights, whether it is inside (always, in
// reflect mode), and the raw sample position (px, py) before the mirror.
struct Taps {
  int x0, x1, y0, y1;
  int o00, o01, o10, o11;
  float wx, wy;
  bool inside;
  float rx, ry;
};

__device__ __forceinline__ float grid_coord(int o, int out) {
  return __fsub_rn(__fdiv_rn(__fadd_rn(2.0f * (float)o, 1.0f), (float)out), 1.0f);
}

// The linear part and translation of one image's G_inv, read once.
struct Affine {
  float g00, g01, g02, g10, g11, g12;
};

__device__ __forceinline__ Affine load_affine(const float* __restrict__ G) {
  return {__ldg(G + 0), __ldg(G + 1), __ldg(G + 2), __ldg(G + 3), __ldg(G + 4), __ldg(G + 5)};
}

// The taps of the sample at grid coordinates (gx, gy) = (grid_coord(ox, out_w),
// grid_coord(oy, out_h)).
__device__ __forceinline__ Taps taps_from(const Affine& A, float gx, float gy, int H, int W,
                                          bool zeros) {
  const float xin = __fadd_rn(__fadd_rn(__fmul_rn(A.g00, gx), __fmul_rn(A.g01, gy)), A.g02);
  const float yin = __fadd_rn(__fadd_rn(__fmul_rn(A.g10, gx), __fmul_rn(A.g11, gy)), A.g12);
  float px = __fmul_rn(__fsub_rn(__fmul_rn(__fadd_rn(xin, 1.0f), (float)W), 1.0f), 0.5f);
  float py = __fmul_rn(__fsub_rn(__fmul_rn(__fadd_rn(yin, 1.0f), (float)H), 1.0f), 0.5f);
  Taps t;
  t.rx = px;
  t.ry = py;
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
  t.x0 = (int)fminf(fmaxf(fx, 0.0f), (float)(W - 1));
  t.y0 = (int)fminf(fmaxf(fy, 0.0f), (float)(H - 1));
  t.x1 = min(t.x0 + 1, W - 1);
  t.y1 = min(t.y0 + 1, H - 1);
  t.o00 = t.y0 * W + t.x0;
  t.o01 = t.y0 * W + t.x1;
  t.o10 = t.y1 * W + t.x0;
  t.o11 = t.y1 * W + t.x1;
  return t;
}

__device__ __forceinline__ Taps taps_at(const float* __restrict__ G, int ox, int oy, int H,
                                        int W, int out_h, int out_w, bool zeros) {
  return taps_from(load_affine(G), grid_coord(ox, out_w), grid_coord(oy, out_h), H, W, zeros);
}

}  // namespace warp_geom
