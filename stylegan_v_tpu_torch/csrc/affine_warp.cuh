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

// ---- K4's tile boxes (ops/grid_sample.py:_warp_tile_boxes mirrors these) ----
//
// Every double operation is rounded on its own (the __d*_rn intrinsics forbid
// fused multiply-adds), so the Python plan computes the same boxes.

// One axis of the raw sample position over the output grid, in float64:
// p = u ox + v oy + w, a margin that exceeds the float32 geometry's rounding
// (and its mirror's), and 1 / P (P = 2 size, the mirror's period); K4-bwd's
// make_axis computes the same five.
struct AxisMap {
  double u, v, w, margin, inv_p;
};

__device__ inline AxisMap axis_map(float g0, float g1, float g2, int size, int out_w, int out_h) {
  const double d0 = g0, d1 = g1, d2 = g2, s = size;
  const double inv_w = __ddiv_rn(1.0, (double)out_w), inv_h = __ddiv_rn(1.0, (double)out_h);
  const double half = __dmul_rn(0.5, s);
  AxisMap m;
  m.u = __dmul_rn(__dmul_rn(d0, s), inv_w);
  m.v = __dmul_rn(__dmul_rn(d1, s), inv_h);
  m.w = __dsub_rn(__dmul_rn(half, __dadd_rn(__dadd_rn(__dadd_rn(__dmul_rn(d0, __dsub_rn(inv_w, 1.0)),
                                                                  __dmul_rn(d1, __dsub_rn(inv_h, 1.0))),
                                                        d2),
                                              1.0)),
                  0.5);
  const double gsum = __dadd_rn(__dadd_rn(__dadd_rn(fabs(d0), fabs(d1)), fabs(d2)), 1.0);
  m.margin = __dadd_rn(0x1p-6, __dmul_rn(0x1p-18, __dadd_rn(__dadd_rn(__dmul_rn(half, gsum),
                                                                       __dmul_rn(2.0, s)),
                                                             1.0)));
  m.inv_p = __ddiv_rn(0.5, s);
  return m;
}

// The mirror of reflect() in float64, reduced by a multiplication with
// 1 / P instead of fmod: within 1e-12 of the exact mirror, far inside the
// margin.
__device__ inline double reflect64(double p, double s, double inv_p) {
  const double u = __dadd_rn(p, 0.5);
  const double v = __dsub_rn(u, __dmul_rn(floor(__dmul_rn(u, inv_p)), 2.0 * s));
  return __dsub_rn(__dsub_rn(s, fabs(__dsub_rn(s, v))), 0.5);
}

// The box of one axis, [b0, b1], that holds every tap of the output columns
// ox0..ox1 and rows oy0..oy1. The raw range over the tile's corners, widened
// by the margin. With the mirror, its image: the mirror is continuous, so
// the image of an interval is the interval between its end points' mirrors,
// widened to the border -0.5 (an even fold, p + 0.5 = 2 j size) or
// size - 0.5 (an odd one) wherever a fold lies inside, and the whole axis
// for a range of a period (2 size) or more; widened by the margin again.
// (A range shorter than a period holds at most two folds; three candidates
// from the first one past lo, so that a rounding of its index cannot lose
// one.) Without the mirror, the range clipped to [-1, size], where the
// samples that load lie. Then the columns of its taps: x0 = clip(floor(p))
// and x1 = min(x0 + 1, size - 1), so b1 = min(max(floor(hi), 0) + 1,
// size - 1), which keeps pixel 1 for a range in [-0.5, 0) (floor -1,
// clipped to 0; the second tap is pixel 1).
__device__ inline void tile_span(const AxisMap& m, int size, int ox0, int ox1, int oy0, int oy1,
                                 bool zeros, int& b0, int& b1) {
  const double s = size;
  const double ex0 = __dmul_rn(m.u, (double)ox0), ex1 = __dmul_rn(m.u, (double)ox1);
  const double ey0 = __dmul_rn(m.v, (double)oy0), ey1 = __dmul_rn(m.v, (double)oy1);
  const double lo = __dsub_rn(__dadd_rn(__dadd_rn(m.w, fmin(ex0, ex1)), fmin(ey0, ey1)), m.margin);
  const double hi = __dadd_rn(__dadd_rn(__dadd_rn(m.w, fmax(ex0, ex1)), fmax(ey0, ey1)), m.margin);
  double a, b;
  if (zeros) {
    a = fmin(fmax(lo, -1.0), s);
    b = fmin(fmax(hi, -1.0), s);
  } else if (!(__dsub_rn(hi, lo) < 2.0 * s)) {
    a = -0.5;
    b = s - 0.5;
  } else {
    const double ma = reflect64(lo, s, m.inv_p), mb = reflect64(hi, s, m.inv_p);
    a = fmin(ma, mb);
    b = fmax(ma, mb);
    double k = __dadd_rn(floor(__dmul_rn(__dadd_rn(lo, 0.5), 2.0 * m.inv_p)), 1.0);
    for (int j = 0; j < 3; ++j, k = __dadd_rn(k, 1.0)) {
      if (__dsub_rn(__dmul_rn(k, s), 0.5) <= hi) {
        if (__dsub_rn(k, 2.0 * floor(0.5 * k)) == 0.0) {
          a = -0.5;
        } else {
          b = s - 0.5;
        }
      }
    }
    a = __dsub_rn(a, m.margin);
    b = __dadd_rn(b, m.margin);
  }
  b0 = (int)fmin(fmax(floor(a), 0.0), s - 1.0);
  b1 = (int)fmin(__dadd_rn(fmax(floor(b), 0.0), 1.0), s - 1.0);
}

}  // namespace warp_geom
