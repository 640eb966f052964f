// The adjoint of the bilinear affine warp (K4-bwd), NCHW, for Hopper (sm_90a).
//
// The JAX package has no kernel for it: jax.grad derives the gradient of
// stylegan_v_tpu/ops/grid_sample.py:affine_grid_sample (:33, an XLA gather),
// whose transpose is a scatter-add into the packed [B, H*W, 4C]
// neighbourhood and then into the edge-padded image. This kernel is the
// exact transpose of K4 (affine_warp.cu), with the same geometry
// (affine_warp.cuh):
//
//   dx[n,c,y_i,x_j] = sum of w_ij * dy[n,c,oy,ox] over the output pixels
//                     (oy, ox) whose tap (i, j) is that pixel,
//   w00 = (1-wy)(1-wx), w01 = (1-wy) wx, w10 = wy (1-wx), w11 = wy wx
//
// each product taken as (dy (1-wy)) (1-wx) etc., the order of JAX's vjp, and
// nothing from a sample outside the image in zeros mode.
//
// A gather, with no atomics. One thread owns QX x QY input pixels and a
// chunk of up to CHUNK channels; it enumerates the output pixels that may
// tap its pixels (their footprint, below), recomputes each one's taps with
// K4's float32 geometry (taps_from), and adds to each of its pixels, in the
// order o00, o01, o10, o11, the weight of every tap on that pixel: two taps
// that the border clip puts on one pixel both add, as in the scatter. The
// sums are float32 registers in a fixed order, written once in dy's dtype
// (float32, or bfloat16 rounded to nearest even). So a call repeats to the
// bit, needs no zeroed buffer and no cast pass.
//
// The footprint (mirrored line by line by ops/grid_sample.py:_warp_footprint,
// which the CPU tests check for coverage). The raw sample position of output
// pixel (ox, oy) is affine: px = a ox + b oy + c, py = d ox + e oy + f
// (make_axis, float64). Pixel i of an axis receives a tap from every sample
// whose mirrored position lies in (i - 1, i + 1), or in [-1, 0) for pixel 1
// (the x0 clip); that interval is widened by a margin that exceeds the
// float32 geometry's rounding. In reflect mode a mirrored position p comes
// from the raw positions 2kW + p and 2kW - 1 - p, so each column and each
// row of threads has a short sorted list of raw intervals over the mirror
// periods that the grid's hull reaches, merged where they come within the
// margin of each other (make_intervals, for a thread's QX x QY pixels
// together, once a block, in shared memory). Each pair of an x- and a
// y-interval is a parallelogram in output space: its rows come from the
// inverse of the linear part at its corners (float64), each row's ox range
// from the two linear constraints (float32, each operation rounded on its
// own, within the margin). A candidate counts for the pair only if its
// float32 raw position (the geometry's own, before the mirror) lies in both
// intervals: every output pixel has one such position and the intervals of
// an axis are disjoint, so no output pixel counts twice, and the margin
// keeps every true tap inside. Exactness rests on the recomputed taps
// alone. A near-singular linear part, or a hull wider than MAX_PERIODS mirror
// periods or reaching past MAX_COORD, has no useful bound: that image scans
// the whole output grid (exact and slow; the ADA pipe never draws such a
// map).
//
// Bound: at the ADA step's warp the traffic is 162 MB (dy read once, dx
// written once), 0.048 ms at 3.35 TB/s. What bounds the kernel is the L1:
// each tap's nine dy loads come from lanes whose taps lie apart, so a warp's
// load touches several cache lines for few lanes. A thread owning two
// pixels (QY = 2) loads a dy element once for the taps of both, which cuts
// the loads by about a third; a warp owns an 8 x 4 patch of threads, so its
// lanes' taps stay close together. The geometry of the candidates (about
// 6 / |det J| a thread, with the rows' edges) costs less. dy is read through
// the read-only path, and L1 and L2 serve its reuse. Each block derives its
// image's map from the 6 floats of G_inv in device memory: no host sync, no
// extra launch. Staging each block's footprint of dy in shared memory with
// coalesced loads is the next step.
//
// The C entry point launches on the given stream, does not synchronise,
// allocates nothing and returns cudaGetLastError().

#include "affine_warp.cuh"

#include <math.h>

namespace {

using namespace warp_geom;

constexpr int CHUNK = 9;                // channels a thread sums: the ADA pipe's 3 frames x RGB
constexpr int QX = 1;                   // input pixels a thread owns: QX x QY
constexpr int QY = 2;
constexpr int TILE_X = 32, TILE_Y = 8;  // threads of a block
constexpr int WARP_X = 8, WARP_Y = 4;   // threads of a warp
constexpr int THREADS = TILE_X * TILE_Y;
constexpr double MAX_PERIODS = 4.0;     // a hull wider than this many mirror periods: scan
constexpr double SINGULAR = 1e-6;       // |det| at most this times (|a|+|b|)(|d|+|e|): scan
constexpr double MAX_COORD = 0x1p16;    // a hull reaching this far (or not finite): scan
// Raw intervals of one pixel: 2 for each of at most 8 periods (the hull spans
// at most MAX_PERIODS, the widened tap range one more, the rounding three).
constexpr int MAX_INTERVALS = 16;

// One axis of the raw sample position over the output grid, in float64:
// p = u ox + v oy + w, its hull over the grid [lo, hi], the margin and
// 1 / P (P = 2 size, the mirror's period); and u, 1 / u (0 for u = 0), v and
// w rounded to float32, for the rows' ranges.
struct Axis {
  double u, v, w, lo, hi, margin, inv_p;
  float uf, inv_uf, vf, wf;
};

__device__ Axis make_axis(float g0, float g1, float g2, int size, int out_w, int out_h) {
  const double inv_w = 1.0 / out_w, inv_h = 1.0 / out_h;
  Axis ax;
  ax.u = (double)g0 * size * inv_w;
  ax.v = (double)g1 * size * inv_h;
  ax.w = 0.5 * size * ((double)g0 * (inv_w - 1.0) + (double)g1 * (inv_h - 1.0) + (double)g2
                       + 1.0) - 0.5;
  ax.margin = 0x1p-6 + 0x1p-18 * (0.5 * size * (fabs((double)g0) + fabs((double)g1)
                                               + fabs((double)g2) + 1.0) + 2.0 * size + 1.0);
  const double ex = ax.u * (out_w - 1), ey = ax.v * (out_h - 1);
  ax.lo = ax.w + fmin(ex, 0.0) + fmin(ey, 0.0) - ax.margin;
  ax.hi = ax.w + fmax(ex, 0.0) + fmax(ey, 0.0) + ax.margin;
  ax.inv_p = 0.5 / size;
  ax.uf = __double2float_rn(ax.u);
  ax.inv_uf = ax.u != 0.0 ? __double2float_rn(1.0 / ax.u) : 0.0f;
  ax.vf = __double2float_rn(ax.v);
  ax.wf = __double2float_rn(ax.w);
  return ax;
}

// One image's map, computed once a block: both axes, 1 / det of the linear
// part, and whether the footprint enumeration applies (else: scan the whole
// grid). Each test of `bounded` is written so that a NaN fails it.
struct Frame {
  Axis x, y;
  double inv_det;
  bool scan;
};

__device__ Frame make_frame(const Affine& A, int H, int W, int out_h, int out_w, bool zeros) {
  Frame f;
  f.x = make_axis(A.g00, A.g01, A.g02, W, out_w, out_h);
  f.y = make_axis(A.g10, A.g11, A.g12, H, out_w, out_h);
  const double det = f.x.u * f.y.v - f.x.v * f.y.u;
  const bool bounded =
      fabs(det) > SINGULAR * (fabs(f.x.u) + fabs(f.x.v)) * (fabs(f.y.u) + fabs(f.y.v)) &&
      fmax(fabs(f.x.lo), fabs(f.x.hi)) < MAX_COORD &&
      fmax(fabs(f.y.lo), fabs(f.y.hi)) < MAX_COORD &&
      (zeros || (f.x.hi - f.x.lo <= MAX_PERIODS * 2.0 * W &&
                 f.y.hi - f.y.lo <= MAX_PERIODS * 2.0 * H));
  f.scan = !bounded;
  f.inv_det = bounded ? 1.0 / det : 0.0;
  return f;
}

// The sorted, disjoint raw intervals whose taps may land on pixels i0..i1
// of an axis, into iv[0], iv[stride], ...: B_k = [kP - 1 - hi, kP - 1 - lo]
// then A_k = [kP + lo, kP + hi] for each period k (P = 2 size; only A_0
// without the mirror), clipped to the hull, merged when closer than the
// margin. Returns their count.
__device__ int make_intervals(int i0, int i1, int size, const Axis& ax, bool mirror, double2* iv,
                              int stride) {
  const double lo = (i0 <= 1 ? -1.0 : i0 - 1.0) - ax.margin;
  const double hi = i1 + 1.0 + ax.margin;
  const double P = mirror ? 2.0 * size : 0.0;
  const int k0 = mirror ? (int)floor((ax.lo - hi) * ax.inv_p) : 0;
  const int k1 = mirror ? (int)ceil((ax.hi + 1.0 + hi) * ax.inv_p) : 0;
  int count = 0;
  for (int k = k0; k <= k1; ++k) {
    for (int side = mirror ? 0 : 1; side < 2; ++side) {
      const double base = k * P;
      const double s = fmax(side == 0 ? base - 1.0 - hi : base + lo, ax.lo);
      const double e = fmin(side == 0 ? base - 1.0 - lo : base + hi, ax.hi);
      if (s > e) continue;
      if (count > 0 && s <= iv[(count - 1) * stride].y + ax.margin) {
        iv[(count - 1) * stride].y = fmax(iv[(count - 1) * stride].y, e);
      } else if (count < MAX_INTERVALS) {
        iv[count * stride] = make_double2(s, e);
        ++count;
      }
    }
  }
  return count;
}

// ceil(t0) and floor(t1) clipped to [0, n - 1] (i0 > i1 when empty), in
// floating point before the cast.
__device__ __forceinline__ void clip_range(double t0, double t1, int n, int& i0, int& i1) {
  i0 = (int)fmin(fmax(ceil(t0), 0.0), (double)n);
  i1 = (int)fmax(fmin(floor(t1), n - 1.0), -1.0);
}

__device__ __forceinline__ void clip_range(float t0, float t1, int n, int& i0, int& i1) {
  i0 = (int)fminf(fmaxf(ceilf(t0), 0.0f), (float)n);
  i1 = (int)fmaxf(fminf(floorf(t1), (float)(n - 1)), -1.0f);
}

// The ox of row oy whose raw position s ox + r lies in [lo, hi], with
// r = v oy + w and inv_s = 1 / s, in float32: [t0, t1], empty if t0 > t1.
__device__ __forceinline__ void solve(float s, float inv_s, float r, float lo, float hi,
                                      float& t0, float& t1) {
  if (s > 0.0f) {
    t0 = __fmul_rn(__fsub_rn(lo, r), inv_s);
    t1 = __fmul_rn(__fsub_rn(hi, r), inv_s);
  } else if (s < 0.0f) {
    t0 = __fmul_rn(__fsub_rn(hi, r), inv_s);
    t1 = __fmul_rn(__fsub_rn(lo, r), inv_s);
  } else if (lo <= r && r <= hi) {
    t0 = -INFINITY;
    t1 = INFINITY;
  } else {
    t0 = INFINITY;
    t1 = -INFINITY;
  }
}

template <typename T>
struct Gather {
  const T* src;   // dy at (n, c0, 0, 0)
  int64_t plane;  // out_h * out_w
  int nc, ix, iy, H, W, out_w;
  bool zeros;
  Affine A;
  float acc[QY * QX][CHUNK];  // pixel (iy + q / QX, ix + q % QX), channel c0 + j

  // Output pixel (ox, oy), gy = grid_coord(oy, out_h): if its raw position
  // lies in [xl, xh] x [yl, yh], add its taps on the thread's pixels, each
  // pixel's in the order o00, o01, o10, o11.
  __device__ __forceinline__ void visit(int ox, int oy, float gy, float xl, float xh, float yl,
                                        float yh) {
    const Taps t = taps_from(A, grid_coord(ox, out_w), gy, H, W, zeros);
    if (!(t.rx >= xl && t.rx <= xh && t.ry >= yl && t.ry <= yh) || !t.inside) return;
    const int lx0 = t.x0 - ix, lx1 = t.x1 - ix, ly0 = t.y0 - iy, ly1 = t.y1 - iy;
    const bool in_x0 = lx0 >= 0 && lx0 < QX, in_x1 = lx1 >= 0 && lx1 < QX;
    const bool in_y0 = ly0 >= 0 && ly0 < QY, in_y1 = ly1 >= 0 && ly1 < QY;
    // the pixel (q = ly QX + lx) of each tap, or -1 outside the thread's pixels
    const int q[4] = {in_y0 && in_x0 ? ly0 * QX + lx0 : -1, in_y0 && in_x1 ? ly0 * QX + lx1 : -1,
                      in_y1 && in_x0 ? ly1 * QX + lx0 : -1, in_y1 && in_x1 ? ly1 * QX + lx1 : -1};
    if ((q[0] & q[1] & q[2] & q[3]) < 0) return;
    const float omx = __fsub_rn(1.0f, t.wx), omy = __fsub_rn(1.0f, t.wy);
    const T* p = src + (int64_t)oy * out_w + ox;
#pragma unroll
    for (int j = 0; j < CHUNK; ++j) {
      if (j < nc) {
        const float d = load_f32(p + j * plane);
        const float dtop = __fmul_rn(d, omy), dbot = __fmul_rn(d, t.wy);
        const float v[4] = {__fmul_rn(dtop, omx), __fmul_rn(dtop, t.wx), __fmul_rn(dbot, omx),
                            __fmul_rn(dbot, t.wx)};
#pragma unroll
        for (int r = 0; r < QY * QX; ++r) {
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            if (q[k] == r) acc[r][j] = __fadd_rn(acc[r][j], v[k]);
          }
        }
      }
    }
  }
};

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <typename T>
__global__ void __launch_bounds__(THREADS, 3)
    affine_warp_bwd_kernel(const T* __restrict__ dy, const float* __restrict__ G_inv,
                           T* __restrict__ dx, const int C, const int H, const int W,
                           const int out_h, const int out_w, const bool zeros, const int chunks) {
  // warp w of the block owns the WARP_X x WARP_Y patch (w % 4, w / 4) of its
  // threads; thread (tx, ty) owns the QX x QY pixels from (ix, iy)
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int tx = (warp % (TILE_X / WARP_X)) * WARP_X + lane % WARP_X;
  const int ty = (warp / (TILE_X / WARP_X)) * WARP_Y + lane / WARP_X;
  const int ix0 = blockIdx.x * TILE_X * QX, iy0 = blockIdx.y * TILE_Y * QY;
  const int ix = ix0 + tx * QX, iy = iy0 + ty * QY;
  const int n = blockIdx.z / chunks, c0 = (blockIdx.z % chunks) * CHUNK;

  __shared__ Frame frame;
  __shared__ double2 x_iv[MAX_INTERVALS][TILE_X], y_iv[MAX_INTERVALS][TILE_Y];
  __shared__ int x_count[TILE_X], y_count[TILE_Y];
  const Affine A = load_affine(G_inv + 9 * n);
  if (threadIdx.x == 0) frame = make_frame(A, H, W, out_h, out_w, zeros);
  __syncthreads();
  if (!frame.scan) {  // one thread a column of threads, one a row
    const int t = threadIdx.x, r = t - 32, i = ix0 + t * QX, k = iy0 + r * QY;
    if (t < TILE_X && i < W) {
      x_count[t] = make_intervals(i, min(i + QX, W) - 1, W, frame.x, !zeros, &x_iv[0][t],
                                  TILE_X);
    } else if (r >= 0 && r < TILE_Y && k < H) {
      y_count[r] = make_intervals(k, min(k + QY, H) - 1, H, frame.y, !zeros, &y_iv[0][r],
                                  TILE_Y);
    }
  }
  __syncthreads();
  if (ix >= W || iy >= H) return;

  const int64_t out_plane = (int64_t)out_h * out_w, in_plane = (int64_t)H * W;
  Gather<T> g;
  g.src = dy + ((int64_t)n * C + c0) * out_plane;
  g.plane = out_plane;
  g.nc = min(CHUNK, C - c0);
  g.ix = ix;
  g.iy = iy;
  g.H = H;
  g.W = W;
  g.out_w = out_w;
  g.zeros = zeros;
  g.A = A;
#pragma unroll
  for (int r = 0; r < QY * QX; ++r) {
#pragma unroll
    for (int j = 0; j < CHUNK; ++j) g.acc[r][j] = 0.0f;
  }

  if (frame.scan) {
    for (int oy = 0; oy < out_h; ++oy) {
      const float gy = grid_coord(oy, out_h);
      for (int ox = 0; ox < out_w; ++ox) {
        g.visit(ox, oy, gy, -INFINITY, INFINITY, -INFINITY, INFINITY);
      }
    }
  } else {
    const Axis& ax = frame.x;
    const Axis& ay = frame.y;
    const double inv_det = frame.inv_det;
    for (int a = 0; a < x_count[tx]; ++a) {
      const double2 xi = x_iv[a][tx];
      for (int b = 0; b < y_count[ty]; ++b) {
        const double2 yi = y_iv[b][ty];
        // the rows: those of the parallelogram's corners, at
        // oy = (a (py - f) - d (px - c)) / det
        const double px0 = xi.x - ax.w, px1 = xi.y - ax.w;
        const double py0 = yi.x - ay.w, py1 = yi.y - ay.w;
        const double cy[4] = {(ax.u * py0 - ay.u * px0) * inv_det,
                              (ax.u * py0 - ay.u * px1) * inv_det,
                              (ax.u * py1 - ay.u * px0) * inv_det,
                              (ax.u * py1 - ay.u * px1) * inv_det};
        int oy0, oy1;
        clip_range(fmin(fmin(cy[0], cy[1]), fmin(cy[2], cy[3])),
                   fmax(fmax(cy[0], cy[1]), fmax(cy[2], cy[3])), out_h, oy0, oy1);
        const float xl = __double2float_rn(xi.x), xh = __double2float_rn(xi.y);
        const float yl = __double2float_rn(yi.x), yh = __double2float_rn(yi.y);
        for (int oy = oy0; oy <= oy1; ++oy) {
          const float foy = (float)oy;
          float sx0, sx1, sy0, sy1;
          solve(ax.uf, ax.inv_uf, __fadd_rn(__fmul_rn(ax.vf, foy), ax.wf), xl, xh, sx0, sx1);
          solve(ay.uf, ay.inv_uf, __fadd_rn(__fmul_rn(ay.vf, foy), ay.wf), yl, yh, sy0, sy1);
          int ox0, ox1;
          clip_range(fmaxf(sx0, sy0), fminf(sx1, sy1), out_w, ox0, ox1);
          if (ox0 > ox1) continue;
          const float gy = grid_coord(oy, out_h);
          for (int ox = ox0; ox <= ox1; ++ox) g.visit(ox, oy, gy, xl, xh, yl, yh);
        }
      }
    }
  }
  T* dst = dx + ((int64_t)n * C + c0) * in_plane + (int64_t)iy * W + ix;
#pragma unroll
  for (int r = 0; r < QY * QX; ++r) {
    if (iy + r / QX < H && ix + r % QX < W) {
#pragma unroll
      for (int j = 0; j < CHUNK; ++j) {
        if (j < g.nc) store(dst + j * in_plane + (r / QX) * W + r % QX, g.acc[r][j]);
      }
    }
  }
}

template <typename T>
void launch(const void* dy, const float* G_inv, void* dx, int N, int C, int H, int W, int out_h,
            int out_w, bool zeros, cudaStream_t stream) {
  const int chunks = (C + CHUNK - 1) / CHUNK;
  const dim3 grid((W + TILE_X * QX - 1) / (TILE_X * QX), (H + TILE_Y * QY - 1) / (TILE_Y * QY),
                  N * chunks);
  affine_warp_bwd_kernel<T><<<grid, THREADS, 0, stream>>>(static_cast<const T*>(dy), G_inv,
                                                          static_cast<T*>(dx), C, H, W, out_h,
                                                          out_w, zeros, chunks);
}

}  // namespace

// dtype (of dy and dx): 0 = float32, 1 = bfloat16. mode: 0 = reflect, 1 =
// zeros. dy is [N, C, out_h, out_w] and dx [N, C, H, W], both contiguous;
// every element of dx is written. G_inv is [N, 3, 3] float32 on the device.
// N * ceil(C / 9) and ceil(H / 16) are at most 65535.
extern "C" int affine_warp_bwd(const void* dy, const float* G_inv, void* dx, int dtype, int mode,
                               int N, int C, int H, int W, int out_h, int out_w, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool zeros = mode == 1;
  if (mode != 0 && mode != 1) return (int)cudaErrorInvalidValue;
  if (dtype == 0) {
    launch<float>(dy, G_inv, dx, N, C, H, W, out_h, out_w, zeros, s);
  } else if (dtype == 1) {
    launch<__nv_bfloat16>(dy, G_inv, dx, N, C, H, W, out_h, out_w, zeros, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
