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
// Bound: memory. It must read x once and write y once (at the ADA step's
// warp, [16,9,536,536] -> 524^2 in bf16, 162 MB: 0.048 ms at 3.35 TB/s).
// Sampling each tap straight from device memory costs more than the bytes:
// under a rotation the 32 lanes of a warp sample along a tilted line, so one
// load touches many rows and cache lines for 64 bytes of data, and the L1's
// wavefronts bound the kernel (affine_warp_per_pixel below, kept as the
// reference design). So a block takes a tile of TILE_W x TILE_H outputs of
// one image and stages the tile's input box in shared memory first:
//
//   * The box, per axis (tile_span in affine_warp.cuh): the raw range over
//     the tile's corners in float64, widened by a margin that exceeds the
//     float32 geometry's rounding, mapped through the mirror, and turned
//     into the columns (rows) of its taps. ops/grid_sample.py's
//     _warp_tile_boxes computes it line by line, and the CPU tests check
//     that every tap of every staged tile lies in its box.
//   * The copy: each row of the box from the 16-byte chunk left of its first
//     column, in 16-byte cp.async chunks (element copies where the rows are
//     not 16-byte aligned), an odd number of chunks a row, so that rows land
//     on banks 16 bytes apart and a warp's tilted reads spread over the 32
//     banks. Every channel at once if they fit SMEM_BYTES; else chunks of
//     channels that fit twice, double-buffered, so that one chunk's copy
//     overlaps the previous chunk's sums.
//   * The sums: each thread computes the taps of its ROWS output pixels
//     (one column, rows THREAD_ROWS apart) once with the unchanged
//     taps_from, so positions, weights and summing order are the reference
//     design's and the result is the same to the bit; then reads the four
//     taps of each channel from shared memory. A tap outside the box (which
//     the margin rules out) is read from device memory.
//   * A tile whose box does not fit even one channel twice (a zoom-out of
//     more than about 3x) samples straight from device memory, as the
//     reference design does.
//   * Stores: a warp writes 32 neighbouring outputs of one row.
//
// Order within a block: the box (two threads, float64), then each thread's
// taps, then the copy (starting the copy before the taps timed slower).
// What bounds the kernel now is not the bytes but its instructions and their
// latency: the geometry, the copy and the stores each take a large part of
// its time (tools/k4_variants.py times them apart, and the variants tried).
//
// The C entry points launch on the given stream, do not synchronise,
// allocate nothing and return cudaGetLastError().

#include "affine_warp.cuh"
#include "fir_tile.cuh"

namespace {

using namespace warp_geom;

constexpr int TILE_W = 32;           // output columns of a tile: a warp takes a row
constexpr int THREAD_ROWS = 8;       // warps of a block
constexpr int ROWS = 2;              // output rows of a thread, THREAD_ROWS apart
constexpr int TILE_H = THREAD_ROWS * ROWS;
constexpr int THREADS = TILE_W * THREAD_ROWS;
constexpr int SMEM_BYTES = 48 * 1024;  // the staging budget of a block

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// top = g00 (1 - wx) + g01 wx, bot = g10 (1 - wx) + g11 wx, top (1 - wy) + bot wy
__device__ __forceinline__ float bilinear(float g00, float g01, float g10, float g11, float wx,
                                          float wy) {
  const float omx = __fsub_rn(1.0f, wx), omy = __fsub_rn(1.0f, wy);
  const float top = __fadd_rn(__fmul_rn(g00, omx), __fmul_rn(g01, wx));
  const float bot = __fadd_rn(__fmul_rn(g10, omx), __fmul_rn(g11, wx));
  return __fadd_rn(__fmul_rn(top, omy), __fmul_rn(bot, wy));
}

// One output of one channel plane, its taps read from device memory.
template <typename T>
__device__ __forceinline__ float sample_direct(const T* __restrict__ src, const Taps& t) {
  if (!t.inside) return 0.0f;
  return bilinear(load_f32(src + t.o00), load_f32(src + t.o01), load_f32(src + t.o10),
                  load_f32(src + t.o11), t.wx, t.wy);
}

// The reference design: one thread an output pixel (blocks of up to 128 of
// one row), every tap read from device memory.
template <typename T>
__global__ void affine_warp_per_pixel_kernel(const T* __restrict__ x,
                                             const float* __restrict__ G_inv, T* __restrict__ y,
                                             const int C, const int H, const int W,
                                             const int out_h, const int out_w, const bool zeros) {
  const int ox = blockIdx.x * blockDim.x + threadIdx.x;
  const int oy = blockIdx.y;
  const int n = blockIdx.z;
  if (ox >= out_w) return;
  const Taps t = taps_at(G_inv + 9 * n, ox, oy, H, W, out_h, out_w, zeros);
  const int64_t in_plane = (int64_t)H * W, out_plane = (int64_t)out_h * out_w;
  const T* src = x + (int64_t)n * C * in_plane;
  T* dst = y + (int64_t)n * C * out_plane + (int64_t)oy * out_w + ox;
  for (int c = 0; c < C; ++c, src += in_plane, dst += out_plane) store(dst, sample_direct(src, t));
}

// The channels a tile stages at once (ops/grid_sample.py:_tile_channels):
// all if they fit the budget, else as many as fit twice, 0 if one does not
// fit twice (the direct path).
__device__ __forceinline__ int tile_channels(int C, int64_t plane_bytes) {
  return (int64_t)C * plane_bytes <= SMEM_BYTES ? C : (int)(SMEM_BYTES / (2 * plane_bytes));
}

// The staged box: rows by0.. of bh rows, each `chunks` 16-byte chunks from
// column ax0, at `pitch` elements a row and `plane` a channel.
struct Box {
  int bx0, bx1, by0, by1, ax0, chunks, pitch, bh, plane;
};

// Start the copy of channels c0 .. c0 + nc - 1 of the box into buf: chunk k
// of row r of channel c at buf[c plane + r pitch + k V]. With VEC by 16-byte
// cp.async, else element by element (the columns past the image are never
// read). Each thread steps THREADS chunks at a time.
template <typename T, bool VEC>
__device__ __forceinline__ void stage(T* buf, const T* __restrict__ src, int64_t in_plane, int W,
                                      const Box& b, int c0, int nc) {
  constexpr int V = 16 / sizeof(T);
  const int dr = THREADS / b.chunks, dk = THREADS - dr * b.chunks;
  int k = threadIdx.x % b.chunks, r = threadIdx.x / b.chunks;
  int c = r / b.bh;
  r -= c * b.bh;
  for (; c < nc;) {
    const T* g = src + (c0 + c) * in_plane + (int64_t)(b.by0 + r) * W + b.ax0 + k * V;
    T* d = buf + c * b.plane + r * b.pitch + k * V;
    if constexpr (VEC) {
      fir::cp_async16(d, g, 16);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) {
        if (b.ax0 + k * V + e < W) d[e] = g[e];
      }
    }
    k += dk;
    r += dr;
    if (k >= b.chunks) {
      k -= b.chunks;
      ++r;
    }
    while (r >= b.bh) {
      r -= b.bh;
      ++c;
    }
  }
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One thread's output pixel: its taps, whether it lies in the grid, and its
// taps in the staged box (offset of tap 00 in a channel's plane, steps to
// taps 01 and 10; staged: all four lie in the box).
struct Pixel {
  Taps t;
  int oy, s00, sx, sy;
  bool live, staged;
};

template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS, 4)
    affine_warp_kernel(const T* __restrict__ x, const float* __restrict__ G_inv,
                       T* __restrict__ y, const int C, const int H, const int W,
                       const int out_h, const int out_w, const bool zeros) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int span[4];
  constexpr int V = 16 / sizeof(T);
  const int n = blockIdx.z;
  const int ox0 = blockIdx.x * TILE_W, oy0 = blockIdx.y * TILE_H;
  const Affine A = load_affine(G_inv + 9 * n);
  if (threadIdx.x < 2) {  // thread 0 the columns, thread 1 the rows
    const int last_x = min(ox0 + TILE_W, out_w) - 1, last_y = min(oy0 + TILE_H, out_h) - 1;
    const AxisMap m = threadIdx.x == 0 ? axis_map(A.g00, A.g01, A.g02, W, out_w, out_h)
                                       : axis_map(A.g10, A.g11, A.g12, H, out_w, out_h);
    tile_span(m, threadIdx.x == 0 ? W : H, ox0, last_x, oy0, last_y, zeros,
              span[2 * threadIdx.x], span[2 * threadIdx.x + 1]);
  }
  __syncthreads();
  Box b;
  b.bx0 = span[0];
  b.bx1 = span[1];
  b.by0 = span[2];
  b.by1 = span[3];
  b.ax0 = b.bx0 - b.bx0 % V;
  b.chunks = (b.bx1 - b.ax0) / V + 1;
  b.pitch = (b.chunks | 1) * V;
  b.bh = b.by1 - b.by0 + 1;
  b.plane = b.bh * b.pitch;
  const int cg = tile_channels(C, (int64_t)b.plane * sizeof(T));
  const int64_t in_plane = (int64_t)H * W, out_plane = (int64_t)out_h * out_w;
  const T* src = x + (int64_t)n * C * in_plane;
  T* const buf = reinterpret_cast<T*>(smem);  // two buffers of cg planes
  const int buf_step = cg * b.plane;

  const int ox = ox0 + threadIdx.x % TILE_W;
  const float gx = grid_coord(ox, out_w);
  Pixel px[ROWS];
#pragma unroll
  for (int q = 0; q < ROWS; ++q) {
    Pixel& p = px[q];
    p.oy = oy0 + threadIdx.x / TILE_W + q * THREAD_ROWS;
    p.live = ox < out_w && p.oy < out_h;
    p.t = taps_from(A, gx, grid_coord(p.oy, out_h), H, W, zeros);
    p.staged = p.t.x0 >= b.bx0 && p.t.x1 <= b.bx1 && p.t.y0 >= b.by0 && p.t.y1 <= b.by1;
    p.s00 = (p.t.y0 - b.by0) * b.pitch + (p.t.x0 - b.ax0);
    p.sx = p.t.x1 - p.t.x0;
    p.sy = (p.t.y1 - p.t.y0) * b.pitch;
  }
  T* dst = y + (int64_t)n * C * out_plane + ox;

  if (cg == 0) {  // the direct path
    for (int c = 0; c < C; ++c) {
#pragma unroll
      for (int q = 0; q < ROWS; ++q) {
        if (px[q].live) {
          store(dst + c * out_plane + (int64_t)px[q].oy * out_w,
                sample_direct(src + c * in_plane, px[q].t));
        }
      }
    }
    return;
  }

  stage<T, VEC>(buf, src, in_plane, W, b, 0, min(cg, C));
  fir::cp_async_commit();
  for (int c0 = 0, k = 0; c0 < C; c0 += cg, ++k) {
    if (c0 + cg < C) {  // the next chunk's copy runs during this chunk's sums
      stage<T, VEC>(buf + ((k + 1) & 1) * buf_step, src, in_plane, W, b, c0 + cg,
                    min(cg, C - c0 - cg));
      fir::cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* s = buf + (k & 1) * buf_step;
    const int nc = min(cg, C - c0);
    for (int c = 0; c < nc; ++c, s += b.plane) {
#pragma unroll
      for (int q = 0; q < ROWS; ++q) {
        const Pixel& p = px[q];
        if (!p.live) continue;
        float v;
        if (!p.t.inside) {
          v = 0.0f;
        } else if (p.staged) {
          const T* g = s + p.s00;
          v = bilinear(to_f32(g[0]), to_f32(g[p.sx]), to_f32(g[p.sy]), to_f32(g[p.sy + p.sx]),
                       p.t.wx, p.t.wy);
        } else {  // a tap outside the box: never, by the margin
          v = sample_direct(src + (c0 + c) * in_plane, p.t);
        }
        store(dst + (c0 + c) * out_plane + (int64_t)p.oy * out_w, v);
      }
    }
    __syncthreads();  // every read of this buffer done before it is refilled
  }
}

template <typename T, bool VEC>
cudaError_t launch_tiles(const void* x, const float* G_inv, void* y, int N, int C, int H, int W,
                         int out_h, int out_w, bool zeros, cudaStream_t stream) {
  const auto kernel = affine_warp_kernel<T, VEC>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid((out_w + TILE_W - 1) / TILE_W, (out_h + TILE_H - 1) / TILE_H, N);
  kernel<<<grid, THREADS, SMEM_BYTES, stream>>>(static_cast<const T*>(x), G_inv,
                                                static_cast<T*>(y), C, H, W, out_h, out_w, zeros);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* x, const float* G_inv, void* y, int N, int C, int H, int W,
                   int out_h, int out_w, bool zeros, cudaStream_t stream) {
  // 16-byte copies need every row of x on 16 bytes
  const bool vec = reinterpret_cast<uintptr_t>(x) % 16 == 0 && (W * sizeof(T)) % 16 == 0;
  return vec ? launch_tiles<T, true>(x, G_inv, y, N, C, H, W, out_h, out_w, zeros, stream)
             : launch_tiles<T, false>(x, G_inv, y, N, C, H, W, out_h, out_w, zeros, stream);
}

template <typename T>
cudaError_t launch_per_pixel(const void* x, const float* G_inv, void* y, int N, int C, int H,
                             int W, int out_h, int out_w, bool zeros, cudaStream_t stream) {
  const int threads = out_w >= 128 ? 128 : 32 * ((out_w + 31) / 32);
  const dim3 grid((out_w + threads - 1) / threads, out_h, N);
  affine_warp_per_pixel_kernel<T><<<grid, threads, 0, stream>>>(
      static_cast<const T*>(x), G_inv, static_cast<T*>(y), C, H, W, out_h, out_w, zeros);
  return cudaGetLastError();
}

using Launcher = cudaError_t (*)(const void*, const float*, void*, int, int, int, int, int, int,
                                 bool, cudaStream_t);

int dispatch(Launcher f32, Launcher bf16, const void* x, const float* G_inv, void* y, int dtype,
             int mode, int N, int C, int H, int W, int out_h, int out_w, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode != 0 && mode != 1) return (int)cudaErrorInvalidValue;
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  return (int)(dtype == 0 ? f32 : bf16)(x, G_inv, y, N, C, H, W, out_h, out_w, mode == 1, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. mode: 0 = reflect, 1 = zeros. x is
// [N, C, H, W] and y [N, C, out_h, out_w], both contiguous; G_inv is
// [N, 3, 3] float32 on the device. N and ceil(out_h / 16) are at most 65535.
extern "C" int affine_warp(const void* x, const float* G_inv, void* y, int dtype, int mode,
                           int N, int C, int H, int W, int out_h, int out_w, void* stream) {
  return dispatch(launch<float>, launch<__nv_bfloat16>, x, G_inv, y, dtype, mode, N, C, H, W,
                  out_h, out_w, stream);
}

// The reference design (every tap from device memory), with the same
// arguments and the same result to the bit; for comparisons only. N and
// out_h are at most 65535.
extern "C" int affine_warp_per_pixel(const void* x, const float* G_inv, void* y, int dtype,
                                     int mode, int N, int C, int H, int W, int out_h, int out_w,
                                     void* stream) {
  return dispatch(launch_per_pixel<float>, launch_per_pixel<__nv_bfloat16>, x, G_inv, y, dtype,
                  mode, N, C, H, W, out_h, out_w, stream);
}
