// Shared pieces of K1 (downfirdn2d_x2.cu) and K1-bwd (downfirdn2d_x2_bwd.cu):
// the tile plan, the copy of a tile's input window into shared memory, and
// the persistent two-stage loop over tiles.
//
// The wrapper (ops/fir_kernels.py:fir_plan) computes the plan and passes it
// as an int64 array in the field order of FirPlan there. A tile is P planes x
// tile_h x tile_w cells of the tile grid (K1: its outputs; K1-bwd: dy). Its
// window is the part of the source tensor (K1: x; K1-bwd: dy) that the tile
// reads, with a halo of one: win_h rows from scale*h0 - 1 and win_w columns
// from scale*w0 - pad, zero outside the plane. With `vec` every source row
// starts on 16 bytes (W a multiple of 16 bytes' elements, pad = one such
// chunk), so the window is copied in 16-byte cp.async chunks, each wholly
// inside or wholly outside the plane (zero-filled by a source size of 0);
// otherwise element by element. K1 stores the chunks of a window row
// swizzled (`swizzle`), so that the 16-byte reads of eight neighbouring
// threads, 32 bytes apart, fall in distinct banks; its rows then hold an even
// number of chunks (row_stride elements).
//
// A block walks over tiles blockIdx.x, + gridDim.x, ... (the grid is what the
// card holds at once), and copies the next tile's window while it computes
// on this one: two stages of stage_bytes each in dynamic shared memory.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

// An upper bound on a block's threads (ops/fir_kernels.py:THREADS), for the
// compiler's register budget.
#define FIR_MAX_THREADS 256

namespace fir {

struct Filter4x4 {
  float v[16];
};

// The plan, in the field order of ops/fir_kernels.py:FirPlan.
enum PlanField {
  kPlanes, kSrcH, kSrcW, kGridH, kGridW, kVec, kScale, kRunH, kRunW, kP, kTileH, kTileW,
  kNX, kNY, kThreads, kTilesP, kTilesH, kTilesW, kTiles, kGrid, kPad, kWinH, kWinW,
  kRowStride, kChunk, kCpr, kCprMagic, kCprShift, kWinHMagic, kWinHShift, kStageBytes, kNumPlanFields
};

struct Plan {
  int64_t planes, tiles;
  int src_h, src_w, grid_h, grid_w, scale, P, tile_h, tile_w, nx, ny, threads;
  int tiles_h, tiles_w, grid, pad, win_h, win_w, row_stride, chunk, cpr, stage_bytes;
  unsigned cpr_magic, cpr_shift, winh_magic, winh_shift;
};

inline Plan read_plan(const int64_t* a) {
  Plan p;
  p.planes = a[kPlanes];
  p.tiles = a[kTiles];
  p.src_h = (int)a[kSrcH];
  p.src_w = (int)a[kSrcW];
  p.grid_h = (int)a[kGridH];
  p.grid_w = (int)a[kGridW];
  p.scale = (int)a[kScale];
  p.P = (int)a[kP];
  p.tile_h = (int)a[kTileH];
  p.tile_w = (int)a[kTileW];
  p.nx = (int)a[kNX];
  p.ny = (int)a[kNY];
  p.threads = (int)a[kThreads];
  p.tiles_h = (int)a[kTilesH];
  p.tiles_w = (int)a[kTilesW];
  p.grid = (int)a[kGrid];
  p.pad = (int)a[kPad];
  p.win_h = (int)a[kWinH];
  p.win_w = (int)a[kWinW];
  p.row_stride = (int)a[kRowStride];
  p.chunk = (int)a[kChunk];
  p.cpr = (int)a[kCpr];
  p.stage_bytes = (int)a[kStageBytes];
  p.cpr_magic = (unsigned)a[kCprMagic];
  p.cpr_shift = (unsigned)a[kCprShift];
  p.winh_magic = (unsigned)a[kWinHMagic];
  p.winh_shift = (unsigned)a[kWinHShift];
  return p;
}

// n / d for n < 2^31, with (magic, shift) of d from ops/fir_kernels.py:fast_div_magic.
__device__ __forceinline__ unsigned fast_div(unsigned n, unsigned magic, unsigned shift) {
  return (unsigned)(((unsigned long long)__umulhi(n, magic) + n) >> shift);
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// The slot of chunk c in a swizzled window row: pairs of chunks swap in
// every second group of eight, a permutation of an even number of slots.
__device__ __forceinline__ int swizzle(int c) { return c ^ ((c >> 3) & 1); }

template <int BYTES> struct VecOf;
template <> struct VecOf<8> { using type = uint2; };
template <> struct VecOf<16> { using type = uint4; };

// v[0..N) = the N elements from p on, as float. With VEC, p - (E - 1) is
// aligned to CHUNK bytes (E elements of T) and the elements are read as
// whole CHUNK-byte vectors from p - (E - 1) on.
template <typename T, bool VEC, int N, int CHUNK>
__device__ __forceinline__ void load_row(const T* p, float (&v)[N]) {
  if constexpr (VEC) {
    constexpr int E = CHUNK / (int)sizeof(T);
    constexpr int NC = (N + E - 1 + E - 1) / E;
    using V = typename VecOf<CHUNK>::type;
    V raw[NC];
    const V* src = reinterpret_cast<const V*>(p - (E - 1));
#pragma unroll
    for (int c = 0; c < NC; ++c) raw[c] = src[c];
    const T* e = reinterpret_cast<const T*>(raw);
#pragma unroll
    for (int k = 0; k < N; ++k) v[k] = to_f32(e[E - 1 + k]);
  } else {
#pragma unroll
    for (int k = 0; k < N; ++k) v[k] = to_f32(p[k]);
  }
}

// v[0..N) = the N elements from element E - 1 of 16-byte chunk c0 on (E
// elements of T a chunk), read as whole chunks from a swizzled row.
template <typename T, int N>
__device__ __forceinline__ void load_row_swizzled(const T* row, int c0, float (&v)[N]) {
  constexpr int E = 16 / (int)sizeof(T);
  constexpr int NC = (N + E - 1 + E - 1) / E;
  uint4 raw[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) raw[c] = reinterpret_cast<const uint4*>(row)[swizzle(c0 + c)];
  const T* e = reinterpret_cast<const T*>(raw);
#pragma unroll
  for (int k = 0; k < N; ++k) v[k] = to_f32(e[E - 1 + k]);
}

// Stores a[0..N) at p: one 16-byte vector with VEC, else the first `valid`.
template <typename T, bool VEC, int N>
__device__ __forceinline__ void store_run(T* p, const float (&a)[N], int valid) {
  static_assert(N * sizeof(T) == 16, "a run is one 16-byte vector");
  if constexpr (VEC) {
    if constexpr (sizeof(T) == 4) {
      *reinterpret_cast<float4*>(p) = make_float4(a[0], a[1], a[2], a[3]);
    } else {
      uint4 packed;
      __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&packed);
#pragma unroll
      for (int j = 0; j < N / 2; ++j) h[j] = __floats2bfloat162_rn(a[2 * j], a[2 * j + 1]);
      *reinterpret_cast<uint4*>(p) = packed;
    }
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j)
      if (j < valid) p[j] = from_f32<T>(a[j]);
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

struct Tile {
  int64_t plane0;
  int h0, w0;  // origin in the tile grid
};

__device__ __forceinline__ Tile tile_at(const Plan& pl, int64_t t) {
  const int64_t rest = t / pl.tiles_w;
  Tile tl;
  tl.w0 = (int)(t - rest * pl.tiles_w) * pl.tile_w;
  const int64_t tp = rest / pl.tiles_h;
  tl.h0 = (int)(rest - tp * pl.tiles_h) * pl.tile_h;
  tl.plane0 = tp * pl.P;
  return tl;
}

// Start the copy of tile tl's window into sw (cp.async with VEC, else plain
// loads and stores). Window cell (p, r, c) is source element
// (plane0 + p, scale*h0 - 1 + r, scale*w0 - pad + c), zero outside; with
// SWZ its chunk goes to slot swizzle(c / chunk) of the row.
template <typename T, bool VEC, bool SWZ>
__device__ __forceinline__ void copy_window(T* sw, const T* __restrict__ src, const Plan& pl,
                                            const Tile& tl) {
  const int row0 = pl.scale * tl.h0 - 1, col0 = pl.scale * tl.w0 - pl.pad;
  const int n = pl.P * pl.win_h * pl.cpr;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const unsigned pr = fast_div((unsigned)i, pl.cpr_magic, pl.cpr_shift);  // p*win_h + r
    const int c = i - (int)pr * pl.cpr;
    const unsigned p = fast_div(pr, pl.winh_magic, pl.winh_shift);
    const int iy = row0 + (int)(pr - p * pl.win_h), ix = col0 + c * pl.chunk;
    const int64_t plane = tl.plane0 + p;
    const bool inside = plane < pl.planes && iy >= 0 && iy < pl.src_h && ix >= 0 &&
                        ix < pl.src_w;
    const T* g = inside ? src + (plane * pl.src_h + iy) * (int64_t)pl.src_w + ix : src;
    T* d = sw + (size_t)pr * pl.row_stride + (SWZ ? swizzle(c) : c) * pl.chunk;
    if constexpr (VEC) {
      cp_async16(d, g, inside ? 16 : 0);
    } else {
      *d = inside ? *g : from_f32<T>(0.f);
    }
  }
}

// The persistent two-stage loop: compute(tile, window) for every tile of
// this block, the next tile's window in flight meanwhile.
template <typename T, bool VEC, bool SWZ, typename Compute>
__device__ __forceinline__ void tile_loop(const T* __restrict__ src, const Plan& pl,
                                          unsigned char* smem, Compute&& compute) {
  T* cur = reinterpret_cast<T*>(smem);
  T* nxt = reinterpret_cast<T*>(smem + pl.stage_bytes);
  int64_t t = blockIdx.x;
  if (t < pl.tiles) copy_window<T, VEC, SWZ>(cur, src, pl, tile_at(pl, t));
  cp_async_commit();
  for (; t < pl.tiles; t += gridDim.x) {
    const int64_t next = t + gridDim.x;
    if (next < pl.tiles) copy_window<T, VEC, SWZ>(nxt, src, pl, tile_at(pl, next));
    cp_async_commit();
    cp_async_wait_prev();  // this tile's group is done; the next one may still run
    __syncthreads();
    compute(tile_at(pl, t), static_cast<const T*>(cur));
    __syncthreads();       // all reads of cur done before it is refilled
    T* done = cur;
    cur = nxt;
    nxt = done;
  }
}

// Dynamic shared memory beyond 48 KB needs the kernel's attribute raised.
template <typename K>
inline cudaError_t allow_smem(K kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace fir
