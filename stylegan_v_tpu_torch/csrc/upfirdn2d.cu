// The general FIR resampler upfirdn2d (K2), one filter pass, NCHW, for
// Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package computes each filter pass as
// one XLA convolution (stylegan_v_tpu/ops/upfirdn2d.py:_depthwise_pass,
// upfirdn2d), which the TPU fuses. The port's plain version of the pass
// (ops/upfirdn2d_kernel.py:_depthwise_pass) is three launches: a zero-insert
// that writes up^2 times the input, a pad, and a cuDNN depthwise conv that
// also multiplies every inserted zero. This kernel computes the same pass:
//
//   y[p, oy, ox] = sum_{ty < fh, tx < fw} k[ty][tx] * u[p, oy*DY - py0 + ty, ox*DX - px0 + tx]
//
// where u is x zero-inserted by (UY, UX) (u[q] = x[q / U] where q is a
// multiple of U and q / U lies inside the plane, else 0), k is the filter as
// a correlation (flipped and gained by the wrapper), rounded to the input's
// dtype as the plain version's conv takes it, the sum is float32 over ty
// then tx in that order for every output, whatever the tile, and the result
// is rounded once to the input's dtype (float32, or bfloat16 to nearest
// even). A negative pad crops.
//
// Bound: HBM. A pass reads its input and writes its output once, and does at
// most 16 multiply-adds an output (4 at up 2 with a 4x4 filter): the work is
// to move each byte once. Design (the plan is ops/upfirdn2d_kernel.py:k2_plan,
// which the CPU tests check for coverage and window bounds):
// - Polyphase: a thread computes a run of 4 rows x 2 columns of outputs;
//   for each output it visits only the taps that land on source samples.
//   Which taps those are depends on the output's position modulo the run,
//   and on the leading pad mod up (the phase), both compile-time here, so
//   the loops unroll to the real multiply-adds and nothing else.
// - Tiled: a block takes a tile of outputs (one plane, or several small
//   planes packed) and first copies the tile's input window from device
//   memory into shared memory, with cp.async in 16-, 8- or 4-byte chunks
//   where the source rows are whole chunks, else element by element. The
//   window starts on a chunk, so every chunk lies wholly inside or outside
//   the plane; outside ones are zero-filled (a source size of 0). Padding
//   and crops are only where the window starts: no padded copy exists.
// - Register reuse: a thread reads each window row its run needs once, into
//   registers, and feeds every output and tap of the run from them.
// - Stores: a warp's lanes take neighbouring runs, so each of its stores
//   writes one row's contiguous outputs, two outputs at an even element
//   offset a store (4 bytes in bf16, 8 in float32). A run starts on an even
//   column, so in a row that starts on an even offset its two columns are a
//   pair. Where the rows are odd in length, every other row starts on an
//   odd offset: there a run's second column pairs with the next lane's first
//   (a warp shuffle), and a column goes alone only at a tile's or a warp's
//   edge and at the row's end.
// - Templates per filter class (at most 4x4, a row of 16 or a column of 16),
//   per axis up and down ((1,1), (2,1), (1,2)) and phase: K2_VARIANTS, which
//   the wrapper's VARIANTS lists in the same order.
//
// The C entry point launches on the given stream, does not synchronise,
// allocates nothing and returns the CUDA error of the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

#define K2_MAX_THREADS 256

// (filter rows, filter columns) held, then (up, down, phase) for y and x.
#define K2_VARIANTS(X)                                                                        \
  X(4, 4, 1, 1, 0, 1, 1, 0) X(4, 4, 2, 1, 0, 2, 1, 0) X(4, 4, 2, 1, 1, 2, 1, 1)               \
  X(4, 4, 1, 2, 0, 1, 2, 0)                                                                   \
  X(1, 16, 1, 1, 0, 1, 1, 0) X(1, 16, 1, 1, 0, 2, 1, 0) X(1, 16, 1, 1, 0, 2, 1, 1)            \
  X(1, 16, 1, 1, 0, 1, 2, 0)                                                                  \
  X(16, 1, 1, 1, 0, 1, 1, 0) X(16, 1, 2, 1, 0, 1, 1, 0) X(16, 1, 2, 1, 1, 1, 1, 0)            \
  X(16, 1, 1, 2, 0, 1, 1, 0)

namespace {

constexpr int RUN_X = 2;  // output columns a thread computes
constexpr int RUN_Y = 4;  // output rows a thread computes

struct Taps {
  float v[16];  // [FY][FX] row-major, zero beyond fh x fw
};

// The plan, in the field order of ops/upfirdn2d_kernel.py:K2Plan.
enum PlanField {
  kVariant, kPlanes, kSrcH, kSrcW, kOutH, kOutW, kFH, kFW, kPlanesPerTile, kNX, kNY, kThreads,
  kTileH, kTileW, kTilesH, kTilesW, kTiles, kStepY, kStepX, kBaseY, kBaseX, kLeadX, kWinH, kWinW,
  kChunk, kChunkBytes, kCpr, kStageBytes, kNumPlanFields
};

struct Plan {
  int64_t planes, tiles;
  int src_h, src_w, out_h, out_w, fh, fw, P, nx, ny, threads, tile_h, tile_w, tiles_h, tiles_w;
  int step_y, step_x, base_y, base_x, lead_x, win_h, win_w, chunk, chunk_bytes, cpr;
  int stage_bytes;
};

Plan read_plan(const int64_t* a) {
  Plan p;
  p.planes = a[kPlanes];
  p.tiles = a[kTiles];
  p.src_h = (int)a[kSrcH];
  p.src_w = (int)a[kSrcW];
  p.out_h = (int)a[kOutH];
  p.out_w = (int)a[kOutW];
  p.fh = (int)a[kFH];
  p.fw = (int)a[kFW];
  p.P = (int)a[kPlanesPerTile];
  p.nx = (int)a[kNX];
  p.ny = (int)a[kNY];
  p.threads = (int)a[kThreads];
  p.tile_h = (int)a[kTileH];
  p.tile_w = (int)a[kTileW];
  p.tiles_h = (int)a[kTilesH];
  p.tiles_w = (int)a[kTilesW];
  p.step_y = (int)a[kStepY];
  p.step_x = (int)a[kStepX];
  p.base_y = (int)a[kBaseY];
  p.base_x = (int)a[kBaseX];
  p.lead_x = (int)a[kLeadX];
  p.win_h = (int)a[kWinH];
  p.win_w = (int)a[kWinW];
  p.chunk = (int)a[kChunk];
  p.chunk_bytes = (int)a[kChunkBytes];
  p.cpr = (int)a[kCpr];
  p.stage_bytes = (int)a[kStageBytes];
  return p;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Two neighbouring outputs as one store (p on 2 elements).
__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// A BYTES-byte cp.async from global to shared memory, zero-filled past src_bytes.
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src, int src_bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
                 "r"(src_bytes)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d), "l"(src),
                 "n"(BYTES), "r"(src_bytes)
                 : "memory");
  }
}

// Copy the tile's window: cell (p, r, c) of it is source element
// (plane0 + p, row0 + r, col0 + c), zero outside the planes. BYTES is the
// chunk's size for cp.async, or 0 for element copies.
template <typename T, int BYTES>
__device__ __forceinline__ void copy_window(T* sw, const T* __restrict__ x, const Plan& pl,
                                            int64_t plane0, int row0, int col0) {
  const int n = pl.P * pl.win_h * pl.cpr;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int pr = i / pl.cpr;  // p * win_h + r
    const int c = i - pr * pl.cpr;
    const int p = pr / pl.win_h;
    const int iy = row0 + (pr - p * pl.win_h), ix = col0 + c * pl.chunk;
    const int64_t plane = plane0 + p;
    const bool inside = plane < pl.planes && iy >= 0 && iy < pl.src_h && ix >= 0 &&
                        ix < pl.src_w;
    const T* g = inside ? x + (plane * pl.src_h + iy) * (int64_t)pl.src_w + ix : x;
    T* d = sw + (size_t)pr * pl.win_w + c * pl.chunk;
    if constexpr (BYTES == 0) {
      *d = inside ? *g : from_f32<T>(0.f);
    } else {
      cp_async<BYTES>(d, g, inside ? BYTES : 0);
    }
  }
}

// The run's sums: acc[jy][jx] over the taps that land on source samples.
// Output row jy of the run reads, with tap row ty, window row
// (jy DY + ty - RY) / UY of the run's rows where that divides; so window
// row sy feeds tap row sy UY - jy DY + RY. The same for columns.
template <typename T, int FY, int FX, int UY, int DY, int RY, int UX, int DX, int RX>
__device__ __forceinline__ void accumulate(float (&acc)[RUN_Y][RUN_X], const T* s,
                                           const Taps& k, const Plan& pl) {
  constexpr int SEGY = ((RUN_Y - 1) * DY + FY - 1 - RY) / UY + 1;
  constexpr int SEGX = ((RUN_X - 1) * DX + FX - 1 - RX) / UX + 1;
#pragma unroll
  for (int sy = 0; sy < SEGY; ++sy) {
    float v[SEGX];
#pragma unroll
    for (int sx = 0; sx < SEGX; ++sx) v[sx] = to_f32(s[sy * pl.win_w + sx]);
#pragma unroll
    for (int jy = 0; jy < RUN_Y; ++jy) {
      const int ty = sy * UY - jy * DY + RY;
      if (ty < 0 || ty >= FY || ty >= pl.fh) continue;
#pragma unroll
      for (int jx = 0; jx < RUN_X; ++jx) {
#pragma unroll
        for (int sx = 0; sx < SEGX; ++sx) {
          const int tx = sx * UX - jx * DX + RX;
          if (tx < 0 || tx >= FX || tx >= pl.fw) continue;
          acc[jy][jx] = fmaf(k.v[ty * FX + tx], v[sx], acc[jy][jx]);
        }
      }
    }
  }
}

// ODD_W: the output rows are odd in length (a launch takes the one its plan
// needs), so every other row starts on an odd element offset.
template <typename T, bool ODD_W, int FY, int FX, int UY, int DY, int RY, int UX, int DX,
          int RX>
__global__ void __launch_bounds__(K2_MAX_THREADS)
    upfirdn2d_kernel(const T* __restrict__ x, T* __restrict__ y, const Taps k, const Plan pl) {
  static_assert((RUN_Y * DY) % UY == 0 && (RUN_X * DX) % UX == 0, "runs start on a phase");
  extern __shared__ __align__(16) unsigned char smem[];
  T* sw = reinterpret_cast<T*>(smem);

  // the tile: (planes, rows, columns) from blockIdx.x
  const int64_t t = blockIdx.x;
  const int64_t rest = t / pl.tiles_w;
  const int tw = (int)(t - rest * pl.tiles_w);
  const int64_t tp = rest / pl.tiles_h;
  const int th = (int)(rest - tp * pl.tiles_h);
  const int64_t plane0 = tp * pl.P;
  const int row0 = th * pl.step_y + pl.base_y, col0 = tw * pl.step_x + pl.base_x;
  switch (pl.chunk_bytes) {
    case 16: copy_window<T, 16>(sw, x, pl, plane0, row0, col0); break;
    case 8: copy_window<T, 8>(sw, x, pl, plane0, row0, col0); break;
    case 4: copy_window<T, 4>(sw, x, pl, plane0, row0, col0); break;
    default: copy_window<T, 0>(sw, x, pl, plane0, row0, col0); break;
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // this thread's run: RUN_Y rows x RUN_X columns from (oy, ox) of plane
  const int cx = threadIdx.x % pl.nx, rest_t = threadIdx.x / pl.nx;
  const int cy = rest_t % pl.ny, cp = rest_t / pl.ny;
  const int64_t plane = plane0 + cp;
  const int oy = th * pl.tile_h + cy * RUN_Y, ox = tw * pl.tile_w + cx * RUN_X;
  const bool valid = plane < pl.planes && oy < pl.out_h && ox < pl.out_w;
  if (!ODD_W && !valid) return;
  const T* s = sw + ((size_t)cp * pl.win_h + cy * (RUN_Y * DY / UY)) * pl.win_w + pl.lead_x +
               cx * (RUN_X * DX / UX);
  float acc[RUN_Y][RUN_X];
#pragma unroll
  for (int jy = 0; jy < RUN_Y; ++jy)
#pragma unroll
    for (int jx = 0; jx < RUN_X; ++jx) acc[jy][jx] = 0.f;
  T* out = y + (plane * pl.out_h + oy) * (int64_t)pl.out_w + ox;

  if constexpr (!ODD_W) {
    // Even rows: ox is even, so is every row's offset, and (ox, ox + 1) is
    // a pair inside the row.
    accumulate<T, FY, FX, UY, DY, RY, UX, DX, RX>(acc, s, k, pl);
#pragma unroll
    for (int jy = 0; jy < RUN_Y; ++jy) {
      if (oy + jy >= pl.out_h) break;
      store_pair(out + (int64_t)jy * pl.out_w, acc[jy][0], acc[jy][1]);
    }
  } else {
    // Odd rows. A thread past the output skips the sums and stores nothing
    // but stays for the shuffle, in which every lane of its warp takes part:
    // the next lane's first column of each run row, for the pairs that
    // straddle two runs.
    if (valid) accumulate<T, FY, FX, UY, DY, RY, UX, DX, RX>(acc, s, k, pl);
    const int lane = threadIdx.x & 31;
    const int in_warp = min(32, (int)blockDim.x - (int)(threadIdx.x & ~31u));
    const unsigned mask = in_warp == 32 ? 0xffffffffu : (1u << in_warp) - 1u;
    float next[RUN_Y];
#pragma unroll
    for (int jy = 0; jy < RUN_Y; ++jy) next[jy] = __shfl_down_sync(mask, acc[jy][0], 1);
    if (!valid) return;
    // A row starts on an odd offset where its index is odd. There column
    // ox - 1 (the previous lane's) pairs with ox, and ox + 1 with ox + 2 (the
    // next lane's), where that lane holds the same row's next run; a column
    // goes alone at a tile's or a warp's edge and at the row's end.
    const bool second = ox + 1 < pl.out_w;
    const bool left_pairs = cx > 0 && lane > 0;
    const bool right_pairs = cx + 1 < pl.nx && lane < 31 && ox + 2 < pl.out_w;
    const int odd0 = (int)((plane * pl.out_h + oy) & 1);
#pragma unroll
    for (int jy = 0; jy < RUN_Y; ++jy) {
      if (oy + jy >= pl.out_h) break;
      T* o = out + (int64_t)jy * pl.out_w;
      if (((jy & 1) ^ odd0) == 0) {
        if (second) {
          store_pair(o, acc[jy][0], acc[jy][1]);
        } else {
          o[0] = from_f32<T>(acc[jy][0]);
        }
      } else {
        if (!left_pairs) o[0] = from_f32<T>(acc[jy][0]);
        if (right_pairs) {
          store_pair(o + 1, acc[jy][1], next[jy]);
        } else if (second) {
          o[1] = from_f32<T>(acc[jy][1]);
        }
      }
    }
  }
}

template <typename T, int FY, int FX, int UY, int DY, int RY, int UX, int DX, int RX>
cudaError_t launch_variant(const void* x, void* y, const Taps& k, const Plan& pl,
                           cudaStream_t stream) {
  auto kernel = (pl.out_w & 1) ? upfirdn2d_kernel<T, true, FY, FX, UY, DY, RY, UX, DX, RX>
                               : upfirdn2d_kernel<T, false, FY, FX, UY, DY, RY, UX, DX, RX>;
  if (pl.stage_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, pl.stage_bytes);
    if (err != cudaSuccess) return err;
  }
  kernel<<<(unsigned)pl.tiles, pl.threads, pl.stage_bytes, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), k, pl);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int variant, const void* x, void* y, const Taps& k, const Plan& pl,
                     cudaStream_t stream) {
  int i = 0;
#define K2_CASE(...) \
  if (variant == i++) return launch_variant<T, __VA_ARGS__>(x, y, k, pl, stream);
  K2_VARIANTS(K2_CASE)
#undef K2_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. taps: 16 host floats, [FY][FX] of the
// variant, the filter already flipped, gained and rounded to dtype. plan:
// the int64 plan of ops/upfirdn2d_kernel.py:k2_plan for x [planes, src_h,
// src_w], contiguous; y is [planes, out_h, out_w].
extern "C" int upfirdn2d(const void* x, void* y, const float* taps, int dtype, int variant,
                         const int64_t* plan, void* stream) {
  if (plan[kVariant] != variant || plan[kThreads] < 1 || plan[kThreads] > K2_MAX_THREADS ||
      plan[kThreads] != plan[kPlanesPerTile] * plan[kNX] * plan[kNY] || plan[kTiles] < 1 ||
      plan[kTiles] >= (int64_t)1 << 31)
    return (int)cudaErrorInvalidValue;
  Taps k;
  for (int i = 0; i < 16; ++i) k.v[i] = taps[i];
  const Plan pl = read_plan(plan);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch<float>(variant, x, y, k, pl, s);
  if (dtype == 1) return (int)dispatch<__nv_bfloat16>(variant, x, y, k, pl, s);
  return (int)cudaErrorInvalidValue;
}
