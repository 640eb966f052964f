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
// dtype as the plain version's conv takes it, the sum is float32 and the
// result is rounded once to the input's dtype (float32, or bfloat16 to
// nearest even). A negative pad crops. Every output sums its taps in one
// fixed order, whatever the tile: the kernel is deterministic.
//
// Bound: HBM. A pass reads its input and writes its output once and does at
// most 16 multiply-adds an output (4 at up 2): the work is to move each byte
// once, which at D's 4x4 pre-filter (bf16, up 1) is about 4 bytes an output,
// 0.84 T outputs/s at 3.35 TB/s. So the design counts instructions an
// output as well as bytes. Two kernels, one launch a pass:
//
// The 2-D pass (a filter of at most 4x4, K2_VARIANTS_2D: every 2-D filter of
// the main path, D's pre-filter and G's up-convs and image skips, and their
// adjoints). Its plan is ops/upfirdn2d_kernel.py:k2_plan_2d, which the CPU
// tests check for coverage, ring slots and window bounds by emulating it.
// - Persistent blocks, a few an SM, walk the tiles t = blockIdx.x + k grid.
//   Each keeps a ring of STAGES windows in shared memory, filled by cp.async
//   commit groups: tile k + 1's and k + 2's copies are in flight while tile
//   k sums. One barrier a tile: the slot that tile k + STAGES - 1 fills is
//   the one tile k - 1 read.
// - Planes stacked: the output is a tall image of planes x vh "virtual"
//   rows, vh >= out_h, and the input a tall image of planes x sr rows that
//   starts each plane q rows above its row 0 (zero rows pad it). vh and sr
//   are chosen so that the zero rows one plane reads below itself are the
//   zero rows the next plane has above it. A tile is any band of tile_h
//   virtual rows (several small planes, or a part of a large one) by
//   tile_w columns; no run is wasted on a plane's ragged last rows but the
//   vh - out_h rows a plane has beyond its outputs (at most a few).
// - Runs: a thread computes 8 x 4 outputs (4 x 2 at down 2, whose windows
//   are twice as tall and wide an output); the tile's runs are dealt to the
//   threads in row-major order, so the lanes of a warp hold consecutive runs
//   of a row and a tile only wastes a warp's tail. Small calls take shorter
//   tiles, so that every SM gets some.
// - Rows, then columns: where x is bf16 and the filter is exactly the outer
//   product of two factors (fy, fx), in float32, after rounding to bf16
//   (the main path's [1, 3, 3, 1] always is), a thread sums each window row
//   across its columns (fx), then those row sums down its rows (fy): 9.5
//   multiply-adds an output at up 1 instead of 16, 3.25 at up 2 instead of
//   4, 14 at down 2 instead of 16. bf16 samples times such taps sum
//   without rounding in float32 unless their magnitudes are far apart, so
//   the result is the 2-D sum's. Float32 inputs, and every other filter,
//   sum in 2-D, tap rows then tap columns (the plain version's order: the
//   export's ATen route then equals the direct forward to the bit), with
//   no guards for exactly 4x4 taps, else guarded by the filter's size.
// - Polyphase: which taps land on source samples depends on the output's
//   position in its run and on the leading pad mod up (the phase), both
//   compile-time, so the loops unroll to the real multiply-adds.
// - Reads: bf16 window rows are read as 32-bit words, two samples a load,
//   realigned by one byte permute where a thread's first sample is odd, and
//   widened by a shift; float32 rows a sample a load.
// - Copies: 16-byte cp.async chunks, zero-filled outside the plane (a
//   copy's source size). Where a row's length is not whole chunks (D's
//   adjoint reads bf16 rows of r + 1, G's up-conv adjoint rows of r + 2),
//   each window row starts its copies on the 16 bytes at or before its
//   first column, e (its shift, linear in the row) samples to the left; the
//   chunk that straddles the row's left edge is loaded into registers,
//   masked to the row, and written to its slot after the tile's sums
//   (never cp.async, which would bring the previous row's last samples). A
//   thread keeps one chunk column and walks the rows, so a row's plane and
//   address are worked out once for its chunks.
// - Stores: two outputs at an even element offset a store (4 bytes in
//   bf16, 8 in float32). Where the rows are odd in length (ODD_W), every
//   other row starts on an odd offset: there a run's columns (1, 2), ...
//   pair, its last pairs with the next lane's column 0 (a warp shuffle), and
//   a column goes alone only at a tile's or a warp's edge and at the row's
//   end.
// - Launch: the dynamic shared memory attribute is set once an instantiation
//   and device.
//
// The separable 1-D pass (a row [1, 16] or a column [16, 1] of at most 16
// taps, K2_VARIANTS_1D: the augment's 12-tap 2x up and down, two passes
// each) keeps the first design. Its plan is ops/upfirdn2d_kernel.py:k2_plan.
// - A block takes a tile of outputs (one plane, or several small planes
//   packed) and copies the tile's window into shared memory with cp.async in
//   16-, 8- or 4-byte chunks where the source rows are whole chunks, else
//   element by element, then computes: a thread takes a run of 4 rows x 2
//   columns, reads each window row its run needs once into registers and
//   feeds every output and tap of the run from them. Stores as above.
//
// Templates per filter class, per axis up and down ((1,1), (2,1), (1,2)) and
// phase: K2_VARIANTS_2D then K2_VARIANTS_1D, which the wrapper's VARIANTS
// lists in the same order.
//
// The C entry point launches on the given stream, does not synchronise,
// allocates nothing and returns the CUDA error of the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <stdint.h>

#define K2_MAX_THREADS 256
#define K2_MAX_DYNAMIC_SMEM (227 * 1024)

// (filter rows, filter columns) held, then (up, down, phase) for y and x.
#define K2_VARIANTS_2D(X)                                                                     \
  X(4, 4, 1, 1, 0, 1, 1, 0) X(4, 4, 2, 1, 0, 2, 1, 0) X(4, 4, 2, 1, 1, 2, 1, 1)               \
  X(4, 4, 1, 2, 0, 1, 2, 0)
#define K2_VARIANTS_1D(X)                                                                     \
  X(1, 16, 1, 1, 0, 1, 1, 0) X(1, 16, 1, 1, 0, 2, 1, 0) X(1, 16, 1, 1, 0, 2, 1, 1)            \
  X(1, 16, 1, 1, 0, 1, 2, 0)                                                                  \
  X(16, 1, 1, 1, 0, 1, 1, 0) X(16, 1, 2, 1, 0, 1, 1, 0) X(16, 1, 2, 1, 1, 1, 1, 0)            \
  X(16, 1, 1, 2, 0, 1, 1, 0)

namespace {

// ------------------------------------------------------------------- shared

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

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// cudaFuncSetAttribute once for each kernel K and device, so that a launch
// may take up to K2_MAX_DYNAMIC_SMEM of dynamic shared memory.
template <auto K>
cudaError_t allow_dynamic_smem() {
  static std::atomic<unsigned long long> done{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(K, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             K2_MAX_DYNAMIC_SMEM);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

// --------------------------------------------------------------- the 2-D pass

namespace k2d {

// A run, the outputs a thread computes: 8 rows x 4 columns, or 4 x 2 at
// down 2 (whose windows are twice as tall and wide an output).
template <int D> constexpr int RUN_Y = D == 2 ? 4 : 8;
template <int D> constexpr int RUN_X = D == 2 ? 2 : 4;
constexpr int THREADS = 256;
constexpr int STAGES = 3;    // windows in a block's ring
constexpr int MIN_BLOCKS = 3;

// How a run sums its taps (the plan's mode): the 2-D sum guarded by the
// filter's size (smaller than 4x4), the 2-D sum of exactly 4x4 taps, or
// rows then columns (exactly 4x4 taps, the outer product of fy and fx).
enum SumMode { kGuarded = 0, kFull = 1, kRowsThenColumns = 2 };

struct Taps {
  float k[16];         // [4][4] row-major, zero beyond fh x fw
  float fy[4], fx[4];  // k = fy (x) fx exactly, where the plan's mode is kRowsThenColumns
};

// n / d for 0 <= n < 2^30: (n m) >> s (the plan computes m and s).
struct FastDiv {
  unsigned m;
  int s;
  __device__ __forceinline__ int operator()(int n) const {
    return (int)(((unsigned long long)(unsigned)n * m) >> s);
  }
};

// The plan, in the field order of ops/upfirdn2d_kernel.py:K2Plan2D.
enum Plan2DField {
  kVariant, kPlanes, kSrcH, kSrcW, kOutH, kOutW, kFH, kFW, kMode, kVH, kSR, kQ, kTileH,
  kTileW, kRunsX, kTilesW, kTiles, kGrid, kStepX, kBaseX, kLeadX, kWinH, kPitch, kChunk, kCpr,
  kEB, kWM, kPM, kSlotElems, kStageBytes, kRunsXM, kRunsXS, kVHM, kVHS, kSRM, kSRS, kCprM, kCprS,
  kTilesWM, kTilesWS, kNumPlan2DFields
};

struct Plan {
  int planes, src_h, src_w, out_h, out_w, fh, fw, mode, vh, sr, q, tile_h, tile_w, runs_x,
      tiles_w, tiles, grid, step_x, base_x, lead_x, win_h, pitch, chunk, cpr, eb, wm, pm,
      slot_elems, stage_bytes;
  FastDiv by_runs_x, by_vh, by_sr, by_cpr, by_tiles_w;
};

Plan read_plan(const int64_t* a) {
  Plan p;
  p.planes = (int)a[kPlanes];
  p.src_h = (int)a[kSrcH];
  p.src_w = (int)a[kSrcW];
  p.out_h = (int)a[kOutH];
  p.out_w = (int)a[kOutW];
  p.fh = (int)a[kFH];
  p.fw = (int)a[kFW];
  p.mode = (int)a[kMode];
  p.vh = (int)a[kVH];
  p.sr = (int)a[kSR];
  p.q = (int)a[kQ];
  p.tile_h = (int)a[kTileH];
  p.tile_w = (int)a[kTileW];
  p.runs_x = (int)a[kRunsX];
  p.tiles_w = (int)a[kTilesW];
  p.tiles = (int)a[kTiles];
  p.grid = (int)a[kGrid];
  p.step_x = (int)a[kStepX];
  p.base_x = (int)a[kBaseX];
  p.lead_x = (int)a[kLeadX];
  p.win_h = (int)a[kWinH];
  p.pitch = (int)a[kPitch];
  p.chunk = (int)a[kChunk];
  p.cpr = (int)a[kCpr];
  p.eb = (int)a[kEB];
  p.wm = (int)a[kWM];
  p.pm = (int)a[kPM];
  p.slot_elems = (int)a[kSlotElems];
  p.stage_bytes = (int)a[kStageBytes];
  p.by_runs_x = FastDiv{(unsigned)a[kRunsXM], (int)a[kRunsXS]};
  p.by_vh = FastDiv{(unsigned)a[kVHM], (int)a[kVHS]};
  p.by_sr = FastDiv{(unsigned)a[kSRM], (int)a[kSRS]};
  p.by_cpr = FastDiv{(unsigned)a[kCprM], (int)a[kCprS]};
  p.by_tiles_w = FastDiv{(unsigned)a[kTilesWM], (int)a[kTilesWS]};
  return p;
}

// The shift of tall source row ts of `plane`: the samples its window row
// holds left of column base_x, so that its copies start on 16 bytes. For
// rows whose length is whole 16-byte chunks, 0.
template <typename T>
__device__ __forceinline__ int row_shift(const Plan& pl, int ts, int plane) {
  constexpr unsigned CH = 16 / sizeof(T);
  const unsigned e = (unsigned)pl.eb + (unsigned)pl.wm * (unsigned)ts -
                     (unsigned)pl.pm * (unsigned)plane;
  return (int)(e & (CH - 1));
}

// The 16-byte chunk of a window row that holds column 0 and e > 0 samples
// left of it (the previous row's last): loaded into registers when its
// tile's copies are issued, masked to the row, and written to its slot
// after the tile's sums (see the note at the top).
struct Straddle {
  uint4 bits;
  unsigned addr = 0;
  bool pending = false;
  __device__ __forceinline__ void flush(unsigned char* smem) {
    if (pending) *reinterpret_cast<uint4*>(smem + addr) = bits;
    pending = false;
  }
};

// Zero the bytes of a 16-byte chunk outside [lo, hi).
__device__ __forceinline__ uint4 keep_bytes(uint4 v, int lo, int hi) {
  unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int a = min(max(lo - 4 * i, 0), 4), b = min(max(hi - 4 * i, 0), 4);  // kept: [a, b)
    const unsigned above = a >= 4 ? 0u : 0xffffffffu << (8 * a);
    const unsigned below = b >= 4 ? 0xffffffffu : (1u << (8 * b)) - 1u;
    w[i] &= above & below;
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// The window rows and chunk columns a thread copies: rows j0, j0 + dj, ...
// and, in each, columns c0, c0 + dc, ... (THREADS / cpr rows at a time when
// a row has at most THREADS chunks; else every row, THREADS chunks at a time).
struct CopyShare {
  int j0, dj, c0, dc;
  __device__ __forceinline__ CopyShare(const Plan& pl) {
    if (pl.cpr <= THREADS) {
      j0 = pl.by_cpr((int)threadIdx.x), c0 = (int)threadIdx.x - j0 * pl.cpr;
      dj = THREADS / pl.cpr, dc = pl.cpr;
      if (j0 >= dj) j0 = pl.win_h;  // past the last whole pass: no rows
    } else {
      j0 = 0, dj = 1, c0 = (int)threadIdx.x, dc = THREADS;
    }
  }
};

// Issue the copies of tile t's window into slot, 16 bytes a chunk, zero
// outside the planes. Window row j is tall source row ts = w0 + j: plane
// ts / sr, row ts % sr - q; its element c is source column col0 - e + c, e
// its shift.
template <typename T, int UY, int DY>
__device__ __forceinline__ void issue_tile(T* slot, const T* __restrict__ x, const Plan& pl,
                                           const CopyShare& cs, int t, Straddle& st,
                                           unsigned char* smem) {
  constexpr int CH = 16 / (int)sizeof(T);
  const int rt = pl.by_tiles_w(t), ct = t - rt * pl.tiles_w;
  const int w0 = rt * pl.tile_h * DY / UY;
  const int col0 = pl.base_x + ct * pl.step_x;
  for (int j = cs.j0; j < pl.win_h; j += cs.dj) {
    const int ts = w0 + j, plane = pl.by_sr(ts), row = ts - plane * pl.sr - pl.q;
    const bool row_in = plane < pl.planes && row >= 0 && row < pl.src_h;
    const int first = col0 - row_shift<T>(pl, ts, plane);  // the row's element 0
    const T* g = x + ((int64_t)plane * pl.src_h + row) * pl.src_w;
    T* d = slot + j * pl.pitch;
    for (int c = cs.c0; c < pl.cpr; c += cs.dc) {
      const int col = first + c * CH;
      if (row_in && col < 0 && col + CH > 0) continue;  // the straddle, below
      const int n_in = row_in && col >= 0 ? min(pl.src_w - col, CH) : 0;
      cp_async<16>(d + c * CH, n_in > 0 ? g + col : x, n_in > 0 ? n_in * (int)sizeof(T) : 0);
    }
  }
  const int j = threadIdx.x, ts = w0 + j, plane = pl.by_sr(ts);
  const int row = ts - plane * pl.sr - pl.q, e = row_shift<T>(pl, ts, plane);
  if (j < pl.win_h && plane < pl.planes && row >= 0 && row < pl.src_h && e > 0 && col0 <= 0 &&
      -col0 < pl.pitch) {
    const T* g = x + ((int64_t)plane * pl.src_h + row) * pl.src_w - e;  // on 16 bytes
    st.bits = keep_bytes(__ldg(reinterpret_cast<const uint4*>(g)), e * (int)sizeof(T),
                         (e + pl.src_w) * (int)sizeof(T));
    st.addr = (unsigned)((slot + j * pl.pitch - col0) - reinterpret_cast<T*>(smem)) *
              (unsigned)sizeof(T);
    st.pending = true;
  }
}

// SEGX window samples of a row from element c on, as float32.
template <int SEGX>
__device__ __forceinline__ void load_row(float (&v)[SEGX], const float* row, int c) {
#pragma unroll
  for (int i = 0; i < SEGX; ++i) v[i] = row[c + i];
}
template <int SEGX>
__device__ __forceinline__ void load_row(float (&v)[SEGX], const __nv_bfloat16* row, int c) {
  constexpr int NW = SEGX / 2 + 1;
  const unsigned* w = reinterpret_cast<const unsigned*>(row) + (c >> 1);
  const unsigned sel = (c & 1) ? 0x5432u : 0x3210u;
  unsigned word[NW];
#pragma unroll
  for (int i = 0; i < NW; ++i) word[i] = w[i];
#pragma unroll
  for (int i = 0; 2 * i < SEGX; ++i) {
    const unsigned p = __byte_perm(word[i], i + 1 < NW ? word[i + 1] : 0u, sel);
    v[2 * i] = __uint_as_float(p << 16);
    if (2 * i + 1 < SEGX) v[2 * i + 1] = __uint_as_float(p & 0xffff0000u);
  }
}

// The run's sums from its first window row s on, the thread's first sample
// at element c0 plus the row's shift (e0 + sy wm, mod the chunk). Window row
// sy feeds tap row sy UY - jy DY + PY of run row jy, sample sx tap column sx
// UX - jx DX + PX of run column jx, where those lie in [0, 4).
template <typename T, int MODE, int UY, int DY, int PY, int UX, int DX, int PX>
__device__ __forceinline__ void sums(float (&acc)[RUN_Y<DY>][RUN_X<DX>], const T* s, int c0,
                                     int e0, const Taps& k, const Plan& pl) {
  constexpr int RY = RUN_Y<DY>, RX = RUN_X<DX>;
  constexpr int SEGY = ((RY - 1) * DY + 3 - PY) / UY + 1;
  constexpr int SEGX = ((RX - 1) * DX + 3 - PX) / UX + 1;
  constexpr int CH = 16 / (int)sizeof(T);
#pragma unroll
  for (int sy = 0; sy < SEGY; ++sy) {
    float v[SEGX];
    load_row<SEGX>(v, s + sy * pl.pitch, c0 + ((e0 + sy * pl.wm) & (CH - 1)));
    if constexpr (MODE == kRowsThenColumns) {
      float h[RX];
#pragma unroll
      for (int jx = 0; jx < RX; ++jx) {
        h[jx] = 0.f;
#pragma unroll
        for (int sx = 0; sx < SEGX; ++sx) {
          const int tx = sx * UX - jx * DX + PX;
          if (tx >= 0 && tx < 4) h[jx] = fmaf(k.fx[tx], v[sx], h[jx]);
        }
      }
#pragma unroll
      for (int jy = 0; jy < RY; ++jy) {
        const int ty = sy * UY - jy * DY + PY;
        if (ty < 0 || ty >= 4) continue;
#pragma unroll
        for (int jx = 0; jx < RX; ++jx) acc[jy][jx] = fmaf(k.fy[ty], h[jx], acc[jy][jx]);
      }
    } else {
#pragma unroll
      for (int jy = 0; jy < RY; ++jy) {
        const int ty = sy * UY - jy * DY + PY;
        if (ty < 0 || ty >= 4 || (MODE == kGuarded && ty >= pl.fh)) continue;
#pragma unroll
        for (int jx = 0; jx < RX; ++jx) {
#pragma unroll
          for (int sx = 0; sx < SEGX; ++sx) {
            const int tx = sx * UX - jx * DX + PX;
            if (tx < 0 || tx >= 4 || (MODE == kGuarded && tx >= pl.fw)) continue;
            acc[jy][jx] = fmaf(k.k[ty * 4 + tx], v[sx], acc[jy][jx]);
          }
        }
      }
    }
  }
}

// Where the rows are odd in length: the stores of one run row from o on, nv
// of its RX columns inside the row, two outputs at an even element offset a
// store. Where the row starts on an odd offset (odd_row), its column 0 pairs
// with the left lane's last (which stores them, where `left`), columns (1,
// 2), ... pair, and its last column pairs with the right lane's column 0
// (next, where `right`); a column goes alone at a tile's or a warp's edge
// and at the row's end.
template <typename T, int RX>
__device__ __forceinline__ void store_odd_w(T* o, const float (&a)[RX], float next, int nv,
                                            bool odd_row, bool left, bool right) {
  if (!odd_row) {
#pragma unroll
    for (int i = 0; i < RX; i += 2) {
      if (nv >= i + 2) store_pair(o + i, a[i], a[i + 1]);
      else if (nv == i + 1) o[i] = from_f32<T>(a[i]);
    }
    return;
  }
  if (!left) o[0] = from_f32<T>(a[0]);
#pragma unroll
  for (int i = 1; i < RX - 1; i += 2) {
    if (nv >= i + 2) store_pair(o + i, a[i], a[i + 1]);
    else if (nv == i + 1) o[i] = from_f32<T>(a[i]);
  }
  if (right) store_pair(o + RX - 1, a[RX - 1], next);
  else if (nv == RX) o[RX - 1] = from_f32<T>(a[RX - 1]);
}

// Tile t's outputs from its window in slot.
template <typename T, bool ODD_W, int MODE, int UY, int DY, int PY, int UX, int DX, int PX>
__device__ __forceinline__ void compute_tile(const T* slot, T* __restrict__ y, const Taps& k,
                                             const Plan& pl, int t) {
  constexpr int RY = RUN_Y<DY>, RX = RUN_X<DX>;
  const int rt = pl.by_tiles_w(t), ct = t - rt * pl.tiles_w;
  const int v0 = rt * pl.tile_h, w0 = v0 * DY / UY, ox0 = ct * pl.tile_w;
  // the tile's plane, where a row's shift depends on it (its tiles then lie
  // in one plane, and the other planes' rows it reads are zero)
  const int tplane = pl.pm ? pl.by_sr(w0) : 0;
  const int items = (pl.tile_h / RY) * pl.runs_x;
  const int lane = threadIdx.x & 31;
  for (int base = 0; base < items; base += THREADS) {
    if (base + (int)(threadIdx.x & ~31u) >= items) break;  // the whole warp is past the tile
    const int it = base + threadIdx.x;
    const bool active = it < items;
    const int ry = pl.by_runs_x(it), cx = it - ry * pl.runs_x;
    const int wr = ry * (RY * DY / UY);
    float acc[RY][RX];
#pragma unroll
    for (int jy = 0; jy < RY; ++jy)
#pragma unroll
      for (int jx = 0; jx < RX; ++jx) acc[jy][jx] = 0.f;
    if (active)
      sums<T, MODE, UY, DY, PY, UX, DX, PX>(acc, slot + wr * pl.pitch,
                                             pl.lead_x + cx * (RX * DX / UX),
                                             row_shift<T>(pl, w0 + wr, tplane), k, pl);
    const int vrow = v0 + ry * RY, ox = ox0 + cx * RX;
    int p = pl.by_vh(vrow), oy = vrow - p * pl.vh;
    if constexpr (!ODD_W) {
      // Even rows: every row starts on an even offset, and so does ox.
      if (!active || ox >= pl.out_w) continue;
#pragma unroll
      for (int jy = 0; jy < RY; ++jy) {
        if (p < pl.planes && oy < pl.out_h) {
          T* o = y + ((int64_t)p * pl.out_h + oy) * pl.out_w + ox;
#pragma unroll
          for (int i = 0; i < RX; i += 2)
            if (i == 0 || ox + i < pl.out_w) store_pair(o + i, acc[jy][i], acc[jy][i + 1]);
        }
        if (++oy == pl.vh) oy = 0, ++p;
      }
    } else {
      // Odd rows. Every lane of the warp takes part in the shuffle: the next
      // lane's column 0 of each run row, for the pairs across two runs.
      float next[RY];
#pragma unroll
      for (int jy = 0; jy < RY; ++jy) next[jy] = __shfl_down_sync(0xffffffffu, acc[jy][0], 1);
      if (!active || ox >= pl.out_w) continue;
      const int nv = min(RX, pl.out_w - ox);
      const bool left = lane > 0 && cx > 0;
      const bool right = lane < 31 && cx + 1 < pl.runs_x && ox + RX < pl.out_w;
#pragma unroll
      for (int jy = 0; jy < RY; ++jy) {
        if (p < pl.planes && oy < pl.out_h) {
          const int64_t r = (int64_t)p * pl.out_h + oy;
          store_odd_w<T, RX>(y + r * pl.out_w + ox, acc[jy], next[jy], nv, r & 1, left, right);
        }
        if (++oy == pl.vh) oy = 0, ++p;
      }
    }
  }
}

template <typename T, bool ODD_W, int MODE, int UY, int DY, int PY, int UX, int DX, int PX>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    upfirdn2d_2d_kernel(const T* __restrict__ x, T* __restrict__ y, const Taps k,
                        const Plan pl) {
  static_assert((RUN_Y<DY> * DY) % UY == 0 && (RUN_X<DX> * DX) % UX == 0,
                "runs start on a phase");
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);
  Straddle st;
  const CopyShare cs(pl);
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    const int t = blockIdx.x + s * pl.grid;
    if (t < pl.tiles) issue_tile<T, UY, DY>(ring + s * pl.slot_elems, x, pl, cs, t, st, smem);
    cp_async_commit();
    st.flush(smem);
  }
  int slot = 0;
  for (int t = blockIdx.x; t < pl.tiles; t += pl.grid) {
    cp_async_wait<STAGES - 2>();  // this thread's copies of tile t have landed
    __syncthreads();              // everyone's have, and tile t - grid's sums are done
    const int nt = t + (STAGES - 1) * pl.grid;
    const int ns = slot == 0 ? STAGES - 1 : slot - 1;
    if (nt < pl.tiles) issue_tile<T, UY, DY>(ring + ns * pl.slot_elems, x, pl, cs, nt, st, smem);
    cp_async_commit();
    compute_tile<T, ODD_W, MODE, UY, DY, PY, UX, DX, PX>(ring + slot * pl.slot_elems, y, k, pl,
                                                          t);
    st.flush(smem);
    slot = slot + 1 == STAGES ? 0 : slot + 1;
  }
  cp_async_wait<0>();
}

template <typename T, bool ODD_W, int MODE, int UY, int DY, int PY, int UX, int DX, int PX>
cudaError_t launch_one(const void* x, void* y, const Taps& k, const Plan& pl,
                       cudaStream_t stream) {
  constexpr auto kernel = upfirdn2d_2d_kernel<T, ODD_W, MODE, UY, DY, PY, UX, DX, PX>;
  const cudaError_t err = allow_dynamic_smem<kernel>();
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)pl.grid, THREADS, pl.stage_bytes, stream>>>(static_cast<const T*>(x),
                                                                 static_cast<T*>(y), k, pl);
  return cudaGetLastError();
}

template <typename T, int FY, int FX, int UY, int DY, int PY, int UX, int DX, int PX>
cudaError_t launch_variant(const void* x, void* y, const Taps& k, const Plan& pl,
                           cudaStream_t stream) {
  static_assert(FY == 4 && FX == 4, "the 2-D pass holds a 4x4 filter");
  if (pl.tile_h % RUN_Y<DY> != 0 || pl.tile_w != pl.runs_x * RUN_X<DX>)
    return cudaErrorInvalidValue;
  const bool odd = pl.out_w & 1;
  switch (pl.mode) {
    case kGuarded:
      return odd ? launch_one<T, true, kGuarded, UY, DY, PY, UX, DX, PX>(x, y, k, pl, stream)
                 : launch_one<T, false, kGuarded, UY, DY, PY, UX, DX, PX>(x, y, k, pl, stream);
    case kFull:
      return odd ? launch_one<T, true, kFull, UY, DY, PY, UX, DX, PX>(x, y, k, pl, stream)
                 : launch_one<T, false, kFull, UY, DY, PY, UX, DX, PX>(x, y, k, pl, stream);
    case kRowsThenColumns:
      return odd ? launch_one<T, true, kRowsThenColumns, UY, DY, PY, UX, DX, PX>(x, y, k, pl,
                                                                             stream)
                 : launch_one<T, false, kRowsThenColumns, UY, DY, PY, UX, DX, PX>(x, y, k, pl,
                                                                              stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch(int variant, const void* x, void* y, const Taps& k, const Plan& pl,
                     cudaStream_t stream) {
  int i = 0;
#define K2_CASE(...) \
  if (variant == i++) return launch_variant<T, __VA_ARGS__>(x, y, k, pl, stream);
  K2_VARIANTS_2D(K2_CASE)
#undef K2_CASE
  return cudaErrorInvalidValue;
}

constexpr int kNumVariants = 0
#define K2_COUNT(...) +1
    K2_VARIANTS_2D(K2_COUNT)
#undef K2_COUNT
    ;

}  // namespace k2d

// --------------------------------------------------------------- the 1-D pass

namespace k1d {

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
  cp_async_commit();
  cp_async_wait<0>();
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

template <typename T, bool ODD_W, int FY, int FX, int UY, int DY, int RY, int UX, int DX, int RX>
cudaError_t launch_one(const void* x, void* y, const Taps& k, const Plan& pl,
                       cudaStream_t stream) {
  constexpr auto kernel = upfirdn2d_kernel<T, ODD_W, FY, FX, UY, DY, RY, UX, DX, RX>;
  if (pl.stage_bytes > 48 * 1024) {
    const cudaError_t err = allow_dynamic_smem<kernel>();
    if (err != cudaSuccess) return err;
  }
  kernel<<<(unsigned)pl.tiles, pl.threads, pl.stage_bytes, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), k, pl);
  return cudaGetLastError();
}

template <typename T, int FY, int FX, int UY, int DY, int RY, int UX, int DX, int RX>
cudaError_t launch_variant(const void* x, void* y, const Taps& k, const Plan& pl,
                           cudaStream_t stream) {
  return (pl.out_w & 1) ? launch_one<T, true, FY, FX, UY, DY, RY, UX, DX, RX>(x, y, k, pl, stream)
                        : launch_one<T, false, FY, FX, UY, DY, RY, UX, DX, RX>(x, y, k, pl,
                                                                              stream);
}

template <typename T>
cudaError_t dispatch(int variant, const void* x, void* y, const Taps& k, const Plan& pl,
                     cudaStream_t stream) {
  int i = k2d::kNumVariants;
#define K2_CASE(...) \
  if (variant == i++) return launch_variant<T, __VA_ARGS__>(x, y, k, pl, stream);
  K2_VARIANTS_1D(K2_CASE)
#undef K2_CASE
  return cudaErrorInvalidValue;
}

}  // namespace k1d

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. variant: the index in K2_VARIANTS_2D
// then K2_VARIANTS_1D. taps: 24 host floats, the variant's [FY][FX] (16 at
// most; the filter already flipped, gained and rounded to dtype), then, for
// a 2-D pass, its factors fy[4] and fx[4]. plan: the int64 plan of
// ops/upfirdn2d_kernel.py:k2_plan_2d (a 2-D pass) or k2_plan (a 1-D one)
// for x [planes, src_h, src_w], contiguous; y is [planes, out_h, out_w].
extern "C" int upfirdn2d(const void* x, void* y, const float* taps, int dtype, int variant,
                         const int64_t* plan, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (variant >= 0 && variant < k2d::kNumVariants) {
    if (plan[k2d::kVariant] != variant || plan[k2d::kTiles] < 1 || plan[k2d::kGrid] < 1 ||
        plan[k2d::kGrid] > plan[k2d::kTiles] || plan[k2d::kTiles] >= (int64_t)1 << 31 ||
        plan[k2d::kStageBytes] > K2_MAX_DYNAMIC_SMEM || plan[k2d::kWinH] > k2d::THREADS ||
        plan[k2d::kChunk] * (dtype == 0 ? 4 : 2) != 16)
      return (int)cudaErrorInvalidValue;
    k2d::Taps k;
    for (int i = 0; i < 16; ++i) k.k[i] = taps[i];
    for (int i = 0; i < 4; ++i) k.fy[i] = taps[16 + i], k.fx[i] = taps[20 + i];
    const k2d::Plan pl = k2d::read_plan(plan);
    if (dtype == 0) return (int)k2d::dispatch<float>(variant, x, y, k, pl, s);
    if (dtype == 1) return (int)k2d::dispatch<__nv_bfloat16>(variant, x, y, k, pl, s);
    return (int)cudaErrorInvalidValue;
  }
  if (plan[k1d::kVariant] != variant || plan[k1d::kThreads] < 1 ||
      plan[k1d::kThreads] > K2_MAX_THREADS ||
      plan[k1d::kThreads] != plan[k1d::kPlanesPerTile] * plan[k1d::kNX] * plan[k1d::kNY] ||
      plan[k1d::kTiles] < 1 || plan[k1d::kTiles] >= (int64_t)1 << 31)
    return (int)cudaErrorInvalidValue;
  k1d::Taps k;
  for (int i = 0; i < 16; ++i) k.v[i] = taps[i];
  const k1d::Plan pl = k1d::read_plan(plan);
  if (dtype == 0) return (int)k1d::dispatch<float>(variant, x, y, k, pl, s);
  if (dtype == 1) return (int)k1d::dispatch<__nv_bfloat16>(variant, x, y, k, pl, s);
  return (int)cudaErrorInvalidValue;
}
