// The general FIR resampler upfirdn2d (K2), one launch a call, NCHW, for
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
// Bound: HBM. A call reads its input and writes its output once and does at
// most 16 multiply-adds an output a pass (4 at up 2): the work is to move
// each byte once, which at D's 4x4 pre-filter (bf16, up 1) is about 4 bytes
// an output, 0.84 T outputs/s at 3.35 TB/s. So the design counts
// instructions an output as well as bytes. Two kernels, one launch a call:
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
// The separable pass (K2_VARIANTS_SEP: the augment's 12-tap 2x up and 2x
// down around the warp and their adjoints, and any separable filter, or a
// lone row [1, fw] or column [fh, 1], of at most 16 taps): both of the plain
// version's passes, rows then columns, in one launch. Its plan is
// ops/upfirdn2d_kernel.py:k2_plan_sep, which the CPU tests check for
// coverage, ring slots and window bounds and emulate to the bit.
// - Persistent blocks, a few an SM, walk the tiles t = blockIdx.x + k grid:
//   tile_h x tile_w outputs of one plane. Each keeps a ring of 2 windows,
//   filled by cp.async: tile k + 1's copies are in flight while tile k sums.
// - A tile: its window, the source rows its outputs read, goes through the
//   row pass into an intermediate tile in shared memory (win_h rows x tile_w
//   columns, each rounded to x's dtype, as the plain version's first conv
//   rounds it), then, after one barrier, through the column pass to its
//   outputs. The intermediate rows a tile shares with its neighbours above
//   and below are computed again by each (about 20 % more row-pass work at
//   up 2, 16 % at down 2).
// - Sums: each pass sums its taps in float32 in tap order, one fused
//   multiply-add a tap, as the plain version does: the kernel equals it to
//   the bit and is deterministic. The pipe's instantiations hold 12 taps,
//   their axes and phases at compile time, with no guards; the one other
//   (taps held as 16) guards them by the plan's counts and reads each
//   axis's up, down and phase from the plan: a run there is 8 columns and
//   its loops take the most samples any axis reads.
// - Row pass: a thread takes a run of 16 intermediate columns at up 2 (8
//   else) of one window row, reads its samples as 16-byte chunks and shifts
//   them into place by the row's offset in a chunk: selects and one byte
//   permute a word, or, where the offset's low two bits are the same for
//   every row (bf16 with exact taps and rows of whole 4-sample groups, as
//   the pipe's), a select a word for its high bit alone. At down 2 a warp's
//   lanes hold consecutive rows: the slot's pitch is an odd number of
//   chunks, so their loads fall in different banks (along a row they would
//   be 2 chunks apart), and 2 blocks an SM take taller tiles.
// - Column pass: a thread takes 4 output rows by one 16-byte chunk of
//   columns, reading one intermediate chunk a row; stores are 16 bytes where
//   the output rows are whole chunks, else pairs (even rows) or one by one.
// - Copies: 16-byte cp.async chunks, zero-filled outside the plane, with the
//   2-D pass's row shift for rows that are not whole chunks and the
//   straddling chunk through registers.
//
// Templates per filter class, per axis up and down ((1,1), (2,1), (1,2)) and
// phase (the guarded separable one: per filter class alone): K2_VARIANTS_2D
// then K2_VARIANTS_SEP, which the wrapper's VARIANTS lists in the same
// order.
//
// The C entry point launches on the given stream, does not synchronise,
// allocates nothing and returns the CUDA error of the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <stdint.h>

#define K2_MAX_DYNAMIC_SMEM (227 * 1024)

// (filter rows, filter columns) held, then (up, down, phase) for y and x.
#define K2_VARIANTS_2D(X)                                                                     \
  X(4, 4, 1, 1, 0, 1, 1, 0) X(4, 4, 2, 1, 0, 2, 1, 0) X(4, 4, 2, 1, 1, 2, 1, 1)               \
  X(4, 4, 1, 2, 0, 1, 2, 0)
// (column taps, row taps) held, then (up, down, phase) for y and x: the ADA
// pipe's 12-tap 2x up and 2x down (and their adjoints), exactly 12 taps and
// their axes at compile time; then every other separable filter, or a lone
// row or column with a one-tap other axis: at most 16 taps, guarded, and
// each axis's (up, down, phase) read from the plan (0 here).
#define K2_VARIANTS_SEP(X)                                                                    \
  X(12, 12, 2, 1, 0, 2, 1, 0) X(12, 12, 1, 2, 0, 1, 2, 0) X(16, 16, 0, 0, 0, 0, 0, 0)


namespace {

// ------------------------------------------------------------------- shared

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

// n / d for 0 <= n < 2^30: (n m) >> s (the plan computes m and s).
struct FastDiv {
  unsigned m;
  int s;
  __device__ __forceinline__ int operator()(int n) const {
    return (int)(((unsigned long long)(unsigned)n * m) >> s);
  }
};

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

// The window rows and chunk columns a thread of THREADS copies: rows j0,
// j0 + dj, ... and, in each, columns c0, c0 + dc, ... (THREADS / cpr rows at
// a time when a row has at most THREADS chunks; else every row, THREADS
// chunks at a time).
template <int THREADS>
struct CopyShare {
  int j0, dj, c0, dc;
  __device__ __forceinline__ CopyShare(int cpr, FastDiv by_cpr, int win_h) {
    if (cpr <= THREADS) {
      j0 = by_cpr((int)threadIdx.x), c0 = (int)threadIdx.x - j0 * cpr;
      dj = THREADS / cpr, dc = cpr;
      if (j0 >= dj) j0 = win_h;  // past the last whole pass: no rows
    } else {
      j0 = 0, dj = 1, c0 = (int)threadIdx.x, dc = THREADS;
    }
  }
};

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

// Issue the copies of tile t's window into slot, 16 bytes a chunk, zero
// outside the planes. Window row j is tall source row ts = w0 + j: plane
// ts / sr, row ts % sr - q; its element c is source column col0 - e + c, e
// its shift.
template <typename T, int UY, int DY>
__device__ __forceinline__ void issue_tile(T* slot, const T* __restrict__ x, const Plan& pl,
                                           const CopyShare<THREADS>& cs, int t, Straddle& st,
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
  const CopyShare<THREADS> cs(pl.cpr, pl.by_cpr, pl.win_h);
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

// ------------------------------------------------------- the separable pass

namespace ksep {

constexpr int THREADS = 256;
constexpr int RUN_C = 4;  // output rows of a column-pass run; its columns are one 16-byte chunk

// Blocks an SM: 2 at down 2 on x, whose row pass makes twice the outputs'
// intermediate (taller tiles share fewer window rows), and at the guarded
// instantiation's run-time axes; else 3.
template <int DX> constexpr int BLOCKS = DX == 1 ? 3 : 2;

// Intermediate columns of a row-pass run: 16 at up 2 (a chunk of bf16
// input), else 8. At down 2 a warp's lanes hold the runs of consecutive
// window rows (the slot's pitch is an odd number of chunks, so their
// 16-byte loads fall in different banks); else the consecutive runs of a row.
template <int UX> constexpr int RUN_R = UX == 2 ? 16 : 8;

// Held taps: 16 means at most 16, guarded by the plan's fh / fw, with the
// axes (template arguments 0) read from the plan; any other count is exact
// and unguarded, its axes compile-time.
constexpr int GUARDED_TAPS = 16;

// The samples a run of R outputs of F taps reads along an axis of (up,
// down, phase) (U, D, P); at run-time axes (U = 0), the most any takes.
template <int F, int R, int U, int D, int P>
constexpr int SEGMENT = U ? ((R - 1) * D + F - 1 - P) / U + 1 : (R - 1) * 2 + F;

struct Taps {
  float ky[16], kx[16];  // the column and the row filter, zero beyond fh / fw
};

// The plan, in the field order of ops/upfirdn2d_kernel.py:K2PlanSep.
enum PlanSepField {
  kVariant, kPlanes, kSrcH, kSrcW, kOutH, kOutW, kFH, kFW, kTileH, kTileW, kTilesH, kTilesW,
  kTiles, kGrid, kStepY, kStepX, kBaseY, kBaseX, kLeadX, kWinH, kPitch, kCpr, kEB, kWM,
  kMidPitch, kSlotElems, kSmemBytes, kRunsR, kRunsC, kRunsRM, kRunsRS, kRunsCM, kRunsCS, kWinHM,
  kWinHS, kCprM, kCprS, kUY, kDY, kPY, kUX, kDX, kPX, kNumPlanSepFields
};

struct Plan {
  int planes, src_h, src_w, out_h, out_w, fh, fw, tile_h, tile_w, tiles_h, tiles_w, tiles, grid,
      step_y, step_x, base_y, base_x, lead_x, win_h, pitch, cpr, eb, wm, mid_pitch, slot_elems,
      smem_bytes, runs_r, runs_c;
  FastDiv by_runs_r, by_runs_c, by_win_h, by_cpr;
  int uy, dy, py, ux, dx, px;  // the call's axes
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
  p.tile_h = (int)a[kTileH];
  p.tile_w = (int)a[kTileW];
  p.tiles_h = (int)a[kTilesH];
  p.tiles_w = (int)a[kTilesW];
  p.tiles = (int)a[kTiles];
  p.grid = (int)a[kGrid];
  p.step_y = (int)a[kStepY];
  p.step_x = (int)a[kStepX];
  p.base_y = (int)a[kBaseY];
  p.base_x = (int)a[kBaseX];
  p.lead_x = (int)a[kLeadX];
  p.win_h = (int)a[kWinH];
  p.pitch = (int)a[kPitch];
  p.cpr = (int)a[kCpr];
  p.eb = (int)a[kEB];
  p.wm = (int)a[kWM];
  p.mid_pitch = (int)a[kMidPitch];
  p.slot_elems = (int)a[kSlotElems];
  p.smem_bytes = (int)a[kSmemBytes];
  p.runs_r = (int)a[kRunsR];
  p.runs_c = (int)a[kRunsC];
  p.by_runs_r = FastDiv{(unsigned)a[kRunsRM], (int)a[kRunsRS]};
  p.by_runs_c = FastDiv{(unsigned)a[kRunsCM], (int)a[kRunsCS]};
  p.by_win_h = FastDiv{(unsigned)a[kWinHM], (int)a[kWinHS]};
  p.by_cpr = FastDiv{(unsigned)a[kCprM], (int)a[kCprS]};
  p.uy = (int)a[kUY];
  p.dy = (int)a[kDY];
  p.py = (int)a[kPY];
  p.ux = (int)a[kUX];
  p.dx = (int)a[kDX];
  p.px = (int)a[kPX];
  return p;
}

// An axis's (up, down, phase), valid for the separable pass.
__host__ __device__ inline bool axis_ok(int u, int d, int p) {
  return (u == 1 && d == 1 && p == 0) || (u == 2 && d == 1 && (p == 0 || p == 1)) ||
         (u == 1 && d == 2 && p == 0);
}

// The shift of source row `row` of `plane`: the samples its window row
// holds left of the tile's first column, so that its copies start on 16
// bytes (0 where every row is whole 16-byte chunks and x starts on 16).
template <typename T>
__device__ __forceinline__ int row_shift(const Plan& pl, int plane, int row) {
  constexpr unsigned CH = 16 / sizeof(T);
  return (int)(((unsigned)pl.eb + (unsigned)pl.wm * ((unsigned)plane * (unsigned)pl.src_h +
                                                     (unsigned)row)) & (CH - 1));
}

// Tile t: plane, the window's first source row and the source column of
// its element e (e a row's shift), its first output row and column.
struct Tile {
  int plane, row0, col0, oy0, ox0;
  __device__ __forceinline__ Tile(const Plan& pl, int t) {
    const int r = t / pl.tiles_w, tw = t - r * pl.tiles_w;
    const int th = r % pl.tiles_h;
    plane = r / pl.tiles_h;
    row0 = pl.base_y + th * pl.step_y, col0 = pl.base_x + tw * pl.step_x;
    oy0 = th * pl.tile_h, ox0 = tw * pl.tile_w;
  }
};

// Issue the copies of tile tl's window into slot: win_h rows of cpr chunks
// (`pitch` elements apart), element c of row j source column col0 - e + c of
// row row0 + j (zero outside the plane), 16 bytes a chunk; the chunk that
// straddles the row's left edge goes through registers (Straddle).
template <typename T>
__device__ __forceinline__ void issue_tile(T* slot, const T* __restrict__ x, const Plan& pl,
                                           const CopyShare<THREADS>& cs, const Tile& tl, Straddle& st,
                                           unsigned char* smem) {
  constexpr int CH = 16 / (int)sizeof(T);
  for (int j = cs.j0; j < pl.win_h; j += cs.dj) {
    const int row = tl.row0 + j;
    const bool row_in = row >= 0 && row < pl.src_h;
    const int first = tl.col0 - row_shift<T>(pl, tl.plane, row);  // the row's element 0
    const T* g = x + ((int64_t)tl.plane * pl.src_h + row) * pl.src_w;
    T* d = slot + j * pl.pitch;
    for (int c = cs.c0; c < pl.cpr; c += cs.dc) {
      const int col = first + c * CH;
      if (row_in && col < 0 && col + CH > 0) continue;  // the straddle, below
      const int n_in = row_in && col >= 0 ? min(pl.src_w - col, CH) : 0;
      cp_async<16>(d + c * CH, n_in > 0 ? g + col : x, n_in > 0 ? n_in * (int)sizeof(T) : 0);
    }
  }
  const int j = threadIdx.x, row = tl.row0 + j;
  if (j >= pl.win_h || row < 0 || row >= pl.src_h || tl.col0 > 0 || -tl.col0 >= pl.cpr * CH)
    return;
  const int e = row_shift<T>(pl, tl.plane, row);
  if (e == 0) return;
  const T* g = x + ((int64_t)tl.plane * pl.src_h + row) * pl.src_w - e;  // on 16 bytes
  st.bits = keep_bytes(__ldg(reinterpret_cast<const uint4*>(g)), e * (int)sizeof(T),
                       (e + pl.src_w) * (int)sizeof(T));
  st.addr = (unsigned)((slot + j * pl.pitch - tl.col0) - reinterpret_cast<T*>(smem)) *
            (unsigned)sizeof(T);
  st.pending = true;
}

// The 16-byte chunks a row-pass run loads for SEG samples from any element.
template <typename T, int SEG>
constexpr int LOAD_CHUNKS = sizeof(T) == 2 ? (SEG / 2 + 5 + 3) / 4 : (SEG + 3 + 3) / 4;

// SEG samples of a window row from element c on, as float32, read in
// 16-byte chunks from the one that holds c, then shifted by c's place in it
// (s): by selects and a byte permute a word, or, where SLO >= 0 gives s's
// low two bits (the same for every row), by a select for its high bit only.
template <int SEG, int SLO>
__device__ __forceinline__ void load_seg(float (&v)[SEG], const __nv_bfloat16* row, int c) {
  constexpr int NC = LOAD_CHUNKS<__nv_bfloat16, SEG>, NW = 4 * NC;
  const uint4* p = reinterpret_cast<const uint4*>(row) + (c >> 3);
  unsigned w[NW];
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    const uint4 q = p[i];
    w[4 * i] = q.x, w[4 * i + 1] = q.y, w[4 * i + 2] = q.z, w[4 * i + 3] = q.w;
  }
  const int s = c & 7;
#pragma unroll
  for (int i = 0; i + 2 < NW; ++i) w[i] = (s & 4) ? w[i + 2] : w[i];
  if constexpr (SLO >= 0) {
#pragma unroll
    for (int i = 0; i < SEG; ++i) {
      constexpr int K = SLO >> 1;
      const int h = i + (SLO & 1);  // the sample's half in the words from K on
      const unsigned word = w[K + h / 2];
      v[i] = __uint_as_float(h % 2 ? word & 0xffff0000u : word << 16);
    }
  } else {
#pragma unroll
    for (int i = 0; i + 1 < NW; ++i) w[i] = (s & 2) ? w[i + 1] : w[i];
    const unsigned sel = (s & 1) ? 0x5432u : 0x3210u;
#pragma unroll
    for (int i = 0; 2 * i < SEG; ++i) {
      const unsigned q = __byte_perm(w[i], w[i + 1], sel);
      v[2 * i] = __uint_as_float(q << 16);
      if (2 * i + 1 < SEG) v[2 * i + 1] = __uint_as_float(q & 0xffff0000u);
    }
  }
}
template <int SEG, int SLO>
__device__ __forceinline__ void load_seg(float (&v)[SEG], const float* row, int c) {
  constexpr int NC = LOAD_CHUNKS<float, SEG>, NW = 4 * NC;
  const float4* p = reinterpret_cast<const float4*>(row) + (c >> 2);
  float w[NW];
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    const float4 q = p[i];
    w[4 * i] = q.x, w[4 * i + 1] = q.y, w[4 * i + 2] = q.z, w[4 * i + 3] = q.w;
  }
  const int s = c & 3;
#pragma unroll
  for (int i = 0; i + 2 < NW; ++i) w[i] = (s & 2) ? w[i + 2] : w[i];
#pragma unroll
  for (int i = 0; i + 1 < NW; ++i) w[i] = (s & 1) ? w[i + 1] : w[i];
#pragma unroll
  for (int i = 0; i < SEG; ++i) v[i] = w[i];
}

// 8 or 4 float32 values from a 16-byte chunk.
__device__ __forceinline__ void load_chunk(float (&v)[8], const __nv_bfloat16* p) {
  const uint4 q = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void load_chunk(float (&v)[4], const float* p) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
}

// Two float32 values as a bf16 pair in one word.
__device__ __forceinline__ unsigned pack2(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const unsigned*>(&h);
}

// N float32 values rounded to T, 16 bytes a store (p on 16 bytes).
template <int N>
__device__ __forceinline__ void store_chunks(__nv_bfloat16* p, const float* a) {
#pragma unroll
  for (int i = 0; i < N; i += 8)
    *reinterpret_cast<uint4*>(p + i) = make_uint4(pack2(a[i], a[i + 1]), pack2(a[i + 2], a[i + 3]),
                                                  pack2(a[i + 4], a[i + 5]),
                                                  pack2(a[i + 6], a[i + 7]));
}
template <int N>
__device__ __forceinline__ void store_chunks(float* p, const float* a) {
#pragma unroll
  for (int i = 0; i < N; i += 4)
    *reinterpret_cast<float4*>(p + i) = make_float4(a[i], a[i + 1], a[i + 2], a[i + 3]);
}

// nv of a column-pass run row's outputs from o on: 16 bytes a store where o
// lies on 16 bytes and the run is whole, else 8 where o lies on 8, else two
// outputs a store where it lies on 4 (bf16), else one by one.
__device__ __forceinline__ void store_run(__nv_bfloat16* o, const float (&a)[8], int nv) {
  const unsigned al = (unsigned)reinterpret_cast<uintptr_t>(o) & 15u;
  if (nv == 8 && al == 0) {
    store_chunks<8>(o, a);
  } else if (al % 8 == 0 && nv % 4 == 0) {
#pragma unroll
    for (int i = 0; i < 8; i += 4)
      if (i < nv)
        *reinterpret_cast<uint2*>(o + i) = make_uint2(pack2(a[i], a[i + 1]),
                                                      pack2(a[i + 2], a[i + 3]));
  } else if (al % 4 == 0 && nv % 2 == 0) {
#pragma unroll
    for (int i = 0; i < 8; i += 2)
      if (i < nv) store_pair(o + i, a[i], a[i + 1]);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (i < nv) o[i] = __float2bfloat16_rn(a[i]);
  }
}
__device__ __forceinline__ void store_run(float* o, const float (&a)[4], int nv) {
  const unsigned al = (unsigned)reinterpret_cast<uintptr_t>(o) & 15u;
  if (nv == 4 && al == 0) {
    store_chunks<4>(o, a);
  } else if (al % 8 == 0 && nv % 2 == 0) {
#pragma unroll
    for (int i = 0; i < 4; i += 2)
      if (i < nv) store_pair(o + i, a[i], a[i + 1]);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (i < nv) o[i] = a[i];
  }
}

// A row-pass run's sums: acc[jx] over the taps that land on source samples,
// in tap order. Sample sx feeds tap sx ux - jx dx + px of column jx (the
// template's axis, or at UX = 0 the plan's).
template <int RX, int SEG, int FX, int UX, int DX, int PX>
__device__ __forceinline__ void row_sums(float (&acc)[RX], const float (&v)[SEG],
                                         const Taps& k, const Plan& pl) {
  constexpr bool GUARD = FX == GUARDED_TAPS;
  const int ux = UX ? UX : pl.ux, dx = UX ? DX : pl.dx, px = UX ? PX : pl.px;
#pragma unroll
  for (int sx = 0; sx < SEG; ++sx)
#pragma unroll
    for (int jx = 0; jx < RX; ++jx) {
      const int tx = sx * ux - jx * dx + px;
      if (tx >= 0 && tx < FX && (!GUARD || tx < pl.fw)) acc[jx] = fmaf(k.kx[tx], v[sx], acc[jx]);
    }
}

// The row pass: the tile's intermediate, win_h rows x tile_w columns, each
// rounded to T, into mid. Run (j, cx) is window row j's intermediate columns
// cx RX ...; it reads RX DX / UX window elements a run further on. SLO: as
// load_seg's.
template <typename T, int FX, int UX, int DX, int PX, int SLO>
__device__ __forceinline__ void row_runs(const T* slot, T* mid, const Taps& k, const Plan& pl,
                                         const Tile& tl) {
  constexpr int RX = RUN_R<UX>;
  constexpr int SEG = SEGMENT<FX, RX, UX, DX, PX>;
  const int step = UX ? RX * DX / UX : RX * pl.dx / pl.ux;  // window elements a run
  const int items = pl.win_h * pl.runs_r;
  for (int it = threadIdx.x; it < items; it += THREADS) {
    int j, cx;
    if constexpr (DX == 2) {
      cx = pl.by_win_h(it), j = it - cx * pl.win_h;
    } else {
      j = pl.by_runs_r(it), cx = it - j * pl.runs_r;
    }
    float v[SEG];
    load_seg<SEG, SLO>(v, slot + j * pl.pitch,
                       pl.lead_x + row_shift<T>(pl, tl.plane, tl.row0 + j) + cx * step);
    float acc[RX];
#pragma unroll
    for (int jx = 0; jx < RX; ++jx) acc[jx] = 0.f;
    row_sums<RX, SEG, FX, UX, DX, PX>(acc, v, k, pl);
    store_chunks<RX>(mid + j * pl.mid_pitch + cx * RX, acc);
  }
}

// The row pass, with a run's offset in its chunk partly at compile time
// where every row's has the same low two bits (bf16 with exact taps, rows
// of whole 4-sample groups: the ADA pipe's calls).
template <typename T, int FX, int UX, int DX, int PX>
__device__ __forceinline__ void row_pass(const T* slot, T* mid, const Taps& k, const Plan& pl,
                                         const Tile& tl) {
  if constexpr (sizeof(T) == 2 && FX != GUARDED_TAPS) {
    switch (pl.wm % 4 ? -1 : (pl.lead_x + pl.eb) % 4) {
      case 0: return row_runs<T, FX, UX, DX, PX, 0>(slot, mid, k, pl, tl);
      case 1: return row_runs<T, FX, UX, DX, PX, 1>(slot, mid, k, pl, tl);
      case 2: return row_runs<T, FX, UX, DX, PX, 2>(slot, mid, k, pl, tl);
      case 3: return row_runs<T, FX, UX, DX, PX, 3>(slot, mid, k, pl, tl);
      default: break;
    }
  }
  row_runs<T, FX, UX, DX, PX, -1>(slot, mid, k, pl, tl);
}

// A column-pass run's sums from its first intermediate row s on: row sy
// feeds tap sy uy - jy dy + py of run row jy (the template's axis, or at
// UY = 0 the plan's).
template <typename T, int FY, int UY, int DY, int PY>
__device__ __forceinline__ void column_sums(float (&acc)[RUN_C][16 / sizeof(T)], const T* s,
                                            const Taps& k, const Plan& pl) {
  constexpr int CH = 16 / sizeof(T);
  constexpr int SEGY = SEGMENT<FY, RUN_C, UY, DY, PY>;
  constexpr bool GUARD = FY == GUARDED_TAPS;
  const int uy = UY ? UY : pl.uy, dy = UY ? DY : pl.dy, py = UY ? PY : pl.py;
#pragma unroll
  for (int sy = 0; sy < SEGY; ++sy) {
    if (GUARD && sy * uy - (RUN_C - 1) * dy + py >= pl.fh) break;  // feeds no tap, nor do later rows
    float v[CH];
    load_chunk(v, s + sy * pl.mid_pitch);
#pragma unroll
    for (int jy = 0; jy < RUN_C; ++jy) {
      const int ty = sy * uy - jy * dy + py;
      if (ty < 0 || ty >= FY || (GUARD && ty >= pl.fh)) continue;
#pragma unroll
      for (int i = 0; i < CH; ++i) acc[jy][i] = fmaf(k.ky[ty], v[i], acc[jy][i]);
    }
  }
}

// The column pass: the tile's outputs from mid. Run (ry, cx) is output rows
// ry RUN_C ... by one 16-byte chunk of columns (store_run).
template <typename T, int FY, int UY, int DY, int PY>
__device__ __forceinline__ void column_pass(const T* mid, T* __restrict__ y, const Taps& k,
                                            const Plan& pl, const Tile& tl) {
  constexpr int CH = 16 / sizeof(T);
  const int items = (pl.tile_h / RUN_C) * pl.runs_c;
  for (int it = threadIdx.x; it < items; it += THREADS) {
    const int ry = pl.by_runs_c(it), cx = it - ry * pl.runs_c;
    const int oy = tl.oy0 + ry * RUN_C, ox = tl.ox0 + cx * CH;
    if (oy >= pl.out_h || ox >= pl.out_w) continue;
    float acc[RUN_C][CH];
#pragma unroll
    for (int jy = 0; jy < RUN_C; ++jy)
#pragma unroll
      for (int i = 0; i < CH; ++i) acc[jy][i] = 0.f;
    const int step = UY ? RUN_C * DY / UY : RUN_C * pl.dy / pl.uy;  // intermediate rows a run
    column_sums<T, FY, UY, DY, PY>(acc, mid + ry * step * pl.mid_pitch + cx * CH, k, pl);
    const int nv = min(CH, pl.out_w - ox);
#pragma unroll
    for (int jy = 0; jy < RUN_C; ++jy)
      if (oy + jy < pl.out_h)
        store_run(y + ((int64_t)tl.plane * pl.out_h + oy + jy) * pl.out_w + ox, acc[jy], nv);
  }
}

template <typename T, int FY, int FX, int UY, int DY, int PY, int UX, int DX, int PX>
__global__ void __launch_bounds__(THREADS, BLOCKS<DX>)
    upfirdn2d_sep_kernel(const T* __restrict__ x, T* __restrict__ y, const Taps k,
                         const Plan pl) {
  static_assert((UY == 0 || (RUN_C * DY) % UY == 0) && (UX == 0 || (RUN_R<UX> * DX) % UX == 0),
                "runs start on a phase");
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);  // two window slots, then the intermediate
  T* mid = ring + 2 * pl.slot_elems;
  Straddle st;
  const CopyShare<THREADS> cs(pl.cpr, pl.by_cpr, pl.win_h);
  if ((int)blockIdx.x < pl.tiles)
    issue_tile<T>(ring, x, pl, cs, Tile(pl, blockIdx.x), st, smem);
  cp_async_commit();
  st.flush(smem);
  int slot = 0;
  for (int t = blockIdx.x; t < pl.tiles; t += pl.grid) {
    cp_async_wait<0>();  // this thread's copies of tile t have landed
    __syncthreads();     // everyone's have, and tile t - grid's column pass is done with mid
    const int nt = t + pl.grid;
    if (nt < pl.tiles)
      issue_tile<T>(ring + (slot ^ 1) * pl.slot_elems, x, pl, cs, Tile(pl, nt), st, smem);
    cp_async_commit();
    const Tile tl(pl, t);
    row_pass<T, FX, UX, DX, PX>(ring + slot * pl.slot_elems, mid, k, pl, tl);
    __syncthreads();     // the intermediate is whole
    column_pass<T, FY, UY, DY, PY>(mid, y, k, pl, tl);
    st.flush(smem);
    slot ^= 1;
  }
  cp_async_wait<0>();
}

template <typename T, int FY, int FX, int UY, int DY, int PY, int UX, int DX, int PX>
cudaError_t launch_variant(const void* x, void* y, const Taps& k, const Plan& pl,
                           cudaStream_t stream) {
  constexpr int CH = 16 / sizeof(T);
  const bool axes = UY ? pl.uy == UY && pl.dy == DY && pl.py == PY && pl.ux == UX &&
                             pl.dx == DX && pl.px == PX
                       : axis_ok(pl.uy, pl.dy, pl.py) && axis_ok(pl.ux, pl.dx, pl.px);
  if (!axes || pl.tile_h % RUN_C || pl.tile_w != pl.runs_r * RUN_R<UX> ||
      pl.tile_w != pl.runs_c * CH || (pl.tile_w * pl.dx / pl.ux) % CH || pl.pitch % CH ||
      pl.cpr * CH > pl.pitch || pl.mid_pitch % CH ||
      pl.win_h > THREADS || (FY != GUARDED_TAPS && pl.fh != FY) ||
      (FX != GUARDED_TAPS && pl.fw != FX) || pl.fh > FY || pl.fw > FX)
    return cudaErrorInvalidValue;
  constexpr auto kernel = upfirdn2d_sep_kernel<T, FY, FX, UY, DY, PY, UX, DX, PX>;
  const cudaError_t err = allow_dynamic_smem<kernel>();
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)pl.grid, THREADS, pl.smem_bytes, stream>>>(static_cast<const T*>(x),
                                                                static_cast<T*>(y), k, pl);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int variant, const void* x, void* y, const Taps& k, const Plan& pl,
                     cudaStream_t stream) {
  int i = k2d::kNumVariants;
#define K2_CASE(...) \
  if (variant == i++) return launch_variant<T, __VA_ARGS__>(x, y, k, pl, stream);
  K2_VARIANTS_SEP(K2_CASE)
#undef K2_CASE
  return cudaErrorInvalidValue;
}

}  // namespace ksep

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. variant: the index in K2_VARIANTS_2D
// then K2_VARIANTS_SEP. taps: 32 host floats, the filter already flipped,
// gained and rounded to dtype: for a 2-D pass its [4][4] taps (zero beyond
// fh x fw), then its factors fy[4] and fx[4]; for a separable call its
// column filter ky[16], then its row filter kx[16]. plan: the int64 plan of
// ops/upfirdn2d_kernel.py:k2_plan_2d (a 2-D pass) or k2_plan_sep (a
// separable call) for x [planes, src_h, src_w], contiguous; y is [planes,
// out_h, out_w].
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
  const int64_t itemsize = dtype == 0 ? 4 : 2;
  if (plan[ksep::kVariant] != variant || plan[ksep::kTiles] < 1 || plan[ksep::kGrid] < 1 ||
      plan[ksep::kGrid] > plan[ksep::kTiles] || plan[ksep::kTiles] >= (int64_t)1 << 31 ||
      plan[ksep::kSmemBytes] > K2_MAX_DYNAMIC_SMEM ||
      plan[ksep::kSlotElems] < plan[ksep::kWinH] * plan[ksep::kPitch] ||
      plan[ksep::kSmemBytes] != (2 * plan[ksep::kSlotElems] +
                                 plan[ksep::kWinH] * plan[ksep::kMidPitch]) * itemsize)
    return (int)cudaErrorInvalidValue;
  ksep::Taps k;
  for (int i = 0; i < 16; ++i) k.ky[i] = taps[i], k.kx[i] = taps[16 + i];
  const ksep::Plan pl = ksep::read_plan(plan);
  if (dtype == 0) return (int)ksep::dispatch<float>(variant, x, y, k, pl, s);
  if (dtype == 1) return (int)ksep::dispatch<__nv_bfloat16>(variant, x, y, k, pl, s);
  return (int)cudaErrorInvalidValue;
}
