// The adjoint of the shear warp's shared-scale resample (K7-bwd), NCHW, for
// Hopper (sm_90a).
//
// Replaces the gradient of stage 1 of stylegan_v_tpu/ops/shear_warp.py:
// jax.grad of _line_pass_onehot (:104), the transposed one-hot matmul
// S^T @ g (a scatter-add in _line_pass, :81), of the reflect pad before it
// (:423, :455) and of pass V's rot90 select (:388). It is the exact
// transpose of stage 1 of the fused pass (shear_pass.cu), whose taps index
// the unpadded source. With b = p / C:
//
//   AXIS 0: dx'[p, l, s] = sum over the taps (i, w) of sample b on source line l of w dz[p, i, s]
//           dx[p, c, S - 1 - l] = dx'[p, l, c] where rot[b] is set (the rot90 turned back),
//           else dx = dx'
//   AXIS 1: dx[p, r, l]  = sum over the taps (i, w) of sample b on source line l of w dz[p, r, i]
//
// A tap is (i, w0[b, i]) on line i0[b, i] or (i, w1[b, i]) on line
// i1[b, i]: the forward's own tables (ops/shear_warp.py:line_taps).
// Because of the mirror, the reflect pad composed into the taps, and scales
// below 1, several output lines i tap one source line l, and both taps of
// an i may land on one line. Each element sums its taps in float32 in the
// order (i, tap), each product and sum rounded on its own, and is written
// once in dz's dtype: the order of ops/shear_warp.py:LineTaps.lists, which
// the CPU tests sum to the bit. No atomics on values: a call repeats to the
// bit, and needs no zeroed buffer.
//
// The lists are built on chip, once a block (build_lists), from the taps
// themselves: the block reads its sample's 2 L taps, four loads in flight
// a thread, counts those that land on its lines (shared atomics: a count
// does not depend on their order), scans the counts into each line's
// start, places the taps, and sorts each line's few taps by 2 i + tap, so
// that the order does not depend on the atomics either. No list is built
// by a launch of its own.
//
// Pass V (AXIS 0): a block owns a tile of one sample, V_LINES source lines
// by V_ROW_BYTES of columns (128 bf16, 64 float32), for all C planes of
// it, which share its lists; a rot90 sample's tile is the other way round,
// V_ROW_BYTES of source lines by V_LINES columns, so that the rows of dx it
// writes turned are runs of 256 bytes too (in bf16 at the canvas, runs of
// 64 bytes, half of them off a 32-byte sector, took longer than all the
// rest of the pass). The grid is the same for both, since a rot90 sample is
// square. A tile's lists are in dynamic shared memory, room for all 2 L
// taps of the sample (17 KB at the ADA step's canvas), so that no table
// can overflow them; the kernel traps past that all the same. A thread
// owns G neighbouring columns of one source line and
// V_PLANES planes at once; for each batch of V_BATCH of the line's taps it
// loads the G-wide vectors of the dz rows i of those planes, then adds
// them in order: dz rows are read whole and coalesced, each about twice
// (the two taps of an i mostly land on neighbouring lines of one block),
// the second time from L1. A rot90 sample's tile of dx' goes through shared
// memory and is stored turned, G elements of a row of dx at a time.
//
// Pass H (AXIS 1): persistent blocks, as many as fit on the card, each an
// even share of all the samples' rows (plane by plane), a sample's part at
// a time, with every tap of that sample in shared memory (2 L). A block
// stages its rows in groups of RB in a ring of H_RING groups, by 16-byte
// cp.async chunks (the aligned chunks that cover a row, the row's offset
// into its first chunk kept; element copies only for a chunk that starts
// before the tensor); the first groups are in flight while the lists are
// built. RB is 16 bytes of rows (8 bf16, 4 float32) where that fits in
// shared memory (up to 1048^2 -> 1036^2), else a quarter of it. A thread
// owns ceil(lines / 1024) source lines, one at the step's canvas: it holds
// its first line's first H_REG_TAPS taps in registers, gathers its lines'
// taps from the group's staged rows (its warp stops at its longest first
// list), and the group's rows of dx leave through shared memory as G-wide
// vectors.
//
// G: 16 or 8 bytes where every row of dx (and in pass V of dz, as long)
// starts on such a boundary, else one element (the rule of shear_lines.cuh).
//
// Bound: memory. It must read dz once and write dx once: at the ADA step's
// canvas in bf16, pass V [144, 1060, 536] in and [144, 536, 536] out, 246
// MB, 0.0735 ms at 3.35 TB/s; pass H [144, 524, 1060] in and [144, 524,
// 536] out, 0.0719 ms. Where it stands (an H100 at 700 W, PERF.md): about
// 0.18 ms a pass, 0.40 of the bound; pass H issues about five instructions
// for each element and tap it gathers, and pass V waits on its loads at
// two blocks a multiprocessor (117 registers in bf16; fewer spill).
//
// The C entry point launches on the given stream, does not synchronise,
// allocates nothing and returns cudaGetLastError().

#include "shear_lines.cuh"

#include <atomic>

namespace {

using namespace shear;

// pass V's tile: V_LINES source lines by V_ROW_BYTES of columns (128 bf16, 64
// float32); a rot90 sample's is the other way round
constexpr int V_LINES = 32;       // (ops/shear_warp.py)
constexpr int V_ROW_BYTES = 256;  // (ops/shear_warp.py)
constexpr int V_PLANES = 3;       // pass V: planes a thread sums at once
constexpr int V_BATCH = 2;        // pass V: taps a thread loads before it adds them
constexpr int H_RING = 3;         // pass H: groups of staged rows in flight or in use
constexpr int H_REG_TAPS = 8;     // pass H: a line's first taps, held in registers
constexpr int MAX_SMEM = 232448;  // the shared memory a block may have on Hopper

struct Bwd {
  const void* dz;                 // [planes, R, S]
  void* dx;                       // [planes, out_r, out_s]
  const int* i0;                  // the taps [N, L]
  const int* i1;
  const float* w0;
  const float* w1;
  const unsigned char* rot;       // [N], pass V only, or null
  int C, R, S, out_r, out_s;
  int L;                          // dz's length along the axis
  int lines;                      // dx's length along the axis: the source lines
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Exclusive prefix sums of cnt[0 .. n) into start[0 .. n], start[n] the
// total, by the whole block (whole warps); sums: 32 ints of scratch.
__device__ void scan_counts(const int* cnt, int* start, int n, int* sums) {
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31, warp = tid >> 5;
  const int per = (n + nt - 1) / nt, a = min(n, tid * per), b = min(n, a + per);
  int own = 0;
  for (int j = a; j < b; ++j) own += cnt[j];
  int x = own;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int v = lane < nt / 32 ? sums[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += y;
    }
    sums[lane] = v;
  }
  __syncthreads();
  int at = x - own + (warp ? sums[warp - 1] : 0);
  for (int j = a; j < b; ++j) {
    start[j] = at;
    at += cnt[j];
  }
  if (tid == nt - 1) start[n] = at;
  __syncthreads();
}

// A block's lists in shared memory: line j's taps are key[start[j]] ..
// key[start[j + 1] - 1], key 2 i + tap ascending, with their weights wt.
struct Lists {
  int* start;
  int* key;
  float* wt;
};

// The taps of sample n that land on the source lines l0 .. l0 + lines - 1,
// as lists; cnt is `lines` ints of scratch. More than cap taps trap.
__device__ void build_lists(const Bwd& a, int n, int l0, int lines, int cap, int* cnt,
                            const Lists& s, int* sums) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int* i0 = a.i0 + (int64_t)n * a.L;
  const int* i1 = a.i1 + (int64_t)n * a.L;
  for (int j = tid; j < lines; j += nt) cnt[j] = 0;
  __syncthreads();
  for (int e0 = tid; e0 < 2 * a.L; e0 += 4 * nt) {       // four loads in flight, then the counts
    int j[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int e = e0 + k * nt;
      j[k] = e < 2 * a.L ? __ldg((e & 1 ? i1 : i0) + (e >> 1)) - l0 : -1;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if ((unsigned)j[k] < (unsigned)lines) atomicAdd(cnt + j[k], 1);
  }
  __syncthreads();
  scan_counts(cnt, s.start, lines, sums);
  if (s.start[lines] > cap) __trap();
  for (int j = tid; j < lines; j += nt) cnt[j] = s.start[j];
  __syncthreads();
  const float* w0 = a.w0 + (int64_t)n * a.L;
  const float* w1 = a.w1 + (int64_t)n * a.L;
  for (int e0 = tid; e0 < 2 * a.L; e0 += 4 * nt) {
    int j[4];
    float w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int e = e0 + k * nt, i = e >> 1;
      j[k] = -1;
      if (e < 2 * a.L) {
        j[k] = __ldg((e & 1 ? i1 : i0) + i) - l0;
        w[k] = __ldg((e & 1 ? w1 : w0) + i);
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if ((unsigned)j[k] < (unsigned)lines) {
        const int at = atomicAdd(cnt + j[k], 1);
        s.key[at] = e0 + k * nt;
        s.wt[at] = w[k];
      }
    }
  }
  __syncthreads();
  for (int j = tid; j < lines; j += nt) {          // each line's few taps, by key
    const int e0 = s.start[j], e1 = s.start[j + 1];
    for (int e = e0 + 1; e < e1; ++e) {
      const int k = s.key[e];
      const float w = s.wt[e];
      int f = e;
      for (; f > e0 && s.key[f - 1] > k; --f) {
        s.key[f] = s.key[f - 1];
        s.wt[f] = s.wt[f - 1];
      }
      s.key[f] = k;
      s.wt[f] = w;
    }
  }
  __syncthreads();
}

// acc[g] += w * u[g], the product and the sum rounded on their own.
template <typename T, int G>
__device__ __forceinline__ void add_tap(float (&acc)[G], float w, const Vec<T, G>& u) {
#pragma unroll
  for (int g = 0; g < G; ++g) acc[g] = __fadd_rn(acc[g], __fmul_rn(w, to_f(u.v[g])));
}

// ------------------------------------------------------------------ pass V

// One pass-V block: TURN for a rot90 sample, whose tile is V_LINES columns of
// COLS source lines, else COLS columns of V_LINES lines; either way every
// row of dx that it writes is a run of 256 bytes.
template <typename T, int G, bool TURN>
__device__ __forceinline__ void rows_tile(const Bwd& a, int* cnt, int* start, int* key, float* wt,
                                          int* sums, T* turned) {
  constexpr int COLS = V_ROW_BYTES / (int)sizeof(T);
  constexpr int TL = TURN ? COLS : V_LINES, TC = TURN ? V_LINES : COLS;  // lines, columns
  constexpr int PITCH = V_LINES + 4 / (int)sizeof(T);    // an odd number of words a row
  constexpr int VPL = TC / G;                             // vectors a line of the tile
  constexpr int P = V_PLANES;
  const int n = blockIdx.z;
  const int l0 = (TURN ? blockIdx.x : blockIdx.y) * TL, s0 = (TURN ? blockIdx.y : blockIdx.x) * TC;
  const int lines = min(TL, a.out_r - l0), width = min(TC, a.S - s0);
  build_lists(a, n, l0, lines, 2 * a.L, cnt, Lists{start, key, wt}, sums);
  const int64_t in_plane = (int64_t)a.R * a.S, out_plane = (int64_t)a.out_r * a.S;
  for (int c0 = 0; c0 < a.C; c0 += P) {                   // P planes at once
    const int np = min(P, a.C - c0);
    const int64_t p0 = (int64_t)n * a.C + c0;
    const T* src = static_cast<const T*>(a.dz) + p0 * in_plane + s0;
    T* dst = static_cast<T*>(a.dx) + p0 * out_plane;
    for (int t = threadIdx.x; t < TL * VPL; t += THREADS) {
      const int j = t / VPL, v = (t - j * VPL) * G;
      if (j >= lines || v >= width) continue;
      float acc[P][G];
#pragma unroll
      for (int q = 0; q < P; ++q)
#pragma unroll
        for (int g = 0; g < G; ++g) acc[q][g] = 0.0f;
      const int e1 = start[j + 1];
      for (int e = start[j]; e < e1; e += V_BATCH) {   // a batch in flight, added in order
        Vec<T, G> u[V_BATCH][P];
        float w[V_BATCH];
#pragma unroll
        for (int k = 0; k < V_BATCH; ++k) {
          if (e + k < e1) {
            w[k] = wt[e + k];
            const T* row = src + (int64_t)(key[e + k] >> 1) * a.S + v;
#pragma unroll
            for (int q = 0; q < P; ++q)
              if (q < np) u[k][q] = ldg_vec<T, G>(row + q * in_plane);
          }
        }
#pragma unroll
        for (int k = 0; k < V_BATCH; ++k)
#pragma unroll
          for (int q = 0; q < P; ++q)
            if (e + k < e1 && q < np) add_tap<T, G>(acc[q], w[k], u[k][q]);
      }
#pragma unroll
      for (int q = 0; q < P; ++q) {
        if (q >= np) break;
        Vec<T, G> o;
#pragma unroll
        for (int g = 0; g < G; ++g) o.v[g] = from_f<T>(acc[q][g]);
        if (TURN) {
#pragma unroll
          for (int g = 0; g < G; ++g) turned[(q * TL + j) * PITCH + v + g] = o.v[g];
        } else {
          *reinterpret_cast<Vec<T, G>*>(dst + q * out_plane + (int64_t)(l0 + j) * a.S + s0 + v) = o;
        }
      }
    }
    if (TURN) {
      // dx[p, s0 + cc, S - 1 - l] = dx'[p, l, s0 + cc]: G columns of a row of dx
      // at a time, from column `first`, that of the tile's last line slot; the
      // last tile's slots past the source land left of column 0
      constexpr int VPR = TL / G;
      const int first = a.S - l0 - TL;
      __syncthreads();
      for (int t = threadIdx.x; t < np * TC * VPR; t += THREADS) {
        const int q = t / (TC * VPR), rest = t - q * (TC * VPR);
        const int cc = rest / VPR, f = (rest - cc * VPR) * G;
        if (cc >= width || first + f < 0) continue;
        Vec<T, G> o;
#pragma unroll
        for (int g = 0; g < G; ++g) o.v[g] = turned[(q * TL + TL - 1 - f - g) * PITCH + cc];
        *reinterpret_cast<Vec<T, G>*>(dst + q * out_plane + (int64_t)(s0 + cc) * a.S + first + f) =
            o;
      }
      __syncthreads();
    }
  }
}

// The lists' keys and weights are dynamic shared memory, 2 L of each.
template <typename T, int G>
__global__ void __launch_bounds__(THREADS) shear_resample_bwd_rows(Bwd a) {
  constexpr int COLS = V_ROW_BYTES / (int)sizeof(T);
  __shared__ int cnt[COLS], start[COLS + 1], sums[32];
  __shared__ T turned[V_PLANES * COLS * (V_LINES + 4 / (int)sizeof(T))];
  extern __shared__ __align__(16) unsigned char dyn[];
  int* key = reinterpret_cast<int*>(dyn);
  float* wt = reinterpret_cast<float*>(dyn) + 2 * a.L;
  if (a.rot != nullptr && a.rot[blockIdx.z])
    rows_tile<T, G, true>(a, cnt, start, key, wt, sums, turned);
  else
    rows_tile<T, G, false>(a, cnt, start, key, wt, sums, turned);
}

// ------------------------------------------------------------------ pass H

__host__ __device__ constexpr int up16(int b) { return (b + 15) & ~15; }

// Pass H's shared memory, byte offsets: the lists (2 L keys and weights),
// start and cnt, the scan's sums, a ring of H_RING groups of rb staged rows
// of `pitch` bytes (the 16-byte chunks that cover L elements from any
// offset), and rb rows of dx.
template <typename T>
struct HLayout {
  static constexpr int RB = 16 / (int)sizeof(T);          // rows a group at most: 8 bf16, 4 float32
  int pitch, key, wt, start, cnt, sums, ring, out, bytes;
  __host__ __device__ HLayout(int L, int lines, int rb) {
    const int e = (int)sizeof(T);
    pitch = up16(16 - e + L * e);
    key = 0;
    wt = up16(key + 2 * L * 4);
    start = up16(wt + 2 * L * 4);
    cnt = up16(start + (lines + 1) * 4);
    sums = up16(cnt + lines * 4);
    ring = up16(sums + 32 * 4);
    out = ring + H_RING * rb * pitch;
    bytes = up16(out + rb * lines * e);
  }
};

// Start the copies of `rows` rows of L elements from `row` into buf, `pitch`
// bytes a row: each row's aligned 16-byte chunks, cut at the tensor's end
// (`end`); a chunk that starts before the tensor (`begin`) is copied
// element by element.
template <typename T>
__device__ __forceinline__ void stage_rows(unsigned char* buf, const T* row, int rows, int L,
                                           int pitch, const T* begin, const T* end) {
  const int chunks = pitch / 16;
  for (int q = threadIdx.x; q < rows * chunks; q += blockDim.x) {
    const int r = q / chunks, k = q - r * chunks;
    const T* first = row + (int64_t)r * L;
    const uintptr_t c = ((uintptr_t)first & ~(uintptr_t)15) + 16 * (uintptr_t)k;
    if (c >= (uintptr_t)(first + L)) continue;            // past the row
    unsigned char* d = buf + r * pitch + 16 * k;
    if (c >= (uintptr_t)begin) {
      const uintptr_t left = (uintptr_t)end - c;
      cp_async16(d, reinterpret_cast<const void*>(c), left < 16 ? (int)left : 16);
    } else {
      for (uintptr_t b = (uintptr_t)begin; b < c + 16 && b < (uintptr_t)end; b += sizeof(T))
        *reinterpret_cast<T*>(d + (b - c)) = *reinterpret_cast<const T*>(b);
    }
  }
}

__device__ __forceinline__ void cp_async_wait_ring() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(H_RING - 1) : "memory");
}

// Line l of the rows of dx that the group zs (rows at off) gives: the taps
// e .. last - 1 from the lists, after the `held` taps in registers (ri, rw,
// those of e0 .. e1 - 1; the warp's longest such list is `most`).
template <typename T, int RB>
__device__ __forceinline__ void sum_line(T* out, int lines, int l, const T* zs,
                                         const int (&off)[RB], const int* key, const float* wt,
                                         int e, int last, int held, const int (&ri)[H_REG_TAPS],
                                         const float (&rw)[H_REG_TAPS], int most, int e0, int e1) {
  float acc[RB];
#pragma unroll
  for (int q = 0; q < RB; ++q) acc[q] = 0.0f;
  if (held) {
#pragma unroll
    for (int k = 0; k < H_REG_TAPS; ++k) {
      if (k >= most) break;
      if (e0 + k < e1) {
#pragma unroll
        for (int q = 0; q < RB; ++q)
          acc[q] = __fadd_rn(acc[q], __fmul_rn(rw[k], to_f(zs[off[q] + ri[k]])));
      }
    }
    e += held;
  }
  for (; e < last; ++e) {
    const T* z = zs + (key[e] >> 1);
    const float w = wt[e];
#pragma unroll
    for (int q = 0; q < RB; ++q) acc[q] = __fadd_rn(acc[q], __fmul_rn(w, to_f(z[off[q]])));
  }
#pragma unroll
  for (int q = 0; q < RB; ++q) out[q * lines + l] = from_f<T>(acc[q]);
}

// A block sums the rows first .. first + per - 1 of dz (all samples' rows,
// plane by plane, one after another), a sample's part at a time, with that
// sample's lists, in groups of RB rows; the wrapper gives each block an
// even share. Thread t owns the source lines t, t + blockDim.x, ...
template <typename T, int G, int RB>
__global__ void __launch_bounds__(1024) shear_resample_bwd_cols(Bwd a, int N, int64_t per) {
  extern __shared__ __align__(16) unsigned char smem[];
  const HLayout<T> h(a.L, a.lines, RB);
  int* cnt = reinterpret_cast<int*>(smem + h.cnt);
  int* start = reinterpret_cast<int*>(smem + h.start);
  int* key = reinterpret_cast<int*>(smem + h.key);
  float* wt = reinterpret_cast<float*>(smem + h.wt);
  T* out = reinterpret_cast<T*>(smem + h.out);
  unsigned char* ring = smem + h.ring;
  const int64_t rows = (int64_t)a.C * a.R;                 // a sample's rows
  const int64_t total = rows * N;
  const T* dz = static_cast<const T*>(a.dz);
  const T* end = dz + total * a.L;
  const int vpr = a.lines / G, l = threadIdx.x;            // l: the thread's first line
  int64_t r = (int64_t)blockIdx.x * per;
  const int64_t r_end = r + per < total ? r + per : total;
  while (r < r_end) {
    const int n = (int)(r / rows);
    const int64_t seg = (int64_t)(n + 1) * rows < r_end ? (int64_t)(n + 1) * rows : r_end;
    const int groups = (int)((seg - r + RB - 1) / RB);
    const T* z0 = dz + r * a.L;
    T* dx = static_cast<T*>(a.dx) + r * a.lines;
    auto in_group = [&](int g) {
      const int64_t m = seg - r - (int64_t)g * RB;
      return m < RB ? (int)m : RB;
    };
    auto stage = [&](int g) {
      if (g < groups)
        stage_rows<T>(ring + (g % H_RING) * RB * h.pitch, z0 + (int64_t)g * RB * a.L,
                      in_group(g), a.L, h.pitch, dz, end);
      cp_async_commit();
    };
    for (int g = 0; g < H_RING - 1; ++g) stage(g);       // in flight while the lists are built
    build_lists(a, n, 0, a.lines, 2 * a.L, cnt, Lists{start, key, wt},
                reinterpret_cast<int*>(smem + h.sums));
    int e0 = 0, e1 = 0, ri[H_REG_TAPS];                     // the first line's first taps
    float rw[H_REG_TAPS];
    if (l < a.lines) {
      e0 = start[l];
      e1 = start[l + 1];
#pragma unroll
      for (int k = 0; k < H_REG_TAPS; ++k) {
        ri[k] = e0 + k < e1 ? key[e0 + k] >> 1 : 0;
        rw[k] = e0 + k < e1 ? wt[e0 + k] : 0.0f;
      }
    }
    const int most = __reduce_max_sync(0xffffffffu, e1 - e0);   // the warp's longest first list
    for (int g = 0; g < groups; ++g) {
      stage(g + H_RING - 1);
      cp_async_wait_ring();
      __syncthreads();
      const T* zs = reinterpret_cast<const T*>(ring + (g % H_RING) * RB * h.pitch);
      const T* row0 = z0 + (int64_t)g * RB * a.L;
      int off[RB];                         // each staged row's first element in zs
#pragma unroll
      for (int q = 0; q < RB; ++q)
        off[q] = q * (h.pitch / (int)sizeof(T)) +
                 (int)(((uintptr_t)(row0 + (int64_t)q * a.L) & 15) / sizeof(T));
      if (l < a.lines)
        sum_line<T, RB>(out, a.lines, l, zs, off, key, wt, e0, e1, H_REG_TAPS, ri, rw, most, e0,
                        e1);
      for (int m = l + blockDim.x; m < a.lines; m += blockDim.x)   // past 1024 lines
        sum_line<T, RB>(out, a.lines, m, zs, off, key, wt, start[m], start[m + 1], 0, ri, rw, 0,
                        0, 0);
      __syncthreads();
      T* drow = dx + (int64_t)g * RB * a.lines;
      for (int q = threadIdx.x; q < in_group(g) * vpr; q += blockDim.x) {
        const int rr = q / vpr, v = (q - rr * vpr) * G;
        *reinterpret_cast<Vec<T, G>*>(drow + (int64_t)rr * a.lines + v) =
            *reinterpret_cast<const Vec<T, G>*>(out + rr * a.lines + v);
      }
    }
    cp_async_wait_all();
    __syncthreads();                        // the next part's lists and ring start afresh
    r = seg;
  }
}

// ------------------------------------------------------------------ launch

// cudaFuncSetAttribute once for each kernel K and device, so that a launch
// may take all the shared memory a block may have beside K's static
// shared memory; *room: that much dynamic shared memory.
template <auto K>
cudaError_t allow_dynamic_smem(int* room) {
  static std::atomic<unsigned long long> done{0};
  static std::atomic<int> dynamic{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (done.load(std::memory_order_acquire) & bit) {
    *room = dynamic.load(std::memory_order_relaxed);
    return cudaSuccess;
  }
  cudaFuncAttributes fa;
  if ((err = cudaFuncGetAttributes(&fa, K)) != cudaSuccess) return err;
  const int left = MAX_SMEM - (int)fa.sharedSizeBytes;
  err = cudaFuncSetAttribute(K, cudaFuncAttributeMaxDynamicSharedMemorySize, left);
  if (err != cudaSuccess) return err;
  dynamic.store(left, std::memory_order_relaxed);
  done.fetch_or(bit, std::memory_order_release);
  *room = left;
  return cudaSuccess;
}

template <typename T, int G>
int start_rows(int N, const Bwd& a, cudaStream_t stream) {
  constexpr int COLS = V_ROW_BYTES / (int)sizeof(T);
  constexpr auto kernel = shear_resample_bwd_rows<T, G>;
  int room = 0;
  cudaError_t err = allow_dynamic_smem<kernel>(&room);
  if (err != cudaSuccess) return (int)err;
  const int64_t bytes = 2 * (int64_t)a.L * 8;           // 2 L keys and weights
  if (bytes > room) return (int)cudaErrorInvalidValue;
  const dim3 grid((a.S + COLS - 1) / COLS, (a.out_r + V_LINES - 1) / V_LINES, N);
  kernel<<<grid, THREADS, (size_t)bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, int G, int RB>
int start_cols_rb(int N, const Bwd& a, cudaStream_t stream) {
  constexpr auto kernel = shear_resample_bwd_cols<T, G, RB>;
  int room = 0;
  cudaError_t err = allow_dynamic_smem<kernel>(&room);
  if (err != cudaSuccess) return (int)err;
  const HLayout<T> h(a.L, a.lines, RB);
  if (h.bytes > room) return (int)cudaErrorInvalidValue;
  // ceil(lines / 1024) lines a thread, spread evenly over whole warps
  const int each = (a.lines + 1023) / 1024;
  const int threads = ((a.lines + each - 1) / each + 31) / 32 * 32;
  // as many blocks as fit on the card at once, each an even share of the rows
  int dev = 0, sms = 0, fit = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fit, kernel, threads, h.bytes)) !=
          cudaSuccess)
    return (int)err;
  const int64_t rows = (int64_t)N * a.C * a.R, groups = (rows + RB - 1) / RB;
  const int64_t slots = (int64_t)sms * (fit > 0 ? fit : 1);
  const int64_t per = (groups + (groups < slots ? groups : slots) - 1) /
                      (groups < slots ? groups : slots) * RB;
  kernel<<<(unsigned)((rows + per - 1) / per), threads, h.bytes, stream>>>(a, N, per);
  return (int)cudaGetLastError();
}

// Groups of 16 bytes of rows (8 bf16, 4 float32) where they fit in shared
// memory (up to 1048^2 -> 1036^2 in either dtype), else of a quarter of that.
template <typename T, int G>
int start_cols(int N, const Bwd& a, cudaStream_t stream) {
  constexpr int RB = HLayout<T>::RB;
  const int e = start_cols_rb<T, G, RB>(N, a, stream);
  return e == (int)cudaErrorInvalidValue ? start_cols_rb<T, G, RB / 4 ? RB / 4 : 1>(N, a, stream)
                                         : e;
}

template <typename T>
int start_typed(int axis, int N, const Bwd& a, cudaStream_t stream) {
  // the widest vector at which every row of dx (and in pass V of dz) starts aligned
  auto fits = [&](int b) {
    bool ok = (uintptr_t)a.dx % b == 0 && (int64_t)a.out_s * (int64_t)sizeof(T) % b == 0;
    if (axis == 0) ok = ok && (uintptr_t)a.dz % b == 0;
    return ok;
  };
  constexpr int G16 = 16 / sizeof(T), G8 = 8 / sizeof(T);
  if (axis == 0) {
    if (fits(16)) return start_rows<T, G16>(N, a, stream);
    if (fits(8)) return start_rows<T, G8>(N, a, stream);
    return start_rows<T, 1>(N, a, stream);
  }
  if (fits(16)) return start_cols<T, G16>(N, a, stream);
  if (fits(8)) return start_cols<T, G8>(N, a, stream);
  return start_cols<T, 1>(N, a, stream);
}

}  // namespace

// dtype (of dz and dx): 0 = float32, 1 = bfloat16. dz is [planes, R, S] and
// dx [planes, out_r, out_s], both contiguous; i0, i1, w0, w1 are the
// forward's taps [planes / C, L] (int32 source lines, float32 weights), L
// dz's length along the axis; axis 0: out_s == S, the taps index [0,
// out_r), rot is null or [planes / C] (then out_r == S); axis 1: out_r ==
// R, the taps index [0, out_s), rot is null. A block's lists have room for
// all 2 L taps of its sample in dynamic shared memory: 16 L bytes along
// rows, beside the static 27 KB (L up to about 12,800), and along columns
// beside a ring of staged rows and a group of dx (L up to about 6,800 where
// the source has L / 2 lines, as a warp's); larger L returns
// cudaErrorInvalidValue. Every element of dx is written. planes / C and
// ceil(out_r / 32) are at most 65535.
extern "C" int shear_resample_bwd(const void* dz, void* dx, const int* i0, const int* i1,
                                  const float* w0, const float* w1, const unsigned char* rot,
                                  int dtype, int axis, int planes, int C, int R, int S, int out_r,
                                  int out_s, void* stream) {
  if (dtype < 0 || dtype > 1 || axis < 0 || axis > 1 || C <= 0 || planes % C != 0 ||
      (axis == 1 && rot != nullptr))
    return (int)cudaErrorInvalidValue;
  const Bwd a{dz, dx, i0, i1, w0, w1, rot, C, R, S, out_r, out_s, axis == 0 ? R : S,
              axis == 0 ? out_r : out_s};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? start_typed<float>(axis, planes / C, a, s)
                    : start_typed<__nv_bfloat16>(axis, planes / C, a, s);
}
