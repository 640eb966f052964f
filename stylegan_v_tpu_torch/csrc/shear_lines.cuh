// What the shear warp's kernels share: the tiled line kernel that the fused
// pass (shear_pass.cu, K7) and the shift (shear_shift.cu, K8) instantiate,
// and the loads in float32 or bfloat16 and the vector type, which the
// resample's adjoint (shear_resample_bwd.cu, K7-bwd) also uses.
//
// Each kernel maps NCHW planes [R, S] (the input) to planes [out_r, out_s]
// (the output) along one axis: AXIS 0 (pass V) runs along the rows (dim 2),
// AXIS 1 (pass H) along the columns (dim 3). Plane p belongs to sample
// p / C, whose tables it reads. A kernel takes its tensors as untyped
// pointers, so that its instantiations (float32 or bfloat16, AXIS 0 or 1)
// share one signature and its C entry point picks one.
//
// The fused pass and K8 are `line_kernel`: a block is one tile
// of outputs of one plane. It stages in shared memory the window of z, the
// stage-1 lines that its outputs' shifts read, as the payload dtype:
//
//   fused pass: z[j] = w0t[j] x[i0[j]] + w1t[j] x[i1[j]] (stage 1, the
//               resample; pass V reads a rot90 sample's x through its map
//               x'[r, c] = x[c, S - 1 - r]);
//   K8:         z[j] = x[j], zero outside [0, L).
//
// and then writes y[i] = w0[l] z[start[l] + i] + w1[l] z[start[l] + i + 1]
// (stage 2, the shift of line l), G outputs a thread stored as one vector
// of G elements along the contiguous axis (16 or 8 bytes where every row
// of y, and in pass V of x, starts on such a boundary; else one element).
//
// Pass V: a tile is V_TR rows x V_TS columns, the lines are the columns and
// each has its own start. The window is the z rows from the tile's least
// start plus its first row to its greatest start plus its last row plus 1,
// spread + rows + 1 rows; ops/shear_warp.py:tile_windows computes it as
// the kernel does. The plan's conditioning (|c1| <= 1, |d1| >= 1 /
// SCALE_MAX) keeps a start within SCALE_MAX rows of its neighbour's, so
// the spread of V_TS columns is at most SCALE_MAX (V_TS - 1) + 2 rows with
// the floors' rounding: the window holds V_JW rows. The wrapper refuses
// tables that make no such promise; a larger window traps.
//
// Pass H: a tile is H_TR rows x H_TS columns, the lines are the rows, and
// each row's window is its own H_TS + 1 elements of z.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <limits.h>
#include <stdint.h>
#include <string.h>

namespace shear {

constexpr int SCALE_MAX = 4;                          // ops/shear_warp.py:SCALE_MAX
constexpr int THREADS = 256;                          // line_kernel's block
constexpr int V_TR = 64, V_TS = 32;                   // pass V tile: rows, columns
constexpr int V_JW = V_TR + SCALE_MAX * (V_TS - 1) + 2 + 1;   // window rows: 191
constexpr int H_TR = 32, H_TS = 64;                   // pass H tile: rows, columns

__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// w0 v0 + w1 v1, each product and the sum rounded on its own (no fused
// multiply-add): the plain version's arithmetic, so the two agree to the bit.
__device__ __forceinline__ float two_taps(float w0, float v0, float w1, float v1) {
  return __fadd_rn(__fmul_rn(w0, v0), __fmul_rn(w1, v1));
}

// G neighbouring elements, moved as one access of G * sizeof(T) bytes.
template <typename T, int G>
struct alignas(G * sizeof(T)) Vec {
  T v[G];
};

// G neighbouring elements from p, which is aligned to their G * sizeof(T)
// bytes, as one load through the read-only path.
template <typename T, int G>
__device__ __forceinline__ Vec<T, G> ldg_vec(const T* p) {
  constexpr int B = G * (int)sizeof(T);
  Vec<T, G> v;
  if constexpr (B == 16) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    memcpy(&v, &u, B);
  } else if constexpr (B == 8) {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
    memcpy(&v, &u, B);
  } else if constexpr (B == 4) {
    const unsigned u = __ldg(reinterpret_cast<const unsigned*>(p));
    memcpy(&v, &u, B);
  } else {
    static_assert(B == 2, "a vector of 2, 4, 8 or 16 bytes");
    const unsigned short u = __ldg(reinterpret_cast<const unsigned short*>(p));
    memcpy(&v, &u, B);
  }
  return v;
}

// The tensors and tables of one line_kernel launch.
struct Lines {
  const void* x;                  // the input [planes, R, S]
  void* y;                        // the output [planes, out_r, out_s]
  const int* i0;                  // fused: stage 1's taps [N, L] (i0, i1, tw0, tw1); K8: null
  const int* i1;
  const float* tw0;
  const float* tw1;
  const unsigned char* rot;       // fused pass V: [N], nonzero reads x through rot90; or null
  const int* start;               // stage 2's shift [N, lines] (start, w0, w1)
  const float* w0;
  const float* w1;
  int C, R, S, out_r, out_s;
  int L;                          // z's length along the axis
};

template <typename T, int G, bool FUSED>
__global__ void __launch_bounds__(THREADS) line_kernel_v(Lines a) {
  constexpr int PITCH = V_TS + 4 / (int)sizeof(T);    // an odd number of words a row
  constexpr int GROUPS = V_TS / G;                     // threads along a row of the tile
  __shared__ T zs[V_JW * PITCH];
  __shared__ int bounds[2];
  const T* x = static_cast<const T*>(a.x) + (int64_t)blockIdx.z * a.R * a.S;
  T* y = static_cast<T*>(a.y) + (int64_t)blockIdx.z * a.out_r * a.out_s;
  const int n = blockIdx.z / a.C;
  const int s_lo = blockIdx.x * V_TS, i_lo = blockIdx.y * V_TR;
  const int width = min(V_TS, a.out_s - s_lo), rows = min(V_TR, a.out_r - i_lo);
  const int* start = a.start + (int64_t)n * a.out_s + s_lo;
  if (threadIdx.x < 32) {                              // the tile's least and greatest start
    const int lane = threadIdx.x;
    int lo = lane < width ? __ldg(start + lane) : INT_MAX;
    int hi = lane < width ? __ldg(start + lane) : INT_MIN;
    for (int o = 16; o > 0; o >>= 1) {
      lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
      hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
    }
    if (lane == 0) bounds[0] = lo, bounds[1] = hi;
  }
  __syncthreads();
  const int lo = bounds[0], j0 = lo + i_lo, count = bounds[1] - lo + rows + 1;
  if (count > V_JW) __trap();

  // the window: z rows j0 .. j0 + count - 1 of the tile's columns
  const int64_t tab = (int64_t)n * a.L;
  if (FUSED && a.rot != nullptr && a.rot[n]) {
    // x'[r, c] = x[c, S - 1 - r]: threads run along the window, whose
    // neighbouring rows read neighbouring elements of one row of x
    for (int t = threadIdx.x; t < count * width; t += THREADS) {
      const int c = t / count, jj = t - c * count, j = j0 + jj;
      float v = 0.0f;
      if (j >= 0 && j < a.L) {
        const T* row = x + (int64_t)(s_lo + c) * a.S + (a.S - 1);
        v = two_taps(__ldg(a.tw0 + tab + j), load(row - __ldg(a.i0 + tab + j)),
                     __ldg(a.tw1 + tab + j), load(row - __ldg(a.i1 + tab + j)));
      }
      zs[jj * PITCH + c] = from_f<T>(v);
    }
  } else {
    for (int t = threadIdx.x; t < count * GROUPS; t += THREADS) {
      const int jj = t / GROUPS, c = (t - jj * GROUPS) * G, j = j0 + jj;
      Vec<T, G> v;
      if (c < width && j >= 0 && j < a.L) {
        if (FUSED) {
          const Vec<T, G> u0 = *reinterpret_cast<const Vec<T, G>*>(
              x + (int64_t)__ldg(a.i0 + tab + j) * a.S + s_lo + c);
          const Vec<T, G> u1 = *reinterpret_cast<const Vec<T, G>*>(
              x + (int64_t)__ldg(a.i1 + tab + j) * a.S + s_lo + c);
          const float w0 = __ldg(a.tw0 + tab + j), w1 = __ldg(a.tw1 + tab + j);
#pragma unroll
          for (int g = 0; g < G; ++g)
            v.v[g] = from_f<T>(two_taps(w0, to_f(u0.v[g]), w1, to_f(u1.v[g])));
        } else {
          v = *reinterpret_cast<const Vec<T, G>*>(x + (int64_t)j * a.S + s_lo + c);
        }
      } else {
#pragma unroll
        for (int g = 0; g < G; ++g) v.v[g] = from_f<T>(0.0f);
      }
#pragma unroll
      for (int g = 0; g < G; ++g) zs[jj * PITCH + c + g] = v.v[g];
    }
  }
  __syncthreads();

  // the shift: this thread's G columns, every GROUPS-th row of the tile
  const int c = (threadIdx.x % GROUPS) * G;
  if (c >= width) return;
  int off[G];
  float w0[G], w1[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const int64_t k = (int64_t)n * a.out_s + s_lo + c + g;
    off[g] = __ldg(a.start + k) - lo;
    w0[g] = __ldg(a.w0 + k);
    w1[g] = __ldg(a.w1 + k);
  }
  for (int ii = threadIdx.x / GROUPS; ii < rows; ii += THREADS / GROUPS) {
    Vec<T, G> o;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const T* z = zs + (off[g] + ii) * PITCH + c + g;
      o.v[g] = from_f<T>(two_taps(w0[g], to_f(z[0]), w1[g], to_f(z[PITCH])));
    }
    *reinterpret_cast<Vec<T, G>*>(y + (int64_t)(i_lo + ii) * a.out_s + s_lo + c) = o;
  }
}

template <typename T, int G, bool FUSED>
__global__ void __launch_bounds__(THREADS) line_kernel_h(Lines a) {
  constexpr int PITCH = H_TS + 1;
  constexpr int GROUPS = H_TS / G;
  __shared__ T zs[H_TR * PITCH];
  const T* x = static_cast<const T*>(a.x) + (int64_t)blockIdx.z * a.R * a.S;
  T* y = static_cast<T*>(a.y) + (int64_t)blockIdx.z * a.out_r * a.out_s;
  const int n = blockIdx.z / a.C;
  const int s_lo = blockIdx.x * H_TS, r_lo = blockIdx.y * H_TR;
  const int width = min(H_TS, a.out_s - s_lo), rows = min(H_TR, a.out_r - r_lo);
  const int64_t tab = (int64_t)n * a.L;

  // the windows: warp w fills rows w, w + 8, ...; row r's is z[start[r] + s_lo + t],
  // t = 0 .. width, lanes along t
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if constexpr (FUSED) {
    for (int ii = warp; ii < rows; ii += THREADS / 32) {
      const int r = r_lo + ii;
      const int first = __ldg(a.start + (int64_t)n * a.R + r) + s_lo;
      const T* line = x + (int64_t)r * a.S;
      for (int t = lane; t <= width; t += 32) {
        const int j = first + t;
        float v = 0.0f;
        if (j >= 0 && j < a.L)
          v = two_taps(__ldg(a.tw0 + tab + j), load(line + __ldg(a.i0 + tab + j)),
                       __ldg(a.tw1 + tab + j), load(line + __ldg(a.i1 + tab + j)));
        zs[ii * PITCH + t] = from_f<T>(v);
      }
    }
  } else {
    // every load of this thread first, then the stores: KR x KU loads in flight
    constexpr int KR = H_TR / (THREADS / 32), KU = H_TS / 32 + 1;
    T v[KR][KU];
#pragma unroll
    for (int k = 0; k < KR; ++k) {
      const int ii = warp + k * (THREADS / 32);
      const int r = r_lo + min(ii, rows - 1);
      const int first = __ldg(a.start + (int64_t)n * a.R + r) + s_lo;
      const T* line = x + (int64_t)r * a.S;
#pragma unroll
      for (int u = 0; u < KU; ++u) {
        const int t = lane + 32 * u, j = first + t;
        v[k][u] = ii < rows && t <= width && j >= 0 && j < a.L ? line[j] : from_f<T>(0.0f);
      }
    }
#pragma unroll
    for (int k = 0; k < KR; ++k) {
#pragma unroll
      for (int u = 0; u < KU; ++u) {
        const int ii = warp + k * (THREADS / 32), t = lane + 32 * u;
        if (ii < rows && t <= width) zs[ii * PITCH + t] = v[k][u];
      }
    }
  }
  __syncthreads();

  // the shift: G columns of every (THREADS / GROUPS)-th row
  const int c = (threadIdx.x % GROUPS) * G;
  if (c >= width) return;
  for (int ii = threadIdx.x / GROUPS; ii < rows; ii += THREADS / GROUPS) {
    const int64_t k = (int64_t)n * a.R + r_lo + ii;
    const float w0 = __ldg(a.w0 + k), w1 = __ldg(a.w1 + k);
    const T* z = zs + ii * PITCH + c;
    Vec<T, G> o;
#pragma unroll
    for (int g = 0; g < G; ++g) o.v[g] = from_f<T>(two_taps(w0, to_f(z[g]), w1, to_f(z[g + 1])));
    *reinterpret_cast<Vec<T, G>*>(y + (int64_t)(r_lo + ii) * a.out_s + s_lo + c) = o;
  }
}

// The widest access, 16 or 8 bytes, at which every row of y (and in pass V
// every row of x, which has y's length) starts on a boundary; else 0.
inline int vector_bytes(const Lines& a, int axis, int esize) {
  for (int b = 16; b >= 8; b /= 2) {
    bool ok = (uintptr_t)a.y % b == 0 && (int64_t)a.out_s * esize % b == 0;
    if (axis == 0) ok = ok && (uintptr_t)a.x % b == 0 && (int64_t)a.S * esize % b == 0;
    if (ok) return b;
  }
  return 0;
}

template <bool FUSED, typename T, int G>
int start_grid(int axis, int planes, const Lines& a, cudaStream_t stream) {
  if (axis == 0) {
    const dim3 grid((a.out_s + V_TS - 1) / V_TS, (a.out_r + V_TR - 1) / V_TR, planes);
    line_kernel_v<T, G, FUSED><<<grid, THREADS, 0, stream>>>(a);
  } else {
    const dim3 grid((a.out_s + H_TS - 1) / H_TS, (a.out_r + H_TR - 1) / H_TR, planes);
    line_kernel_h<T, G, FUSED><<<grid, THREADS, 0, stream>>>(a);
  }
  return (int)cudaGetLastError();
}

template <bool FUSED, typename T>
int start_typed(int axis, int planes, const Lines& a, cudaStream_t stream) {
  switch (vector_bytes(a, axis, sizeof(T))) {
    case 16: return start_grid<FUSED, T, 16 / sizeof(T)>(axis, planes, a, stream);
    case 8: return start_grid<FUSED, T, 8 / sizeof(T)>(axis, planes, a, stream);
    default: return start_grid<FUSED, T, 1>(axis, planes, a, stream);
  }
}

// Starts line_kernel for dtype (0 = float32, 1 = bfloat16) and axis on
// stream; returns cudaGetLastError(), or cudaErrorInvalidValue for a dtype
// or axis out of range. Does not synchronise.
template <bool FUSED>
int launch_lines(int dtype, int axis, int planes, const Lines& a, cudaStream_t stream) {
  if (axis != 0 && axis != 1) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return start_typed<FUSED, float>(axis, planes, a, stream);
  if (dtype == 1) return start_typed<FUSED, __nv_bfloat16>(axis, planes, a, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace shear
