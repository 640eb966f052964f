// The adjoint of the fused 2x FIR downsample: a 2x FIR upsample, NCHW, for
// Hopper (sm_90a).
//
// The JAX package has no kernel for this: jax.grad derives the gradient of
// stylegan_v_tpu/ops/pallas_kernels.py:downfirdn2d_x2 (the TPU kernel that
// csrc/downfirdn2d_x2.cu replaces). The forward kernel computes
//
//   y[n,c,ho,wo] = sum_{ky,kx} fk[ky][kx] * x[n,c,2ho-1+ky,2wo-1+kx]
//
// so its adjoint scatters each dy[ho,wo] back through the same taps:
//
//   dx[n,c,iy,ix] = sum over 2ho-1+ky = iy, 2wo-1+kx = ix of fk[ky][kx] * dy[n,c,ho,wo]
//
// with fk the filter flipped in both axes (the caller passes it flipped, as
// to the forward kernel), gain 1, and dy taken as zero outside [0,Ho)x[0,Wo).
// Each output receives exactly 2x2 of the 16 taps, by the parity of its row
// and column: for the quad of outputs dx[2Y..2Y+1][2X..2X+1],
//
//   dx[2Y  ][2X  ] = f11 d[Y][X]   + f13 d[Y][X-1]   + f31 d[Y-1][X]   + f33 d[Y-1][X-1]
//   dx[2Y  ][2X+1] = f10 d[Y][X+1] + f12 d[Y][X]     + f30 d[Y-1][X+1] + f32 d[Y-1][X]
//   dx[2Y+1][2X  ] = f01 d[Y+1][X] + f03 d[Y+1][X-1] + f21 d[Y][X]     + f23 d[Y][X-1]
//   dx[2Y+1][2X+1] = f00 d[Y+1][X+1] + f02 d[Y+1][X] + f20 d[Y][X+1]   + f22 d[Y][X]
//
// with fRC = fk[R][C] and d = dy. The sum is float32, in the order written;
// the result is stored in the input dtype (float32, or bfloat16 rounded to
// nearest even). It equals conv_transpose2d(dy, fk, stride=2, padding=1) per
// channel.
//
// Bound: HBM. It reads N*C*H*W/4 elements and writes four times that, for 4
// multiply-adds per output. Design (the tile plan is
// ops/fir_kernels.py:fir_plan, see fir_tile.cuh), K1's transposed:
// - A block copies a (tile_h + 2) x (tile_w + 2*pad) dy window, halo and
//   zeros outside the plane included, into shared memory by 16-byte
//   cp.async; persistent blocks overlap the next tile's copy with this
//   tile's sums (two stages).
// - A thread computes 2 dy rows x 16/2 bytes of quads (4 quads in bf16, 2 in
//   f32), so every dx row it writes is one 16-byte vector, from four window
//   rows read as 8-byte vectors; every tap index is fixed at compile time.
// - Planes with at most 16 bytes' worth of quads a row are packed several to
//   a tile, so that every lane has work; no integer division per element.
// Shapes whose rows are not whole 16-byte vectors (or a misaligned dy) take
// the same plan with element-wise copies and stores.
//
// The C entry point launches on the given stream, does not synchronise,
// allocates nothing and returns the CUDA error of the launch.

#include "fir_tile.cuh"

namespace {

using fir::Filter4x4;
using fir::Plan;
using fir::Tile;

template <typename T, bool VEC>
__global__ void __launch_bounds__(FIR_MAX_THREADS)
    downfirdn2d_x2_bwd_kernel(const T* __restrict__ dy, T* __restrict__ dx, const Filter4x4 f,
                              const Plan pl) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int Q = 8 / (int)sizeof(T);  // quads per thread and dy row
  const int cx = threadIdx.x % pl.nx, rest = threadIdx.x / pl.nx;
  const int cy = rest % pl.ny, cp = rest / pl.ny;
  const int Ho = pl.grid_h, Wo = pl.grid_w, W = 2 * Wo;
  fir::tile_loop<T, VEC, false>(dy, pl, smem, [&](const Tile& tl, const T* sw) {
    const int64_t plane = tl.plane0 + cp;
    const int Y0 = tl.h0 + 2 * cy, X0 = tl.w0 + Q * cx;
    if (plane >= pl.planes || Y0 >= Ho || X0 >= Wo) return;
    // window row of dy row Y0 - 1 + r: 2cy + r; column of X0 - 1 + k: Q cx + pad - 1 + k
    const T* s = sw + ((size_t)cp * pl.win_h + 2 * cy) * pl.row_stride + Q * cx + pl.pad - 1;
    float d[4][Q + 2];
#pragma unroll
    for (int r = 0; r < 4; ++r) fir::load_row<T, VEC, Q + 2, 8>(s + r * pl.row_stride, d[r]);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int Y = Y0 + i;
      if (Y >= Ho) break;
      const float* m = d[i];      // d[Y-1][X0-1 ..]
      const float* z = d[i + 1];  // d[Y][..]
      const float* p = d[i + 2];  // d[Y+1][..]
      float top[2 * Q], bot[2 * Q];
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const float mm = m[q], m0 = m[q + 1], mp = m[q + 2];
        const float zm = z[q], z0 = z[q + 1], zp = z[q + 2];
        const float pm = p[q], p0 = p[q + 1], pp = p[q + 2];
        float a = 0.f, b = 0.f;
        a += f.v[5] * z0;  a += f.v[7] * zm;  a += f.v[13] * m0;  a += f.v[15] * mm;
        b += f.v[4] * zp;  b += f.v[6] * z0;  b += f.v[12] * mp;  b += f.v[14] * m0;
        top[2 * q] = a;
        top[2 * q + 1] = b;
        a = 0.f;
        b = 0.f;
        a += f.v[1] * p0;  a += f.v[3] * pm;  a += f.v[9] * z0;   a += f.v[11] * zm;
        b += f.v[0] * pp;  b += f.v[2] * p0;  b += f.v[8] * zp;   b += f.v[10] * z0;
        bot[2 * q] = a;
        bot[2 * q + 1] = b;
      }
      T* out = dx + (plane * 2 * Ho + 2 * Y) * (int64_t)W + 2 * X0;
      fir::store_run<T, VEC, 2 * Q>(out, top, W - 2 * X0);
      fir::store_run<T, VEC, 2 * Q>(out + W, bot, W - 2 * X0);
    }
  });
}

template <typename T, bool VEC>
cudaError_t launch(const void* dy, void* dx, const Filter4x4& f, const Plan& pl,
                   cudaStream_t stream) {
  auto kernel = downfirdn2d_x2_bwd_kernel<T, VEC>;
  const int smem = 2 * pl.stage_bytes;
  cudaError_t err = fir::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<pl.grid, pl.threads, smem, stream>>>(static_cast<const T*>(dy),
                                                 static_cast<T*>(dx), f, pl);
  return cudaGetLastError();
}

template <typename T, bool VEC>
cudaError_t occupancy(int threads, int smem, int* blocks) {
  auto kernel = downfirdn2d_x2_bwd_kernel<T, VEC>;
  cudaError_t err = fir::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, threads, smem);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. f_flipped: 16 host floats, row-major,
// already flipped. plan: the int64 plan of ops/fir_kernels.py:fir_plan for
// dy [planes, Ho, Wo], contiguous; dx is [planes, 2Ho, 2Wo].
extern "C" int downfirdn2d_x2_bwd(const void* dy, void* dx, const float* f_flipped, int dtype,
                                  const int64_t* plan, void* stream) {
  Filter4x4 f;
  for (int i = 0; i < 16; ++i) f.v[i] = f_flipped[i];
  const int64_t size = dtype == 0 ? 4 : 2;   // the runs the kernel is written for
  if (plan[fir::kRunH] != 2 || plan[fir::kRunW] * size != 8) return (int)cudaErrorInvalidValue;
  const Plan pl = fir::read_plan(plan);
  const bool vec = plan[fir::kVec] != 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)(vec ? launch<float, true>(dy, dx, f, pl, s)
                                   : launch<float, false>(dy, dx, f, pl, s));
  if (dtype == 1) return (int)(vec ? launch<__nv_bfloat16, true>(dy, dx, f, pl, s)
                                   : launch<__nv_bfloat16, false>(dy, dx, f, pl, s));
  return (int)cudaErrorInvalidValue;
}

// Blocks of `threads` threads and 2 * stage_bytes of shared memory that one
// SM holds at once, for the plan's persistent grid.
extern "C" int downfirdn2d_x2_bwd_occupancy(int dtype, int vec, int threads, int stage_bytes,
                                            int* blocks) {
  const int smem = 2 * stage_bytes;
  if (dtype == 0) return (int)(vec ? occupancy<float, true>(threads, smem, blocks)
                                   : occupancy<float, false>(threads, smem, blocks));
  if (dtype == 1) return (int)(vec ? occupancy<__nv_bfloat16, true>(threads, smem, blocks)
                                   : occupancy<__nv_bfloat16, false>(threads, smem, blocks));
  return (int)cudaErrorInvalidValue;
}
