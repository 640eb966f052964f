// Fused 2x FIR downsample, NCHW, for Hopper (sm_90a).
//
// Replaces stylegan_v_tpu/ops/pallas_kernels.py:downfirdn2d_x2, the TPU
// kernel. Computes what it computes, i.e. upfirdn2d(x, f, down=2,
// padding=[1,1,1,1]) with a 4x4 filter as a true convolution:
//
//   y[n,c,ho,wo] = sum_{ky,kx} fk[ky][kx] * x[n,c,2ho-1+ky,2wo-1+kx]
//
// with fk = f flipped in both axes (the caller passes it flipped), zeros
// outside the image, a float32 sum over ky then kx, and a result in the input
// dtype (float32 or bfloat16, rounded to nearest even).
//
// Bound: HBM. It reads N*C*H*W elements and writes a quarter of that, for 16
// multiply-adds per output (in bf16, 10 bytes per 16 FMAs): the tensor cores
// have nothing to do, and the work is to move each byte once at full width.
// Design (the tile plan is ops/fir_kernels.py:fir_plan, see fir_tile.cuh):
// - A block copies a tile's input window, (2*tile_h + 2) x (2*tile_w + 2*pad)
//   with the halo and the zeros outside the plane, into shared memory by
//   16-byte cp.async; persistent blocks keep the next tile's copy in flight
//   (two stages) while they sum this one, as the TPU kernel streams row bands
//   with a halo into VMEM (pallas_kernels.py:44-69).
// - A thread computes 2 output rows x 16 bytes of outputs (8 bf16 or 4 f32)
//   from six window rows read as 16-byte vectors, with the 16 taps in
//   registers, and stores each output row as one 16-byte vector. The window
//   rows are swizzled in shared memory, so that these reads, 32 bytes apart
//   from thread to thread, meet no bank conflict.
// - Tile and thread coordinates come from the loop counter and threadIdx,
//   divided once per tile and once per thread, not per element.
// - Planes with at most 16 outputs a row are packed several to a tile, so
//   that every lane has work.
// Shapes whose rows are not whole 16-byte vectors (or a misaligned x) take
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
    downfirdn2d_x2_kernel(const T* __restrict__ x, T* __restrict__ y, const Filter4x4 f,
                          const Plan pl) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int RUN = 16 / (int)sizeof(T);  // outputs per thread and row
  constexpr int N = 2 * RUN + 2;            // input columns they read
  const int cx = threadIdx.x % pl.nx, rest = threadIdx.x / pl.nx;
  const int cy = rest % pl.ny, cp = rest / pl.ny;
  const int Ho = pl.grid_h, Wo = pl.grid_w;
  fir::tile_loop<T, VEC, VEC>(x, pl, smem, [&](const Tile& tl, const T* sw) {
    const int64_t plane = tl.plane0 + cp;
    const int ho = tl.h0 + 2 * cy, wo = tl.w0 + RUN * cx;
    if (plane >= pl.planes || ho >= Ho || wo >= Wo) return;
    // window row of input row 2ho - 1 + ky: 4cy + ky; column of 2wo - 1 + kx:
    // 2 RUN cx + pad - 1 + kx, i.e. (VEC, pad = RUN) element RUN - 1 + kx of
    // chunk 2cx on
    const T* s = sw + ((size_t)cp * pl.win_h + 4 * cy) * pl.row_stride;
    float acc0[RUN], acc1[RUN];
#pragma unroll
    for (int j = 0; j < RUN; ++j) acc0[j] = acc1[j] = 0.f;
#pragma unroll
    for (int r = 0; r < 6; ++r) {
      float v[N];
      if constexpr (VEC) {
        fir::load_row_swizzled<T, N>(s + r * pl.row_stride, 2 * cx, v);
      } else {
        fir::load_row<T, false, N, 16>(s + r * pl.row_stride + 2 * RUN * cx + pl.pad - 1, v);
      }
      if (r < 4) {
#pragma unroll
        for (int j = 0; j < RUN; ++j)
#pragma unroll
          for (int kx = 0; kx < 4; ++kx) acc0[j] += f.v[r * 4 + kx] * v[2 * j + kx];
      }
      if (r >= 2) {
#pragma unroll
        for (int j = 0; j < RUN; ++j)
#pragma unroll
          for (int kx = 0; kx < 4; ++kx) acc1[j] += f.v[(r - 2) * 4 + kx] * v[2 * j + kx];
      }
    }
    T* out = y + (plane * Ho + ho) * (int64_t)Wo + wo;
    fir::store_run<T, VEC, RUN>(out, acc0, Wo - wo);
    if (ho + 1 < Ho) fir::store_run<T, VEC, RUN>(out + Wo, acc1, Wo - wo);
  });
}

template <typename T, bool VEC>
cudaError_t launch(const void* x, void* y, const Filter4x4& f, const Plan& pl,
                   cudaStream_t stream) {
  auto kernel = downfirdn2d_x2_kernel<T, VEC>;
  const int smem = 2 * pl.stage_bytes;
  cudaError_t err = fir::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<pl.grid, pl.threads, smem, stream>>>(static_cast<const T*>(x), static_cast<T*>(y),
                                                 f, pl);
  return cudaGetLastError();
}

template <typename T, bool VEC>
cudaError_t occupancy(int threads, int smem, int* blocks) {
  auto kernel = downfirdn2d_x2_kernel<T, VEC>;
  cudaError_t err = fir::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, threads, smem);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. f_flipped: 16 host floats, row-major,
// already flipped. plan: the int64 plan of ops/fir_kernels.py:fir_plan for
// x [planes, H, W] (even H and W), contiguous; y is [planes, H/2, W/2].
extern "C" int downfirdn2d_x2(const void* x, void* y, const float* f_flipped, int dtype,
                              const int64_t* plan, void* stream) {
  Filter4x4 f;
  for (int i = 0; i < 16; ++i) f.v[i] = f_flipped[i];
  const int64_t size = dtype == 0 ? 4 : 2;   // the runs the kernel is written for
  if (plan[fir::kRunH] != 2 || plan[fir::kRunW] * size != 16) return (int)cudaErrorInvalidValue;
  const Plan pl = fir::read_plan(plan);
  const bool vec = plan[fir::kVec] != 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)(vec ? launch<float, true>(x, y, f, pl, s)
                                   : launch<float, false>(x, y, f, pl, s));
  if (dtype == 1) return (int)(vec ? launch<__nv_bfloat16, true>(x, y, f, pl, s)
                                   : launch<__nv_bfloat16, false>(x, y, f, pl, s));
  return (int)cudaErrorInvalidValue;
}

// Blocks of `threads` threads and 2 * stage_bytes of shared memory that one
// SM holds at once, for the plan's persistent grid.
extern "C" int downfirdn2d_x2_occupancy(int dtype, int vec, int threads, int stage_bytes,
                                        int* blocks) {
  const int smem = 2 * stage_bytes;
  if (dtype == 0) return (int)(vec ? occupancy<float, true>(threads, smem, blocks)
                                   : occupancy<float, false>(threads, smem, blocks));
  if (dtype == 1) return (int)(vec ? occupancy<__nv_bfloat16, true>(threads, smem, blocks)
                                   : occupancy<__nv_bfloat16, false>(threads, smem, blocks));
  return (int)cudaErrorInvalidValue;
}
