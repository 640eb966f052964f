// The adjoint of the bilinear affine warp (K4-bwd), NCHW, for Hopper (sm_90a).
//
// The JAX package has no kernel for it: jax.grad derives the gradient of
// stylegan_v_tpu/ops/grid_sample.py:affine_grid_sample (an XLA gather,
// whose transpose is a scatter-add into the packed [B, H*W, 4C] neighbourhood
// and then into the edge-padded image). This kernel is the exact transpose
// of K4 (affine_warp.cu), with the same geometry (affine_warp.cuh):
//
//   dx[n,c,y_i,x_j] += w_ij * dy[n,c,oy,ox]   for the 4 taps of (oy, ox),
//   w00 = (1-wy)(1-wx), w01 = (1-wy) wx, w10 = wy (1-wx), w11 = wy wx
//
// computed as (dy (1-wy)) (1-wx) etc., the order of JAX's vjp, and nothing
// for a pixel outside the image in zeros mode. Two taps that the border
// clip puts on one pixel both add to it.
//
// Bound: atomics and memory. One thread takes one output pixel for every
// channel (the geometry once, reused C times) and adds its 4 products to dx
// with float32 atomicAdd, which the L2 resolves; neighbouring output pixels
// hit neighbouring input pixels, so a few threads contend per address. dx is
// a float32 buffer zeroed by the caller (for a bfloat16 gradient the caller
// rounds it once at the end), so every sum is float32, in an order that
// changes from run to run. A gather formulation without atomics needs the
// inverse map's footprint per input pixel: later work.
//
// The C entry point launches on the given stream, does not synchronise,
// allocates nothing and returns cudaGetLastError().

#include "affine_warp.cuh"

namespace {

using namespace warp_geom;

template <typename T>
__global__ void affine_warp_bwd_kernel(const T* __restrict__ dy, const float* __restrict__ G_inv,
                                       float* __restrict__ dx, const int C, const int H,
                                       const int W, const int out_h, const int out_w,
                                       const bool zeros) {
  const int ox = blockIdx.x * blockDim.x + threadIdx.x;
  const int oy = blockIdx.y;
  const int n = blockIdx.z;
  if (ox >= out_w) return;
  const Taps t = taps_at(G_inv + 9 * n, ox, oy, H, W, out_h, out_w, zeros);
  if (!t.inside) return;
  const float omx = __fsub_rn(1.0f, t.wx), omy = __fsub_rn(1.0f, t.wy);
  const int64_t in_plane = (int64_t)H * W, out_plane = (int64_t)out_h * out_w;
  const T* src = dy + (int64_t)n * C * out_plane + (int64_t)oy * out_w + ox;
  float* dst = dx + (int64_t)n * C * in_plane;
  for (int c = 0; c < C; ++c, src += out_plane, dst += in_plane) {
    const float d = load_f32(src);
    const float dtop = __fmul_rn(d, omy), dbot = __fmul_rn(d, t.wy);
    atomicAdd(dst + t.o00, __fmul_rn(dtop, omx));
    atomicAdd(dst + t.o01, __fmul_rn(dtop, t.wx));
    atomicAdd(dst + t.o10, __fmul_rn(dbot, omx));
    atomicAdd(dst + t.o11, __fmul_rn(dbot, t.wx));
  }
}

template <typename T>
void launch(const void* dy, const float* G_inv, float* dx, int N, int C, int H, int W, int out_h,
            int out_w, bool zeros, cudaStream_t stream) {
  const int threads = out_w >= 128 ? 128 : 32 * ((out_w + 31) / 32);
  const dim3 grid((out_w + threads - 1) / threads, out_h, N);
  affine_warp_bwd_kernel<T><<<grid, threads, 0, stream>>>(
      static_cast<const T*>(dy), G_inv, dx, C, H, W, out_h, out_w, zeros);
}

}  // namespace

// dtype (of dy): 0 = float32, 1 = bfloat16. mode: 0 = reflect, 1 = zeros.
// dy is [N, C, out_h, out_w], contiguous; dx is [N, C, H, W] float32,
// contiguous and zeroed; G_inv is [N, 3, 3] float32 on the device. N and
// out_h are at most 65535.
extern "C" int affine_warp_bwd(const void* dy, const float* G_inv, float* dx, int dtype, int mode,
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
