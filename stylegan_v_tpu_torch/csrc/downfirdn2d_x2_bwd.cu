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
// Bound: memory. It reads N*C*H*W/4 elements and writes four times that.
// One thread computes one quad: it loads the 3x3 neighbourhood of d[Y][X]
// (neighbouring threads share it through L1), so every tap index is known
// at compile time, and stores each output row of the quad as one two-element
// vector. A 3-D grid (X in blocks of threads, Y, plane) needs no integer
// division. Shared-memory tiling and wider stores are later work.
//
// The C entry point launches on the given stream, does not synchronise,
// allocates nothing and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace {

struct Filter4x4 {
  float v[16];
};

__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

template <typename T>
__global__ void downfirdn2d_x2_bwd_kernel(const T* __restrict__ dy, T* __restrict__ dx,
                                          const Filter4x4 f, const int Ho, const int Wo,
                                          const int64_t planes) {
  const int X = blockIdx.x * blockDim.x + threadIdx.x;
  const int Y = blockIdx.y;
  if (X >= Wo) return;
  const int W = 2 * Wo;
  const bool up = Y > 0, down = Y + 1 < Ho, left = X > 0, right = X + 1 < Wo;
  for (int64_t p = blockIdx.z; p < planes; p += gridDim.z) {
    const T* r = dy + (p * Ho + Y) * (int64_t)Wo + X;      // d[Y][X]
    // d[Y+i][X+j] for i, j in {-1, 0, 1}, zero outside the plane
    const float mm = (up && left) ? load_f32(r - Wo - 1) : 0.f;
    const float m0 = up ? load_f32(r - Wo) : 0.f;
    const float mp = (up && right) ? load_f32(r - Wo + 1) : 0.f;
    const float zm = left ? load_f32(r - 1) : 0.f;
    const float z0 = load_f32(r);
    const float zp = right ? load_f32(r + 1) : 0.f;
    const float pm = (down && left) ? load_f32(r + Wo - 1) : 0.f;
    const float p0 = down ? load_f32(r + Wo) : 0.f;
    const float pp = (down && right) ? load_f32(r + Wo + 1) : 0.f;
    T* out = dx + (p * 2 * Ho + 2 * Y) * (int64_t)W + 2 * X;
    float a = 0.f, b = 0.f;
    a += f.v[5] * z0;  a += f.v[7] * zm;  a += f.v[13] * m0;  a += f.v[15] * mm;
    b += f.v[4] * zp;  b += f.v[6] * z0;  b += f.v[12] * mp;  b += f.v[14] * m0;
    store2(out, a, b);
    a = 0.f;
    b = 0.f;
    a += f.v[1] * p0;  a += f.v[3] * pm;  a += f.v[9] * z0;   a += f.v[11] * zm;
    b += f.v[0] * pp;  b += f.v[2] * p0;  b += f.v[8] * zp;   b += f.v[10] * z0;
    store2(out + W, a, b);
  }
}

template <typename T>
void launch(const void* dy, void* dx, const Filter4x4& f, int64_t planes, int H, int W,
            cudaStream_t stream) {
  const int Ho = H / 2, Wo = W / 2;
  const int threads = Wo >= 128 ? 128 : 32 * ((Wo + 31) / 32);
  const dim3 grid((Wo + threads - 1) / threads, Ho,
                  (unsigned)(planes < 65535 ? planes : 65535));  // planes loop in-kernel
  downfirdn2d_x2_bwd_kernel<T><<<grid, threads, 0, stream>>>(
      static_cast<const T*>(dy), static_cast<T*>(dx), f, Ho, Wo, planes);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. f_flipped: 16 host floats, row-major,
// already flipped. planes = N*C. H and W are the OUTPUT's (even); dy is
// [planes, H/2, W/2] and dx [planes, H, W], both contiguous.
extern "C" int downfirdn2d_x2_bwd(const void* dy, void* dx, const float* f_flipped, int dtype,
                                  int64_t planes, int H, int W, void* stream) {
  Filter4x4 f;
  for (int i = 0; i < 16; ++i) f.v[i] = f_flipped[i];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch<float>(dy, dx, f, planes, H, W, s);
  } else if (dtype == 1) {
    launch<__nv_bfloat16>(dy, dx, f, planes, H, W, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
