// Fused 2x FIR downsample, NCHW, for Hopper (sm_90a).
//
// Replaces stylegan_v_tpu/ops/pallas_kernels.py:downfirdn2d_x2, the TPU
// kernel. Computes what it computes, i.e. upfirdn2d(x, f, down=2,
// padding=[1,1,1,1]) with a 4x4 filter as a true convolution:
//
//   y[n,c,ho,wo] = sum_{ky,kx} fk[ky][kx] * x[n,c,2ho-1+ky,2wo-1+kx]
//
// with fk = f flipped in both axes (the caller passes it flipped), zeros
// outside the image, a float32 sum and a result in the input dtype (float32
// or bfloat16, rounded to nearest even).
//
// Bound: memory. It reads N*C*H*W elements and writes a quarter of that, for
// 16 multiply-adds per output. One thread computes one output, with wo fastest
// so that a warp stores 32 neighbouring outputs and reads two neighbouring
// input rows per filter row; the windows of neighbouring threads overlap and
// are served from L1 and L2. The filter's 16 floats travel by value in the
// kernel's parameters, so there is no device tensor for them. A simple kernel
// that is right comes first: TMA and shared-memory tiling are later work.
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
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void downfirdn2d_x2_kernel(const T* __restrict__ x, T* __restrict__ y,
                                      const Filter4x4 f, const int H, const int W,
                                      const int Ho, const int Wo, const int64_t total) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; idx < total;
       idx += stride) {
    const int wo = (int)(idx % Wo);
    const int64_t rest = idx / Wo;
    const int ho = (int)(rest % Ho);
    const int64_t nc = rest / Ho;
    const T* plane = x + nc * (int64_t)H * W;
    const int iy0 = 2 * ho - 1;
    const int ix0 = 2 * wo - 1;
    float acc = 0.f;
#pragma unroll
    for (int ky = 0; ky < 4; ++ky) {
      const int iy = iy0 + ky;
      if (iy < 0 || iy >= H) continue;
      const T* row = plane + (int64_t)iy * W;
#pragma unroll
      for (int kx = 0; kx < 4; ++kx) {
        const int ix = ix0 + kx;
        if (ix < 0 || ix >= W) continue;
        acc += f.v[ky * 4 + kx] * load_f32(row + ix);
      }
    }
    store(y + idx, acc);
  }
}

template <typename T>
void launch(const void* x, void* y, const Filter4x4& f, int64_t planes, int H, int W,
            cudaStream_t stream) {
  const int Ho = H / 2, Wo = W / 2;
  const int64_t total = planes * Ho * Wo;
  const int threads = 256;
  int64_t blocks = (total + threads - 1) / threads;
  // The grid-stride loop covers what a capped grid leaves.
  if (blocks > (int64_t)1 << 30) blocks = (int64_t)1 << 30;
  downfirdn2d_x2_kernel<T><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), f, H, W, Ho, Wo, total);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. f_flipped: 16 host floats, row-major,
// already flipped. planes = N*C. H and W even, x and y contiguous NCHW.
extern "C" int downfirdn2d_x2(const void* x, void* y, const float* f_flipped, int dtype,
                              int64_t planes, int H, int W, void* stream) {
  Filter4x4 f;
  for (int i = 0; i < 16; ++i) f.v[i] = f_flipped[i];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch<float>(x, y, f, planes, H, W, s);
  } else if (dtype == 1) {
    launch<__nv_bfloat16>(x, y, f, planes, H, W, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
