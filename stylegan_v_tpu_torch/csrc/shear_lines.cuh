// What the shear warp's three kernels share (shear_resample.cu, K7;
// shear_resample_bwd.cu, K7-bwd; shear_shift.cu, K8): loads and stores in
// float32 or bfloat16, the two-tap sum and the grid.
//
// Each kernel maps NCHW planes [R, S] (the input) to planes [out_r, out_s]
// (the output) along one axis: AXIS 0 runs along the rows (dim 2), AXIS 1
// along the columns (dim 3). Plane p belongs to sample p / C, whose tables
// it reads. A block is TX x TY outputs of one plane, one a thread; a warp
// writes 32 neighbouring outputs of a row. A kernel takes its tensors as
// untyped pointers, so that its four instantiations (float32 or bfloat16,
// AXIS 0 or 1) share one signature and its C entry point picks one with
// SHEAR_KERNEL and starts it with `launch`.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace shear {

constexpr int TX = 32, TY = 8;

__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// w0 v0 + w1 v1, each product and the sum rounded on its own (no fused
// multiply-add): the plain version's arithmetic, so the two agree to the bit.
__device__ __forceinline__ float two_taps(float w0, float v0, float w1, float v1) {
  return __fadd_rn(__fmul_rn(w0, v0), __fmul_rn(w1, v1));
}

inline dim3 grid_of(int planes, int out_r, int out_s) {
  return dim3((out_s + TX - 1) / TX, (out_r + TY - 1) / TY, planes);
}

// Starts kernel on the output's grid on stream with args; returns
// cudaGetLastError(), or cudaErrorInvalidValue where kernel is null (a
// dtype or axis out of range). Does not synchronise.
template <typename... P, typename... A>
int launch(void (*kernel)(P...), int planes, int out_r, int out_s, cudaStream_t stream,
           A... args) {
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  kernel<<<grid_of(planes, out_r, out_s), dim3(TX, TY), 0, stream>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace shear

// K<T, AXIS> for dtype (0 = float32, 1 = bfloat16) and axis (0, 1), or null.
#define SHEAR_KERNEL(K, dtype, axis)                                                  \
  ((dtype) == 0   ? ((axis) == 0 ? &K<float, 0> : (axis) == 1 ? &K<float, 1> : nullptr) \
   : (dtype) == 1 ? ((axis) == 0   ? &K<__nv_bfloat16, 0>                            \
                     : (axis) == 1 ? &K<__nv_bfloat16, 1>                            \
                                   : nullptr)                                        \
                  : nullptr)
