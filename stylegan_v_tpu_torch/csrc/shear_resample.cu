// The shear warp's shared-scale resample (K7), NCHW, for Hopper (sm_90a).
//
// Replaces stage 1 of stylegan_v_tpu/ops/shear_warp.py (the ADA pipe's
// two-pass shear executor): _line_pass_onehot (:104), which applies a banded
// one-hot matrix S [out, L] with a batched matmul on the TPU's MXU, and its
// gather twin _line_pass (:81). Each output line i of sample b is a two-tap
// mix of two source lines whose indices and weights are shared by every
// column and channel of the sample:
//
//   AXIS 0 (pass V): y[p, i, s] = w0[b,i] x[p, i0[b,i], s] + w1[b,i] x[p, i1[b,i], s]
//   AXIS 1 (pass H): y[p, r, i] = w0[b,i] x[p, r, i0[b,i]] + w1[b,i] x[p, r, i1[b,i]]
//
// with b = p / C. The tables (i0, i1 mirrored into the source, w0 = 1 - f,
// w1 = f; [N, out] each) are computed once a call by
// ops/shear_warp.py:line_taps with torch operations on the device, so the
// kernel and its plain version read the same taps. Sums in float32, one
// rounding to the output dtype (float32, or bfloat16 to nearest even); the
// JAX package multiplies in the payload dtype.
//
// Bound: memory. It must read the rows (columns) that the taps touch and
// write y once: at the ADA step's canvas in bf16, pass V reads up to
// [144, 1072, 536] and writes [144, 1060, 536], 329 MB, 0.098 ms at
// 3.35 TB/s. NCHW keeps every read a whole row: in pass V a warp reads 32
// neighbouring columns of two source rows, in pass H 32 taps along one row,
// which the shared scale keeps within a few cache lines. The one-hot matmul
// would multiply by L zeros for every two taps; the gather needs none. The
// ring of rows in shared memory, and the fusion with K8 and the reflect pads
// around it, are the next steps.
//
// The C entry point launches on the given stream, does not synchronise,
// allocates nothing and returns cudaGetLastError().

#include "shear_lines.cuh"

namespace {

using namespace shear;

template <typename T, int AXIS>
__global__ void __launch_bounds__(TX * TY)
    shear_resample_kernel(const void* x_, void* y_, const int* __restrict__ i0,
                          const int* __restrict__ i1, const float* __restrict__ w0,
                          const float* __restrict__ w1, int C, int R, int S, int out_r,
                          int out_s) {
  const T* x = static_cast<const T*>(x_);
  T* y = static_cast<T*>(y_);
  const int s = blockIdx.x * TX + threadIdx.x;
  const int r = blockIdx.y * TY + threadIdx.y;
  if (s >= out_s || r >= out_r) return;
  const int p = blockIdx.z;
  const int out_len = AXIS == 0 ? out_r : out_s;
  const int t = (p / C) * out_len + (AXIS == 0 ? r : s);
  const int a = __ldg(i0 + t), b = __ldg(i1 + t);
  const T* src = x + (int64_t)p * R * S;
  float v0, v1;
  if (AXIS == 0) {
    v0 = load(src + (int64_t)a * S + s);
    v1 = load(src + (int64_t)b * S + s);
  } else {
    v0 = load(src + (int64_t)r * S + a);
    v1 = load(src + (int64_t)r * S + b);
  }
  store(y + ((int64_t)p * out_r + r) * out_s + s, two_taps(__ldg(w0 + t), v0, __ldg(w1 + t), v1));
}

}  // namespace

// dtype (of x and y): 0 = float32, 1 = bfloat16. x is [planes, R, S] and y
// [planes, out_r, out_s], both contiguous; axis 0: out_s == S and the
// tables are [planes / C, out_r]; axis 1: out_r == R and they are
// [planes / C, out_s]. Every index in i0 and i1 lies in the source axis.
// planes and ceil(out_r / 8) are at most 65535.
extern "C" int shear_resample(const void* x, void* y, const int* i0, const int* i1,
                              const float* w0, const float* w1, int dtype, int axis, int planes,
                              int C, int R, int S, int out_r, int out_s, void* stream) {
  const auto kernel = SHEAR_KERNEL(shear_resample_kernel, dtype, axis);
  return shear::launch(kernel, planes, out_r, out_s, static_cast<cudaStream_t>(stream),
                       x, y, i0, i1, w0, w1, C, R, S, out_r, out_s);
}
