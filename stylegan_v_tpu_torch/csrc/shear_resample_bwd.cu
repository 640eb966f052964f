// The adjoint of the shear warp's shared-scale resample (K7-bwd), NCHW, for
// Hopper (sm_90a).
//
// Replaces the gradient of stage 1 of stylegan_v_tpu/ops/shear_warp.py:
// jax.grad of _line_pass_onehot (:104), the transposed one-hot matmul
// S^T @ g (a scatter-add in _line_pass, :81), and of the reflect pad before
// it (:423, :455). It is the exact transpose of stage 1 of the fused pass
// (shear_pass.cu), whose taps index the unpadded source:
//
//   AXIS 0: dx[p, l, s] = sum over entries e of list (b, l) of w[e] dy[p, i[e], s]
//   AXIS 1: dx[p, r, l] = sum over entries e of list (b, l) of w[e] dy[p, r, i[e]]
//
// with b = p / C. Because of the mirror, the reflect pad composed into the
// taps, and scales below 1, several output lines i tap one source line l;
// the list of (b, l) holds each such tap (i, w), both taps of an i where
// the mirror or the pad puts them on one line.
// ops/shear_warp.py:LineTaps.lists builds the lists once a call with stable
// torch operations on the device, as CSR arrays (ptr [N, L + 1], line and
// weight [N, 2 out]) in a fixed order: by i, then the tap. A thread owns one
// element of dx and sums its list in float32 in that order, then writes it
// once in dy's dtype. No atomics: a call repeats to the bit, and needs no
// zeroed buffer. A list is short: |scale| >= 1/4, so a line of the padded
// axis takes about 10 taps at most, and the pad folds at most three such
// lines (the line and its two reflections) into one list of the source.
//
// Bound: memory. It must read dy once and write dx once: at the ADA step's
// canvas in bf16 (pass V), [144, 1060, 536] in and [144, 536, 536] out,
// 246 MB, 0.074 ms at 3.35 TB/s (it wrote the padded [144, 1072, 536] and
// the pad's backward summed it, before the pad was composed into the taps). Each row of dy is read by the few threads
// whose lists hold it, whole rows in pass V, nearby taps of one row in pass
// H; L1 and L2 serve the repeats.
//
// The C entry point launches on the given stream, does not synchronise,
// allocates nothing and returns cudaGetLastError().

#include "shear_lines.cuh"

namespace {

using namespace shear;

constexpr int TX = 32, TY = 8;                    // a block: one output a thread

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <typename T, int AXIS>
__global__ void __launch_bounds__(TX * TY)
    shear_resample_bwd_kernel(const void* dy_, void* dx_, const int* __restrict__ ptr,
                              const int* __restrict__ line, const float* __restrict__ weight,
                              int C, int R, int S, int out_r, int out_s) {
  const T* dy = static_cast<const T*>(dy_);
  T* dx = static_cast<T*>(dx_);
  const int s = blockIdx.x * TX + threadIdx.x;
  const int r = blockIdx.y * TY + threadIdx.y;
  if (s >= out_s || r >= out_r) return;
  const int p = blockIdx.z, n = p / C;
  const int in_len = AXIS == 0 ? out_r : out_s;     // dx's length along the axis
  const int entries = 2 * (AXIS == 0 ? R : S);      // two taps a line of dy
  const int* list = ptr + (int64_t)n * (in_len + 1) + (AXIS == 0 ? r : s);
  const int e1 = __ldg(list + 1);
  const int* lines = line + (int64_t)n * entries;
  const float* weights = weight + (int64_t)n * entries;
  const T* src = dy + (int64_t)p * R * S;
  float acc = 0.0f;
  for (int e = __ldg(list); e < e1; ++e) {
    const int i = __ldg(lines + e);
    const float g = AXIS == 0 ? load(src + (int64_t)i * S + s) : load(src + (int64_t)r * S + i);
    acc = __fadd_rn(acc, __fmul_rn(__ldg(weights + e), g));
  }
  store(dx + ((int64_t)p * out_r + r) * out_s + s, acc);
}

template <typename T, int AXIS>
void start(const void* dy, void* dx, const int* ptr, const int* line, const float* weight,
           int planes, int C, int R, int S, int out_r, int out_s, cudaStream_t stream) {
  const dim3 grid((out_s + TX - 1) / TX, (out_r + TY - 1) / TY, planes);
  shear_resample_bwd_kernel<T, AXIS><<<grid, dim3(TX, TY), 0, stream>>>(
      dy, dx, ptr, line, weight, C, R, S, out_r, out_s);
}

}  // namespace

// dtype (of dy and dx): 0 = float32, 1 = bfloat16. dy is [planes, R, S] and
// dx [planes, out_r, out_s], both contiguous; axis 0: out_s == S, the lists
// run over dx's out_r rows and their entries are dy's rows (2 R a sample);
// axis 1: out_r == R, the lists run over dx's out_s columns and their
// entries are dy's columns (2 S a sample). ptr is [planes / C, lines + 1];
// every element of dx is written. planes and ceil(out_r / 8) are at most
// 65535.
extern "C" int shear_resample_bwd(const void* dy, void* dx, const int* ptr, const int* line,
                                  const float* weight, int dtype, int axis, int planes, int C,
                                  int R, int S, int out_r, int out_s, void* stream) {
  using Start = void (*)(const void*, void*, const int*, const int*, const float*, int, int,
                        int, int, int, int, cudaStream_t);
  static const Start starts[2][2] = {{start<float, 0>, start<float, 1>},
                                     {start<__nv_bfloat16, 0>, start<__nv_bfloat16, 1>}};
  if (dtype < 0 || dtype > 1 || axis < 0 || axis > 1) return (int)cudaErrorInvalidValue;
  starts[dtype][axis](dy, dx, ptr, line, weight, planes, C, R, S, out_r, out_s,
                      static_cast<cudaStream_t>(stream));
  return (int)cudaGetLastError();
}
