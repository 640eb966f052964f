// The shear warp's per-line fractional shift (K8), NCHW, for Hopper
// (sm_90a); its adjoint is this kernel too.
//
// Replaces stage 2 of stylegan_v_tpu/ops/shear_warp.py: the lane-dense
// barrel shifter _shift_lines_dense_impl (:278), and its custom VJP (:323),
// which is a shift of the zero-padded cotangent. Each line of a plane is
// shifted along the axis by its own integer start and mixed from two
// neighbours:
//
//   AXIS 0 (lines are the columns): y[p, i, s] = w0[b,s] z[p, j, s] + w1[b,s] z[p, j+1, s],
//                                   j = start[b,s] + i
//   AXIS 1 (lines are the rows):    y[p, r, i] = w0[b,r] z[p, r, j] + w1[b,r] z[p, r, j+1],
//                                   j = start[b,r] + i
//
// with b = p / C, and z read as zero outside the axis. The forward's tables
// (start = clip(k, 0, L - out - 1), w0 = 1 - frac, w1 = frac) come from
// ops/shear_warp.py:line_shift, computed once a call with torch operations
// on the device, so no floor is taken here (the clip is not continuous
// where the position is 2 J0). The adjoint is the same map with start
// -1 - start and the weights swapped (LineShift.adjoint): its reads past
// either end of the cotangent are the zero padding, bounded here instead of
// copied, which keeps it exact where the output is as long as the input
// (the case where the JAX package's VJP clips its start to 0).
//
// Bound: memory. It must read the lines' windows and write y once: at the
// ADA step's canvas in bf16, pass V reads about [144, 525, 536] of
// [144, 1060, 536] and writes [144, 524, 536], 162 MB, 0.048 ms at
// 3.35 TB/s. In pass H a warp reads 33 neighbours along one row. In pass V
// the columns of a warp start on rows up to |shear / scale| apart, so its
// loads spread over several rows; a block covers 8 rows, whose reads of
// those rows L1 and L2 serve. Staging each block's window in shared memory,
// and fusing this stage into K7's, are the next steps.
//
// The C entry point launches on the given stream, does not synchronise,
// allocates nothing and returns cudaGetLastError().

#include "shear_lines.cuh"

namespace {

using namespace shear;

template <typename T, int AXIS>
__global__ void __launch_bounds__(TX * TY)
    shear_shift_kernel(const void* z_, void* y_, const int* __restrict__ start,
                       const float* __restrict__ w0, const float* __restrict__ w1, int C, int R,
                       int S, int out_r, int out_s) {
  const T* z = static_cast<const T*>(z_);
  T* y = static_cast<T*>(y_);
  const int s = blockIdx.x * TX + threadIdx.x;
  const int r = blockIdx.y * TY + threadIdx.y;
  if (s >= out_s || r >= out_r) return;
  const int p = blockIdx.z;
  const int t = (p / C) * (AXIS == 0 ? S : R) + (AXIS == 0 ? s : r);
  const int L = AXIS == 0 ? R : S;                     // the axis the lines are shifted along
  const int j = __ldg(start + t) + (AXIS == 0 ? r : s);
  const T* src = z + (int64_t)p * R * S;
  float v0 = 0.0f, v1 = 0.0f;
  if (AXIS == 0) {
    if (j >= 0 && j < L) v0 = load(src + (int64_t)j * S + s);
    if (j + 1 >= 0 && j + 1 < L) v1 = load(src + (int64_t)(j + 1) * S + s);
  } else {
    if (j >= 0 && j < L) v0 = load(src + (int64_t)r * S + j);
    if (j + 1 >= 0 && j + 1 < L) v1 = load(src + (int64_t)r * S + j + 1);
  }
  store(y + ((int64_t)p * out_r + r) * out_s + s, two_taps(__ldg(w0 + t), v0, __ldg(w1 + t), v1));
}

}  // namespace

// dtype (of z and y): 0 = float32, 1 = bfloat16. z is [planes, R, S] and y
// [planes, out_r, out_s], both contiguous; axis 0: out_s == S and the
// tables are [planes / C, S]; axis 1: out_r == R and they are
// [planes / C, R]. start may be negative or reach past the axis: those
// reads are zero. planes and ceil(out_r / 8) are at most 65535.
extern "C" int shear_shift(const void* z, void* y, const int* start, const float* w0,
                           const float* w1, int dtype, int axis, int planes, int C, int R, int S,
                           int out_r, int out_s, void* stream) {
  const auto kernel = SHEAR_KERNEL(shear_shift_kernel, dtype, axis);
  return shear::launch(kernel, planes, out_r, out_s, static_cast<cudaStream_t>(stream),
                       z, y, start, w0, w1, C, R, S, out_r, out_s);
}
