// The shear warp's per-line fractional shift (K8), NCHW, for Hopper
// (sm_90a); its adjoint is this kernel too.
//
// Replaces stage 2 of stylegan_v_tpu/ops/shear_warp.py: the lane-dense
// barrel shifter _shift_lines_dense_impl (:278), and its custom VJP
// (:333, :337), which is a shift of the zero-padded cotangent. Each line of
// a plane is shifted along the axis by its own integer start and mixed from
// two neighbours:
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
// (the case where the JAX package's VJP clips its start to 0). The forward
// pass runs fused with its resample (shear_pass.cu); the executor launches
// this kernel for the adjoint, in the backward of each pass.
//
// Bound: memory. It must read the lines' windows and write y once: at the
// ADA step's canvas in bf16, the adjoint of pass V reads [144, 524, 536]
// and writes [144, 1060, 536], about half of it zeros, 245 MB, 0.073 ms at
// 3.35 TB/s. A block (shear_lines.cuh:line_kernel) stages the window of z
// that its tile reads in shared memory, with 16- or 8-byte loads in pass V,
// where a warp's columns start on rows up to SCALE_MAX apart and so would
// scatter their loads over many rows; then each thread writes G outputs as
// one vector, zero runs included. In pass H each row's window is its own
// contiguous span; a thread issues the loads of all its elements of the
// tile's windows before it stores any, so that enough bytes are in flight.
//
// The C entry point launches on the given stream, does not synchronise,
// allocates nothing and returns cudaGetLastError().

#include "shear_lines.cuh"

// dtype (of z and y): 0 = float32, 1 = bfloat16. z is [planes, R, S] and y
// [planes, out_r, out_s], both contiguous; axis 0: out_s == S and the
// tables are [planes / C, S], whose starts of 32 neighbouring columns lie
// within 4 x 31 + 2 of each other (else the kernel traps); axis 1:
// out_r == R and they are [planes / C, R]. start may be negative or reach
// past the axis: those reads are zero. planes is at most 65535.
extern "C" int shear_shift(const void* z, void* y, const int* start, const float* w0,
                           const float* w1, int dtype, int axis, int planes, int C, int R, int S,
                           int out_r, int out_s, void* stream) {
  const shear::Lines a{z, y, nullptr, nullptr, nullptr, nullptr, nullptr, start, w0, w1,
                       C, R, S, out_r, out_s, axis == 0 ? R : S};
  return shear::launch_lines<false>(dtype, axis, planes, a, static_cast<cudaStream_t>(stream));
}
