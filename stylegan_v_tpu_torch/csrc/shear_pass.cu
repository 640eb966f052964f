// One pass of the shear warp, its resample and its shift in one launch
// (K7, the fused pass), NCHW, for Hopper (sm_90a).
//
// Replaces, in stylegan_v_tpu/ops/shear_warp.py (the ADA pipe's two-pass
// shear executor), the whole of each pass:
//   stage 1, _line_pass_onehot (:104), a banded one-hot matrix applied with
//     a batched matmul on the TPU's MXU (its gather twin _line_pass, :81);
//   stage 2, the lane-dense shifter _shift_lines_dense_impl (:278);
//   the reflect pads before stage 1 (:423, :455) and the rot90 select of
//     the samples that the conditioning turns (:388).
// With b = p / C, the lines l across the axis and the source x:
//
//   z[j] = w0t[b,j] x'[i0[b,j]] + w1t[b,j] x'[i1[b,j]]       (stage 1, along the axis)
//   y[i] = w0[b,l] z[start[b,l] + i] + w1[b,l] z[start[b,l] + i + 1]   (stage 2, line l)
//
// where x' is x, or in pass V (AXIS 0) a rot90 sample's x'[r, c] =
// x[c, S - 1 - r] (rot[b] nonzero), and z reads zero outside [0, L). The
// taps (ops/shear_warp.py:line_taps) index the source itself: the reflect
// pad is composed into them, so no padded copy exists. Every table is
// computed once a call with torch operations on the device. z is rounded
// to the payload dtype, as the plain chain (shear_resample_plain, then
// shear_shift_plain) rounds it, and each sum is float32 without a fused
// multiply-add: the kernel equals that chain to the bit.
//
// Bound: memory. The pass must read the source lines that its taps touch
// once and write y once: at the ADA step's canvas in bf16, pass V reads
// [144, 536, 536] and writes [144, 524, 536], about 164 MB, 0.049 ms at
// 3.35 TB/s; pass H reads [144, 524, 536] and writes [144, 524, 524],
// 0.048 ms. The earlier chain (pad, resample, shift, and the select)
// moved each pass's data through device memory four times. Here z never
// leaves the chip: a block (shear_lines.cuh:line_kernel) computes the
// window of z that its tile of outputs reads into shared memory, then
// shifts out of it, G outputs a thread stored as one 16- or 8-byte
// vector. In pass V the window is the tile's rows plus the spread of its
// columns' starts (at most SCALE_MAX rows a column), so rows of z are
// computed again by the tile below; a rot90 sample's window is filled by
// threads running along it, which read along a row of x, and transposed in
// shared memory.
//
// The C entry point launches on the given stream, does not synchronise,
// allocates nothing and returns cudaGetLastError().

#include "shear_lines.cuh"

// dtype (of x and y): 0 = float32, 1 = bfloat16. x is [planes, R, S] and y
// [planes, out_r, out_s], both contiguous; axis 0: out_s == S, the taps
// i0, i1, tw0, tw1 are [planes / C, L] with indices in [0, R), rot is null
// or [planes / C] (then R == S), and start, w0, w1 are [planes / C, S];
// axis 1: out_r == R, the taps index [0, S), rot is null, and the shift's
// tables are [planes / C, R]. Pass V's starts of 32 neighbouring columns lie
// within 4 x 31 + 2 rows of each other (else the kernel traps). planes is
// at most 65535.
extern "C" int shear_pass(const void* x, void* y, const int* i0, const int* i1, const float* tw0,
                          const float* tw1, const unsigned char* rot, const int* start,
                          const float* w0, const float* w1, int dtype, int axis, int planes,
                          int C, int R, int S, int out_r, int out_s, int L, void* stream) {
  const shear::Lines a{x, y, i0, i1, tw0, tw1, rot, start, w0, w1, C, R, S, out_r, out_s, L};
  return shear::launch_lines<true>(dtype, axis, planes, a, static_cast<cudaStream_t>(stream));
}
