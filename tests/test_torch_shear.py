"""Parity of the PyTorch port's shear warp executor (ops/shear_warp.py:
the stages' plain versions, the fused pass and its transpose, the whole
warp, and the ADA pipe and step with `warp_mode="shear"`) against the JAX
package, on CPU; and the fused pass's own structure: the reflect pad
composed into the taps, the kernels' tile windows, and K7-bwd's lists.

Inputs are numpy arrays from a seed. The JAX side runs as its own tests run
it: stylegan_v_tpu/ops/shear_warp.py with its default stage executors (the
one-hot-matmul resample and the lane-dense shift), eagerly or under jit, in
float32; the port runs its plain versions (CPU tensors) in float32. A stage
alone runs through `_ShearPass` with the other stage's identity tables
(one tap of weight 1), which adds nothing and rounds nothing.

Tolerances (test_torch_augment.py's): value and vjp to TOL = 1e-4 of each
array's scale, second order to TOL2 = 1e-3 (test_torch_grads.py:check_op);
the coefficient tables are the same float32 operations in the same order,
and only the sums' order differs (the one-hot matmul adds zeros). The step
is held as test_torch_train.py holds it. K8's adjoint where the output is
as long as the input is held to its dense transpose, not to JAX, whose VJP
clips its start there. The composed taps equal the pad and the padded taps
to the bit; their lists sum to the pad's adjoint in float64 to 1e-12.

The card's cases (each kernel against its plain version, repeats to the
bit, autograd's launches) are in test_torch_kernels.py, which runs without
jax.
"""
import math
import re
from pathlib import Path

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
import torch.nn.functional as F

from stylegan_v_tpu.ops import setup_filter as jsetup_filter
from stylegan_v_tpu.ops import shear_warp as jsw
from stylegan_v_tpu.training import augment as jaug
from stylegan_v_tpu_torch.ops import setup_filter, shear_warp as tsw
from stylegan_v_tpu_torch.training import augment as taug
from test_torch_augment import JaxKeyDraws, assert_close, pipes
from test_torch_grads import NHWC, TOL, check_op
from test_torch_train import (GPL_TOL, assert_state_close, assert_stats_close,  # noqa: F401
                              jax_side, one_torch_thread, run_steps)

# layout converters for one stage, JAX -> port and back: the JAX package's
# [B, L, R] lines (R the payload), the port's [B, 1, L, R] along rows and
# [B, 1, R, L] along columns
ALONG_ROWS = (lambda a: torch.from_numpy(np.ascontiguousarray(a[:, None])),
              lambda t: t.detach().numpy()[:, 0])
ALONG_COLS = (lambda a: torch.from_numpy(np.ascontiguousarray(np.swapaxes(a, 1, 2)[:, None])),
              lambda t: np.swapaxes(t.detach().numpy()[:, 0], 1, 2))
# the JAX shift's [B, L, N, C] (shifted along L, lines n), the port's
# [B, C, L, N] along rows and [B, C, N, L] along columns
SHIFT_ROWS = NHWC
SHIFT_COLS = (lambda a: torch.from_numpy(np.ascontiguousarray(np.transpose(a, (0, 3, 2, 1)))),
              lambda t: t.detach().numpy().transpose(0, 3, 2, 1))


def identity_taps(B, L):
    """Stage 1 that copies each of L lines (one tap of weight 1)."""
    i = torch.arange(L, dtype=torch.int32).expand(B, L).contiguous()
    return tsw.LineTaps(i, i, torch.ones(B, L), torch.zeros(B, L), L)


def identity_shift(B, lines):
    """Stage 2 that copies each line (start 0, one tap of weight 1)."""
    return tsw.LineShift(torch.zeros(B, lines, dtype=torch.int32), torch.ones(B, lines),
                         torch.zeros(B, lines))


# ------------------------------------------------------- copied constants

@pytest.mark.parametrize("name", ["SCALE_MAX", "SHEAR_MAX"])
def test_constants_equal_the_jax_package(name):
    assert getattr(tsw, name) == getattr(jsw, name)


@pytest.mark.parametrize("size", [1, 2, 7, 64])
def test_index_helpers_equal_the_jax_package(size):
    """_mirror_idx repeats the edge (-1 -> 0, size -> size - 1), whatever its
    JAX docstring says; _reflect_pad_len is half the length."""
    i = np.arange(-5 * size - 3, 5 * size + 4, dtype=np.int32)
    want = np.asarray(jsw._mirror_idx(jnp.asarray(i), size))
    got = tsw._mirror_idx(torch.from_numpy(i).long(), size).numpy()
    np.testing.assert_array_equal(got, want)
    assert tsw._mirror_idx(torch.tensor([-1, size]), size).tolist() == [0, size - 1]
    assert tsw._reflect_pad_len(size) == jsw._reflect_pad_len(size)


def test_rot90_in_nchw_is_the_jax_packages():
    """The conditioning's source: NHWC flip(swapaxes(x, 1, 2), axis=1) is
    NCHW x.transpose(-1, -2).flip(-2)."""
    x = np.random.RandomState(0).randn(2, 5, 5, 3).astype(np.float32)
    want = np.asarray(jnp.flip(jnp.swapaxes(jnp.asarray(x), 1, 2), axis=1))
    got = NHWC[0](x).transpose(-1, -2).flip(-2)
    np.testing.assert_array_equal(NHWC[1](got), want)


# ------------------------------------------------------------ the stages

RESAMPLE = [  # (shift [B], scale [B], L, out_len): mirrored past both ends, negative scales,
    #           the scale floor 1/4 and the clip 4
    (np.float32([-5.3, 12.7, 3.1]), np.float32([0.25, -1.7, 3.9]), 11, 17),
    (np.float32([0.0, -0.5, 20.2]), np.float32([1.0, 0.6, -4.0]), 9, 9),
]


@pytest.mark.parametrize("axis", ["rows", "cols"])
@pytest.mark.parametrize("case", range(len(RESAMPLE)))
def test_resample_plain_matches_jax(case, axis):
    """Stage 1's plain version (and K7-bwd's, its vjp), through _ShearPass
    with an identity shift, against _line_pass_onehot, and the gather twin
    _line_pass, with mirrored edges and negative scales."""
    shift, scale, L, out_len = RESAMPLE[case]
    x = np.random.RandomState(case).randn(len(shift), L, 5).astype(np.float32)
    taps = tsw.line_taps(torch.from_numpy(shift), torch.from_numpy(scale), out_len, L)
    tax, lay = (tsw.ROWS, ALONG_ROWS) if axis == "rows" else (tsw.COLS, ALONG_COLS)
    ident = identity_shift(len(shift), x.shape[2])
    check_op(jax.jit(lambda x: jsw._line_pass_onehot(x, shift, scale, out_len)),
             lambda x: tsw._ShearPass.apply(x, taps, ident, tax, out_len, None), [x], [lay], lay)
    gathered = np.asarray(jsw._line_pass(jnp.asarray(x), shift, scale, out_len))
    assert_close(lay[1](tsw.shear_resample_plain(lay[0](x), taps, tax)), gathered, TOL, "gather")


SHIFTS = [  # (k [B, N], frac [B, N], L, out_len): k past both clip ends, frac at 0
    (np.int32([[-3, 0, 2, 4, 9], [5, 5, 1, 0, 3]]),
     np.float32([[0.3, 0.0, 0.7, 0.99, 0.5], [0.1, 0.2, 0.0, 0.6, 0.45]]), 12, 7),
    (np.int32([[0, 1, 2, 7], [2, 0, 1, 1]]), np.float32([[0.5, 0.25, 0.0, 0.8], [0.9, 0.4,
                                                                                   0.3, 0.0]]),
     5, 3),
]


def shift_tables(k, frac, L, out_len):
    """The port's tables for the JAX shift's (k, frac): its clip, 1 - frac, frac."""
    kc = np.clip(k, 0, max(L - out_len - 1, 0)).astype(np.int32)
    return tsw.LineShift(torch.from_numpy(kc), torch.from_numpy(1.0 - frac),
                         torch.from_numpy(frac))


@pytest.mark.parametrize("axis", ["rows", "cols"])
@pytest.mark.parametrize("case", range(len(SHIFTS)))
def test_shift_plain_matches_jax(case, axis):
    """K8's plain version (and K8 on the adjoint tables, its vjp), through
    _ShearPass with identity taps, against shift_lines_dense, with the start
    clipped at both ends."""
    k, frac, L, out_len = SHIFTS[case]
    B, N = k.shape
    x = np.random.RandomState(case).randn(B, L, N, 2).astype(np.float32)
    sh = shift_tables(k, frac, L, out_len)
    tax, lay = (tsw.ROWS, SHIFT_ROWS) if axis == "rows" else (tsw.COLS, SHIFT_COLS)
    check_op(jax.jit(lambda x: jsw.shift_lines_dense(x, jnp.asarray(k), jnp.asarray(frac),
                                                     out_len)),
             lambda x: tsw._ShearPass.apply(x, identity_taps(B, L), sh, tax, out_len, None),
             [x], [lay], lay)


def dense_shift(shift, b, n, L, out_len):
    """K8's matrix [out_len, L] for line n of sample b, from its definition."""
    A = np.zeros((out_len, L), np.float64)
    s, w0, w1 = int(shift.start[b, n]), float(shift.w0[b, n]), float(shift.w1[b, n])
    for i in range(out_len):
        for j, w in ((s + i, w0), (s + i + 1, w1)):
            if 0 <= j < L:
                A[i, j] += w
    return A


@pytest.mark.parametrize("axis", ["rows", "cols"])
def test_shift_adjoint_is_exact_when_the_output_is_as_long_as_the_input(axis):
    """out_len == L (pad 0): the forward reads zero past the end, and its
    adjoint, K8 on LineShift.adjoint, equals the dense transpose; so does the
    adjoint's adjoint (second order). Through _ShearPass with identity taps,
    float64, to rounding."""
    L, B, N, C = 6, 2, 4, 3
    rng = np.random.RandomState(5)
    frac = rng.rand(B, N).astype(np.float32)
    sh = shift_tables(np.zeros((B, N), np.int32), frac, L, L)
    tax = tsw.ROWS if axis == "rows" else tsw.COLS
    shape = (B, C, L, N) if axis == "rows" else (B, C, N, L)
    z = torch.from_numpy(rng.randn(*shape)).requires_grad_(True)
    g = torch.from_numpy(rng.randn(*shape)).requires_grad_(True)
    v = torch.from_numpy(rng.randn(*shape))
    ident = identity_taps(B, L)
    y = tsw._ShearPass.apply(z, ident, sh, tax, L, None)
    dz, = torch.autograd.grad(y, z, g, create_graph=True)
    dg, = torch.autograd.grad(dz, g, v)

    def lines(t):                                   # [B, C, N, L]: each line's samples
        t = t.detach().numpy()
        return t.transpose(0, 1, 3, 2) if axis == "rows" else t

    want_y, want_dz, want_dg = (np.zeros((B, C, N, L)) for _ in range(3))
    for b in range(B):
        for n in range(N):
            A = dense_shift(sh, b, n, L, L)
            want_y[b, :, n] = lines(z)[b, :, n] @ A.T
            want_dz[b, :, n] = lines(g)[b, :, n] @ A
            want_dg[b, :, n] = lines(v)[b, :, n] @ A.T
    for got, want in ((y, want_y), (dz, want_dz), (dg, want_dg)):
        np.testing.assert_allclose(lines(got), want, rtol=1e-12, atol=1e-12)
    assert torch.autograd.gradcheck(lambda z: tsw._ShearPass.apply(z, ident, sh, tax, L, None),
                                    (z,))


def test_resample_lists_sum_to_the_plain_adjoint():
    """K7-bwd's kernel, emulated: each source line's CSR list summed in its
    order equals the plain scatter-add, and every tap is in exactly one list."""
    for shift, scale, L, out_len in RESAMPLE:
        taps = tsw.line_taps(torch.from_numpy(shift), torch.from_numpy(scale), out_len, L)
        ptr, line, weight = taps.lists
        B = len(shift)
        assert ptr.dtype == line.dtype == torch.int32 and ptr.shape == (B, L + 1)
        assert (ptr[:, 0] == 0).all() and (ptr[:, -1] == 2 * out_len).all()
        dy = torch.randn(B, 2, out_len, 4, generator=torch.Generator().manual_seed(1))
        got = torch.zeros(B, 2, L, 4)
        for b in range(B):
            for l in range(L):
                for e in range(int(ptr[b, l]), int(ptr[b, l + 1])):
                    i = int(line[b, e])
                    assert l in (int(taps.i0[b, i]), int(taps.i1[b, i]))
                    got[b, :, l] += weight[b, e] * dy[b, :, i]
            taps_of = sorted((int(line[b, e]), float(weight[b, e])) for e in range(2 * out_len))
            assert taps_of == sorted([(i, float(taps.w0[b, i])) for i in range(out_len)]
                                     + [(i, float(taps.w1[b, i])) for i in range(out_len)])
        want = tsw.shear_resample_bwd_plain(dy, taps, tsw.ROWS)
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


# ------------------------------------------------------- K7-bwd's lists

def kernel_lists(taps, l0, lines, seed=0):
    """csrc/shear_resample_bwd.cu:build_lists for the source lines l0 ..
    l0 + lines - 1 of every sample, step by step: count the taps that land
    there, scan the counts into starts, place the taps in an order that
    stands for the shared atomics' (a seeded permutation), then order each
    line's taps by their key 2 i + tap. Returns a (start [lines + 1], key,
    weight) a sample."""
    B, n = taps.i0.shape
    line = torch.stack([taps.i0, taps.i1], dim=2).reshape(B, 2 * n).long()
    weight = torch.stack([taps.w0, taps.w1], dim=2).reshape(B, 2 * n)
    g = torch.Generator().manual_seed(seed)
    out = []
    for b in range(B):
        j = line[b] - l0
        kept = torch.nonzero((j >= 0) & (j < lines)).flatten()
        start = torch.zeros(lines + 1, dtype=torch.long)
        start[1:] = torch.bincount(j[kept], minlength=lines).cumsum(0)
        placed = kept[torch.randperm(len(kept), generator=g)]
        # the atomics put each tap somewhere in its line's slots; the sort by key
        # inside each line leaves the lines in order and each sorted by key
        key = placed[torch.argsort(j[placed] * 2 * n + placed)]
        out.append((start, key, weight[b, key]))
    return out


def tile_counts(taps, lines=tsw.V_LINES):
    """The taps each pass-V tile of K7-bwd collects, [B, tiles], from the lists."""
    ptr = taps.lists.ptr.long()
    edges = torch.arange(0, taps.in_len + lines, lines).clamp(max=taps.in_len)
    return ptr[:, edges[1:]] - ptr[:, edges[:-1]]


def extreme_taps(size, out, N=512, seed=0):
    """Pass-V taps of size^2 -> out^2 under N seeded shifts anywhere and
    scales of either sign over the whole promise, 1 / SCALE_MAX ... SCALE_MAX
    (log-uniform), the ends among them."""
    g = torch.Generator().manual_seed(seed)
    lo = math.log(1 / tsw.SCALE_MAX)
    scale = torch.exp(torch.empty(N).uniform_(lo, -lo, generator=g))
    scale[:8], scale[8:16] = 1 / tsw.SCALE_MAX, tsw.SCALE_MAX
    scale = scale * torch.where(torch.rand(N, generator=g) < 0.5, -1.0, 1.0)
    shift = torch.empty(N).uniform_(-4 * size, 4 * size, generator=g)
    pad = size // 2
    return tsw.line_taps(shift, scale, out + 2 * pad, size, pad=pad)


@pytest.mark.parametrize("case", ["canvas bgc", "canvas edges", "canvas extreme", "odd edges",
                                  "odd extreme", "large edges"])
def test_kernel_lists_are_slices_of_the_lists_and_hold_every_tap_once(case):
    """K7-bwd's lists as its blocks build them (kernel_lists): a pass-V
    tile's (V_LINES lines, a rot90 sample's V_ROW_BYTES / 2 in bf16 and
    V_ROW_BYTES / 4 in float32) are the slice of LineTaps.lists from its
    first line on, hold each tap of the sample in exactly one tile, and fit
    the room for 2 out_len taps the kernel gives them; a pass-H block's,
    every tap of its sample, are the lists themselves. Over the pipe's
    seeded bgc draws and branch_maps at the step's canvas, at 67^2 -> 61^2
    and at the 512^2 pipe's canvas, 1048^2 -> 1036^2, and over scales
    across the whole of the plan's range."""
    size, out = {"odd": (67, 61), "canvas": (536, 524), "large": (1048, 1036)}[case.split()[0]]
    if case.endswith("extreme"):
        passes = [("V", extreme_taps(size, out, N=64 if size > 100 else 512))]
    else:
        G = canvas_maps() if case == "canvas bgc" else tsw.branch_maps(12)
        plan = tsw.shear_plan(G, size, size, out, out)
        passes = [("V", plan.v_taps), ("H", plan.h_taps)]
    for name, taps in passes:
        lists = taps.lists
        B, total = taps.i0.shape[0], 2 * taps.out_len
        if name == "H":
            for b, (start, key, weight) in enumerate(kernel_lists(taps, 0, taps.in_len)):
                assert torch.equal(start, lists.ptr[b].long())
                assert torch.equal(key // 2, lists.line[b].long())
                assert torch.equal(weight, lists.weight[b])
            continue
        # a block's lines, a rot90 sample's in bf16 and in float32
        for tile in (tsw.V_LINES, tsw.V_ROW_BYTES // 2, tsw.V_ROW_BYTES // 4):
            assert int(tile_counts(taps, tile).max()) <= total, (case, tile)
            seen = torch.zeros(B, total, dtype=torch.long)
            for l0 in range(0, taps.in_len, tile):
                lines = min(tile, taps.in_len - l0)
                for b, (start, key, weight) in enumerate(kernel_lists(taps, l0, lines, seed=l0)):
                    ptr = lists.ptr[b, l0:l0 + lines + 1].long()
                    assert torch.equal(start, ptr - ptr[0])
                    assert torch.equal(key // 2, lists.line[b, ptr[0]:ptr[-1]].long())
                    assert torch.equal(weight, lists.weight[b, ptr[0]:ptr[-1]])
                    seen[b, key] += 1
            assert bool((seen == 1).all()), (case, tile)


@pytest.mark.parametrize("case", range(len(RESAMPLE)))
def test_kernel_lists_sum_like_the_lists_to_the_bit(case):
    """K7-bwd's sums, emulated over the lists its blocks build (pass V's
    tiles of V_LINES lines, pass H's whole sample), each element from 0 in
    float32 in its list's order, equal the sums over LineTaps.lists to the
    bit, and the plain adjoint to its sums' order."""
    shift, scale, L, out_len = RESAMPLE[case]
    taps = tsw.line_taps(torch.from_numpy(shift), torch.from_numpy(scale), out_len, L)
    B = len(shift)
    dy = torch.randn(B, 3, out_len, 4, generator=torch.Generator().manual_seed(case))
    ptr, line, weight = taps.lists
    want = torch.zeros(B, 3, L, 4)
    for b in range(B):
        for l in range(L):
            for e in range(int(ptr[b, l]), int(ptr[b, l + 1])):
                want[b, :, l] += weight[b, e] * dy[b, :, int(line[b, e])]
    for lines in (tsw.V_LINES, 4, L):                   # pass V's tiles, small ones, pass H's
        got = torch.zeros(B, 3, L, 4)
        for l0 in range(0, L, lines):
            n = min(lines, L - l0)
            for b, (start, key, w) in enumerate(kernel_lists(taps, l0, n, seed=l0)):
                for j in range(n):
                    acc = torch.zeros(3, 4)
                    for e in range(int(start[j]), int(start[j + 1])):
                        acc = acc + w[e] * dy[b, :, int(key[e]) // 2]
                    got[b, :, l0 + j] = acc
        assert torch.equal(got, want), lines
    torch.testing.assert_close(want, tsw.shear_resample_bwd_plain(dy, taps, tsw.ROWS),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_resample_bwd_with_rot_is_the_adjoint_of_the_select_then_the_resample(dtype):
    """shear_resample_bwd with rot (K7-bwd's turn back in its store) is
    _rot90_back of the plain adjoint on the CPU, which is the adjoint of
    pass V's rot90 select followed by stage 1 (autograd's), over branch_maps
    at 16^2 and 67^2 -> 61^2; without rot it is the plain adjoint."""
    for size, out in ((16, 16), (67, 61)):
        plan = tsw.shear_plan(tsw.branch_maps(12), size, size, out, out)
        ps = tsw.warp_passes(plan, 12, 2, size, out)[0]
        g = torch.Generator().manual_seed(size)
        x = torch.randn(ps.shape, generator=g, dtype=dtype, requires_grad=True)
        z = tsw.shear_resample_plain(tsw.rot90_select(x, ps.rot), ps.taps, ps.axis)
        dz = torch.randn(z.shape, generator=g, dtype=dtype)
        want, = torch.autograd.grad(z, x, dz)
        got = tsw.shear_resample_bwd(dz, ps.taps, ps.axis, ps.rot)
        assert torch.equal(got, tsw._rot90_back(tsw.shear_resample_bwd_plain(dz, ps.taps,
                                                                             ps.axis), ps.rot))
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        assert torch.equal(tsw.shear_resample_bwd(dz, ps.taps, ps.axis),
                           tsw.shear_resample_bwd_plain(dz, ps.taps, ps.axis))


def test_resample_bwd_takes_long_taps_and_refuses_rot_along_columns():
    """The wrapper takes taps of any length on the CPU, as the card does
    (its lists have room for every tap of a sample): pass-V taps whose
    2 out_len is past 2560 and pass-H taps of more than 1024 source lines
    and 4096 taps equal the plain adjoint, with rot too; rot along columns,
    or into a non-square output, raises."""
    def taps_of(out_len, in_len):
        return tsw.line_taps(torch.tensor([3.0]), torch.tensor([0.5]), out_len, in_len,
                             pad=in_len // 2)

    g = torch.Generator().manual_seed(5)
    n = 1281
    for dy, taps, axis, rot in (
            (torch.randn(1, 1, n, 8, generator=g), taps_of(n, 600), tsw.ROWS, None),
            (torch.randn(1, 1, n, 600, generator=g), taps_of(n, 600), tsw.ROWS,
             torch.tensor([True])),
            (torch.randn(1, 1, 2, 2085, generator=g), taps_of(2085, 1100), tsw.COLS, None)):
        want = tsw.shear_resample_bwd_plain(dy, taps, axis)
        want = want if rot is None else tsw._rot90_back(want, rot)
        assert torch.equal(tsw.shear_resample_bwd(dy, taps, axis, rot), want)
    sq = taps_of(6, 8)
    with pytest.raises(ValueError, match="rot90"):
        tsw.shear_resample_bwd(torch.randn(1, 1, 8, 6), sq, tsw.COLS, torch.tensor([True]))
    with pytest.raises(ValueError, match="rot90"):
        tsw.shear_resample_bwd(torch.randn(1, 1, 6, 5), sq, tsw.ROWS, torch.tensor([True]))


def test_bwd_constants_equal_the_kernel_source():
    """V_LINES and V_ROW_BYTES, the tiles of the lists' emulation, are
    csrc/shear_resample_bwd.cu's."""
    src = (Path(tsw.__file__).parents[1] / "csrc" / "shear_resample_bwd.cu").read_text()
    const = dict(re.findall(r"constexpr int (V_LINES|V_ROW_BYTES) = (\d+);", src))
    assert {k: int(v) for k, v in const.items()} == {"V_LINES": tsw.V_LINES,
                                                     "V_ROW_BYTES": tsw.V_ROW_BYTES}


def test_wrappers_on_cpu_are_the_plain_versions_and_launch_nothing():
    taps = tsw.line_taps(torch.tensor([1.5]), torch.tensor([0.7]), 6, 8)
    sh = tsw.LineShift(torch.tensor([[1, 0, 2]], dtype=torch.int32), torch.rand(1, 3),
                       torch.rand(1, 3))
    x = torch.randn(1, 2, 8, 3)
    kernels = (tsw.shear_pass, tsw.shear_resample_bwd, tsw.shear_shift)
    before = [k.launches for k in kernels]
    assert torch.equal(tsw.shear_pass(x, taps, sh, tsw.ROWS, 4),
                       tsw.shear_shift_plain(tsw.shear_resample_plain(x, taps, tsw.ROWS), sh,
                                             tsw.ROWS, 4))
    dy = torch.randn(1, 2, 6, 3)
    assert torch.equal(tsw.shear_resample_bwd(dy, taps, tsw.ROWS),
                       tsw.shear_resample_bwd_plain(dy, taps, tsw.ROWS))
    assert torch.equal(tsw.shear_shift(x, sh, tsw.ROWS, 5), tsw.shear_shift_plain(x, sh, tsw.ROWS,
                                                                                  5))
    sq = torch.randn(1, 2, 8, 8)
    rot = torch.tensor([True])
    sh8 = tsw.LineShift(torch.zeros(1, 8, dtype=torch.int32), torch.rand(1, 8), torch.rand(1, 8))
    assert torch.equal(tsw.shear_pass(sq, taps, sh8, tsw.ROWS, 4, rot),
                       tsw.shear_pass_plain(sq.transpose(-1, -2).flip(-2), taps, sh8, tsw.ROWS, 4))
    assert [k.launches for k in kernels] == before
    with pytest.raises(ValueError, match="lines"):
        tsw.shear_shift(x, sh, tsw.COLS, 5)            # 3 lines' tables for 8 rows
    with pytest.raises(ValueError, match="taps of 8"):
        tsw.shear_pass(x, taps, sh, tsw.COLS, 4)
    with pytest.raises(ValueError, match="rot90"):
        tsw.shear_pass(sq, taps, sh8, tsw.COLS, 4, rot)


# ------------------------------------------------ the fused pass's structure

def old_pass(x, taps, shift, axis, out_len, rot=None):
    """The executor's earlier route for one pass: the rot90 select, F.pad's
    reflect by the taps' pad, the padded taps, the shift."""
    src = x if rot is None else tsw.rot90_select(x, rot)
    m = taps.origin[2]
    padded = F.pad(src, [0, 0, m, m] if axis == tsw.ROWS else [m, m, 0, 0], mode="reflect")
    z = tsw.shear_resample_plain(padded, taps.padded(), axis)
    return tsw.shear_shift_plain(z, shift, axis, out_len)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.bfloat16])
@pytest.mark.parametrize("axis", ["rows", "cols"])
@pytest.mark.parametrize("size,out", [(16, 16), (32, 32), (64, 64), (67, 61)])
def test_composed_taps_equal_the_reflect_pad_then_the_padded_taps(size, out, axis, dtype):
    """line_taps with pad: the taps on the unpadded source equal F.pad's
    reflect followed by the taps on the padded axis, to the bit, over
    branch_maps (rot90 both ways, the shear and scale clips, flips); so does
    the whole pass, the rot90 select included, against the earlier route."""
    plan = tsw.shear_plan(tsw.branch_maps(12), size, size, out, out)
    assert 0 < int(plan.rot.sum()) < 12
    ps = tsw.warp_passes(plan, 12, 3, size, out)[0 if axis == "rows" else 1]
    taps = ps.taps
    assert taps.in_len == ps.shape[2 + ps.axis] and taps.origin[2] == size // 2
    assert int(taps.i0.min()) >= 0 and int(taps.i1.max()) < taps.in_len
    x = torch.randn(ps.shape, generator=torch.Generator().manual_seed(size)).to(dtype)
    m = size // 2
    padded = F.pad(x, [0, 0, m, m] if ps.axis == tsw.ROWS else [m, m, 0, 0], mode="reflect")
    assert torch.equal(tsw.shear_resample_plain(x, taps, ps.axis),
                       tsw.shear_resample_plain(padded, taps.padded(), ps.axis))
    assert torch.equal(tsw.shear_pass_plain(x, taps, ps.shift, ps.axis, out, ps.rot),
                       old_pass(x, taps, ps.shift, ps.axis, out, ps.rot))


def canvas_maps(N=4):
    """The G_inv that the bgc pipe (warp_upsample=2) hands the shear warp on
    its canvas, 256^2 frames -> [N, 3, 536^2] -> 524^2, under seeded draws."""
    seen = {}

    def recorded(x, G_inv, out_h, out_w):
        seen["G"] = G_inv.clone()
        return x[..., :out_h, :out_w]

    shear = taug.shear_affine_grid_sample
    taug.shear_affine_grid_sample = recorded
    try:
        pipe = taug.make_augment_pipe(taug.AugmentConfig(**taug.AUGPIPE_SPECS["bgc"],
                                                         warp_upsample=2, warp_mode="shear"))
        with torch.no_grad():
            pipe(torch.Generator().manual_seed(6), torch.rand(N, 3, 256, 256) * 2 - 1,
                 torch.tensor(1.0))
    finally:
        taug.shear_affine_grid_sample = shear
    return seen["G"]


def test_tile_constants_equal_the_kernel_header():
    """V_TILE, H_TILE and V_WINDOW are csrc/shear_lines.cuh's."""
    src = (Path(tsw.__file__).parents[1] / "csrc" / "shear_lines.cuh").read_text()
    const = {k: int(v) for k, v in re.findall(r"\b([VH]_T[RS]|SCALE_MAX|THREADS) = (\d+)", src)}
    assert (const["V_TR"], const["V_TS"]) == tsw.V_TILE
    assert (const["H_TR"], const["H_TS"]) == tsw.H_TILE
    assert const["SCALE_MAX"] == tsw.SCALE_MAX
    jw = re.search(r"V_JW = V_TR \+ SCALE_MAX \* \(V_TS - 1\) \+ 2 \+ 1;", src)
    assert jw and tsw.V_WINDOW == const["V_TR"] + const["SCALE_MAX"] * (const["V_TS"] - 1) + 3


@pytest.mark.parametrize("case", ["canvas bgc", "canvas edges", "odd edges"])
def test_tile_windows_cover_every_tap(case):
    """Each tile's window of stage-1 lines (tile_windows, computed as the
    kernel computes it) holds both taps of every output of the tile, for the
    fused pass's and K8's forward tables and for K8's adjoint ones, at both
    passes; pass V's windows fit the V_WINDOW rows of shared memory."""
    size, out = (67, 61) if case == "odd edges" else (536, 524)
    G = canvas_maps() if case == "canvas bgc" else tsw.branch_maps(12)
    plan = tsw.shear_plan(G, size, size, out, out)
    for ps in tsw.warp_passes(plan, len(G), 3, size, out):
        Lz = ps.taps.out_len
        for shift, out_len in ((ps.shift, out), (ps.shift.adjoint(), Lz)):
            lines = shift.start.shape[1]
            out_r, out_s = (out_len, lines) if ps.axis == tsw.ROWS else (lines, out_len)
            first, count = tsw.tile_windows(shift, ps.axis, out_r, out_s)
            start = shift.start.long()
            i = torch.arange(out_len)
            if ps.axis == tsw.ROWS:
                assert int(count.max()) <= tsw.V_WINDOW
                j = start[:, None, :] + i[None, :, None]                    # [B, out_r, out_s]
                tr, ts = tsw.V_TILE
                rows, cols = i // tr, torch.arange(lines) // ts
                f = first[:, rows][:, :, cols]
                c = count[:, rows][:, :, cols]
            else:
                j = start[:, :, None] + i[None, None, :]                    # [B, out_r, out_s]
                f = first[:, :, i // tsw.H_TILE[1]]
                c = count[:, :, i // tsw.H_TILE[1]]
            assert bool(((j >= f) & (j + 1 < f + c)).all()), (case, ps.name, out_len)
            assert int(count.min()) >= 2


def test_composed_lists_sum_to_the_adjoint_of_the_pad_then_the_padded_taps():
    """K7-bwd's kernel on the composed taps, emulated: each source line's
    CSR list summed in its order equals the adjoint of F.pad's reflect after
    the padded taps (autograd's), float64, at both passes of branch_maps at
    16^2 and 67^2 -> 61^2; every tap is in exactly one list."""
    for size, out in ((16, 16), (67, 61)):
        plan = tsw.shear_plan(tsw.branch_maps(12), size, size, out, out)
        for ps in tsw.warp_passes(plan, 12, 2, size, out):
            taps, ax, m = ps.taps, ps.axis, size // 2
            ptr, line, weight = taps.lists
            B, L = 12, taps.in_len
            assert (ptr[:, 0] == 0).all() and (ptr[:, -1] == 2 * taps.out_len).all()
            x = torch.zeros(ps.shape, dtype=torch.float64, requires_grad=True)
            padded = F.pad(x, [0, 0, m, m] if ax == tsw.ROWS else [m, m, 0, 0], mode="reflect")
            z = tsw.shear_resample_plain(padded, taps.padded(), ax)
            dz = torch.randn(z.shape, dtype=torch.float64,
                             generator=torch.Generator().manual_seed(2))
            want, = torch.autograd.grad(z, x, dz)
            lines_of = (lambda t: t) if ax == tsw.ROWS else (lambda t: t.transpose(2, 3))
            g = lines_of(dz)                                      # [B, C, Lz, other]
            got = torch.zeros(lines_of(want).shape, dtype=torch.float64)
            for b in range(B):
                for l in range(L):
                    for e in range(int(ptr[b, l]), int(ptr[b, l + 1])):
                        got[b, :, l] += float(weight[b, e]) * g[b, :, int(line[b, e])]
            torch.testing.assert_close(got, lines_of(want), rtol=1e-12, atol=1e-12)
            torch.testing.assert_close(tsw.shear_resample_bwd_plain(dz, taps, ax), want,
                                       rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("fn", ["pass", "transpose"])
@pytest.mark.parametrize("axis", ["rows", "cols"])
def test_shear_pass_and_its_transpose_pass_gradcheck(axis, fn):
    """_ShearPass and _ShearPassT, each the other's backward, pass gradcheck
    and gradgradcheck in float64 at 8^2 -> 7^2 over branch_maps (pass V with
    its rot90 samples)."""
    size, out = 8, 7
    plan = tsw.shear_plan(tsw.branch_maps(12), size, size, out, out)
    ps = tsw.warp_passes(plan, 12, 1, size, out)[0 if axis == "rows" else 1]
    if fn == "pass":
        shape = ps.shape

        def f(t):
            return tsw._ShearPass.apply(t, ps.taps, ps.shift, ps.axis, out, ps.rot)
    else:
        shape = list(ps.shape)
        shape[2 + ps.axis] = out

        def f(t):
            return tsw._ShearPassT.apply(t, ps.taps, ps.shift, ps.axis, ps.rot)
    t = torch.randn(shape, dtype=torch.float64, generator=torch.Generator().manual_seed(4))
    t.requires_grad_(True)
    assert torch.autograd.gradcheck(f, (t,))
    assert torch.autograd.gradgradcheck(f, (t,))


@pytest.mark.parametrize("size,out", [(536, 524), (1048, 1036), (2072, 2060)])
def test_shear_warp_backward_at_the_pipes_canvases(size, out):
    """shear_affine_grid_sample's VJP (_ShearPassT, the rot90 samples turned
    back by shear_resample_bwd) equals autograd's through the plain stages
    (rot90_select, shear_resample_plain, shear_shift_plain) in float32, at
    the canvases of the 256^2, 512^2 and 1024^2 pipes (res + 12, doubled),
    over maps that take both rot90 branches and the scale clips."""
    G = tsw.branch_maps(12)[[4, 10, 11]]
    g = torch.Generator().manual_seed(size)
    x = torch.randn(3, 1, size, size, generator=g, requires_grad=True)
    y = tsw.shear_affine_grid_sample(x, G, out, out)
    dy = torch.randn(y.shape, generator=g)
    got, = torch.autograd.grad(y, x, dy)
    plan = tsw.shear_plan(G, size, size, out, out)
    ref = x
    for ps in tsw.warp_passes(plan, 3, 1, size, out):
        src = ref if ps.rot is None else tsw.rot90_select(ref, ps.rot)
        ref = tsw.shear_shift_plain(tsw.shear_resample_plain(src, ps.taps, ps.axis), ps.shift,
                                    ps.axis, out)
    torch.testing.assert_close(y, ref, rtol=0, atol=0)
    want, = torch.autograd.grad(ref, x, dy)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


# -------------------------------------------------------------- the warp

@pytest.mark.parametrize("size,out,C", [(16, 16, 3), (32, 28, 9), (64, 64, 3)])
def test_shear_warp_matches_jax(size, out, C):
    """Value, vjp and second order of shear_affine_grid_sample, over
    branch_maps; the rot90 branch, the flips and every clip are taken."""
    G = tsw.branch_maps(12).numpy()
    plan = tsw.shear_plan(torch.from_numpy(G), size, size, out, out)
    assert 0 < int(plan.rot.sum()) < len(G)
    x = np.random.RandomState(size).randn(len(G), size, size, C).astype(np.float32)
    jfn = jax.jit(lambda x: jsw.shear_affine_grid_sample(x, jnp.asarray(G), out, out))
    check_op(jfn, lambda x: tsw.shear_affine_grid_sample(x, torch.from_numpy(G), out, out),
             [x], [NHWC], NHWC)


def test_shear_warp_refuses_a_g_inv_gradient_and_a_rectangle():
    with pytest.raises(AssertionError, match="G_inv"):
        tsw.shear_affine_grid_sample(torch.zeros(1, 1, 4, 4), torch.eye(3)[None].requires_grad_(),
                                     4, 4)
    with pytest.raises(ValueError, match="square"):
        tsw.shear_affine_grid_sample(torch.zeros(1, 1, 4, 5), torch.eye(3)[None], 4, 4)


def test_warp_antialiased_with_shear_matches_jax():
    """The anti-aliased warp (pad, 12-tap 2x up, shear warp, 2x down) with
    warp_mode="shear" on both sides, C = 9 at 32^2."""
    G = tsw.branch_maps(6).numpy()
    x = np.random.RandomState(3).randn(6, 32, 32, 9).astype(np.float32)
    jHz = jsetup_filter(jaug._SYM6)
    Hz = setup_filter(taug._SYM6)
    jfn = jax.jit(lambda x: jaug._warp_antialiased(x, jnp.asarray(G), jHz, 3, warp_mode="shear"))
    check_op(jfn, lambda x: taug._warp_antialiased(x, torch.from_numpy(G), Hz, 3,
                                                   warp_mode="shear"), [x], [NHWC], NHWC)


# -------------------------------------------------------------- the pipe

@pytest.mark.parametrize("C,p", [(3, 1.0), (9, 0.5)])
def test_bgc_pipe_with_shear_matches_jax(C, p):
    """The bgc pipe with warp_mode="shear" on both sides under the JAX keys:
    value, vjp and second order (R1 through ADA)."""
    x = (np.random.RandomState(11).randn(4, 32, 32, C) * 0.5).astype(np.float32)
    rng = jax.random.PRNGKey(12)
    jpipe, tpipe = pipes("bgc", warp_mode="shear")
    check_op(jax.jit(lambda x: jpipe(rng, x, p)),
             lambda x: tpipe(JaxKeyDraws(rng), x, torch.tensor(p)), [x], [NHWC], NHWC)


def test_gather_and_auto_keep_k4_and_shear_runs_the_shear_executor(monkeypatch):
    """The port's "auto" (like "gather") warps with K4, unlike the JAX
    package's "auto" on a CPU; "shear" calls the shear executor; warp_upsample=1
    is K4 in every mode."""
    calls = []
    monkeypatch.setattr(taug, "affine_grid_sample",
                        lambda *a, **k: calls.append("k4") or a[0][..., :a[2], :a[3]])
    monkeypatch.setattr(taug, "shear_affine_grid_sample",
                        lambda *a, **k: calls.append("shear") or a[0][..., :a[2], :a[3]])
    x = torch.randn(2, 3, 16, 16)
    for mode, upsample, want in (("auto", 2, "k4"), ("gather", 2, "k4"), ("shear", 2, "shear"),
                                 ("shear", 1, "k4")):
        calls.clear()
        pipe = taug.make_augment_pipe(taug.AugmentConfig(xflip=1, warp_mode=mode,
                                                         warp_upsample=upsample))
        pipe(torch.Generator().manual_seed(0), x, torch.tensor(1.0))
        assert calls == [want], (mode, upsample, calls)


def test_auto_resolves_to_the_executor_a_snapshot_names():
    """The loop's resolution of warp_mode (training/loop.py): "auto" is K4's
    "gather" unless a resumed snapshot names an executor, as a converted JAX
    run names "shear"; a mode the setup sets stays."""
    for mode, named, want in (("auto", None, "gather"), ("auto", "shear", "shear"),
                              ("auto", "gather", "gather"), ("gather", "shear", "gather"),
                              ("shear", None, "shear"), ("shear", "gather", "shear")):
        assert taug.resolve_warp_mode(mode, named) == want, (mode, named)
    with pytest.raises(ValueError, match="unknown warp executor"):
        taug.resolve_warp_mode("auto", "bilinear")
    with pytest.raises(ValueError, match="unknown warp_mode"):
        taug.resolve_warp_mode("bilinear")


# -------------------------------------------------------------- the step

def test_ada_step_with_shear_matches_jax(jax_side):
    """test_torch_train.py's ADA step (bgc, warp_upsample=2, augment_p 0.5)
    with warp_mode="shear" on both sides (the JAX package's "auto" on a
    CPU): a step with every phase (R1 through the shear warp's second
    order), then one with the main phases, each held after it."""
    plan = [(True, True), (False, False)]
    for state, stats, jstate, jstats in run_steps(jax_side, None, plan, augment=True,
                                                  warp_mode="shear"):
        assert_stats_close(stats, jstats, GPL_TOL if "Loss/pl_penalty" in jstats else TOL)
        assert_state_close(state, jstate)
    assert state.step == 2
