"""Two-pass shear/scale affine warp (NCHW), and its hand-written kernels.

Counterpart of stylegan_v_tpu/ops/shear_warp.py:shear_affine_grid_sample,
the JAX package's executor of the ADA pipe's anti-aliased warp
(`warp_mode="shear"`). It computes the same map as
ops/grid_sample.py:affine_grid_sample(mode="reflect") in another way: the
affine map of each sample is factored into a vertical and a horizontal
pass, each a shared-scale resample of whole lines (stage 1) followed by a
per-line fractional shift (stage 2):

    pass V:  resample along H (reflect pad by H // 2 in the taps) -> shift along H (per column)
    pass H:  resample along W (reflect pad by W // 2 in the taps) -> shift along W (per row)

The JAX package pads each pass's source by reflection and mirrors the taps
into the padded axis; here `line_taps` composes both index maps, so the taps
index the source itself and no padded copy is made. Samples whose
factorisation is ill-conditioned (|a| < |c|, near a quarter turn) are
warped from their rot90 image, `x.transpose(-1, -2).flip(-2)` (the NHWC
`flip(swapaxes(images, 1, 2), axis=1)` of the JAX package), with
re-derived coefficients; pass V reads it through that map. Shears and
scales are clipped to SHEAR_MAX and SCALE_MAX. Two bilinear passes are not
one 2-D bilinear tap, so the result differs from K4's by interpolation, as
in the JAX package.

The index and coefficient math (`shear_plan`) is the JAX package's, in
float32 and in its order of operations, done once a call with torch
operations on G_inv's device into integer and weight tables: the kernels
and their plain versions read the same tables, so no floor is taken inside
a kernel (the shift's clip is not continuous where the position is 2 J0).

Kernels: `shear_pass` (K7, csrc/shear_pass.cu), a whole pass in one
launch, resample then shift with the intermediate in shared memory;
`shear_shift` (K8, csrc/shear_shift.cu), the shift alone, which the
backward runs on the tables of `LineShift.adjoint`; and `shear_resample_bwd`
(K7-bwd, csrc/shear_resample_bwd.cu), the resample's adjoint, which along
rows also turns the rot90 samples back in its store. On a CUDA
tensor each launches its kernel (float32 or bf16) or raises; on a CPU
tensor it runs its plain PyTorch version, which also takes float64. Each
launch adds one to the wrapper's `launches`.

Numbers: weights and sums are float32 and each stage rounds once to the
payload dtype. The JAX package casts the one-hot matrix and the shift's
fraction to the payload dtype first, so in bf16 the two differ by that
rounding; in float32 both are exact to rounding.

`shear_affine_grid_sample` is differentiable to any order in x: `_ShearPass`
(the fused pass) and `_ShearPassT` (K8 on the adjoint tables, then K7-bwd)
are each other's backward, which R1
through the ADA pipe needs. G_inv takes no gradient (the JAX package's
`dfrac` never reaches a parameter in training).
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional

import torch

from .cuda_build import DTYPE_CODES, entry_point, launch, on_cuda
from .grid_sample import _compute_dtype

SCALE_MAX = 4.0     # |per-axis scale| clip
SHEAR_MAX = 2.0     # |shear slope| clip after the rot90 conditioning
ROWS, COLS = 0, 1   # the axis a stage runs along: dim 2 (H) or dim 3 (W) of NCHW
# the tiles of the fused pass and of K8 (csrc/shear_lines.cuh), (rows, columns) of
# outputs; pass V's window of stage-1 rows: the tile's rows, the spread of its columns'
# starts at SCALE_MAX rows a column with 2 for the floors, and one more
V_TILE, H_TILE = (64, 32), (32, 64)
V_WINDOW = V_TILE[0] + math.ceil(SCALE_MAX * (V_TILE[1] - 1)) + 2 + 1
# K7-bwd (csrc/shear_resample_bwd.cu): a pass-V block owns V_LINES source
# lines (a rot90 sample's V_ROW_BYTES of them: 128 in bf16, 64 in float32)
# and builds their lists of taps; a pass-H block, those of all its sample's
# lines
V_LINES, V_ROW_BYTES = 32, 256
_PTR, _INT = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    "shear_pass": (_PTR,) * 10 + (_INT,) * 9 + (_PTR,),
    "shear_resample_bwd": (_PTR,) * 7 + (_INT,) * 8 + (_PTR,),
    "shear_shift": (_PTR,) * 5 + (_INT,) * 8 + (_PTR,),
}


def _reflect_pad_len(L: int) -> int:
    return L // 2


def _mirror_idx(i: torch.Tensor, size: int) -> torch.Tensor:
    """Mirror integer indices into [0, size), repeating the edge: -1 maps to
    0 and size to size - 1 (unlike F.pad's reflect, which does not repeat it)."""
    period = 2 * size
    i = torch.remainder(i, period)
    return torch.where(i < size, i, period - 1 - i)


def _reflect_idx(r: torch.Tensor, size: int) -> torch.Tensor:
    """F.pad(mode="reflect")'s source index of r in [1 - size, 2 size - 2]:
    -r below 0, 2 (size - 1) - r from size on (no edge repeat)."""
    return torch.where(r < 0, -r, torch.where(r >= size, 2 * (size - 1) - r, r))


class TapLists(NamedTuple):
    """The transpose of a LineTaps: for sample b and source line l, entries
    ptr[b, l] to ptr[b, l + 1] - 1 of line and weight are the output lines
    that tap l and their weights, ordered by line, then tap: the order in
    which K7-bwd sums each source line, and the lists its blocks build on
    the card are slices of these (a tile's lines, ptr[b, l0] onwards).
    int32 ptr [B, in_len + 1], int32 line and float32 weight [B, 2 out_len]."""
    ptr: torch.Tensor
    line: torch.Tensor
    weight: torch.Tensor


class LineTaps:
    """Stage 1's taps: output line i of sample b is w0[b, i] times source
    line i0[b, i] plus w1[b, i] times line i1[b, i], of a source axis of
    in_len lines (int32 i0, i1 and float32 w0, w1 [B, out_len]). `origin`
    is line_taps's (shift, scale, pad), for `padded`: the reflection that
    composes the pad into the taps folds several padded lines onto one, so
    the padded route cannot be recovered from the taps, and its shift and
    scale are shear_plan's intermediates; keeping them here spares the
    checks against that route a second copy of shear_plan's math."""

    def __init__(self, i0, i1, w0, w1, in_len: int, origin=None):
        self.i0, self.i1, self.w0, self.w1, self.in_len = i0, i1, w0, w1, in_len
        self.origin = origin

    @property
    def out_len(self) -> int:
        return self.i0.shape[1]

    @property
    def tables(self):
        return self.i0, self.i1, self.w0, self.w1

    def padded(self) -> "LineTaps":
        """The same taps over the source reflect-padded by `pad` lines at both
        ends, the JAX package's route (F.pad, then these taps)."""
        shift, scale, pad = self.origin
        return line_taps(shift, scale, self.out_len, self.in_len + 2 * pad)

    @functools.cached_property
    def lists(self) -> TapLists:
        """The transposed taps as CSR lists, built with a stable sort: the
        CPU's mirror of the order K7-bwd sums in (no CUDA path builds them)."""
        B, n = self.i0.shape
        key = torch.stack([self.i0, self.i1], dim=2).reshape(B, 2 * n).long()
        weight = torch.stack([self.w0, self.w1], dim=2).reshape(B, 2 * n)
        key, order = torch.sort(key, dim=1, stable=True)
        bounds = torch.arange(self.in_len + 1, device=key.device).expand(B, -1).contiguous()
        ptr = torch.searchsorted(key, bounds)
        return TapLists(ptr.int(), (order // 2).int(), weight.gather(1, order))


def line_taps(shift: torch.Tensor, scale: torch.Tensor, out_len: int, in_len: int,
              pad: int = 0) -> LineTaps:
    """_line_pass_onehot's taps on a source of in_len lines reflect-padded by
    pad (< in_len) at both ends: position scale[b] i + shift[b] of output line
    i (in the padded axis), its floor and the next line mirrored into the
    padded axis, then reflected back into [0, in_len), so that the taps read
    the unpadded source. One reflection is enough, since pad < in_len."""
    i = torch.arange(out_len, dtype=torch.float32, device=scale.device)
    pos = scale[:, None] * i[None, :] + shift[:, None]
    i0 = torch.floor(pos)
    f = pos - i0
    i0 = i0.long()

    def source(i):
        return _reflect_idx(_mirror_idx(i, in_len + 2 * pad) - pad, in_len).int()

    return LineTaps(source(i0), source(i0 + 1), 1.0 - f, f, in_len, (shift, scale, pad))


class LineShift(NamedTuple):
    """Stage 2's shift: output i of line n of sample b is w0[b, n] times input
    start[b, n] + i of that line plus w1[b, n] times input start[b, n] + i + 1,
    reading zero past either end (int32 start, float32 w0, w1 [B, lines]).
    `slope` bounds |start[b, n + 1] - start[b, n]| up to the floors' rounding
    (infinite where nothing bounds it): the pass-V tiles' windows need it."""
    start: torch.Tensor
    w0: torch.Tensor
    w1: torch.Tensor
    slope: float = math.inf

    @property
    def tables(self):
        return self.start, self.w0, self.w1

    def adjoint(self) -> "LineShift":
        """The transposed shift: dz[l] = w0 g[l - start] + w1 g[l - start - 1]."""
        return LineShift(-1 - self.start, self.w1, self.w0, self.slope)


def line_shift(q: torch.Tensor, J0: int, out_len: int, in_len: int,
               slope: float = math.inf) -> LineShift:
    """shift_lines_dense's tables for the per-line offsets q [B, lines]
    (whose neighbours differ by at most `slope`): clipped to +-J0, the start
    k = floor(q + J0) clipped to [0, in_len - out_len - 1], and the fraction."""
    pos = q.clamp(-float(J0), float(J0)) + J0
    k = torch.floor(pos)
    frac = pos - k
    kc = k.long().clamp(0, max(in_len - out_len - 1, 0))
    return LineShift(kc.int(), 1.0 - frac, frac, slope)


class ShearPlan(NamedTuple):
    """The tables of one shear warp: which samples are warped from their
    rot90 image (bool [B]), and each pass's stage 1 taps and stage 2 shift."""
    rot: torch.Tensor
    v_taps: LineTaps
    v_shift: LineShift
    h_taps: LineTaps
    h_shift: LineShift


def _floor_scale(s: torch.Tensor) -> torch.Tensor:
    """|s| at least 1 / SCALE_MAX, keeping its sign."""
    lo = 1.0 / SCALE_MAX
    return torch.where(s.abs() < lo, torch.where(s < 0, -lo, lo), s)


def shear_plan(G_inv: torch.Tensor, H: int, W: int, out_h: int, out_w: int) -> ShearPlan:
    """stylegan_v_tpu/ops/shear_warp.py:366-469's coefficient and index math
    for an H x W input (H == W) and an out_h x out_w output, in float32 on
    G_inv's device; the taps index the unpadded source of each pass."""
    G = G_inv.float()

    def pix_row(g0, g1, g2, in_size):
        # p = A j + B i + T (j = x_out, i = y_out), pixel space
        A = g0 * (in_size / out_w)
        Bc = g1 * (in_size / out_h)
        T = (in_size / 2.0) * (g0 * (1.0 / out_w - 1.0)
                               + g1 * (1.0 / out_h - 1.0) + g2) \
            + (in_size - 1.0) / 2.0
        return A, Bc, T

    a, b, tx = pix_row(G[:, 0, 0], G[:, 0, 1], G[:, 0, 2], W)
    c, d, ty = pix_row(G[:, 1, 0], G[:, 1, 1], G[:, 1, 2], H)

    # conditioning: where |a| < |c|, sample rot[y_r, x_r] = img[x_r, W-1-y_r]
    rot = a.abs() < c.abs()
    a, b, tx, c, d, ty = (torch.where(rot, c, a), torch.where(rot, d, b),
                          torch.where(rot, ty, tx), torch.where(rot, -a, c),
                          torch.where(rot, -b, d), torch.where(rot, (W - 1.0) - tx, ty))

    # factor M = H_x o V_y
    sgn_a = torch.where(a < 0, -1.0, 1.0)
    a_safe = sgn_a * a.abs().clamp_min(1e-3)
    c1 = (c / a_safe).clamp(-SHEAR_MAX, SHEAR_MAX)          # vertical shear, |c1| <= 1
    d1 = (d - c1 * b).clamp(-SCALE_MAX, SCALE_MAX)          # vertical scale
    e = ty - c1 * tx
    a_h = a.clamp(-SCALE_MAX, SCALE_MAX)                    # horizontal scale
    b_h = b.clamp(-SHEAR_MAX, SHEAR_MAX)                    # horizontal shear
    d1, a_h = _floor_scale(d1), _floor_scale(a_h)

    # pass V: z[j] = src[d1 (j - J0) + s_mid], then mid[y, x] = z[y + J0 + q_x, x];
    # q moves |c1 / d1| <= SCALE_MAX a column
    Mv, J0 = _reflect_pad_len(H), H // 2
    Lz = out_h + 2 * J0
    s_mid = e + Mv + c1 * (W - 1.0) / 2.0
    v_taps = line_taps(s_mid - d1 * J0, d1, Lz, H, pad=Mv)
    cols = torch.arange(W, dtype=torch.float32, device=G.device)[None, :]
    q = (c1 / d1)[:, None] * (cols - (W - 1.0) / 2.0)
    v_shift = line_shift(q, J0, out_h, Lz, slope=SCALE_MAX)

    # pass H: the same along x, with the shift per output row
    Mh, J0h = _reflect_pad_len(W), W // 2
    Lz2 = out_w + 2 * J0h
    r_mid = tx + Mh + b_h * (out_h - 1.0) / 2.0
    h_taps = line_taps(r_mid - a_h * J0h, a_h, Lz2, W, pad=Mh)
    rows = torch.arange(out_h, dtype=torch.float32, device=G.device)[None, :]
    q2 = (b_h / a_h)[:, None] * (rows - (out_h - 1.0) / 2.0)
    h_shift = line_shift(q2, J0h, out_w, Lz2)
    return ShearPlan(rot, v_taps, v_shift, h_taps, h_shift)


def branch_maps(N: int, device=None) -> torch.Tensor:
    """N inverse maps [N, 3, 3] (float32, normalized) that between them take
    every branch of `shear_plan`, cycled, for checks of the executor and its
    kernels: the JAX package's test transforms (tests/test_shear_warp.py:
    30-42: the identity, fractional and integer translations, rotations by
    0.35, pi/2 + 0.15 (the rot90 conditioning) and pi, a scale, a general
    map), then a flip (a < 0), a shear past SHEAR_MAX, scales past SCALE_MAX
    and below its floor, and a near quarter turn the other way with a flip."""
    def m(rows):
        return torch.tensor(rows, dtype=torch.float64)

    def rot(t):
        c, s = math.cos(t), math.sin(t)
        return m([[c, -s, 0], [s, c, 0], [0, 0, 1]])

    def scale(sx, sy):
        return m([[sx, 0, 0], [0, sy, 0], [0, 0, 1]])

    def trans(tx, ty):
        return m([[1, 0, tx], [0, 1, ty], [0, 0, 1]])

    maps = [torch.eye(3, dtype=torch.float64), trans(0.3 / 16, -0.7 / 16),
            trans(4 * 2 / 32, -6 * 2 / 32), rot(0.35), rot(math.pi / 2 + 0.15), rot(math.pi),
            scale(0.75, 1.3), rot(0.5) @ scale(1.2, 0.8) @ trans(0.1, -0.2),
            scale(-1, 1) @ rot(0.2), m([[1, 2.7, 0.1], [0.3, 1, -0.2], [0, 0, 1]]),
            scale(5.0, 0.1), rot(-math.pi / 2 + 0.05) @ scale(-1.1, 0.9)]
    return torch.stack([maps[i % len(maps)] for i in range(N)]).float().to(device)


class WarpPass(NamedTuple):
    """One pass of a shear warp of [N, C, H, H] to out x out: its name, its
    tables, its axis, its input's shape, its output's length along the axis,
    and the rot90 flags it reads its source through (pass V) or None."""
    name: str
    taps: LineTaps
    shift: LineShift
    axis: int
    shape: tuple
    out_len: int
    rot: Optional[torch.Tensor]


def warp_passes(plan: ShearPlan, N: int, C: int, H: int, out: int):
    """The two passes of a shear warp of [N, C, H, H] to out x out under `plan`."""
    return [WarpPass("V", plan.v_taps, plan.v_shift, ROWS, (N, C, H, H), out, plan.rot),
            WarpPass("H", plan.h_taps, plan.h_shift, COLS, (N, C, out, H), out, None)]


def tile_windows(shift: LineShift, axis: int, out_r: int, out_s: int):
    """The stage-1 lines that each tile of the fused pass and of K8 stages,
    as csrc/shear_lines.cuh:line_kernel computes them, for an output of
    out_r x out_s: (first, count), int64 [B, tiles, tiles along the axis]
    along rows (a V_TILE tile's rows first .. first + count - 1 of z, from
    its least start plus its first row to its greatest start plus its last
    row plus 1), [B, out_r, tiles along the columns] along columns (row r's
    window of an H_TILE tile: first = start[r] plus the tile's first column,
    count = its width plus 1)."""
    start = shift.start.long()
    B = start.shape[0]
    if axis == ROWS:
        (tr, ts), n = V_TILE, -(-out_s // V_TILE[1])
        padded = torch.cat([start, start[:, -1:].expand(B, n * ts - out_s)], dim=1)
        lo = padded.view(B, n, ts).amin(dim=2)
        hi = padded.view(B, n, ts).amax(dim=2)
        i_lo = torch.arange(0, out_r, tr, device=start.device)
        rows = (out_r - i_lo).clamp(max=tr)
        first = lo[:, None, :] + i_lo[None, :, None]
        return first, (hi - lo)[:, None, :] + rows[None, :, None] + 1
    ts = H_TILE[1]
    s_lo = torch.arange(0, out_s, ts, device=start.device)
    width = (out_s - s_lo).clamp(max=ts)
    first = start[:, :, None] + s_lo[None, None, :]
    return first, (width + 1).expand_as(first)


# ------------------------------------------------------------ plain versions

def _along(t: torch.Tensor, axis: int) -> torch.Tensor:
    """A table [B, n] indexed along `axis`, broadcast over NCHW."""
    return t[:, None, :, None] if axis == ROWS else t[:, None, None, :]


def _stage_shape(x: torch.Tensor, axis: int, n: int):
    """x's shape with length n along `axis`."""
    shape = list(x.shape)
    shape[2 + axis] = n
    return shape


def rot90_select(x: torch.Tensor, rot: torch.Tensor) -> torch.Tensor:
    """Pass V's source: x, or for the samples with rot set its rot90 image."""
    return torch.where(rot[:, None, None, None], x.transpose(-1, -2).flip(-2), x)


def _rot90_back(g: torch.Tensor, rot: torch.Tensor) -> torch.Tensor:
    """The adjoint of rot90_select: the rot90 samples' g turned back."""
    return torch.where(rot[:, None, None, None], g.flip(-2).transpose(-1, -2), g)


def shear_resample_plain(x: torch.Tensor, taps: LineTaps, axis: int) -> torch.Tensor:
    """Plain PyTorch version of stage 1: two gathers along `axis`, the
    two-tap sum in float32 (float64 for a float64 x), cast back once."""
    ct = _compute_dtype(x)
    xf = x.to(ct)
    shape = _stage_shape(x, axis, taps.out_len)
    g0 = xf.gather(2 + axis, _along(taps.i0.long(), axis).expand(shape))
    g1 = xf.gather(2 + axis, _along(taps.i1.long(), axis).expand(shape))
    out = _along(taps.w0.to(ct), axis) * g0 + _along(taps.w1.to(ct), axis) * g1
    return out.to(x.dtype)


def shear_resample_bwd_plain(dy: torch.Tensor, taps: LineTaps, axis: int) -> torch.Tensor:
    """Plain PyTorch version of K7-bwd, the transpose of
    `shear_resample_plain`: each tap's weight times dy scatter-added into its
    source line, in float32 (float64 for a float64 dy), cast back once."""
    ct = _compute_dtype(dy)
    d = dy.to(ct)
    dx = torch.zeros(_stage_shape(dy, axis, taps.in_len), dtype=ct, device=dy.device)
    for idx, w in ((taps.i0, taps.w0), (taps.i1, taps.w1)):
        dx.scatter_add_(2 + axis, _along(idx.long(), axis).expand(dy.shape),
                        _along(w.to(ct), axis) * d)
    return dx.to(dy.dtype)


def shear_shift_plain(z: torch.Tensor, shift: LineShift, axis: int, out_len: int) -> torch.Tensor:
    """Plain PyTorch version of K8: per line, two gathers along `axis` from
    start + i and start + i + 1 (zero outside the axis), the two-tap sum in
    float32 (float64 for a float64 z), cast back once."""
    ct = _compute_dtype(z)
    zf = z.to(ct)
    L = z.shape[2 + axis]
    j = shift.start.long()[:, :, None] + torch.arange(out_len, device=z.device)  # [B, lines, out]
    j = (j.transpose(1, 2) if axis == ROWS else j)[:, None]
    shape = _stage_shape(z, axis, out_len)

    def tap(j):
        g = zf.gather(2 + axis, j.clamp(0, L - 1).expand(shape))
        return torch.where((j >= 0) & (j < L), g, 0.0)

    lines = 1 - axis        # the lines run across the axis
    out = _along(shift.w0.to(ct), lines) * tap(j) + _along(shift.w1.to(ct), lines) * tap(j + 1)
    return out.to(z.dtype)


def shear_pass_plain(x: torch.Tensor, taps: LineTaps, shift: LineShift, axis: int,
                     out_len: int, rot: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of the fused pass: pass V's rot90 select (where
    rot is given), stage 1, its output rounded to x's dtype, then stage 2."""
    src = x if rot is None else rot90_select(x, rot)
    return shear_shift_plain(shear_resample_plain(src, taps, axis), shift, axis, out_len)


# ------------------------------------------------------------------- kernels

def _check(t: torch.Tensor, axis: int, tables, name: str) -> None:
    if t.ndim != 4:
        raise ValueError(f"{name} needs NCHW, got shape {tuple(t.shape)}")
    if axis not in (ROWS, COLS):
        raise ValueError(f"{name}: axis must be {ROWS} (rows) or {COLS} (columns), got {axis}")
    if any(tab.shape[0] != t.shape[0] or tab.device != t.device for tab in tables):
        raise ValueError(f"{name} needs tables of {t.shape[0]} samples on {t.device}")


def _check_lines(t: torch.Tensor, shift: LineShift, axis: int, name: str) -> None:
    if shift.start.shape[1] != t.shape[3 - axis]:
        raise ValueError(f"{name}: tables of {shift.start.shape[1]} lines for "
                         f"{tuple(t.shape)} along axis {axis}")


def _window_fits(shift: LineShift, axis: int, name: str) -> None:
    """Raise where a pass-V tile's window could outgrow the V_WINDOW rows the
    kernel holds in shared memory: tables whose slope exceeds SCALE_MAX."""
    if axis == ROWS and not shift.slope <= SCALE_MAX:
        raise ValueError(f"{name}: pass-V tables of slope {shift.slope} could need windows "
                         f"past the {V_WINDOW} rows of shared memory (slope at most "
                         f"{SCALE_MAX}, as shear_plan's)")


def _launch(wrapper, t: torch.Tensor, out: torch.Tensor, tables, axis: int, *extra) -> None:
    """Launch the kernel of `wrapper` (its C entry point has the wrapper's
    name) from t into out on the current stream; count it. A table of None
    is a null pointer; `extra` ints follow the shapes."""
    name = wrapper.__name__
    if t.dtype not in DTYPE_CODES:
        raise ValueError(f"{name} takes float32 or bfloat16, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} needs a contiguous NCHW tensor")
    if not all(tab is None or (tab.is_contiguous()
                               and tab.dtype in (torch.int32, torch.float32, torch.bool))
               for tab in tables):
        raise ValueError(f"{name} needs contiguous int32, float32 and bool tables")
    N, C, R, S = t.shape
    out_r, out_s = out.shape[2:]
    if N * C > 65535 or -(-out_r // 8) > 65535:          # the grid's z and y
        raise ValueError(f"{name} takes at most 65535 planes and {8 * 65535} output rows")
    if out.numel() == 0:
        return
    args = (t.data_ptr(), out.data_ptr(), *(0 if tab is None else tab.data_ptr()
                                            for tab in tables),
            DTYPE_CODES[t.dtype], axis, N * C, C, R, S, out_r, out_s, *extra)
    launch(name, entry_point(name, _ARGTYPES[name]), args, t.device.index)
    wrapper.launches += 1


def shear_pass(x: torch.Tensor, taps: LineTaps, shift: LineShift, axis: int, out_len: int,
               rot: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One pass of the shear warp (K7): x [N, C, R, S] resampled along `axis`
    by taps (of taps.in_len == x's length there), then each line shifted to
    out_len (along rows the lines are the columns, tables [N, S]; along
    columns the rows, tables [N, R]); along rows, the samples with rot set
    read x's rot90 image (R == S). A CPU tensor goes to `shear_pass_plain`; a
    CUDA tensor (float32 or bfloat16, contiguous; tables on its device) to
    the CUDA kernel, or raises. No autograd graph: `_ShearPass` carries the
    gradient."""
    _check(x, axis, (*taps.tables, *shift.tables) + ((rot,) if rot is not None else ()),
           "shear_pass")
    if x.shape[2 + axis] != taps.in_len:
        raise ValueError(f"shear_pass: taps of {taps.in_len} lines for {tuple(x.shape)}")
    _check_lines(x, shift, axis, "shear_pass")
    if rot is not None and (axis != ROWS or x.shape[2] != x.shape[3]):
        raise ValueError("shear_pass reads a rot90 image only along rows, of a square input")
    if not on_cuda(x, "shear_pass"):
        return shear_pass_plain(x, taps, shift, axis, out_len, rot)
    _window_fits(shift, axis, "shear_pass")
    y = torch.empty(_stage_shape(x, axis, out_len), dtype=x.dtype, device=x.device)
    _launch(shear_pass, x, y, (*taps.tables, rot, *shift.tables), axis, taps.out_len)
    return y


shear_pass.launches = 0


def shear_resample_bwd(dy: torch.Tensor, taps: LineTaps, axis: int,
                       rot: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The adjoint of stage 1 (`shear_resample_plain(., taps, axis)`):
    [N, C, out_len, S] -> [N, C, in_len, S] along rows, likewise along
    columns (K7-bwd); along rows with `rot` given, then the adjoint of pass
    V's rot90 select (in_len == S), which turns the samples with rot set
    back. A CPU tensor goes to `shear_resample_bwd_plain` (and
    `_rot90_back`); a CUDA tensor to one launch of the CUDA kernel, whose
    blocks build their lists of taps from the tables, sum each element in
    float32 in the order of `LineTaps.lists` and write dx once in dy's
    dtype, or raises (where out_len is too long for the lists to fit in
    shared memory, past about 6,800 lines: csrc/shear_resample_bwd.cu)."""
    _check(dy, axis, (taps.i0,) + ((rot,) if rot is not None else ()), "shear_resample_bwd")
    if dy.shape[2 + axis] != taps.out_len:
        raise ValueError(f"shear_resample_bwd: taps of {taps.out_len} lines for "
                         f"{tuple(dy.shape)}")
    if rot is not None and (axis != ROWS or taps.in_len != dy.shape[3]):
        raise ValueError("shear_resample_bwd turns rot90 samples back only along rows, into a "
                         "square output")
    if not on_cuda(dy, "shear_resample_bwd"):
        dx = shear_resample_bwd_plain(dy, taps, axis)
        return dx if rot is None else _rot90_back(dx, rot)
    dx = torch.empty(_stage_shape(dy, axis, taps.in_len), dtype=dy.dtype, device=dy.device)
    _launch(shear_resample_bwd, dy, dx, (*taps.tables, rot), axis)
    return dx


shear_resample_bwd.launches = 0


def shear_shift(z: torch.Tensor, shift: LineShift, axis: int, out_len: int) -> torch.Tensor:
    """Shift each line of z [N, C, R, S] along `axis` to out_len outputs
    (K8): along rows the lines are the columns (tables [N, S]), along columns
    the rows (tables [N, R]). A CPU tensor goes to `shear_shift_plain`; a
    CUDA tensor to the CUDA kernel, or raises."""
    _check(z, axis, shift.tables, "shear_shift")
    _check_lines(z, shift, axis, "shear_shift")
    if not on_cuda(z, "shear_shift"):
        return shear_shift_plain(z, shift, axis, out_len)
    _window_fits(shift, axis, "shear_shift")
    y = torch.empty(_stage_shape(z, axis, out_len), dtype=z.dtype, device=z.device)
    _launch(shear_shift, z, y, shift.tables, axis)
    return y


shear_shift.launches = 0


# ------------------------------------------------------------------ autograd

class _ShearPass(torch.autograd.Function):
    """The fused pass with a gradient: forward `shear_pass`, backward
    `_ShearPassT`. The tables are constants of the call."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, taps: LineTaps, shift: LineShift, axis: int,
                out_len: int, rot: Optional[torch.Tensor]) -> torch.Tensor:
        ctx.tables = taps, shift, axis, rot
        return shear_pass(x.contiguous(), taps, shift, axis, out_len, rot)

    @staticmethod
    def backward(ctx, dy: torch.Tensor):
        taps, shift, axis, rot = ctx.tables
        return (_ShearPassT.apply(dy, taps, shift, axis, rot),) + (None,) * 5


class _ShearPassT(torch.autograd.Function):
    """The transpose of the fused pass: the adjoint shift's start table (one
    elementwise op on [N, lines] ints), K8 on the adjoint tables back to
    stage 1's length, then K7-bwd, which along rows turns the rot90 samples
    back in its store. Backward `_ShearPass`."""

    @staticmethod
    def forward(ctx, dy: torch.Tensor, taps: LineTaps, shift: LineShift, axis: int,
                rot: Optional[torch.Tensor]) -> torch.Tensor:
        ctx.tables, ctx.out_len = (taps, shift, axis), dy.shape[2 + axis]
        ctx.rot = rot
        dz = shear_shift(dy.contiguous(), shift.adjoint(), axis, taps.out_len)
        return shear_resample_bwd(dz, taps, axis, rot)

    @staticmethod
    def backward(ctx, ddx: torch.Tensor):
        return (_ShearPass.apply(ddx, *ctx.tables, ctx.out_len, ctx.rot),) + (None,) * 4


def shear_affine_grid_sample(x: torch.Tensor, G_inv: torch.Tensor, out_h: int,
                             out_w: int) -> torch.Tensor:
    """Warp x [N, C, H, W] (H == W) by per-sample inverse maps G_inv [N, 3, 3]
    (normalized, align_corners=False) to [N, C, out_h, out_w] with the two
    shear passes, mirrored at the borders: the function of
    affine_grid_sample(mode="reflect"), differentiable in x to any order.
    G_inv must not require a gradient."""
    assert not G_inv.requires_grad, "shear_affine_grid_sample takes no gradient for G_inv"
    if x.ndim != 4:
        raise ValueError(f"shear_affine_grid_sample needs NCHW, got shape {tuple(x.shape)}")
    N, C, H, W = x.shape
    if H != W:
        raise ValueError(f"shear_affine_grid_sample needs a square input, got {H} x {W}")
    if tuple(G_inv.shape) != (N, 3, 3):
        raise ValueError(f"shear_affine_grid_sample needs G_inv [{N}, 3, 3], "
                         f"got {tuple(G_inv.shape)}")
    plan = shear_plan(G_inv, H, W, out_h, out_w)
    mid = _ShearPass.apply(x, plan.v_taps, plan.v_shift, ROWS, out_h, plan.rot)
    return _ShearPass.apply(mid, plan.h_taps, plan.h_shift, COLS, out_w, None)
