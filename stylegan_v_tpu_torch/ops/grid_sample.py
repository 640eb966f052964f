"""Differentiable bilinear affine warping (NCHW), and its hand-written kernels.

Counterpart of stylegan_v_tpu/ops/grid_sample.py, which warps NHWC images
with an XLA gather. Conventions follow torch's align_corners=False:

  output pixel (i, j) -> normalized (x, y) = ((2j+1)/W_out - 1, (2i+1)/H_out - 1)
  input sample [x', y', 1]^T = G_inv[:2, :] @ [x, y, 1]
  input pixel   px = ((x' + 1) * W_in - 1) / 2

Out-of-bounds handling is 'reflect' (mirror around the half-pixel borders,
the ADA pipe's) or 'zeros'. `x0 = floor(px)` is clipped to the image and the
right neighbour is `min(x0 + 1, W - 1)`, while the weight comes from the
unclipped floor: for px in [-0.5, 0) the taps are pixels 0 and 1, as in the
JAX package (not a true mirror).

`affine_warp(x, G_inv, out_h, out_w, mode)` (K4) samples; its adjoint
`affine_warp_bwd(dy, G_inv, H, W, mode)` (K4-bwd) sums the output gradient
back into the image. On a CUDA tensor each launches its CUDA kernel
(csrc/affine_warp.cu, csrc/affine_warp_bwd.cu; float32 or bf16, the output
in the input's dtype) or raises; on a CPU tensor it runs its plain PyTorch
version, which also takes float64. Each launch adds one to the wrapper's
`launches`. K4's kernel stages each output tile's input box in shared
memory; `_warp_tile_boxes` computes the boxes in Python as the kernel does,
for the tests. K4-bwd's kernel is a gather without atomics, deterministic:
each thread sums over its input pixel's footprint, which `_warp_footprint`
enumerates in Python as the kernel does, for the tests.

`affine_grid_sample` is the differentiable warp: `_AffineWarp` (forward K4,
backward `_AffineWarpT`) and `_AffineWarpT` (forward K4-bwd, backward
`_AffineWarp`) carry it to any order, which R1 through the ADA pipe needs.
G_inv takes no gradient. A plain `F.grid_sample` would not do: its reflect
clamp differs from the JAX package's in the border half pixel, and its
double backward with respect to the input is what the original's
grid_sample_gradfix was for.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from .cuda_build import DTYPE_CODES, entry_point, launch, on_cuda

MODES = {"reflect": 0, "zeros": 1}
BWD_CHUNK = 9          # channels one thread of K4-bwd sums (csrc/affine_warp_bwd.cu:CHUNK)
BWD_QX, BWD_QY = 1, 2  # input pixels one thread of K4-bwd owns (csrc/affine_warp_bwd.cu:QX, QY)
_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_void_p)


def _reflect_coords(px: torch.Tensor, size: int) -> torch.Tensor:
    """Mirror px into [-0.5, size-0.5] with reflective boundaries (no edge repeat)."""
    u = px + 0.5
    period = 2.0 * size
    v = torch.remainder(u, period)
    v = size - torch.abs(size - v)
    return v - 0.5


def _grid(n: int, device) -> torch.Tensor:
    """(2i + 1) / n - 1 in float32, with n as a 0-dim tensor: CUDA divides a
    tensor by a Python scalar as a multiplication by its reciprocal, which
    the kernels and the JAX package do not."""
    i = torch.arange(n, dtype=torch.float32, device=device)
    return (2.0 * i + 1.0) / torch.full((), float(n), device=device) - 1.0


def _raw_positions(G_inv: torch.Tensor, H: int, W: int, out_h: int, out_w: int):
    """The raw sample position (px, py) of every output pixel, before the
    mirror: two float32 [N, out_h, out_w]."""
    G = G_inv.float()
    gy, gx = torch.meshgrid(_grid(out_h, G.device), _grid(out_w, G.device), indexing="ij")
    xin = G[:, 0, 0, None, None] * gx + G[:, 0, 1, None, None] * gy + G[:, 0, 2, None, None]
    yin = G[:, 1, 0, None, None] * gx + G[:, 1, 1, None, None] * gy + G[:, 1, 2, None, None]
    return ((xin + 1.0) * W - 1.0) / 2.0, ((yin + 1.0) * H - 1.0) / 2.0


def _sample_taps(G_inv: torch.Tensor, H: int, W: int, out_h: int, out_w: int, mode: str):
    """Per output pixel [N, out_h, out_w]: the clipped tap indices x0, x1, y0,
    y1 (int64), the weights wx, wy (float32) and the in-bounds mask (zeros
    mode; None in reflect mode). The geometry of csrc/affine_warp.cuh."""
    if mode not in MODES:
        raise ValueError(mode)
    px, py = _raw_positions(G_inv, H, W, out_h, out_w)
    mask = None
    if mode == "reflect":
        px, py = _reflect_coords(px, W), _reflect_coords(py, H)
    else:
        mask = (px > -1.0) & (px < W) & (py > -1.0) & (py < H)
    x0, y0 = torch.floor(px), torch.floor(py)
    wx, wy = px - x0, py - y0
    x0i, y0i = x0.clamp(0, W - 1).long(), y0.clamp(0, H - 1).long()
    return x0i, (x0i + 1).clamp_max(W - 1), y0i, (y0i + 1).clamp_max(H - 1), wx, wy, mask


# The footprint of K4-bwd's gather: the constants of csrc/affine_warp_bwd.cu.
MAX_PERIODS = 4.0      # a hull wider than this many mirror periods: scan
SINGULAR = 1e-6        # |det| at most this times (|a|+|b|)(|d|+|e|): scan
MAX_COORD = 2.0 ** 16  # a hull reaching this far (or not finite): scan
MAX_INTERVALS = 16     # raw intervals of one pixel, at most


class _Axis(NamedTuple):
    """One axis of the raw sample position of output pixel (ox, oy) in
    float64: p = u ox + v oy + w, its hull [lo, hi] over the grid widened by
    the margin (which exceeds the float32 geometry's rounding), and 1 / P
    (P = 2 size, the mirror's period); u, 1 / u (0 for u = 0), v and w as
    float32, for the rows' ranges."""
    u: float
    v: float
    w: float
    lo: float
    hi: float
    margin: float
    inv_p: float
    uf: np.float32
    inv_uf: np.float32
    vf: np.float32
    wf: np.float32


def _warp_axis(g0: float, g1: float, g2: float, size: int, out_w: int, out_h: int) -> _Axis:
    """make_axis, line by line."""
    g0, g1, g2 = float(g0), float(g1), float(g2)
    inv_w, inv_h = 1.0 / out_w, 1.0 / out_h
    u = g0 * size * inv_w
    v = g1 * size * inv_h
    w = 0.5 * size * (g0 * (inv_w - 1.0) + g1 * (inv_h - 1.0) + g2 + 1.0) - 0.5
    margin = 2.0 ** -6 + 2.0 ** -18 * (0.5 * size * (abs(g0) + abs(g1) + abs(g2) + 1.0)
                                       + 2.0 * size + 1.0)
    ex, ey = u * (out_w - 1), v * (out_h - 1)
    return _Axis(u, v, w, w + min(ex, 0.0) + min(ey, 0.0) - margin,
                 w + max(ex, 0.0) + max(ey, 0.0) + margin, margin, 0.5 / size,
                 np.float32(u), np.float32(1.0 / u if u != 0.0 else 0.0), np.float32(v),
                 np.float32(w))


def _warp_frame(g, H: int, W: int, out_h: int, out_w: int, zeros: bool):
    """make_frame: both axes of one image's map and 1/det of its linear part,
    or None where the enumeration does not apply (the kernel scans the whole
    grid); a NaN fails every test."""
    ax = _warp_axis(g[0, 0], g[0, 1], g[0, 2], W, out_w, out_h)
    ay = _warp_axis(g[1, 0], g[1, 1], g[1, 2], H, out_w, out_h)
    det = ax.u * ay.v - ax.v * ay.u
    bounded = (abs(det) > SINGULAR * (abs(ax.u) + abs(ax.v)) * (abs(ay.u) + abs(ay.v))
               and max(abs(ax.lo), abs(ax.hi)) < MAX_COORD
               and max(abs(ay.lo), abs(ay.hi)) < MAX_COORD
               and (zeros or (ax.hi - ax.lo <= MAX_PERIODS * 2.0 * W
                              and ay.hi - ay.lo <= MAX_PERIODS * 2.0 * H)))
    return (ax, ay, 1.0 / det) if bounded else None


def _tap_intervals(i0: int, i1: int, size: int, ax: _Axis, mirror: bool):
    """make_intervals: the sorted, disjoint raw positions whose taps may land
    on pixels i0..i1 of an axis. The mirrored position lies in (i0-1, i1+1),
    or in [-1, 0) for pixel 1 (the x0 clip), widened by the margin; with the
    mirror each period k gives B_k = [kP-1-hi, kP-1-lo] then
    A_k = [kP+lo, kP+hi] (P = 2 size). Clipped to the hull, merged when
    closer than the margin."""
    lo = (-1.0 if i0 <= 1 else i0 - 1.0) - ax.margin
    hi = i1 + 1.0 + ax.margin
    P = 2.0 * size if mirror else 0.0
    k0 = math.floor((ax.lo - hi) * ax.inv_p) if mirror else 0
    k1 = math.ceil((ax.hi + 1.0 + hi) * ax.inv_p) if mirror else 0
    merged = []
    for k in range(k0, k1 + 1):
        for side in range(0 if mirror else 1, 2):
            base = k * P
            s = max(base - 1.0 - hi if side == 0 else base + lo, ax.lo)
            e = min(base - 1.0 - lo if side == 0 else base + hi, ax.hi)
            if s > e:
                continue
            if merged and s <= merged[-1][1] + ax.margin:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
    assert len(merged) <= MAX_INTERVALS, (i0, i1, merged)
    return merged


def _clip_range(t0, t1, n: int):
    """clip_range: ceil(t0) and floor(t1) clipped to [0, n - 1]."""
    return (int(min(max(np.ceil(t0), 0.0), n)), int(max(min(np.floor(t1), n - 1), -1.0)))


def _solve_row(s: np.float32, inv_s: np.float32, r: np.float32, lo: np.float32,
               hi: np.float32):
    """solve: the ox of a row whose raw position s ox + r lies in [lo, hi],
    in float32, as (t0, t1); empty if t0 > t1."""
    if s > 0:
        return (lo - r) * inv_s, (hi - r) * inv_s
    if s < 0:
        return (hi - r) * inv_s, (lo - r) * inv_s
    return (-np.inf, np.inf) if lo <= r <= hi else (np.inf, -np.inf)


def _warp_footprint(G_inv, H: int, W: int, out_h: int, out_w: int, mode: str = "reflect"):
    """For each image n and input pixel (iy, ix) of an H x W input, the output
    pixels (flat, oy * out_w + ox) that K4-bwd's thread for that pixel counts,
    in its order: csrc/affine_warp_bwd.cu's enumeration line by line, for the
    BWD_QX x BWD_QY pixels of a thread together (its float64 rows may fuse
    multiply-adds, which the margin absorbs). A superset of the output pixels
    with a tap on the pixel, without repeats; an image whose map has no
    bounded footprint visits the whole grid. Returns a list over n of lists
    over iy * W + ix of int64 arrays."""
    if mode not in MODES:
        raise ValueError(mode)
    zeros = mode == "zeros"
    G_inv = torch.as_tensor(G_inv).detach().cpu().float()
    rxs, rys = (r.numpy() for r in _raw_positions(G_inv, H, W, out_h, out_w))
    everything = np.arange(out_h * out_w, dtype=np.int64)
    footprints = []
    for g, rx, ry in zip(G_inv.numpy(), rxs, rys):
        frame = _warp_frame(g, H, W, out_h, out_w, zeros)
        if frame is None:
            footprints.append([everything] * (H * W))
            continue
        ax, ay, inv_det = frame
        xs = [_tap_intervals(i, min(i + BWD_QX, W) - 1, W, ax, not zeros)
              for i in range(0, W, BWD_QX)]
        ys = [_tap_intervals(i, min(i + BWD_QY, H) - 1, H, ay, not zeros)
              for i in range(0, H, BWD_QY)]
        image = [None] * (H * W)
        for ty, y_iv in enumerate(ys):
            for tx, x_iv in enumerate(xs):
                visits = []
                for xl, xh in x_iv:
                    for yl, yh in y_iv:
                        # the rows: those of the parallelogram's corners
                        px0, px1, py0, py1 = xl - ax.w, xh - ax.w, yl - ay.w, yh - ay.w
                        cy = [(ax.u * py - ay.u * px) * inv_det
                              for py in (py0, py1) for px in (px0, px1)]
                        oy0, oy1 = _clip_range(min(cy), max(cy), out_h)
                        fxl, fxh, fyl, fyh = (np.float32(v) for v in (xl, xh, yl, yh))
                        for oy in range(oy0, oy1 + 1):
                            foy = np.float32(oy)
                            sx0, sx1 = _solve_row(ax.uf, ax.inv_uf, ax.vf * foy + ax.wf, fxl, fxh)
                            sy0, sy1 = _solve_row(ay.uf, ay.inv_uf, ay.vf * foy + ay.wf, fyl, fyh)
                            ox0, ox1 = _clip_range(max(sx0, sy0), min(sx1, sy1), out_w)
                            if ox0 > ox1:
                                continue
                            row_x, row_y = rx[oy, ox0:ox1 + 1], ry[oy, ox0:ox1 + 1]
                            member = ((row_x >= fxl) & (row_x <= fxh)
                                      & (row_y >= fyl) & (row_y <= fyh))
                            visits.append(oy * out_w + ox0 + np.flatnonzero(member))
                visits = np.concatenate(visits) if visits else np.zeros(0, np.int64)
                for iy in range(ty * BWD_QY, min((ty + 1) * BWD_QY, H)):
                    for ix in range(tx * BWD_QX, min((tx + 1) * BWD_QX, W)):
                        image[iy * W + ix] = visits
        footprints.append(image)
    return footprints


# K4's staged tiles: the constants of csrc/affine_warp.cu.
K4_TILE_W, K4_TILE_H = 32, 16  # output columns and rows of a block's tile
K4_SMEM = 48 * 1024            # bytes of shared memory a block stages into


class TileBoxes(NamedTuple):
    """K4's plan for each image n and output tile (ty, tx): the input box
    [bx0, bx1] x [by0, by1] that the tile stages (int64 [N, tiles_y,
    tiles_x, 4]), and the channels staged at once (int64 [N, tiles_y,
    tiles_x]; 0 for a tile that takes the direct path)."""
    box: np.ndarray
    channels: np.ndarray


def _reflect64(p: float, size: int, inv_p: float) -> float:
    """reflect64: _reflect_coords in float64, reduced by a multiplication
    with 1 / P (P = 2 size) instead of fmod."""
    u = p + 0.5
    v = u - math.floor(u * inv_p) * (2.0 * size)
    return (size - abs(size - v)) - 0.5


def _tile_span(ax: _Axis, size: int, ox0: int, ox1: int, oy0: int, oy1: int,
               zeros: bool):
    """tile_span: the box of one axis, [b0, b1], for the output columns
    ox0..ox1 and rows oy0..oy1. The raw range over the tile's corners, widened
    by the margin; with the mirror its image (the end points' mirrors, and a
    border wherever a fold lies inside, of three candidates; the whole axis
    for a range of a period or more), widened by the margin again; without
    it, clipped to [-1, size]. Then the columns of its taps: a position in
    [-0.5, 0) has floor -1, clipped to 0, and its second tap is pixel 1."""
    ex0, ex1, ey0, ey1 = ax.u * ox0, ax.u * ox1, ax.v * oy0, ax.v * oy1
    lo = ax.w + min(ex0, ex1) + min(ey0, ey1) - ax.margin
    hi = ax.w + max(ex0, ex1) + max(ey0, ey1) + ax.margin
    if zeros:
        a, b = min(max(lo, -1.0), float(size)), min(max(hi, -1.0), float(size))
    elif not hi - lo < 2.0 * size:
        a, b = -0.5, size - 0.5
    else:
        ma, mb = _reflect64(lo, size, ax.inv_p), _reflect64(hi, size, ax.inv_p)
        a, b = min(ma, mb), max(ma, mb)
        k = math.floor((lo + 0.5) * (2.0 * ax.inv_p)) + 1.0   # the first fold past lo
        for _ in range(3):
            if k * size - 0.5 <= hi:
                if k - 2.0 * math.floor(0.5 * k) == 0.0:
                    a = -0.5
                else:
                    b = size - 0.5
            k += 1.0
        a, b = a - ax.margin, b + ax.margin
    return (int(min(max(math.floor(a), 0.0), size - 1.0)),
            int(min(max(math.floor(b), 0.0) + 1.0, size - 1.0)))


def _tile_channels(box, channels: int, itemsize: int, smem: int) -> int:
    """tile_channels: how many channels the tile stages at once. A row of the
    box starts at the 16-byte chunk left of bx0 and holds an odd number of
    chunks (its pitch), so that a warp's tilted reads spread over the banks.
    All channels if they fit the budget; else as many as fit twice (double
    buffering); 0 if one does not fit twice (the direct path)."""
    bx0, bx1, by0, by1 = box
    vec = 16 // itemsize
    ax0 = bx0 - bx0 % vec
    pitch = (((bx1 - ax0) // vec + 1) | 1) * vec
    plane = (by1 - by0 + 1) * pitch * itemsize
    return channels if channels * plane <= smem else smem // (2 * plane)


def _warp_tile_boxes(G_inv, H: int, W: int, out_h: int, out_w: int, mode: str = "reflect",
                     tile=(K4_TILE_W, K4_TILE_H), channels: int = 9, itemsize: int = 2,
                     smem: int = K4_SMEM) -> TileBoxes:
    """K4's plan for every output tile of every image (`TileBoxes`), as
    csrc/affine_warp.cu computes it, line by line (float64, each operation
    rounded on its own), for `channels` channels of `itemsize` bytes."""
    if mode not in MODES:
        raise ValueError(mode)
    zeros = mode == "zeros"
    tw, th = tile
    nty, ntx = -(-out_h // th), -(-out_w // tw)
    G = torch.as_tensor(G_inv).detach().cpu().float().numpy()
    box = np.zeros((len(G), nty, ntx, 4), np.int64)
    staged = np.zeros((len(G), nty, ntx), np.int64)
    for n, g in enumerate(G):
        ax = _warp_axis(g[0, 0], g[0, 1], g[0, 2], W, out_w, out_h)
        ay = _warp_axis(g[1, 0], g[1, 1], g[1, 2], H, out_w, out_h)
        for ty in range(nty):
            oy0, oy1 = ty * th, min((ty + 1) * th, out_h) - 1
            for tx in range(ntx):
                ox0, ox1 = tx * tw, min((tx + 1) * tw, out_w) - 1
                b = (_tile_span(ax, W, ox0, ox1, oy0, oy1, zeros)
                     + _tile_span(ay, H, ox0, ox1, oy0, oy1, zeros))
                box[n, ty, tx] = b
                staged[n, ty, tx] = _tile_channels(b, channels, itemsize, smem)
    return TileBoxes(box, staged)


def _compute_dtype(x: torch.Tensor) -> torch.dtype:
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def affine_grid_sample_plain(x: torch.Tensor, G_inv: torch.Tensor, out_h: int, out_w: int,
                             mode: str = "reflect") -> torch.Tensor:
    """Plain PyTorch version of K4, in the JAX package's formulation: the 2x2
    neighbourhood of every pixel packed into channels (the edge pad gives the
    clipped right and bottom neighbours), one gather per output pixel, then
    the bilinear sum in float32 (float64 for a float64 x), cast back once."""
    N, C, H, W = x.shape
    ct = _compute_dtype(x)
    x0, _, y0, _, wx, wy, mask = _sample_taps(G_inv, H, W, out_h, out_w, mode)
    xp = F.pad(x.to(ct), [0, 1, 0, 1], mode="replicate")
    packed = torch.cat([xp[:, :, :H, :W], xp[:, :, :H, 1:], xp[:, :, 1:, :W], xp[:, :, 1:, 1:]],
                       dim=1).reshape(N, 4 * C, H * W)
    idx = (y0 * W + x0).reshape(N, 1, out_h * out_w).expand(N, 4 * C, out_h * out_w)
    g = packed.gather(2, idx).reshape(N, 4, C, out_h, out_w)
    wx, wy = wx.to(ct)[:, None], wy.to(ct)[:, None]
    top = g[:, 0] * (1 - wx) + g[:, 1] * wx
    bot = g[:, 2] * (1 - wx) + g[:, 3] * wx
    out = top * (1 - wy) + bot * wy
    if mask is not None:
        out = out * mask[:, None].to(ct)
    return out.to(x.dtype)


def affine_grid_sample_bwd_plain(dy: torch.Tensor, G_inv: torch.Tensor, H: int, W: int,
                                 mode: str = "reflect") -> torch.Tensor:
    """Plain PyTorch version of K4-bwd, the transpose of
    `affine_grid_sample_plain`: each output gradient, times its four weights
    (in the order of JAX's vjp), scatter-added into its four clipped taps, in
    float32 (float64 for a float64 dy), cast back once."""
    N, C, out_h, out_w = dy.shape
    ct = _compute_dtype(dy)
    x0, x1, y0, y1, wx, wy, mask = _sample_taps(G_inv, H, W, out_h, out_w, mode)
    d = dy.to(ct)
    if mask is not None:
        d = d * mask[:, None].to(ct)
    wx, wy = wx.to(ct)[:, None], wy.to(ct)[:, None]
    dtop, dbot = d * (1 - wy), d * wy
    dx = torch.zeros(N, C, H * W, dtype=ct, device=dy.device)
    P = out_h * out_w
    for yi, xi, contrib in ((y0, x0, dtop * (1 - wx)), (y0, x1, dtop * wx),
                            (y1, x0, dbot * (1 - wx)), (y1, x1, dbot * wx)):
        idx = (yi * W + xi).reshape(N, 1, P).expand(N, C, P)
        dx.scatter_add_(2, idx, contrib.reshape(N, C, P))
    return dx.reshape(N, C, H, W).to(dy.dtype)


def _check(t: torch.Tensor, G_inv: torch.Tensor, mode: str, name: str) -> None:
    if t.ndim != 4:
        raise ValueError(f"{name} needs NCHW, got shape {tuple(t.shape)}")
    if tuple(G_inv.shape) != (t.shape[0], 3, 3):
        raise ValueError(f"{name} needs G_inv [{t.shape[0]}, 3, 3], got {tuple(G_inv.shape)}")
    if mode not in MODES:
        raise ValueError(f"{name}: mode must be one of {sorted(MODES)}, got {mode!r}")


def _launch(wrapper, inp: torch.Tensor, G_inv: torch.Tensor, out: torch.Tensor, mode: str,
            H: int, W: int, out_h: int, out_w: int) -> None:
    """Launch the kernel of `wrapper` (its C entry point has the wrapper's
    name) on the current stream; count it."""
    name = wrapper.__name__
    if inp.dtype not in DTYPE_CODES:
        raise ValueError(f"{name} takes float32 or bfloat16, got {inp.dtype}")
    if not inp.is_contiguous():
        raise ValueError(f"{name} needs a contiguous NCHW tensor")
    if G_inv.device != inp.device or G_inv.dtype != torch.float32 or not G_inv.is_contiguous():
        raise ValueError(f"{name} needs G_inv as a contiguous float32 tensor on {inp.device}")
    if out.numel() == 0:
        return
    N, C = inp.shape[:2]
    args = (inp.data_ptr(), G_inv.data_ptr(), out.data_ptr(), DTYPE_CODES[inp.dtype],
            MODES[mode], N, C, H, W, out_h, out_w)
    launch(name, entry_point(name, _ARGTYPES), args, inp.device.index)
    wrapper.launches += 1


def affine_warp(x: torch.Tensor, G_inv: torch.Tensor, out_h: int, out_w: int,
                mode: str = "reflect") -> torch.Tensor:
    """Warp x [N, C, H, W] by the inverse maps G_inv [N, 3, 3] to
    [N, C, out_h, out_w] (K4). A CPU tensor goes to `affine_grid_sample_plain`;
    a CUDA tensor (float32 or bfloat16, contiguous; G_inv float32 on the same
    device) to the CUDA kernel, or raises. No autograd graph: `_AffineWarp`
    carries the gradient."""
    _check(x, G_inv, mode, "affine_warp")
    if not on_cuda(x, "affine_warp"):
        return affine_grid_sample_plain(x, G_inv, out_h, out_w, mode)
    N, C, H, W = x.shape
    if N > 65535 or out_h > 65535:          # the grid's z and y
        raise ValueError("affine_warp takes at most 65535 images and output rows")
    y = torch.empty((N, C, out_h, out_w), dtype=x.dtype, device=x.device)
    _launch(affine_warp, x, G_inv, y, mode, H, W, out_h, out_w)
    return y


affine_warp.launches = 0


def affine_warp_bwd(dy: torch.Tensor, G_inv: torch.Tensor, H: int, W: int,
                    mode: str = "reflect") -> torch.Tensor:
    """The adjoint of `affine_warp(., G_inv, out_h, out_w, mode)` for an
    H x W input: [N, C, out_h, out_w] -> [N, C, H, W] (K4-bwd). A CPU tensor
    goes to `affine_grid_sample_bwd_plain`; a CUDA tensor to the CUDA kernel,
    a gather that sums each pixel in float32 in a fixed order and writes dx
    once in dy's dtype (bfloat16 rounded once), or raises."""
    _check(dy, G_inv, mode, "affine_warp_bwd")
    if not on_cuda(dy, "affine_warp_bwd"):
        return affine_grid_sample_bwd_plain(dy, G_inv, H, W, mode)
    N, C, out_h, out_w = dy.shape
    if N * -(-C // BWD_CHUNK) > 65535 or H > 8 * BWD_QY * 65535:   # the grid's z and y
        raise ValueError(f"affine_warp_bwd takes at most 65535 images x {BWD_CHUNK}-channel "
                         f"chunks and {8 * BWD_QY * 65535} input rows")
    dx = torch.empty((N, C, H, W), dtype=dy.dtype, device=dy.device)
    _launch(affine_warp_bwd, dy, G_inv, dx, mode, H, W, out_h, out_w)
    return dx


affine_warp_bwd.launches = 0


class _AffineWarp(torch.autograd.Function):
    """K4 with a gradient: forward `affine_warp`, backward `_AffineWarpT`.

    Both directions launch on the current stream, which the autograd engine
    sets to the forward's stream for the backward. An incoming gradient may
    be non-contiguous, so it is made contiguous first.
    """

    @staticmethod
    def forward(ctx, x: torch.Tensor, G_inv: torch.Tensor, out_h: int, out_w: int,
                mode: str) -> torch.Tensor:
        ctx.save_for_backward(G_inv)
        ctx.args = x.shape[2], x.shape[3], mode
        return affine_warp(x, G_inv, out_h, out_w, mode)

    @staticmethod
    def backward(ctx, dy: torch.Tensor):
        G_inv, = ctx.saved_tensors
        H, W, mode = ctx.args
        return _AffineWarpT.apply(dy.contiguous(), G_inv, H, W, mode), None, None, None, None


class _AffineWarpT(torch.autograd.Function):
    """K4-bwd with a gradient: forward `affine_warp_bwd`, backward `_AffineWarp`."""

    @staticmethod
    def forward(ctx, dy: torch.Tensor, G_inv: torch.Tensor, H: int, W: int,
                mode: str) -> torch.Tensor:
        ctx.save_for_backward(G_inv)
        ctx.args = dy.shape[2], dy.shape[3], mode
        return affine_warp_bwd(dy, G_inv, H, W, mode)

    @staticmethod
    def backward(ctx, ddx: torch.Tensor):
        G_inv, = ctx.saved_tensors
        out_h, out_w, mode = ctx.args
        return _AffineWarp.apply(ddx.contiguous(), G_inv, out_h, out_w, mode), None, None, None, None


def affine_grid_sample(x: torch.Tensor, G_inv: torch.Tensor, out_h: int, out_w: int,
                       mode: str = "reflect") -> torch.Tensor:
    """Warp x [N, C, H, W] by per-sample inverse maps G_inv [N, 3, 3], with a
    gradient for x to any order. G_inv must not require a gradient."""
    assert not G_inv.requires_grad, "affine_grid_sample takes no gradient for G_inv"
    return _AffineWarp.apply(x, G_inv, out_h, out_w, mode)
