"""K2: the general FIR resampler upfirdn2d, one filter pass a launch.

`upfirdn2d_k2(x, f, up, down, padding, flip_filter, gain)` computes
upfirdn2d (ops/upfirdn2d.py) for every case but K1's: a 2-D filter in one
pass, a separable (1-D) filter in two, horizontal then vertical, as its plain
version `upfirdn2d_k2_plain` does. A pass zero-inserts by `up`, pads (a
negative pad crops), FIR-filters and decimates by `down`.

On a CUDA tensor each pass launches the kernel of csrc/upfirdn2d.cu (see the
note there) or the wrapper raises; on a CPU tensor it runs the plain version,
whose pass is a zero-insert, an `F.pad` and a depthwise `F.conv2d`. Each
launch adds one to `upfirdn2d_k2.launches`. The filter goes in as float32 taps
rounded to the input's dtype, as the plain version's `F.conv2d` takes it, and
each output sums its taps in float32, rows then columns, and rounds once.

What the kernel takes (`k2_refusal` names what it does not): float32 or
bfloat16, contiguous NCHW; per axis up and down (1, 1), (2, 1) or (1, 2);
a filter of at most 4x4 with the same up and down on both axes (and, at up 2,
the same parity of the two leading pads), or a row [1, fw] or column [fh, 1]
of at most 16 taps that leaves the other axis alone.

`k2_plan` is the launch geometry, computed here so that the CPU tests can
check that the tiles cover every output once and read inside their windows.

`aten_route()` is the one documented way around the kernel: inside it,
`upfirdn2d` on a CUDA tensor runs the plain version's ATen ops, which
`torch.export` can trace (export_model.py traces the serving artifact so and
records it in the sidecar). Nothing else enters it.
"""
from __future__ import annotations

import contextlib
import ctypes
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .cuda_build import DTYPE_CODES, entry_point, launch, on_cuda

THREADS = 256          # threads a block aims at (at most K2_MAX_THREADS, csrc/upfirdn2d.cu)
RUN_X, RUN_Y = 2, 4    # outputs a thread computes: 2 columns x 4 rows
MAX_STAGE_BYTES = 96 * 1024
# The instantiations of csrc/upfirdn2d.cu, in the order of its K2_VARIANTS:
# (filter rows, filter columns) held, then per axis (up, down, phase) for y
# and x, the phase being the leading pad mod up.
VARIANTS: Tuple[Tuple[int, ...], ...] = (
    (4, 4, 1, 1, 0, 1, 1, 0), (4, 4, 2, 1, 0, 2, 1, 0), (4, 4, 2, 1, 1, 2, 1, 1),
    (4, 4, 1, 2, 0, 1, 2, 0),
    (1, 16, 1, 1, 0, 1, 1, 0), (1, 16, 1, 1, 0, 2, 1, 0), (1, 16, 1, 1, 0, 2, 1, 1),
    (1, 16, 1, 1, 0, 1, 2, 0),
    (16, 1, 1, 1, 0, 1, 1, 0), (16, 1, 2, 1, 0, 1, 1, 0), (16, 1, 2, 1, 1, 1, 1, 0),
    (16, 1, 1, 2, 0, 1, 1, 0),
)
_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int,
             ctypes.c_int, ctypes.POINTER(ctypes.c_int64), ctypes.c_void_p)

_ATEN_ROUTE = [0]


@contextlib.contextmanager
def aten_route():
    """Inside this context, upfirdn2d on a CUDA tensor runs the plain
    version's ATen ops instead of K1 and K2, so that torch.export can trace
    it. export_model.py alone enters it."""
    _ATEN_ROUTE[0] += 1
    try:
        yield
    finally:
        _ATEN_ROUTE[0] -= 1


def aten_route_active() -> bool:
    return _ATEN_ROUTE[0] > 0


# ----------------------------------------------------------------- the passes

class Pass(NamedTuple):
    """One filter pass: k [fh, fw] float32, already flipped and gained (a
    correlation), up (ux, uy), down (dx, dy), pad (px0, px1, py0, py1)."""
    k: torch.Tensor
    up: Tuple[int, int]
    down: Tuple[int, int]
    pad: Tuple[int, int, int, int]


def passes(f: torch.Tensor, up, down, padding, flip_filter: bool, gain: float) -> List[Pass]:
    """The passes of upfirdn2d(x, f, ...): one for a 2-D filter; for a
    separable one, horizontal then vertical with sqrt(gain) each."""
    f = torch.as_tensor(f, dtype=torch.float32)
    if not flip_filter:
        f = f.flip(list(range(f.ndim)))
    up, down, padding = tuple(up), tuple(down), tuple(padding)
    if f.ndim == 2:
        return [Pass(f * gain, up, down, padding)]
    px0, px1, py0, py1 = padding
    g = float(np.sqrt(gain))
    return [Pass((f * g)[None, :], (up[0], 1), (down[0], 1), (px0, px1, 0, 0)),
            Pass((f * g)[:, None], (1, up[1]), (1, down[1]), (0, 0, py0, py1))]


def pass_out_hw(p: Pass, H: int, W: int) -> Tuple[int, int]:
    """The output size of pass p on an H x W plane: the zero-insert gives
    n * up samples, as the plain version's reshape does."""
    fh, fw = p.k.shape
    px0, px1, py0, py1 = p.pad
    return ((H * p.up[1] + py0 + py1 - fh) // p.down[1] + 1,
            (W * p.up[0] + px0 + px1 - fw) // p.down[0] + 1)


def _depthwise_pass(x: torch.Tensor, p: Pass) -> torch.Tensor:
    """The plain pass: zero-insert (n * up samples), pad (negative crops), a
    depthwise F.conv2d in x's dtype whose stride decimates."""
    (upx, upy), (downx, downy), (px0, px1, py0, py1) = p.up, p.down, p.pad
    N, C, H, W = x.shape
    if upx > 1 or upy > 1:
        x = x.reshape(N, C, H, 1, W, 1)
        x = F.pad(x, [0, upx - 1, 0, 0, 0, upy - 1])
        x = x.reshape(N, C, H * upy, W * upx)
    x = F.pad(x, [px0, px1, py0, py1])
    kernel = p.k.to(x.device, x.dtype, non_blocking=True)[None, None].expand(C, 1, *p.k.shape)
    return F.conv2d(x, kernel, stride=(downy, downx), groups=C)


def upfirdn2d_k2_plain(x: torch.Tensor, f, up, down, padding, flip_filter: bool,
                       gain: float) -> torch.Tensor:
    """Plain PyTorch version of K2: each pass as `_depthwise_pass`."""
    for p in passes(f, up, down, padding, flip_filter, gain):
        x = _depthwise_pass(x, p)
    return x


# ------------------------------------------------------- what the kernel takes

def pass_variant(p: Pass) -> Optional[int]:
    """The index in VARIANTS of the instantiation that computes pass p, or None."""
    fh, fw = p.k.shape
    (ux, uy), (dx, dy), (px0, _, py0, _) = p.up, p.down, p.pad
    candidates = []
    if fh <= 4 and fw <= 4:
        candidates.append((4, 4, uy, dy, py0 % uy, ux, dx, px0 % ux))
    if fh == 1 and fw <= 16:
        candidates.append((1, 16, uy, dy, 0, ux, dx, px0 % ux))
    if fw == 1 and fh <= 16:
        candidates.append((16, 1, uy, dy, py0 % uy, ux, dx, 0))
    return next((VARIANTS.index(c) for c in candidates if c in VARIANTS), None)


def k2_refusal(x_shape, dtype, contiguous: bool, f, up, down, padding,
               flip_filter: bool = False, gain: float = 1.0) -> Optional[str]:
    """Why K2 does not take this call, or None if it does."""
    if len(x_shape) != 4:
        return f"needs NCHW, got shape {tuple(x_shape)}"
    if dtype not in DTYPE_CODES:
        return f"takes float32 or bfloat16, got {dtype}"
    if not contiguous:
        return "needs a contiguous NCHW tensor"
    f = torch.as_tensor(f, dtype=torch.float32)
    if f.ndim not in (1, 2):
        return f"needs a 1-D or 2-D filter, got {tuple(f.shape)}"
    _, _, H, W = x_shape
    for p in passes(f, up, down, padding, flip_filter, gain):
        if pass_variant(p) is None:
            return (f"holds a filter of at most 4x4 with the same up and down (and, at up 2, "
                    f"the same leading pad parity) on both axes, or a row or column of at "
                    f"most 16 taps, with up and down 1 or 2 and not both 2; got a "
                    f"{list(p.k.shape)} pass with up {list(p.up)}, down {list(p.down)}, "
                    f"pad {list(p.pad)}")
        Ho, Wo = pass_out_hw(p, H, W)
        if Ho < 1 or Wo < 1:
            return f"gives an empty output ({Ho} x {Wo}) for input {H} x {W}"
        H, W = Ho, Wo
    return None


# -------------------------------------------------------------- the launch plan

class K2Plan(NamedTuple):
    """The launch geometry of one K2 pass; the field order is the int64
    array the C entry point reads (csrc/upfirdn2d.cu:PlanField).

    The output [planes, out_h, out_w] is cut into tiles of P planes x tile_h
    x tile_w outputs; tile t is (t // (tiles_w tiles_h), t // tiles_w %
    tiles_h, t % tiles_w) in (planes, rows, columns), one block each. Thread
    k of nx ny P computes RUN_Y rows x RUN_X columns at (k // (nx ny),
    k // nx % ny, k % nx) in runs; what falls outside the output is masked.
    The block first copies its window, win_h x win_w source elements per
    plane from source row step_y th + base_y and column step_x tw + base_x
    (zero outside the plane), in `chunk`-element copies (cpr a row); source
    column base_x + step_x tw + lead_x + (o D - r) / U feeds output column
    tile_w tw + o where (o D + t - r) is a multiple of U for tap t."""
    variant: int
    planes: int
    src_h: int
    src_w: int
    out_h: int
    out_w: int
    fh: int
    fw: int
    planes_per_tile: int
    nx: int
    ny: int
    threads: int
    tile_h: int
    tile_w: int
    tiles_h: int
    tiles_w: int
    tiles: int
    step_y: int
    step_x: int
    base_y: int
    base_x: int
    lead_x: int
    win_h: int
    win_w: int
    chunk: int
    chunk_bytes: int
    cpr: int
    stage_bytes: int


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _round_up(a: int, b: int) -> int:
    return _ceil_div(a, b) * b


def _chunk(src_w: int, itemsize: int, aligned16: bool) -> int:
    """Elements a window copy moves at once: 16, 8 or 4 bytes where every
    source row is whole such chunks (and the input starts on 16 bytes),
    else one element."""
    if aligned16:
        for nbytes in (16, 8, 4):
            if (src_w * itemsize) % nbytes == 0 and nbytes >= itemsize:
                return nbytes // itemsize
    return 1


def k2_plan(variant: int, planes: int, src_h: int, src_w: int, fh: int, fw: int,
            pad: Sequence[int], itemsize: int, aligned16: bool = True) -> K2Plan:
    """The tile plan of one pass of VARIANTS[variant] over [planes, src_h,
    src_w] with an fh x fw filter and pad (px0, px1, py0, py1)."""
    FY, FX, UY, DY, RY, UX, DX, RX = VARIANTS[variant]
    px0, px1, py0, py1 = pad
    assert py0 % UY == RY and px0 % UX == RX and fh <= FY and fw <= FX
    out_h = (src_h * UY + py0 + py1 - fh) // DY + 1
    out_w = (src_w * UX + px0 + px1 - fw) // DX + 1
    chunk = _chunk(src_w, itemsize, aligned16)
    runs_x = _ceil_div(out_w, RUN_X)
    tiles_w = _ceil_div(runs_x, 64)
    nx = _round_up(_ceil_div(runs_x, tiles_w), 8)     # tile_w D / U a multiple of 8
    runs_y = _ceil_div(out_h, RUN_Y)
    ny = max(1, min(runs_y, THREADS // nx))
    cy0, cx0 = (RY - py0) // UY, (RX - px0) // UX    # first source row / column of tile 0
    lead_x = cx0 % chunk

    def window(ny):
        tile_h, tile_w = ny * RUN_Y, nx * RUN_X
        win_h = ((tile_h - 1) * DY + FY - 1 - RY) // UY + 1
        win_w = _round_up(lead_x + ((tile_w - 1) * DX + FX - 1 - RX) // UX + 1, chunk)
        return tile_h, tile_w, win_h, win_w

    while ny > 1 and window(ny)[2] * window(ny)[3] * itemsize > MAX_STAGE_BYTES:
        ny //= 2
    tile_h, tile_w, win_h, win_w = window(ny)
    tiles_h = _ceil_div(out_h, tile_h)
    whole = tiles_h == 1 and tiles_w == 1                  # pack small planes
    per_tile = max(1, min(planes, THREADS // (nx * ny),
                          MAX_STAGE_BYTES // (win_h * win_w * itemsize))) if whole else 1
    tiles = _ceil_div(planes, per_tile) * tiles_h * tiles_w
    stage_bytes = _round_up(per_tile * win_h * win_w * itemsize, 16)
    return K2Plan(variant, planes, src_h, src_w, out_h, out_w, fh, fw, per_tile, nx, ny,
                  per_tile * nx * ny, tile_h, tile_w, tiles_h, tiles_w, tiles,
                  tile_h * DY // UY, tile_w * DX // UX, cy0, cx0 - lead_x, lead_x, win_h, win_w,
                  chunk, chunk * itemsize, win_w // chunk, stage_bytes)


class _Launch(NamedTuple):
    """One pass's launch: its output shape, instantiation, plan and taps."""
    out_shape: Tuple[int, int, int, int]
    variant: int
    plan: ctypes.Array
    taps: ctypes.Array


_CALLS: dict = {}


def _call_launches(x: torch.Tensor, f, up, down, padding, flip_filter: bool,
                   gain: float) -> List[_Launch]:
    """The launches of upfirdn2d_k2(x, f, ...) for x's shape, dtype and
    alignment; raises on what the kernel does not take. For a filter tensor
    they are remembered by its identity and version (the entry holds the
    tensor, so its identity stays unique), so that a repeated call costs a
    dict lookup and no host work."""
    key = (tuple(x.shape), x.dtype, x.data_ptr() % 16 == 0, tuple(up), tuple(down),
           tuple(padding), bool(flip_filter), float(gain))
    if isinstance(f, torch.Tensor):
        hit = _CALLS.get((id(f),) + key)
        if hit is not None and hit[0] is f and hit[1] == f._version:
            return hit[2]
    ft = torch.as_tensor(f, dtype=torch.float32).detach().cpu()
    why = k2_refusal(key[0], x.dtype, True, ft, up, down, padding, flip_filter, gain)
    if why is not None:
        raise ValueError(f"upfirdn2d_k2 {why}")
    launches, (N, C, H, W), aligned = [], key[0], key[2]
    for p in passes(ft, up, down, padding, flip_filter, gain):
        variant = pass_variant(p)
        (fh, fw), (FY, FX) = p.k.shape, VARIANTS[variant][:2]
        plan = k2_plan(variant, N * C, H, W, fh, fw, p.pad, x.element_size(), aligned)
        if plan.tiles >= 2 ** 31:
            raise ValueError(f"upfirdn2d_k2: {plan.tiles} tiles exceed the grid")
        held = torch.zeros(FY, FX)            # the taps rounded to x's dtype, as the plain conv
        held[:fh, :fw] = p.k.to(x.dtype).float()
        H, W = plan.out_h, plan.out_w
        launches.append(_Launch((N, C, H, W), variant, (ctypes.c_int64 * len(plan))(*plan),
                                (ctypes.c_float * 16)(*held.reshape(-1).tolist())))
        aligned = True                        # a later pass reads a fresh torch.empty
    if isinstance(f, torch.Tensor):
        if len(_CALLS) >= 4096:
            _CALLS.clear()
        _CALLS[(id(f),) + key] = (f, f._version, launches)
    return launches


def upfirdn2d_k2(x: torch.Tensor, f, up, down, padding, flip_filter: bool = False,
                 gain: float = 1.0) -> torch.Tensor:
    """upfirdn2d's every pass as a K2 launch (see the module docstring).

    up, down: (x, y) factors; padding: (px0, px1, py0, py1) w.r.t. the
    upsampled image; f: a host filter [fh, fw] or, separable, [taps]. A CPU
    tensor goes to `upfirdn2d_k2_plain`. A CUDA tensor goes to the kernel, one
    launch a pass, or raises on what the kernel does not take. No autograd
    graph: ops/upfirdn2d.py:_UpFirDn2d carries the gradient.
    """
    if not on_cuda(x, "upfirdn2d_k2"):
        return upfirdn2d_k2_plain(x, f, up, down, padding, flip_filter, gain)
    if not x.is_contiguous():             # the one refusal the remembered launches miss
        raise ValueError("upfirdn2d_k2 needs a contiguous NCHW tensor")
    fn, device = entry_point("upfirdn2d", _ARGTYPES), x.device.index
    for L in _call_launches(x, f, up, down, padding, flip_filter, gain):
        y = torch.empty(L.out_shape, dtype=x.dtype, device=x.device)
        if y.numel():
            launch("upfirdn2d", fn, (x.data_ptr(), y.data_ptr(), L.taps, DTYPE_CODES[x.dtype],
                                     L.variant, L.plan), device)
            upfirdn2d_k2.launches += 1
        x = y
    return x


upfirdn2d_k2.launches = 0
