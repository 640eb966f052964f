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

`k2_plan_2d` (a 2-D pass) and `k2_plan` (a row or column pass) are the
launch geometry, computed here so that the CPU tests can check that the
tiles cover every output once and read inside their windows. A 2-D pass
on bf16 whose filter is exactly the outer product of two factors after
rounding to bf16 (`rank1_factors`; the main path's always is) sums rows,
then columns; any other sums in 2-D, in the plain version's order.
`pass_mode` says which.

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
RUN_X, RUN_Y = 2, 4    # outputs a thread computes in a 1-D pass: 2 columns x 4 rows
MAX_STAGE_BYTES = 96 * 1024
# The 2-D pass (csrc/upfirdn2d.cu, namespace k2d): 256 threads, a ring of 3
# windows, at least 3 blocks an SM by registers; runs in `run_2d`.
STAGES, MIN_BLOCKS = 3, 3
SLOT_BYTES = 24 * 1024         # a ring slot's budget
MAX_TILE_W = 512               # output columns of a tile at up 1 (half at down 2)
SM_SHARED_BYTES = 228 * 1024   # an H100 SM's shared memory, 1 KB of it reserved a block
MAX_DYNAMIC_SMEM = 227 * 1024
WALK_UP2 = 4                   # tiles a block walks at least at up 2, where a call is small
MIN_ITEMS = 64                 # ... as long as a tile keeps two warps' runs
N_2D = 4                       # VARIANTS[:N_2D] are the 2-D pass's, the rest the 1-D pass's
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


class K2Plan2D(NamedTuple):
    """The launch geometry of one 2-D pass (csrc/upfirdn2d.cu, namespace
    k2d); the field order is the int64 array the C entry point reads
    (Plan2DField).

    Planes stack into a tall output of planes x vh virtual rows (plane p's
    output row oy is virtual row p vh + oy; rows oy >= out_h are computed
    and dropped) and a tall input of planes x sr rows (tall source row p sr
    + r is plane p's row r - q, zero outside the plane). Virtual row v reads,
    with tap row ty, tall source row (v DY + ty - PY) / UY where that
    divides. Tile t is (t // tiles_w, t % tiles_w): virtual rows tile_h
    (t // tiles_w) on, output columns tile_w (t % tiles_w) on. Block b of
    `grid` walks tiles b, b + grid, ..., through a ring of STAGES slots of
    slot_elems elements: its k-th tile's window goes to slot k % STAGES,
    win_h rows of `pitch` elements, tall source rows from tile_h (t //
    tiles_w) DY / UY on; window row element c is source column base_x +
    step_x (t % tiles_w) - e + c, e the row's shift, the samples that put
    its copies on 16 bytes (`chunk` elements a copy, cpr a row): for tall
    row ts of plane p, e = (eb + wm ts - pm p) mod chunk. Where pm is not
    0, vh is a multiple of tile_h, so that a tile's data rows lie in one
    plane. The tile's runs (RY rows x RX columns, `run_2d`, runs_x a row) go
    to the threads in row-major order, THREADS at a time; run (ry, cx)
    reads window rows from ry RY DY / UY on and elements from lead_x + cx RX
    DX / UX + e on. Small calls take shorter tiles, so that there are a
    grid's worth of them (four at up 2, whose runs are the lightest), as
    long as a tile keeps MIN_ITEMS runs. The
    *_m, *_s pairs divide by runs_x, vh, sr, cpr and tiles_w (`fast_div`)."""
    variant: int
    planes: int
    src_h: int
    src_w: int
    out_h: int
    out_w: int
    fh: int
    fw: int
    mode: int
    vh: int
    sr: int
    q: int
    tile_h: int
    tile_w: int
    runs_x: int
    tiles_w: int
    tiles: int
    grid: int
    step_x: int
    base_x: int
    lead_x: int
    win_h: int
    pitch: int
    chunk: int
    cpr: int
    eb: int
    wm: int
    pm: int
    slot_elems: int
    stage_bytes: int
    runs_x_m: int
    runs_x_s: int
    vh_m: int
    vh_s: int
    sr_m: int
    sr_s: int
    cpr_m: int
    cpr_s: int
    tiles_w_m: int
    tiles_w_s: int


def run_2d(variant: int) -> Tuple[int, int]:
    """(rows, columns) of the outputs a thread of a 2-D pass computes: 8 x 4,
    or 4 x 2 at down 2, whose windows are twice as tall and wide an output."""
    DY, DX = VARIANTS[variant][3], VARIANTS[variant][6]
    return (4 if DY == 2 else 8), (2 if DX == 2 else 4)


def fast_div(d: int) -> Tuple[int, int]:
    """(m, s) with n // d == (n m) >> s for 0 <= n < 2^30: s = 31 +
    floor(log2 d), m = ceil(2^s / d) < 2^32."""
    s = 31 + d.bit_length() - 1
    return -(-(1 << s) // d), s


# How a 2-D pass sums its taps (csrc/upfirdn2d.cu:SumMode).
GUARDED, FULL, ROWS_THEN_COLUMNS = 0, 1, 2


def rank1_factors(k: np.ndarray) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Float32 (fy, fx) whose outer product, each product rounded to float32,
    equals the float32 4x4 filter k exactly, or None: tried with fx a row of
    k and fy a column of it over the pivot, pivot by pivot."""
    k = np.asarray(k, np.float32)
    if k.shape != (4, 4) or not np.isfinite(k).all():
        return None
    for r, c in zip(*np.nonzero(k)):
        fx = k[r].copy()
        fy = (k[:, c] / k[r, c]).astype(np.float32)
        if np.array_equal(fy[:, None] * fx[None, :], k):
            return fy, fx
    return None


def k2_plan_2d(variant: int, planes: int, src_h: int, src_w: int, fh: int, fw: int,
               pad: Sequence[int], itemsize: int, ptr_mod16: int = 0, mode: int = GUARDED,
               sms: int = 132) -> K2Plan2D:
    """The plan of one 2-D pass of VARIANTS[variant] over [planes, src_h,
    src_w] (the input's data pointer ptr_mod16 bytes past 16) with an fh x fw
    filter summed as `mode`, pad (px0, px1, py0, py1), on a card with `sms`
    SMs."""
    FY, FX, UY, DY, PY, UX, DX, PX = VARIANTS[variant]
    RY, RX = run_2d(variant)
    assert variant < N_2D and fh <= 4 and fw <= 4 and (mode == GUARDED or (fh, fw) == (4, 4))
    px0, px1, py0, py1 = pad
    assert py0 % UY == PY and px0 % UX == PX and ptr_mod16 % itemsize == 0
    out_h = (src_h * UY + py0 + py1 - fh) // DY + 1
    out_w = (src_w * UX + px0 + px1 - fw) // DX + 1
    chunk = 16 // itemsize
    wm = src_w % chunk
    # rows: plane p's padded row j (upsampled row j - py0) is tall row p Sp + j
    q = (py0 - PY) // UY
    read = (out_h - 1) * DY + fh                  # padded rows a plane's outputs read
    Sp = _round_up(max(min(read, py0 + (src_h - 1) * UY + 1), read - py0, out_h * DY), UY * DY)
    for _ in range(chunk):                        # a row's shift, linear in its tall row
        if (wm * (Sp // UY - src_h)) % chunk == 0:
            break
        Sp += UY * DY
    else:
        Sp -= chunk * UY * DY
    pm = (wm * (Sp // UY - src_h)) % chunk        # ... or also in its plane
    vh = Sp // DY
    # columns
    runs = _ceil_div(out_w, RX)
    max_w = MAX_TILE_W * UX // DX
    if runs * RX <= max_w:
        tile_w = runs * RX
    else:
        tile_w = _round_up(_ceil_div(out_w, _ceil_div(out_w, max_w)), 32)
    tiles_w = _ceil_div(out_w, tile_w)
    runs_x = tile_w // RX
    step_x = tile_w * DX // UX
    first = -((px0 - PX) // UX)                   # tile 0's first source column
    base_x = (first // chunk) * chunk
    lead_x = first - base_x
    eb = (ptr_mod16 // itemsize + base_x - wm * q) % chunk
    segx = ((RX - 1) * DX + 3 - PX) // UX + 1
    span = lead_x + ((tile_w - 1) * DX + 3 - PX) // UX + 1
    last = lead_x + (runs_x - 1) * (RX * DX // UX)
    reads = last + 2 * (segx // 2 + 1) if itemsize == 2 else last + segx
    shifted = wm or pm or eb                      # some row's copies start left of base_x
    pitch = _round_up(max(span, reads) + (chunk - 1 if shifted else 0), chunk)
    # rows of a tile: the most that fit a slot, at least one run
    total = planes * vh

    def win_h(th):
        return ((th - 1) * DY + 3 - PY) // UY + 1

    tile_h = RY                                   # enough runs for the threads, if they fit
    most = _round_up(vh, RY) if pm else RY * max(128 // RY, THREADS // runs_x)
    walk = WALK_UP2 if UY == 2 else 1
    least = RY * _ceil_div(MIN_ITEMS, runs_x)
    most = min(most, max(least, total * tiles_w // (sms * MIN_BLOCKS * walk) // RY * RY))
    while (tile_h + RY <= most and win_h(tile_h + RY) * pitch * itemsize <= SLOT_BYTES
           and win_h(tile_h + RY) <= THREADS):
        tile_h += RY
    if pm:
        vh = _round_up(vh, tile_h)
        total = planes * vh
    sr = vh * DY // UY
    wh = win_h(tile_h)
    tiles_h = _ceil_div(total, tile_h)
    tiles = tiles_h * tiles_w
    slot_elems = wh * pitch
    stage_bytes = STAGES * slot_elems * itemsize
    per_sm = min(MIN_BLOCKS, SM_SHARED_BYTES // (stage_bytes + 1024))
    assert per_sm >= 1 and stage_bytes <= MAX_DYNAMIC_SMEM, "a window too large for a block"
    grid = min(tiles, sms * per_sm)
    assert tiles_h * tile_h * DY // UY + wh < 2 ** 30 and tiles < 2 ** 30
    divs = [v for d in (runs_x, vh, sr, pitch // chunk, tiles_w) for v in fast_div(d)]
    return K2Plan2D(variant, planes, src_h, src_w, out_h, out_w, fh, fw, mode, vh, sr, q,
                    tile_h, tile_w, runs_x, tiles_w, tiles, grid, step_x, base_x, lead_x, wh,
                    pitch, chunk, pitch // chunk, eb, wm, (wm * (sr - src_h)) % chunk,
                    slot_elems, stage_bytes, *divs)


class _Launch(NamedTuple):
    """One pass's launch: its output shape, instantiation, plan and taps."""
    out_shape: Tuple[int, int, int, int]
    variant: int
    plan: ctypes.Array
    taps: ctypes.Array


_CALLS: dict = {}
_SMS: dict = {}


def _sm_count(device: torch.device) -> int:
    if device.index not in _SMS:
        _SMS[device.index] = torch.cuda.get_device_properties(device).multi_processor_count
    return _SMS[device.index]


def pass_mode(held: np.ndarray, fh: int, fw: int, dtype: torch.dtype):
    """(mode, factors) of a 2-D pass whose fh x fw taps, rounded to dtype,
    are `held` [4, 4]: rows then columns on bf16 where the taps are exactly
    the outer product of the factors; else the 2-D sum (float32 keeps the
    plain version's order, so that the export's ATen route equals the direct
    forward to the bit), unguarded for exactly 4x4 taps."""
    if (fh, fw) != (4, 4):
        return GUARDED, None
    factors = rank1_factors(held) if dtype == torch.bfloat16 else None
    return (FULL, None) if factors is None else (ROWS_THEN_COLUMNS, factors)


def pass_launch(p: Pass, x_shape, dtype: torch.dtype, ptr_mod16: int,
                sms: int = 132) -> Tuple[int, NamedTuple, np.ndarray]:
    """(variant, plan, taps) of pass p on x [N, C, H, W] of dtype whose data
    pointer lies ptr_mod16 bytes past 16: taps are the 24 floats the C entry
    point reads, the held [FY][FX] rounded to x's dtype, then for a 2-D pass
    its factors fy, fx (zero where the filter is not their outer product)."""
    N, C, H, W = x_shape
    variant = pass_variant(p)
    (fh, fw), (FY, FX) = p.k.shape, VARIANTS[variant][:2]
    held = np.zeros((FY, FX), np.float32)     # the taps rounded to x's dtype, as the plain conv
    held[:fh, :fw] = p.k.to(dtype).float().numpy()
    taps = np.zeros(24, np.float32)
    taps[:16] = held.reshape(-1)
    itemsize = torch.empty((), dtype=dtype).element_size()
    if variant < N_2D:
        mode, factors = pass_mode(held, fh, fw, dtype)
        if factors is not None:
            taps[16:20], taps[20:] = factors
        plan = k2_plan_2d(variant, N * C, H, W, fh, fw, p.pad, itemsize, ptr_mod16, mode, sms)
    else:
        plan = k2_plan(variant, N * C, H, W, fh, fw, p.pad, itemsize, ptr_mod16 == 0)
    return variant, plan, taps


def _call_launches(x: torch.Tensor, f, up, down, padding, flip_filter: bool,
                   gain: float) -> List[_Launch]:
    """The launches of upfirdn2d_k2(x, f, ...) for x's shape, dtype, device
    and alignment; raises on what the kernel does not take. For a filter
    tensor they are remembered by its identity and version (the entry holds
    the tensor, so its identity stays unique), so that a repeated call costs
    a dict lookup and no host work."""
    key = (tuple(x.shape), x.dtype, x.device.index, x.data_ptr() % 16, tuple(up), tuple(down),
           tuple(padding), bool(flip_filter), float(gain))
    if isinstance(f, torch.Tensor):
        hit = _CALLS.get((id(f),) + key)
        if hit is not None and hit[0] is f and hit[1] == f._version:
            return hit[2]
    ft = torch.as_tensor(f, dtype=torch.float32).detach().cpu()
    why = k2_refusal(key[0], x.dtype, True, ft, up, down, padding, flip_filter, gain)
    if why is not None:
        raise ValueError(f"upfirdn2d_k2 {why}")
    launches, shape, ptr_mod16, sms = [], key[0], key[3], _sm_count(x.device)
    for p in passes(ft, up, down, padding, flip_filter, gain):
        variant, plan, taps = pass_launch(p, shape, x.dtype, ptr_mod16, sms)
        if plan.tiles >= 2 ** 31:
            raise ValueError(f"upfirdn2d_k2: {plan.tiles} tiles exceed the grid")
        shape = (*shape[:2], plan.out_h, plan.out_w)
        launches.append(_Launch(shape, variant, (ctypes.c_int64 * len(plan))(*plan),
                                (ctypes.c_float * 24)(*taps.tolist())))
        ptr_mod16 = 0                         # a later pass reads a fresh torch.empty
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
