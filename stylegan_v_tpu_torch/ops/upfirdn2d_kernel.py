"""K2: the general FIR resampler upfirdn2d, one launch a call.

`upfirdn2d_k2(x, f, up, down, padding, flip_filter, gain)` computes
upfirdn2d (ops/upfirdn2d.py) for every case but K1's: a 2-D filter in one
pass, a separable (1-D) filter in two, horizontal then vertical, as its plain
version `upfirdn2d_k2_plain` does. A pass zero-inserts by `up`, pads (a
negative pad crops), FIR-filters and decimates by `down`.

On a CUDA tensor the call launches the kernel of csrc/upfirdn2d.cu once (see
the note there) or the wrapper raises; on a CPU tensor it runs the plain
version, whose pass is a zero-insert, an `F.pad` and a depthwise `F.conv2d`.
Each launch adds one to `upfirdn2d_k2.launches`. The filter goes in as
float32 taps rounded to the input's dtype, as the plain version's `F.conv2d`
takes it, and each output of a pass sums its taps in float32 and rounds once.

What the kernel takes (`k2_refusal` names what it does not): float32 or
bfloat16, contiguous NCHW; per axis up and down (1, 1), (2, 1) or (1, 2);
a filter of at most 4x4 with the same up and down on both axes (and, at up 2,
the same parity of the two leading pads), or a row [1, fw] or column [fh, 1]
of at most 16 taps that leaves the other axis alone.

`k2_plan_2d` (a 2-D pass) and `k2_plan_sep` (a separable call: both passes
in one launch, the intermediate in shared memory; a lone row or column goes
through it with a one-tap other axis) are the launch geometry, computed
here so that the CPU tests can check that the tiles cover every output once
and read inside their windows, and emulate the kernels. A 2-D pass on bf16
whose filter is exactly the outer product of two factors after rounding to
bf16 (`rank1_factors`; the main path's always is) sums rows, then columns;
any other sums in 2-D, in the plain version's order. `pass_mode` says which.

`aten_route()` is the one documented way around the kernel: inside it,
`upfirdn2d` on a CUDA tensor runs the plain version's ATen ops, which
`torch.export` can trace (export_model.py traces the serving artifact so and
records it in the sidecar). Nothing else enters it.
"""
from __future__ import annotations

import contextlib
import ctypes
import math
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .cuda_build import DTYPE_CODES, entry_point, launch, on_cuda

THREADS = 256          # threads a block of either pass runs
# The 2-D pass (csrc/upfirdn2d.cu, namespace k2d): 256 threads, a ring of 3
# windows, at least 3 blocks an SM by registers; runs in `run_2d`.
STAGES, MIN_BLOCKS = 3, 3
SLOT_BYTES = 24 * 1024         # a ring slot's budget
MAX_TILE_W = 512               # output columns of a tile at up 1 (half at down 2)
SM_SHARED_BYTES = 228 * 1024   # an H100 SM's shared memory, 1 KB of it reserved a block
MAX_DYNAMIC_SMEM = 227 * 1024
WALK_UP2 = 4                   # tiles a block walks at least at up 2, where a call is small
MIN_ITEMS = 64                 # ... as long as a tile keeps two warps' runs
N_2D = 4                       # VARIANTS[:N_2D] are the 2-D pass's, the rest the separable's
# The separable pass (namespace ksep): 256 threads, a ring of 2 windows and
# the intermediate, `sep_blocks` blocks an SM; a column-pass run is RUN_C
# output rows by a 16-byte chunk, a row-pass run `run_r` intermediate columns.
RUN_C = 4
SEP_MAX_TILE_H = 64            # output rows of a tile, at most
SEP_MIN_TILE_W = 128           # its columns, at least (where the output has as many)
AXES = ((1, 1, 0), (2, 1, 0), (2, 1, 1), (1, 2, 0))   # an axis's (up, down, phase) it takes
EXACT_TAPS, GUARDED_TAPS = 12, 16
# The instantiations of csrc/upfirdn2d.cu, in the order of its K2_VARIANTS:
# (filter rows, filter columns) held, then per axis (up, down, phase) for y
# and x, the phase being the leading pad mod up. A separable one holds 12
# taps exactly, or, the last (GUARDED_SEP), at most 16, guarded, with each
# axis's (up, down, phase) read from the plan at run time (0 here).
GUARDED_SEP = (GUARDED_TAPS, GUARDED_TAPS, 0, 0, 0, 0, 0, 0)
VARIANTS: Tuple[Tuple[int, ...], ...] = (
    (4, 4, 1, 1, 0, 1, 1, 0), (4, 4, 2, 1, 0, 2, 1, 0), (4, 4, 2, 1, 1, 2, 1, 1),
    (4, 4, 1, 2, 0, 1, 2, 0),
    (12, 12, 2, 1, 0, 2, 1, 0), (12, 12, 1, 2, 0, 1, 2, 0), GUARDED_SEP,
)
_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int,
             ctypes.c_int, ctypes.POINTER(ctypes.c_int64), ctypes.c_void_p)
N_TAPS = 32                    # the floats of the taps array the C entry point reads

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

def _axis(up: int, down: int, pad0: int) -> Optional[Tuple[int, int, int]]:
    """An axis's (up, down, phase), where the separable pass takes it."""
    a = (up, down, pad0 % up)
    return a if a in AXES else None


def sep_variant(row: Pass, col: Pass) -> Optional[int]:
    """The index in VARIANTS of the separable instantiation that computes the
    row pass `row` then the column pass `col`, or None."""
    fh, fw = col.k.shape[0], row.k.shape[1]
    y, x = _axis(col.up[1], col.down[1], col.pad[2]), _axis(row.up[0], row.down[0], row.pad[0])
    if y is None or x is None or max(fh, fw) > GUARDED_TAPS:
        return None
    exact = (EXACT_TAPS, EXACT_TAPS) + y + x
    if fh == fw == EXACT_TAPS and exact in VARIANTS:
        return VARIANTS.index(exact)
    return VARIANTS.index(GUARDED_SEP)


def sep_passes(ps: Sequence[Pass]) -> Optional[Tuple[Pass, Pass]]:
    """The (row, column) passes the separable kernel runs for the passes ps
    of a call: a separable filter's two; a lone row [1, fw] or column [fh, 1]
    that leaves the other axis alone, with a one-tap other axis (the
    identity, which rounds nothing); else None."""
    if len(ps) == 2:
        return ps[0], ps[1]
    p, = ps
    (fh, fw), (ux, uy), (dx, dy), (px0, px1, py0, py1) = p.k.shape, p.up, p.down, p.pad
    one = torch.ones(1, 1)
    if fh == 1 and (uy, dy) == (1, 1):
        return (Pass(p.k, (ux, 1), (dx, 1), (px0, px1, 0, 0)),
                Pass(one, (1, 1), (1, 1), (0, 0, py0, py1)))
    if fw == 1 and (ux, dx) == (1, 1):
        return (Pass(one, (1, 1), (1, 1), (px0, px1, 0, 0)),
                Pass(p.k, (1, uy), (1, dy), (0, 0, py0, py1)))
    return None


def pass_variant(p: Pass) -> Optional[int]:
    """The index in VARIANTS of the instantiation that computes pass p alone:
    the 2-D pass's where it takes p, else the separable pass's for a lone row
    or column (a separable filter's passes are each one), else None."""
    fh, fw = p.k.shape
    (ux, uy), (dx, dy), (px0, _, py0, _) = p.up, p.down, p.pad
    if fh <= 4 and fw <= 4 and (4, 4, uy, dy, py0 % uy, ux, dx, px0 % ux) in VARIANTS[:N_2D]:
        return VARIANTS.index((4, 4, uy, dy, py0 % uy, ux, dx, px0 % ux))
    sep = sep_passes([p])
    return None if sep is None else sep_variant(*sep)


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

def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _round_up(a: int, b: int) -> int:
    return _ceil_div(a, b) * b


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


class K2PlanSep(NamedTuple):
    """The launch geometry of one separable call (csrc/upfirdn2d.cu,
    namespace ksep); the field order is the int64 array the C entry point
    reads (PlanSepField).

    Tile t is (plane, th, tw) = (t // (tiles_h tiles_w), t // tiles_w %
    tiles_h, t % tiles_w): output rows tile_h th on and columns tile_w tw on
    of one plane. Block b of `grid` walks tiles b, b + grid, ...; its k-th
    tile's window goes to ring slot k % 2 (slot_elems elements each): win_h
    rows of `pitch` elements, window row j being source row base_y + step_y
    th + j (zeros outside the plane) and its element c source column base_x
    + step_x tw - e + c, e the shift that puts the row's copies on 16 bytes
    (`cpr` chunks copied a row, as many as its taps read; a run's 16-byte
    loads may reach past them, up to the pitch, into samples it does not
    use): for row r of plane p, e = (eb + wm (p src_h + r)) mod the chunk.
    The intermediate follows the ring: win_h rows of mid_pitch elements,
    row j holding window row j's intermediate columns tile_w tw ... The row
    pass's run (j, cx), runs_r a row, computes
    `run_r` intermediate columns from cx run_r, reading window elements
    from lead_x + e + cx run_r DX / UX on; the column pass's run (ry, cx),
    runs_c a row, computes RUN_C output rows from ry RUN_C by one 16-byte
    chunk of columns, reading intermediate rows from ry RUN_C DY / UY on.
    The *_m, *_s pairs divide by runs_r, runs_c, win_h and cpr
    (`fast_div`). uy, dy, py, ux, dx, px are the call's (up, down, phase)
    per axis (UY ... PX above): the 12-tap instantiations hold them at
    compile time and check them, the guarded one reads them."""
    variant: int
    planes: int
    src_h: int
    src_w: int
    out_h: int
    out_w: int
    fh: int
    fw: int
    tile_h: int
    tile_w: int
    tiles_h: int
    tiles_w: int
    tiles: int
    grid: int
    step_y: int
    step_x: int
    base_y: int
    base_x: int
    lead_x: int
    win_h: int
    pitch: int
    cpr: int
    eb: int
    wm: int
    mid_pitch: int
    slot_elems: int
    smem_bytes: int
    runs_r: int
    runs_c: int
    runs_r_m: int
    runs_r_s: int
    runs_c_m: int
    runs_c_s: int
    win_h_m: int
    win_h_s: int
    cpr_m: int
    cpr_s: int
    uy: int
    dy: int
    py: int
    ux: int
    dx: int
    px: int

    def axes(self) -> Tuple[int, ...]:
        """(taps held, then per axis (up, down, phase) for y and x) of the
        call: its instantiation's taps with the call's own axes."""
        return VARIANTS[self.variant][:2] + (self.uy, self.dy, self.py,
                                              self.ux, self.dx, self.px)


def sep_blocks(variant: int) -> int:
    """Blocks an SM of a separable instantiation: 3 at up or down 1 on x
    at compile time, else 2 (down 2 on x, and the guarded one)."""
    return 3 if VARIANTS[variant][6] == 1 else 2


def run_r(variant: int) -> int:
    """Intermediate columns of a separable call's row-pass run: 16 at up 2
    at compile time (a chunk of bf16 input), else 8."""
    return 16 if VARIANTS[variant][5] == 2 else 8


def sep_segments(variant: int) -> Tuple[int, int]:
    """(SEG, SEGY): the window samples a row-pass run reads and the
    intermediate rows a column-pass run reads, for the taps held; for the
    guarded instantiation, whose axes come at run time, the most any axis
    takes (at down 2)."""
    FY, FX, UY, DY, PY, UX, DX, PX = VARIANTS[variant]
    if UX == 0:
        return (run_r(variant) - 1) * 2 + FX, (RUN_C - 1) * 2 + FY
    return (((run_r(variant) - 1) * DX + FX - 1 - PX) // UX + 1,
            ((RUN_C - 1) * DY + FY - 1 - PY) // UY + 1)


def load_chunks(seg: int, itemsize: int) -> int:
    """csrc/upfirdn2d.cu's LOAD_CHUNKS: the 16-byte chunks a row-pass run
    loads for seg samples, wherever its first lies in its chunk."""
    return (seg // 2 + 8) // 4 if itemsize == 2 else (seg + 6) // 4


def k2_plan_sep(variant: int, planes: int, src_h: int, src_w: int, fh: int, fw: int,
                up: Sequence[int], down: Sequence[int], pad: Sequence[int], itemsize: int,
                ptr_mod16: int = 0, sms: int = 132) -> K2PlanSep:
    """The plan of one separable call of VARIANTS[variant] over [planes,
    src_h, src_w] (the input's data pointer ptr_mod16 bytes past 16): a row
    filter of fw taps with the x factors of up and down (x, y) and the x
    pads (px0, px1) of pad (px0, px1, py0, py1), then a column filter of fh
    taps with the y ones, on a card with `sms` SMs."""
    FY, FX = VARIANTS[variant][:2]
    (UX, UY), (DX, DY), (px0, px1, py0, py1) = up, down, pad
    PY, PX = py0 % UY, px0 % UX
    held = VARIANTS[variant][2:]
    assert variant >= N_2D and fh <= FY and fw <= FX and (UY, DY, PY) in AXES
    assert (FY == GUARDED_TAPS or fh == FY) and (FX == GUARDED_TAPS or fw == FX)
    assert held in ((0,) * 6, (UY, DY, PY, UX, DX, PX)) and (UX, DX, PX) in AXES
    assert ptr_mod16 % itemsize == 0
    out_h = (src_h * UY + py0 + py1 - fh) // DY + 1
    out_w = (src_w * UX + px0 + px1 - fw) // DX + 1
    CH, RX = 16 // itemsize, run_r(variant)
    first = -((px0 - PX) // UX)                   # tile 0's first source column
    base_x = first // CH * CH
    lead_x = first - base_x
    wm = src_w % CH
    eb = (ptr_mod16 // itemsize + base_x) % CH
    emax = CH - 1 if wm else eb                   # the largest row shift
    seg, _ = sep_segments(variant)

    def columns(tile_w):
        """(chunks copied a row, pitch, intermediate pitch) of tiles tile_w wide."""
        span = ((tile_w - 1) * DX + fw - 1 - PX) // UX + 1    # the samples its taps read
        last = lead_x + emax + (tile_w // RX - 1) * (RX * DX // UX)   # a row's last run
        cpr = _ceil_div(lead_x + emax + span, CH)
        pitch = (max(cpr, last // CH + load_chunks(seg, itemsize)) | 1) * CH  # odd: see ksep
        return cpr, pitch, (tile_w // CH | 1) * CH

    def win_h(th):
        return ((th - 1) * DY + fh - 1 - PY) // UY + 1

    # The tile that computes the least in all, by the instructions a window
    # element copied, an intermediate and an output take (about), within a
    # block's share of an SM's shared memory. A tile's columns are whole
    # row-pass runs and chunks, and its input step whole chunks.
    blocks = sep_blocks(variant)
    budget = SM_SHARED_BYTES // blocks - 1024
    per_mid, per_out = fw / UX + 8, fh / UY + 6
    align = math.lcm(RX, CH, UX * CH // math.gcd(DX, UX * CH))
    best = None
    for tile_w in sorted({_round_up(_ceil_div(out_w, n), align)
                          for n in range(1, _ceil_div(out_w, SEP_MIN_TILE_W) + 1)}):
        cpr, pitch, mid_pitch = columns(tile_w)
        tiles_w = _ceil_div(out_w, tile_w)
        for th in range(RUN_C, min(SEP_MAX_TILE_H, _round_up(out_h, RUN_C)) + 1, RUN_C):
            smem = (2 * pitch + mid_pitch) * win_h(th) * itemsize
            if th > RUN_C and (smem > budget or win_h(th) > THREADS):
                break
            cost = tiles_w * _ceil_div(out_h, th) * (
                win_h(th) * (cpr * CH * 0.5 + tile_w * per_mid) + th * tile_w * per_out)
            if best is None or cost < best[0]:
                best = (cost, tile_w, th)
    _, tile_w, tile_h = best
    tiles_w, step_x, runs_r = _ceil_div(out_w, tile_w), tile_w * DX // UX, tile_w // RX
    cpr, pitch, mid_pitch = columns(tile_w)
    tiles_h = _ceil_div(out_h, tile_h)
    tile_h = _round_up(_ceil_div(out_h, tiles_h), RUN_C)
    wh = win_h(tile_h)
    tiles = planes * tiles_h * tiles_w
    slot_elems = wh * pitch
    smem_bytes = (2 * pitch + mid_pitch) * wh * itemsize
    per_sm = min(blocks, SM_SHARED_BYTES // (smem_bytes + 1024))
    assert per_sm >= 1 and smem_bytes <= MAX_DYNAMIC_SMEM and wh <= THREADS, \
        "a window too large for a block"
    grid = min(tiles, sms * per_sm)
    runs_c = tile_w // CH
    divs = [v for d in (runs_r, runs_c, wh, cpr) for v in fast_div(d)]
    return K2PlanSep(variant, planes, src_h, src_w, out_h, out_w, fh, fw, tile_h, tile_w,
                     tiles_h, tiles_w, tiles, grid, tile_h * DY // UY, step_x,
                     -((py0 - PY) // UY), base_x, lead_x, wh, pitch, cpr, eb, wm, mid_pitch,
                     slot_elems, smem_bytes, runs_r, runs_c, *divs, UY, DY, PY, UX, DX, PX)


class _Launch(NamedTuple):
    """A call's launch: its output shape, instantiation, plan and taps."""
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
                sms: int = 132) -> Tuple[int, K2Plan2D, np.ndarray]:
    """(variant, plan, taps) of the 2-D pass p on x [N, C, H, W] of dtype
    whose data pointer lies ptr_mod16 bytes past 16: taps are the N_TAPS
    floats the C entry point reads, the [4][4] taps rounded to x's dtype, then
    its factors fy, fx (zero where the filter is not their outer product)."""
    N, C, H, W = x_shape
    variant = pass_variant(p)
    assert variant < N_2D
    fh, fw = p.k.shape
    held = np.zeros((4, 4), np.float32)       # the taps rounded to x's dtype, as the plain conv
    held[:fh, :fw] = p.k.to(dtype).float().numpy()
    taps = np.zeros(N_TAPS, np.float32)
    taps[:16] = held.reshape(-1)
    mode, factors = pass_mode(held, fh, fw, dtype)
    if factors is not None:
        taps[16:20], taps[20:24] = factors
    itemsize = torch.empty((), dtype=dtype).element_size()
    plan = k2_plan_2d(variant, N * C, H, W, fh, fw, p.pad, itemsize, ptr_mod16, mode, sms)
    return variant, plan, taps


def sep_launch(row: Pass, col: Pass, x_shape, dtype: torch.dtype, ptr_mod16: int,
               sms: int = 132) -> Tuple[int, K2PlanSep, np.ndarray]:
    """(variant, plan, taps) of the separable call that runs the row pass
    `row`, then the column pass `col`, on x as pass_launch's: taps are the
    column filter's 16, then the row filter's 16, rounded to x's dtype."""
    N, C, H, W = x_shape
    ky = col.k[:, 0].to(dtype).float().numpy()
    kx = row.k[0].to(dtype).float().numpy()
    taps = np.zeros(N_TAPS, np.float32)
    taps[:len(ky)], taps[16:16 + len(kx)] = ky, kx
    itemsize = torch.empty((), dtype=dtype).element_size()
    variant = sep_variant(row, col)
    plan = k2_plan_sep(variant, N * C, H, W, len(ky), len(kx), (row.up[0], col.up[1]),
                       (row.down[0], col.down[1]),
                       (row.pad[0], row.pad[1], col.pad[2], col.pad[3]), itemsize, ptr_mod16,
                       sms)
    return variant, plan, taps


def call_launch(ps: Sequence[Pass], x_shape, dtype: torch.dtype, ptr_mod16: int,
                sms: int = 132) -> Tuple[int, NamedTuple, np.ndarray]:
    """(variant, plan, taps) of the one launch of a call whose passes are ps:
    a 2-D pass, or the separable kernel's (a separable filter, or a lone row
    or column)."""
    if len(ps) == 1 and pass_variant(ps[0]) < N_2D:
        return pass_launch(ps[0], x_shape, dtype, ptr_mod16, sms)
    return sep_launch(*sep_passes(ps), x_shape, dtype, ptr_mod16, sms)


def _call_launch(x: torch.Tensor, f, up, down, padding, flip_filter: bool,
                 gain: float) -> _Launch:
    """The launch of upfirdn2d_k2(x, f, ...) for x's shape, dtype, device and
    alignment; raises on what the kernel does not take. For a filter tensor
    it is remembered by its identity and version (the entry holds the
    tensor, so its identity stays unique), so that a repeated call costs a
    dict lookup and no host work."""
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
    variant, plan, taps = call_launch(passes(ft, up, down, padding, flip_filter, gain), key[0],
                                      x.dtype, key[3], _sm_count(x.device))
    if plan.tiles >= 2 ** 31:
        raise ValueError(f"upfirdn2d_k2: {plan.tiles} tiles exceed the grid")
    out = _Launch((*key[0][:2], plan.out_h, plan.out_w), variant,
                  (ctypes.c_int64 * len(plan))(*plan), (ctypes.c_float * N_TAPS)(*taps.tolist()))
    if isinstance(f, torch.Tensor):
        if len(_CALLS) >= 4096:
            _CALLS.clear()
        _CALLS[(id(f),) + key] = (f, f._version, out)
    return out


def upfirdn2d_k2(x: torch.Tensor, f, up, down, padding, flip_filter: bool = False,
                 gain: float = 1.0) -> torch.Tensor:
    """upfirdn2d as one K2 launch (see the module docstring).

    up, down: (x, y) factors; padding: (px0, px1, py0, py1) w.r.t. the
    upsampled image; f: a host filter [fh, fw] or, separable, [taps]. A CPU
    tensor goes to `upfirdn2d_k2_plain`. A CUDA tensor goes to the kernel, one
    launch a call, or raises on what the kernel does not take. No autograd
    graph: ops/upfirdn2d.py:_UpFirDn2d carries the gradient.
    """
    if not on_cuda(x, "upfirdn2d_k2"):
        return upfirdn2d_k2_plain(x, f, up, down, padding, flip_filter, gain)
    if not x.is_contiguous():             # the one refusal the remembered launch misses
        raise ValueError("upfirdn2d_k2 needs a contiguous NCHW tensor")
    L = _call_launch(x, f, up, down, padding, flip_filter, gain)
    y = torch.empty(L.out_shape, dtype=x.dtype, device=x.device)
    if y.numel():
        launch("upfirdn2d", entry_point("upfirdn2d", _ARGTYPES),
               (x.data_ptr(), y.data_ptr(), L.taps, DTYPE_CODES[x.dtype], L.variant, L.plan),
               x.device.index)
        upfirdn2d_k2.launches += 1
    return y


upfirdn2d_k2.launches = 0
