"""K2, the port's hand-written upfirdn2d kernel (csrc/upfirdn2d.cu), on the CPU.

  * Its plain version (`upfirdn2d_k2_plain`, what `upfirdn2d` runs on a CPU
    tensor) against stylegan_v_tpu/ops/upfirdn2d.py:upfirdn2d at the exact
    parameters of every main-path call: G's up=2 conv and image skip, D's
    pre-filter of its 3x3 down=2 conv, the augment's 12-tap 2x up and 2x
    down (a crop). Value, vjp and second order (tests/test_torch_grads.py's
    check_op): float32, values and first order to 1e-4 of scale, second
    order to 1e-3.
  * The launch plans of every call and its adjoint at the FFS-256 step's
    shapes (16 videos x 3 frames; the separable calls also at the MoCoGAN
    pipe's 8 x 48 channels), bf16 and float32, aligned or not: the 2-D
    pass's (`k2_plan_2d`) and the separable call's (`k2_plan_sep`, both
    passes in one launch): every output exactly once, every tap of every
    output read from the window cell that holds its source sample through
    its ring slot, every read inside its slot, every copy on 16 bytes.
  * Emulations of both kernels in numpy (the copies into each block's ring,
    each thread's polyphase loops, as csrc/upfirdn2d.cu indexes them)
    against the plain version at small shapes, including the adjoints: the
    separable one, its intermediate rounded to the dtype and each pass's
    taps summed by fused multiply-adds in tap order, to the bit (also at odd
    widths, both phases, mixed axes and a lone row or column filter); the
    2-D one float32 to 1e-5 of scale (another summation order), bf16 to
    1e-2 (both round once from a float32 sum of the same bf16 taps).
  * Routing: every upfirdn2d call that a reduced-width FFS-256 G, D and bgc
    pipe make in a forward and a backward, recorded by hooks, takes K1 or
    K2 on a CUDA tensor, one K2 launch a call; the counts a G and a D
    forward make (chip_smoke.py's launch counts build on them).
  * The wrapper on a CPU tensor is the plain version and launches nothing;
    a separable call on a (stand-in) CUDA tensor is one launch; what the
    kernel does not take is refused; VARIANTS equals the source's
    K2_VARIANTS.
  * The export's ATen route: the traced graph holds only ATen ops, K2's
    wrapper is not entered while tracing, and the artifact equals the
    direct forward.
"""
import importlib
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from stylegan_v_tpu_torch.ops import setup_filter, upfirdn2d_kernel as k2
from stylegan_v_tpu_torch.ops.upfirdn2d_kernel import (VARIANTS, k2_refusal, passes, pass_out_hw,
                                                       pass_variant, upfirdn2d_k2,
                                                       upfirdn2d_k2_plain)
from stylegan_v_tpu_torch.training.augment import _SYM6

tup = importlib.import_module("stylegan_v_tpu_torch.ops.upfirdn2d")

FIR4 = [1, 3, 3, 1]
# The main path's calls: (input NCHW at a small size, filter, upfirdn2d's
# keyword arguments). The paddings are what the callers compute:
# conv2d_resample's up=2 3x3 conv (padding 1), upsample2d and downsample2d
# (augment.py:_warp_antialiased, Hz_pad = 3), conv2d_resample's down=2 3x3
# conv (padding 1).
CASES = {
    "g_upconv": ((2, 3, 5, 6), FIR4, dict(up=2, padding=(3, 2, 3, 2), gain=4)),
    "g_skip": ((2, 3, 5, 6), FIR4, dict(up=2, padding=(2, 1, 2, 1), gain=4)),
    "d_downconv": ((2, 3, 10, 9), FIR4, dict(padding=2)),
    "aug_up": ((2, 3, 9, 8), _SYM6, dict(up=2, padding=(6, 5, 6, 5), gain=4)),
    "aug_down": ((2, 3, 26, 28), _SYM6, dict(down=2, padding=-1, flip_filter=True)),
}


def call_args(f, kw):
    """upfirdn2d's keyword arguments as (f, up, down, padding, flip, gain)."""
    p = kw.get("padding", 0)
    return (setup_filter(f), tup.parse_scaling(kw.get("up", 1)),
            tup.parse_scaling(kw.get("down", 1)), tup.parse_padding(p),
            kw.get("flip_filter", False), kw.get("gain", 1.0))


def forward_and_adjoint(shape, f, kw):
    """The (x shape, f, up, down, padding, flip, gain) of a call and of its adjoint."""
    args = call_args(f, kw)
    H, W = shape[2:]
    for p in passes(*args):
        H, W = pass_out_hw(p, H, W)
    adj = tup.adjoint_args(*args, shape[2:], (H, W))
    return [(shape, *args), ((*shape[:2], H, W), *adj)]


def test_callers_compute_the_case_paddings():
    """The CASES' paddings are those of the main path's calls."""
    seen = []
    orig = tup.upfirdn2d

    def record(x, f, up=1, down=1, padding=0, flip_filter=False, gain=1.0):
        seen.append((tup.parse_scaling(up), tup.parse_scaling(down),
                     tup.parse_padding(padding), flip_filter, gain))
        return orig(x, f, up, down, padding, flip_filter, gain)

    cr = importlib.import_module("stylegan_v_tpu_torch.ops.conv2d_resample")
    x, f4, f12 = torch.zeros(1, 2, 8, 8), setup_filter(FIR4), setup_filter(_SYM6)
    w = torch.zeros(2, 2, 3, 3)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tup, "upfirdn2d", record)
        mp.setattr(cr, "upfirdn2d", record)
        cr.conv2d_resample(x, w, f4, up=2, padding=1)
        tup.upsample2d(x, f4)
        cr.conv2d_resample(x, w, f4, down=2, padding=1)
        tup.upsample2d(x, f12, up=2)
        tup.downsample2d(torch.zeros(1, 2, 30, 30), f12, down=2, padding=-6, flip_filter=True)
    want = [call_args(f, kw)[1:] for _, f, kw in CASES.values()]
    assert [tuple(s) for s in seen] == [tuple(w) for w in want]


# ---------------------------------------------- the plain version against JAX

@pytest.mark.parametrize("case", list(CASES))
def test_plain_matches_jax_to_second_order(case):
    from test_torch_grads import NHWC, check_op
    jup = importlib.import_module("stylegan_v_tpu.ops.upfirdn2d")
    shape, f, kw = CASES[case]
    x = np.random.RandomState(3).randn(shape[0], shape[2], shape[3], shape[1])
    jf, tf = jup.setup_filter(f), setup_filter(f)
    assert tf.ndim == (1 if f is _SYM6 else 2)
    fargs = call_args(f, kw)[1:]

    def port(x):
        return tup._UpFirDn2d.apply(x, tf, *fargs)

    before = upfirdn2d_k2.launches
    check_op(lambda x: jup.upfirdn2d(x, jf, **kw), port, [x], [NHWC], NHWC)
    check_op(lambda x: jup.upfirdn2d(x, jf, **kw), lambda x: tup.upfirdn2d(x, tf, **kw),
             [x], [NHWC], NHWC)
    assert upfirdn2d_k2.launches == before


# ------------------------------------------------------------- the launch plan

ASYM = (np.arange(16, dtype=np.float32).reshape(4, 4) - 5.0) / 40   # not an outer product


def ffs256_calls():
    """The main path's upfirdn2d calls at the FFS-256 step (16 videos x 3
    frames; channel_base 16384, channel_max 512): (label, x shape, dtype
    itemsize, f, kw)."""
    def ch(r):
        return min(16384 // r, 512)
    for r in (8, 16, 32, 64, 128, 256):
        size = 2 if r >= 32 else 4
        yield f"g_upconv{r}", (48, ch(r // 2), r // 2, r // 2), size, FIR4, CASES["g_upconv"][2]
        yield f"g_skip{r}", (48, 3, r // 2, r // 2), 4, FIR4, CASES["g_skip"][2]
        n = 48 if r > 16 else 16                       # the video batch after concat_res
        yield f"d_downconv{r}", (n, ch(r), r, r), size, FIR4, CASES["d_downconv"][2]
    yield "aug_up", (16, 9, 268, 268), 2, _SYM6, CASES["aug_up"][2]
    yield "aug_down", (16, 9, 524, 524), 2, _SYM6, CASES["aug_down"][2]


def plan_cases():
    """The 2-D passes of ffs256_calls and of the small CASES, forward and adjoint."""
    small = [(f"{name}_small", shape, size, f, kw) for name, (shape, f, kw) in CASES.items()
             for size in (2, 4)]
    for label, shape, size, f, kw in list(ffs256_calls()) + small:
        for which, (xs, *args) in zip(("fwd", "adj"), forward_and_adjoint(shape, f, kw)):
            p, *rest = passes(*args)
            if rest:
                continue
            for aligned in (True, False):
                yield pytest.param(p, (xs[0] * xs[1], *xs[2:]), size, aligned,
                                   id=f"{label}-{which}-{size}B-al{int(aligned)}")


SEP_ODD = {  # off the main path: a lone row or column filter, mixed axes, phase 1
    "row7_up2x": ((2, 5, 9, 13), np.ones((1, 7), np.float32) / 7,
                  dict(up=(2, 1), padding=(3, 2, 1, -1))),
    "col9_down2y": ((2, 5, 31, 10), np.ones((9, 1), np.float32) / 9,
                    dict(down=(1, 2), padding=(-1, 2, 4, 4))),
    "row16": ((1, 3, 6, 40), np.ones((1, 16), np.float32) / 16, dict(padding=(8, 7, 0, 0))),
    "sym6_mixed": ((2, 3, 17, 22), _SYM6, dict(up=(2, 1), down=(1, 2), padding=(5, 6, 6, 5))),
    "sym6_phase1": ((2, 3, 11, 12), _SYM6, dict(up=2, padding=(5, 6, 5, 6), gain=4)),
    "fir10_down2": ((1, 2, 30, 35), [1, 2, 3, 4, 5, 5, 4, 3, 2, 1], dict(down=2, padding=3)),
}


def sep_call_cases():
    """The separable calls: the pipe's 12-tap 2x up and 2x down at the FFS-256
    step (16 videos x 9 fused channels) and at the MoCoGAN step (8 x 48), the
    small CASES, and SEP_ODD: (label, x shape, upfirdn2d's keyword arguments
    as call_args, itemsizes)."""
    for label, C in (("ffs256", 16 * 9), ("mocogan", 8 * 48)):
        for name, shape in (("aug_up", (1, C, 268, 268)), ("aug_down", (1, C, 524, 524))):
            yield f"{label}_{name}", shape, CASES[name][1:], (2, 4)
    for name in ("aug_up", "aug_down"):
        yield f"{name}_small", CASES[name][0], CASES[name][1:], (2, 4)
    for name, (shape, f, kw) in SEP_ODD.items():
        yield name, shape, (f, kw), (2,)


def sep_plan_cases():
    for label, shape, (f, kw), sizes in sep_call_cases():
        for which, (xs, *args) in zip(("fwd", "adj"), forward_and_adjoint(shape, f, kw)):
            for size in sizes:
                for aligned in (True, False):
                    yield pytest.param(xs, args, size, aligned,
                                       id=f"{label}-{which}-{size}B-al{int(aligned)}")


def misaligned(itemsize):
    """A data pointer's offset past 16 bytes for an input that does not start on 16."""
    return 6 if itemsize == 2 else 4


def fdiv(n, md):
    """csrc/upfirdn2d.cu's FastDiv: (n m) >> s."""
    m, sh = md
    return (np.asarray(n, np.uint64) * np.uint64(m)) >> np.uint64(sh)


def copy_share(plan):
    """The (row, chunk) cells of a window each thread copies (csrc/upfirdn2d.cu's
    CopyShare): every cell once."""
    taken = np.zeros((plan.win_h, plan.cpr), np.int64)
    for tid in range(k2.THREADS):
        if plan.cpr <= k2.THREADS:
            j0 = int(fdiv(tid, (plan.cpr_m, plan.cpr_s)))
            c0, dj, dc = tid - j0 * plan.cpr, k2.THREADS // plan.cpr, plan.cpr
            j0 = plan.win_h if j0 >= dj else j0
        else:
            j0, dj, c0, dc = 0, 1, tid, k2.THREADS
        taken[j0::dj, c0::dc] += 1
    return taken


def plan_itemsize(plan):
    return plan.smem_bytes // (2 * plan.slot_elems + plan.win_h * plan.mid_pitch)


def check_plan_sep(plan, row_p, col_p, planes, H, W, itemsize, ptr_mod16):
    """A separable call's plan (k2_plan_sep), axis by axis at full size: the
    persistent walk takes every tile once and the tiles every output once;
    every tap of every output's column pass reads the intermediate row that
    its row pass computed from the window row that holds its source row, and
    every tap of the row pass the window element that holds its source
    column, whatever the row's shift; every load stays inside its slot and
    the intermediate; the threads' copies take every cell of the window once;
    every data row's copies start on 16 bytes."""
    FY, FX, UY, DY, PY, UX, DX, PX = plan.axes()
    assert (UY, DY, PY, UX, DX, PX) == (col_p.up[1], col_p.down[1], col_p.pad[2] % col_p.up[1],
                                        row_p.up[0], row_p.down[0], row_p.pad[0] % row_p.up[0])
    assert VARIANTS[plan.variant][2:] in ((0,) * 6, (UY, DY, PY, UX, DX, PX))
    fh, fw = col_p.k.shape[0], row_p.k.shape[1]
    px0, py0 = row_p.pad[0], col_p.pad[2]
    CH, RX, RC = 16 // itemsize, k2.run_r(plan.variant), k2.RUN_C
    SEG, SEGY = k2.sep_segments(plan.variant)
    NC = k2.load_chunks(SEG, itemsize)
    assert len(plan) == len(k2.K2PlanSep._fields) and plan_itemsize(plan) == itemsize
    assert (plan.fh, plan.fw) == (fh, fw) and (FY == 16 or FY == fh) and (FX == 16 or FX == fw)
    assert plan.pitch % CH == 0 and plan.pitch // CH % 2 == 1 and plan.cpr * CH <= plan.pitch
    assert plan.mid_pitch % CH == 0 and plan.mid_pitch // CH % 2 == 1
    assert plan.mid_pitch >= plan.tile_w and plan.slot_elems == plan.win_h * plan.pitch
    assert plan.smem_bytes == (2 * plan.slot_elems + plan.win_h * plan.mid_pitch) * itemsize
    assert plan.smem_bytes <= k2.MAX_DYNAMIC_SMEM and plan.win_h <= k2.THREADS
    assert plan.tile_h % RC == 0 and plan.tile_w == plan.runs_r * RX == plan.runs_c * CH
    assert plan.step_x * UX == plan.tile_w * DX and plan.step_x % CH == 0
    assert plan.step_y * UY == plan.tile_h * DY and plan.base_x % CH == 0
    assert 0 <= plan.lead_x < CH and plan.wm == W % CH
    for name in ("runs_r", "runs_c", "win_h", "cpr"):
        m, sh = getattr(plan, f"{name}_m"), getattr(plan, f"{name}_s")
        assert (m, sh) == k2.fast_div(getattr(plan, name)) and m < 2 ** 32
    # the walk and the tiles
    assert plan.tiles == planes * plan.tiles_h * plan.tiles_w < 2 ** 31
    assert 1 <= plan.grid <= min(plan.tiles, 132 * k2.sep_blocks(plan.variant))
    walk = np.arange(plan.grid)[:, None] + np.arange(-(-plan.tiles // plan.grid))[None] * plan.grid
    assert np.array_equal(np.sort(walk[walk < plan.tiles]), np.arange(plan.tiles))
    for n, tile, tiles in ((plan.out_h, plan.tile_h, plan.tiles_h),
                           (plan.out_w, plan.tile_w, plan.tiles_w)):
        assert tiles * tile >= n > (tiles - 1) * tile
    # rows: output row oy = tile_h th + RC ry + jy, tap ty
    oy = np.arange(plan.out_h)[:, None]
    ty = np.arange(fh)[None]
    th, ry, jy = oy // plan.tile_h, oy % plan.tile_h // RC, oy % RC
    num = jy * DY + ty - PY
    land = num % UY == 0
    up = oy * DY - py0 + ty                          # the row in the zero-inserted intermediate
    assert np.array_equal(land, up % UY == 0)
    sy = num // UY
    assert sy[land].min() >= 0 and sy[land].max() < SEGY
    j = ry * (RC * DY // UY) + sy
    assert j[land].min() >= 0 and j[land].max() < plan.win_h     # inside the intermediate
    assert np.array_equal((plan.base_y + th * plan.step_y + j)[land], (up // UY)[land])
    if FY == 16:                                     # the guarded column pass stops at fh
        last = ((RC - 1) * DY + fh - 1 - PY) // UY
        assert (plan.tile_h // RC - 1) * (RC * DY // UY) + last < plan.win_h
    else:
        assert (plan.tile_h // RC - 1) * (RC * DY // UY) + SEGY <= plan.win_h
    # columns: intermediate column ox = tile_w tw + RX cx + jx, tap tx, under
    # every shift a data row may have
    rows = np.arange(planes)[:, None] * H + np.arange(H)[None]
    shifts = set(((plan.eb + plan.wm * rows) % CH).ravel().tolist())
    ox = np.arange(plan.out_w)[:, None]
    tx = np.arange(fw)[None]
    tw, cx, jx = ox // plan.tile_w, ox % plan.tile_w // RX, ox % RX
    num = jx * DX + tx - PX
    land = num % UX == 0
    upx = ox * DX - px0 + tx
    assert np.array_equal(land, upx % UX == 0)
    sx = num // UX
    assert sx[land].min() >= 0 and sx[land].max() < SEG
    for e in shifts:
        c0 = plan.lead_x + e + cx * (RX * DX // UX)              # the run's first element
        assert ((c0 // CH + NC) * CH <= plan.pitch).all()        # its loads inside the slot
        assert (c0 + sx)[land].max() < plan.cpr * CH             # every tap's sample copied
        col = plan.base_x + tw * plan.step_x - e + c0 + sx
        assert np.array_equal(col[land], (upx // UX)[land])
    # the threads' copies, and each data row's on 16 bytes; the straddle's chunk
    assert (copy_share(plan) == 1).all()
    for col0 in plan.base_x + np.arange(plan.tiles_w) * plan.step_x:
        e = (plan.eb + plan.wm * rows) % CH
        start = ptr_mod16 // itemsize + rows * W + col0 - e
        assert (start % CH == 0).all()
        if col0 <= 0 and (e > 0).any():
            assert -col0 % CH == 0 and -col0 < plan.cpr * CH


def segs(variant):
    """(SEGY, SEGX): the window rows and samples a 2-D run reads."""
    FY, FX, UY, DY, PY, UX, DX, PX = VARIANTS[variant]
    RY, RX = k2.run_2d(variant)
    return ((RY - 1) * DY + 3 - PY) // UY + 1, ((RX - 1) * DX + 3 - PX) // UX + 1


def row_shift(plan, ts, plane):
    """csrc/upfirdn2d.cu's row_shift, in numpy."""
    return (plan.eb + plan.wm * np.asarray(ts, np.int64)
            - plan.pm * np.asarray(plane, np.int64)) % plan.chunk


def check_plan_2d(plan, p, planes, H, W, itemsize, ptr_mod16):
    """A 2-D pass's plan (k2_plan_2d), axis by axis at full size: the
    persistent walk writes every output once; every tap of every output
    reads, through its ring slot, the window cell that holds its source
    sample (a zero where that lies outside the plane); every read and copy
    stays inside its slot; every window row's copies start on 16 bytes."""
    FY, FX, UY, DY, PY, UX, DX, PX = VARIANTS[plan.variant]
    RY, RX = k2.run_2d(plan.variant)
    fh, fw = p.k.shape
    px0, _, py0, _ = p.pad
    CH, S = plan.chunk, k2.STAGES
    SEGY, SEGX = segs(plan.variant)
    assert len(plan) == len(k2.K2Plan2D._fields) and CH * itemsize == 16
    assert plan.pitch == plan.cpr * CH and plan.slot_elems >= plan.win_h * plan.pitch
    assert plan.slot_elems % CH == 0 and plan.stage_bytes == S * plan.slot_elems * itemsize
    assert plan.stage_bytes <= k2.MAX_DYNAMIC_SMEM and plan.win_h <= k2.THREADS
    assert plan.tile_h % RY == 0 and plan.tile_w == plan.runs_x * RX
    for name in ("runs_x", "vh", "sr", "cpr", "tiles_w"):
        m, sh = getattr(plan, f"{name}_m"), getattr(plan, f"{name}_s")
        assert (m, sh) == k2.fast_div(getattr(plan, name)) and m < 2 ** 32
    # the walk: block b takes tiles b, b + grid, ... (its k-th into slot k % STAGES)
    tiles_h = plan.tiles // plan.tiles_w
    assert plan.tiles == tiles_h * plan.tiles_w and 1 <= plan.grid <= plan.tiles
    assert plan.grid <= 132 * k2.MIN_BLOCKS
    walk = np.arange(plan.grid)[:, None] + np.arange(-(-plan.tiles // plan.grid))[None] * plan.grid
    assert np.array_equal(np.sort(walk[walk < plan.tiles]), np.arange(plan.tiles))
    # rows: virtual row v of row tile v // tile_h, run row ry, run row jy
    v = np.arange(tiles_h * plan.tile_h)
    assert tiles_h * plan.tile_h >= planes * plan.vh >= planes * plan.out_h
    rt, ry, jy = v // plan.tile_h, v % plan.tile_h // RY, v % RY
    pv = fdiv(v - jy, (plan.vh_m, plan.vh_s)).astype(np.int64)    # the run's first row's plane
    assert np.array_equal(pv, (v - jy) // plan.vh)
    pl_, oy = v // plan.vh, v % plan.vh                              # the kernel's count from there
    real = (pl_ < planes) & (oy < plan.out_h)
    assert real.sum() == planes * plan.out_h                         # each (plane, row) once
    if plan.pm:
        assert plan.vh % plan.tile_h == 0                            # a tile lies in one plane
    w0 = rt * plan.tile_h * DY // UY
    wr = ry * RY * DY // UY
    tplane = w0 // plan.sr if plan.pm else 0
    e0 = row_shift(plan, w0 + wr, tplane)
    shifts = set()
    for ty in range(fh):
        num = jy * DY + ty - PY
        land = num % UY == 0
        sy = num // UY
        up = oy * DY - py0 + ty                                      # the upsampled row
        assert np.array_equal(land[real], (up % UY == 0)[real])
        sel = real & land
        assert sy[sel].min() >= 0 and sy[sel].max() < SEGY
        assert (wr + sy)[sel].max() < plan.win_h                     # inside its slot's rows
        ts = w0 + wr + sy
        tp = ts // plan.sr
        trow = ts - tp * plan.sr - plan.q
        data = (tp < planes) & (trow >= 0) & (trow < H)
        row = up // UY
        inside = (row >= 0) & (row < H)
        assert np.array_equal(tp[sel & inside], pl_[sel & inside])
        assert np.array_equal(trow[sel & inside], row[sel & inside])
        assert not data[sel & ~inside].any()                         # a pad row reads zeros
        e_run = (e0 + sy * plan.wm) % CH                             # the run's shift for it
        assert np.array_equal(e_run[sel & inside], row_shift(plan, ts, tp)[sel & inside])
        shifts |= set(e_run[sel & inside].tolist())
    # columns: column tile ct, run column cx, column jx
    ox = np.arange(plan.tiles_w * plan.tile_w)
    ct, cx, jx = ox // plan.tile_w, ox % plan.tile_w // RX, ox % RX
    assert plan.tiles_w * plan.tile_w >= plan.out_w > (plan.tiles_w - 1) * plan.tile_w
    col0 = plan.base_x + ct * plan.step_x
    if plan.tiles_w > 1:
        assert plan.step_x % CH == 0
    assert plan.base_x % CH == 0 and 0 <= plan.lead_x
    c0 = plan.lead_x + cx * (RX * DX // UX)
    realx = ox < plan.out_w
    for e in shifts or {0}:
        c = c0 + e
        end = c - c % 2 + 2 * (SEGX // 2 + 1) if itemsize == 2 else c + SEGX
        assert end[realx].max() <= plan.pitch                        # reads inside the slot
    for tx in range(fw):
        num = jx * DX + tx - PX
        land = num % UX == 0
        sx = num // UX
        up = ox * DX - px0 + tx
        assert np.array_equal(land[realx], (up % UX == 0)[realx])
        sel = realx & land
        assert sx[sel].min() >= 0 and sx[sel].max() < SEGX
        for e in shifts or {0}:
            col = col0 - e + (c0 + e + sx)                           # the sample's source column
            assert np.array_equal(col[sel], (up // UX)[sel])
    # the copies: the threads' shares (CopyShare) take every chunk of the
    # window once, and each data row's chunks start on 16 bytes
    assert (copy_share(plan) == 1).all()
    ts = (np.arange(tiles_h)[:, None] * plan.tile_h * DY // UY
          + np.arange(plan.win_h)[None])
    tp = ts // plan.sr
    trow = ts - tp * plan.sr - plan.q
    data = (tp < planes) & (trow >= 0) & (trow < H)
    for c_0 in set(col0.tolist()):
        start = ptr_mod16 // itemsize + (tp * H + trow) * W + c_0 - row_shift(plan, ts, tp)
        assert (start[data] % CH == 0).all()


@pytest.mark.parametrize("p,shape,itemsize,aligned", list(plan_cases()))
def test_k2_plan_covers_every_output_once_and_reads_inside_its_window(p, shape, itemsize,
                                                                      aligned):
    planes, H, W = shape
    variant = pass_variant(p)
    assert variant is not None and variant < k2.N_2D
    fh, fw = p.k.shape
    ptr = 0 if aligned else misaligned(itemsize)
    dtype = torch.bfloat16 if itemsize == 2 else torch.float32
    mode, _ = k2.pass_mode(p.k.to(dtype).float().numpy(), fh, fw, dtype)
    plan = k2.k2_plan_2d(variant, planes, H, W, fh, fw, p.pad, itemsize, ptr, mode)
    # the main path's [1, 3, 3, 1]: rows then columns on bf16, the 2-D sum on float32
    assert plan.mode == (k2.ROWS_THEN_COLUMNS if itemsize == 2 else k2.FULL)
    assert (plan.out_h, plan.out_w) == pass_out_hw(p, H, W)
    check_plan_2d(plan, p, planes, H, W, itemsize, ptr)


@pytest.mark.parametrize("xs,args,itemsize,aligned", list(sep_plan_cases()))
def test_k2_plan_sep_covers_every_output_once_and_reads_inside_its_window(xs, args, itemsize,
                                                                          aligned):
    """Every separable call's one launch (`call_launch`): the pipe's 12-tap
    calls take the unguarded 12-tap instantiations, every other the guarded
    one, with its axes in the plan; the plan's geometry as check_plan_sep."""
    ps = passes(*args)
    dtype = torch.bfloat16 if itemsize == 2 else torch.float32
    ptr = 0 if aligned else misaligned(itemsize)
    variant, plan, taps = k2.call_launch(ps, xs, dtype, ptr)
    row, col = k2.sep_passes(ps)
    assert variant >= k2.N_2D and variant == k2.sep_variant(row, col) == plan.variant
    exact = ((col.k.shape[0], row.k.shape[1]) == (12, 12)
             and (12, 12) + VARIANTS[variant][2:] in VARIANTS)
    assert VARIANTS[variant] == (VARIANTS[variant][:2] + plan.axes()[2:] if exact
                                 else k2.GUARDED_SEP)
    H, W = xs[2:]
    for p in ps:
        H, W = pass_out_hw(p, H, W)
    assert (plan.out_h, plan.out_w) == (H, W)
    assert np.array_equal(taps[:plan.fh], col.k[:, 0].to(dtype).float().numpy())
    assert np.array_equal(taps[16:16 + plan.fw], row.k[0].to(dtype).float().numpy())
    assert not taps[plan.fh:16].any() and not taps[16 + plan.fw:].any()
    check_plan_sep(plan, row, col, xs[0] * xs[1], *xs[2:], itemsize, ptr)


def test_k2_plan_shapes_at_g_upconv_256():
    """G's r = 256 up-conv at 16 x 3 in bf16: [6144, 128, 128] -> 258^2, a
    tile a whole row of 65 runs by 128 rows, a plane's 258 rows with no
    virtual row to spare, 3 blocks an SM on 132 SMs; small planes pack
    several to a tile."""
    p = passes(setup_filter(FIR4), (2, 2), (1, 1), (3, 2, 3, 2), False, 4.0)[0]
    plan = k2.k2_plan_2d(pass_variant(p), 48 * 128, 128, 128, 4, 4, p.pad, 2, 0,
                         k2.ROWS_THEN_COLUMNS)
    assert (plan.out_h, plan.out_w, plan.vh, plan.tiles_w, plan.tile_w) == (258, 258, 258, 1, 260)
    assert (plan.tile_h, plan.grid, plan.chunk, plan.mode) == (128, 396, 8, 2)
    assert (plan.eb, plan.wm, plan.pm) == (0, 0, 0)
    small = k2.k2_plan_2d(pass_variant(p), 48 * 512, 4, 4, 4, 4, p.pad, 4)
    assert small.tile_h > 2 * small.vh and small.tiles_w == 1


@pytest.mark.parametrize("d", [1, 2, 3, 7, 10, 65, 129, 257, 258, 265, 4095])
def test_fast_div_is_exact_below_2_to_30(d):
    m, sh = k2.fast_div(d)
    n = np.concatenate([np.arange(4 * d), np.random.RandomState(d).randint(0, 2 ** 30, 4096),
                        [2 ** 30 - 1, 2 ** 30 - d]]).astype(np.int64)
    assert m < 2 ** 32 and np.array_equal(fdiv(n, (m, sh)).astype(np.int64), n // d)


# ------------------------------------------------------------ the rank-1 split

RANK1_FILTERS = {
    "fir4": (setup_filter(FIR4).numpy(), True),
    "fir4_gain4": (setup_filter(FIR4).numpy() * 4, True),
    "asym_outer": (np.outer([1, 2, 3, 4], [2, 1, 1, 3]).astype(np.float32) / 64, True),
    "asym": (ASYM, False),
    "rank2": (np.outer([1, 3, 3, 1], [1, 3, 3, 1]).astype(np.float32) / 64 + np.eye(4) / 8,
              False),
    "inexact": (np.outer([1, 1 / 3, 1 / 7, 1], [1, 3, 3, 1]).astype(np.float32), None),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", list(RANK1_FILTERS))
def test_rank1_split_taken_exactly_for_an_outer_product(name, dtype):
    """A 2-D pass sums rows then columns exactly where x is bf16 and its taps,
    rounded to bf16, are the outer product of two factors in float32
    (whichever `rank1_factors` finds); else the 2-D sum: unguarded for 4x4
    taps (float32 always, bf16 an asymmetric or a rank-2 filter), guarded by
    the filter's size for a 3x3 one."""
    f, want = RANK1_FILTERS[name]
    for shape, flt in (((4, 4), f), ((3, 3), f[:3, :3])):
        p = passes(torch.from_numpy(np.ascontiguousarray(flt)), (1, 1), (1, 1), (2, 2, 2, 2),
                   True, 1.0)[0]
        variant, plan, taps = k2.pass_launch(p, (2, 3, 9, 9), dtype, 0)
        held = p.k.to(dtype).float().numpy()
        if shape == (3, 3):
            assert plan.mode == k2.GUARDED
        elif dtype == torch.float32:
            assert plan.mode == k2.FULL
        elif want is not None:
            assert plan.mode == (k2.ROWS_THEN_COLUMNS if want else k2.FULL)
        assert np.array_equal(taps[:16].reshape(4, 4)[:shape[0], :shape[1]], held)
        fy, fx = taps[16:20], taps[20:24]
        if plan.mode == k2.ROWS_THEN_COLUMNS:
            assert np.array_equal(fy[:, None] * fx[None, :], held)
        else:
            assert not fy.any() and not fx.any()


# ------------------------------------------------- an emulation of the kernel

def fma(k, v, acc):
    """acc + k v as one fused multiply-add in float32: the product of two
    float32 values is exact in float64."""
    return (np.float64(k) * v.astype(np.float64) + acc.astype(np.float64)).astype(np.float32)


def rounded(a, dtype):
    """float32 values rounded to dtype (bf16 to nearest even), as float32."""
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dtype).float().numpy()


def emulate_sep(x: np.ndarray, plan, taps: np.ndarray, dtype: torch.dtype) -> np.ndarray:
    """csrc/upfirdn2d.cu's separable kernel (namespace ksep) in numpy, every
    block at once, step by step of its walk: the prologue's copy of each
    block's first tile into slot 0, then for each tile the copy of the next
    one into the other slot (its straddling chunks written after the tile's
    sums), the row pass from the tile's own slot into the intermediate
    (rounded to dtype), the column pass from it into the outputs. The ring
    and the intermediate keep what earlier tiles left (NaN at first), so a
    cell that a tap reads but its tile did not write shows; every load is
    checked to lie inside its slot. Each pass sums its taps as fused multiply-adds in
    tap order; every output is written once. The axes are the plan's (the
    guarded instantiation reads them at run time), the run sizes and the
    row pass's lanes the instantiation's."""
    FY, FX, UY, DY, PY, UX, DX, PX = plan.axes()
    lanes_on_rows = VARIANTS[plan.variant][6] == 2
    planes, H, W = x.shape
    itemsize = plan_itemsize(plan)
    CH, RX, RC, G = 16 // itemsize, k2.run_r(plan.variant), k2.RUN_C, plan.grid
    SEG, SEGY = k2.sep_segments(plan.variant)
    NC = k2.load_chunks(SEG, itemsize)
    ky, kx = taps[:16], taps[16:]
    ring = np.full((G, 2, plan.win_h, plan.pitch), np.nan, np.float32)
    mid = np.full((G, plan.win_h, plan.mid_pitch), np.nan, np.float32)
    out = np.zeros(planes * plan.out_h * plan.out_w, np.float32)
    written = np.zeros(out.shape, np.int64)
    b, j = np.arange(G), np.arange(plan.win_h)

    def tile(t):
        r, tw = t // plan.tiles_w, t % plan.tiles_w
        th, plane = r % plan.tiles_h, r // plan.tiles_h
        return (plane, plan.base_y + th * plan.step_y, plan.base_x + tw * plan.step_x,
                th * plan.tile_h, tw * plan.tile_w)

    def shift(plane, row):
        return (plan.eb + plan.wm * (plane * plan.src_h + row)) % CH

    def issue(t, slot):
        """Copy tiles t [G] (< 0: none) into `slot`, but for the chunks that
        straddle a row's left edge, which it returns (written after the sums)."""
        plane, row0, col0, _, _ = tile(np.maximum(t, 0))
        row = row0[:, None] + j[None]                                 # [G, win_h]
        e = shift(plane[:, None], row)
        col = (col0[:, None] - e)[..., None] + np.arange(plan.cpr * CH)  # [G, win_h, copied]
        data = (row >= 0) & (row < H)
        ok = data[..., None] & (col >= 0) & (col < W)
        vals = np.where(ok, x[np.clip(plane, 0, planes - 1)[:, None, None],
                              np.clip(row, 0, H - 1)[..., None], np.clip(col, 0, W - 1)], 0)
        go = t >= 0
        strad = (go[:, None] & data & (e > 0) & (col0[:, None] <= 0)
                 & (-col0[:, None] < plan.cpr * CH))
        sb, sj = np.nonzero(strad)
        cells = -col0[sb][:, None] + np.arange(CH)                    # [S, CH]
        keep = np.ones(vals.shape, bool)
        keep[sb[:, None], sj[:, None], cells] = False
        cur = ring[go, slot, :, :plan.cpr * CH]
        ring[go, slot, :, :plan.cpr * CH] = np.where(keep[go], vals[go], cur)
        return sb, sj, cells, vals[sb[:, None], sj[:, None], cells], slot

    def flush(st):
        sb, sj, cells, vals, slot = st
        ring[sb[:, None], slot, sj[:, None], cells] = vals

    flush(issue(np.where(b < plan.tiles, b, -1), 0))
    for k in range(-(-plan.tiles // G)):
        t = b + k * G
        slot = k % 2
        nt = t + G
        st = issue(np.where(nt < plan.tiles, nt, -1), 1 - slot)
        live = t < plan.tiles
        plane, row0, _, oy0, ox0 = tile(np.where(live, t, 0))
        # the row pass
        items = plan.win_h * plan.runs_r
        it = np.arange(items)
        if lanes_on_rows:
            cx, jj = it // plan.win_h, it % plan.win_h
        else:
            jj, cx = it // plan.runs_r, it % plan.runs_r
        c = (plan.lead_x + shift(plane[:, None], row0[:, None] + jj[None])
             + cx[None] * (RX * DX // UX))                           # [G, items]
        assert ((c // CH + NC) * CH)[live].max() <= plan.pitch      # loads inside the slot
        v = [ring[b[:, None], slot, jj[None], np.minimum(c + sx, plan.pitch - 1)]
             for sx in range(SEG)]
        sel = np.nonzero(live)[0]
        mid[sel] = np.nan
        for jx in range(RX):
            acc = np.zeros(c.shape, np.float32)
            for sx in range(SEG):
                tx = sx * UX - jx * DX + PX
                if 0 <= tx < min(FX, plan.fw):
                    assert not np.isnan(v[sx][live]).any(), "a tap read a cell not copied"
                    acc = fma(kx[tx], v[sx], acc)
            mid[sel[:, None], jj[None], (cx * RX + jx)[None]] = rounded(acc, dtype)[sel]
        # the column pass
        items = plan.tile_h // RC * plan.runs_c
        it = np.arange(items)
        ry, cx = it // plan.runs_c, it % plan.runs_c
        oy, ox = oy0[:, None] + ry[None] * RC, ox0[:, None] + cx[None] * CH   # [G, items]
        go = live[:, None] & (oy < plan.out_h) & (ox < plan.out_w)
        acc = np.zeros((RC, CH) + go.shape, np.float32)
        for sy in range(SEGY):
            if FY == 16 and sy * UY - (RC - 1) * DY + PY >= plan.fh:
                break
            r = ry * (RC * DY // UY) + sy
            assert r.max() < plan.win_h
            vals = [mid[b[:, None], r[None], cx[None] * CH + i] for i in range(CH)]
            for jy in range(RC):
                ty = sy * UY - jy * DY + PY
                if 0 <= ty < min(FY, plan.fh):
                    for i in range(CH):
                        assert not np.isnan(vals[i][go]).any(), "read an unwritten row"
                        acc[jy, i] = fma(ky[ty], vals[i], acc[jy, i])
        for jy in range(RC):
            for i in range(CH):
                m = go & (oy + jy < plan.out_h) & (ox + i < plan.out_w)
                off = (plane[:, None] * plan.out_h + oy + jy) * plan.out_w + ox + i
                out[off[m]] = rounded(acc[jy, i][m], dtype)
                np.add.at(written, off[m], 1)
        flush(st)
    assert (written == 1).all(), "every output written once"
    return out.reshape(planes, plan.out_h, plan.out_w)


def emulate_2d(x: np.ndarray, plan, taps: np.ndarray, itemsize: int) -> np.ndarray:
    """csrc/upfirdn2d.cu's 2-D kernel (namespace k2d) in numpy, every block
    at once, step by step of its walk: the prologue's copies of tiles 0 and
    1, then for each tile the copy of the tile two ahead into the slot the
    last one freed, the sums from the tile's own slot, and the straddles'
    writes. The ring keeps what earlier tiles left in it (NaN at first), so
    a cell that a tile reads but does not copy shows; every read is checked
    to lie inside its slot. Float32 sums in the kernel's order (rows then
    columns, or the 2-D sum); stores as the kernel's, written once each."""
    FY, FX, UY, DY, PY, UX, DX, PX = VARIANTS[plan.variant]
    RY, RX = k2.run_2d(plan.variant)
    planes, H, W = x.shape
    CH, S, G = plan.chunk, k2.STAGES, plan.grid
    SEGY, SEGX = segs(plan.variant)
    flat = np.concatenate([np.zeros(16), x.reshape(-1).astype(np.float64), np.zeros(16)])
    start = 16                                  # flat index of x's element 0
    ring = np.full((G, S, plan.win_h, plan.pitch), np.nan)
    b = np.arange(G)
    k4 = np.arange(16)

    def issue(t, slot):
        """The copies of tiles t [G] (< 0: none) into `slot` [G]; returns the
        straddles (block, row, element offset, 16-byte values) to write."""
        rt, ct = t // plan.tiles_w, t % plan.tiles_w
        w0 = rt * plan.tile_h * DY // UY
        col0 = plan.base_x + ct * plan.step_x
        j = np.arange(plan.win_h)
        ts = w0[:, None] + j[None]
        tp = ts // plan.sr
        row = ts - tp * plan.sr - plan.q
        e = row_shift(plan, ts, tp)
        row_in = (tp < planes) & (row >= 0) & (row < H) & (t[:, None] >= 0)
        src_row = (tp * H + row) * W
        for c in range(plan.cpr):
            col = col0[:, None] - e + c * CH                  # [G, win_h]
            strad = row_in & (col < 0) & (col + CH > 0)
            go = (t[:, None] >= 0) & ~strad
            cols = col[..., None] + np.arange(CH)             # [G, win_h, CH]
            ok = row_in[..., None] & (col[..., None] >= 0) & (cols < W)
            vals = np.where(ok, flat[np.where(ok, start + src_row[..., None] + cols, 0)], 0.0)
            gb, gj = np.nonzero(go)
            ring[gb, slot[gb], gj, c * CH:(c + 1) * CH] = vals[gb, gj]
        st = (row_in & (e > 0) & (col0[:, None] <= 0) & (-col0[:, None] < plan.pitch)
              & (j[None] < k2.THREADS))
        sb, sj = np.nonzero(st)
        cols = (-e[sb, sj])[:, None] + np.arange(CH)
        ok = (cols >= 0) & (cols < W)
        vals = np.where(ok, flat[np.where(ok, start + src_row[sb, sj][:, None] + cols, 0)], 0.0)
        return sb, slot[sb], sj, -col0[sb], vals

    def flush(st):
        sb, ss, sj, off, vals = st
        for i in range(CH):
            ring[sb, ss, sj, off + i] = vals[:, i]

    out = np.zeros(planes * plan.out_h * plan.out_w)
    written = np.zeros(out.shape, np.int64)
    pairs = []
    steps = -(-plan.tiles // G)
    for s in range(S - 1):
        t = b + s * G
        flush(issue(np.where(t < plan.tiles, t, -1), np.full(G, s)))
    items = plan.tile_h // RY * plan.runs_x
    for kk in range(steps):
        t = b + kk * G
        slot, ns = kk % S, (kk - 1) % S
        nt = t + (S - 1) * G
        st = issue(np.where(nt < plan.tiles, nt, -1), np.full(G, ns))
        live = t < plan.tiles
        rt, ct = t // plan.tiles_w, t % plan.tiles_w
        v0, ox0 = rt * plan.tile_h, ct * plan.tile_w
        w0 = v0 * DY // UY
        tplane = w0 // plan.sr if plan.pm else np.zeros_like(w0)
        it = np.arange(-(-items // k2.THREADS) * k2.THREADS)
        active = live[:, None] & (it < items)[None]
        ry, cx = it // plan.runs_x, it % plan.runs_x
        wr = ry * (RY * DY // UY)
        c0 = plan.lead_x + cx * (RX * DX // UX)
        e0 = row_shift(plan, w0[:, None] + wr[None], tplane[:, None])
        acc = np.zeros((RY, RX) + active.shape, np.float32)
        for sy in range(SEGY):
            r = wr + sy
            assert r[it < items].max() < plan.win_h
            c = c0[None] + (e0 + sy * plan.wm) % CH
            end = c - c % 2 + 2 * (SEGX // 2 + 1) if itemsize == 2 else c + SEGX
            assert end[active].max() <= plan.pitch             # reads inside the slot
            vals = [np.where(active, ring[b[:, None], slot, np.minimum(r, plan.win_h - 1)[None],
                                          np.minimum(c + sx, plan.pitch - 1)], 0.0)
                    .astype(np.float32) for sx in range(SEGX)]
            if plan.mode == k2.ROWS_THEN_COLUMNS:
                fy, fx = taps[16:20], taps[20:24]
                h = []
                for jx in range(RX):
                    hj = np.zeros(active.shape, np.float32)
                    for sx in range(SEGX):
                        tx = sx * UX - jx * DX + PX
                        if 0 <= tx < 4:
                            hj = hj + np.float32(fx[tx]) * vals[sx]
                    h.append(hj)
                for jy in range(RY):
                    ty = sy * UY - jy * DY + PY
                    if 0 <= ty < 4:
                        for jx in range(RX):
                            acc[jy, jx] = acc[jy, jx] + np.float32(fy[ty]) * h[jx]
            else:
                kk2 = taps[:16].reshape(4, 4)
                for jy in range(RY):
                    ty = sy * UY - jy * DY + PY
                    if not (0 <= ty < 4 and (plan.mode == k2.FULL or ty < plan.fh)):
                        continue
                    for jx in range(RX):
                        for sx in range(SEGX):
                            tx = sx * UX - jx * DX + PX
                            if 0 <= tx < 4 and (plan.mode == k2.FULL or tx < plan.fw):
                                acc[jy, jx] = acc[jy, jx] + np.float32(kk2[ty, tx]) * vals[sx]
        assert not np.isnan(acc[:, :, active]).any(), "a run read a cell its tile did not copy"
        # stores
        vrow = v0[:, None] + ry[None] * RY
        ox = ox0[:, None] + cx[None] * RX
        lane = it % 32
        go = active & (ox < plan.out_w)
        nv = np.minimum(RX, plan.out_w - ox)
        left = (lane > 0) & (cx > 0)
        right = (lane < 31) & (cx + 1 < plan.runs_x) & (ox + RX < plan.out_w)
        odd_w = plan.out_w % 2 == 1
        for jy in range(RY):
            vv = vrow + jy
            p_, oy = vv // plan.vh, vv % plan.vh
            m = go & (p_ < planes) & (oy < plan.out_h)
            r = p_ * plan.out_h + oy
            o = np.where(m, r * plan.out_w + ox, 0)
            a = acc[jy]
            nxt = np.roll(a[0], -1, axis=1)                    # the next lane's column 0

            def put(mask, off, val):
                out[off[mask]] = val[mask]
                np.add.at(written, off[mask], 1)

            ev = m & (r % 2 == 0) if odd_w else m       # rows that start on an even offset
            for i in range(0, RX, 2):
                put(ev & (nv >= i + 2), o + i, a[i])
                put(ev & (nv >= i + 2), o + i + 1, a[i + 1])
                put(ev & (nv == i + 1), o + i, a[i])
                pairs.append(o[ev & (nv >= i + 2)] + i)
            if odd_w:                                  # (-1, 0) the left lane's, (1, 2), ...
                od = m & (r % 2 == 1)
                put(od & ~left, o, a[0])
                for i in range(1, RX - 1, 2):
                    put(od & (nv >= i + 2), o + i, a[i])
                    put(od & (nv >= i + 2), o + i + 1, a[i + 1])
                    put(od & (nv == i + 1), o + i, a[i])
                    pairs.append(o[od & (nv >= i + 2)] + i)
                put(od & right, o + RX - 1, a[RX - 1])  # with the right lane's column 0
                put(od & right, o + RX, nxt)
                put(od & ~right & (nv == RX), o + RX - 1, a[RX - 1])
                pairs.append(o[od & right] + RX - 1)
        flush(st)
    assert (written == 1).all(), "every output written once"
    assert all((q % 2 == 0).all() for q in pairs), "every pair on an even offset"
    return out.reshape(planes, plan.out_h, plan.out_w).astype(np.float32)


def emulate_call(x: torch.Tensor, args, aligned=True) -> torch.Tensor:
    """upfirdn2d_k2(x, *args) through the emulated kernel of its one launch."""
    N, C, H, W = x.shape
    ptr = 0 if aligned else misaligned(x.element_size())
    variant, plan, taps = k2.call_launch(passes(*args), x.shape, x.dtype, ptr)
    xs = x.float().reshape(N * C, H, W).numpy()
    if variant < k2.N_2D:
        y = emulate_2d(xs, plan, taps, x.element_size())
    else:
        y = emulate_sep(xs, plan, taps, x.dtype)
    return torch.from_numpy(y).reshape(N, C, plan.out_h, plan.out_w).to(x.dtype)


def assert_emulation_matches_plain(x, args, aligned):
    """A separable call's emulation equals the plain version to the bit; a
    2-D pass's within KERNEL_TOL of its scale."""
    want = upfirdn2d_k2_plain(x, *args)
    got = emulate_call(x, args, aligned)
    assert got.shape == want.shape and got.dtype == want.dtype
    if k2.call_launch(passes(*args), x.shape, x.dtype, 0)[0] >= k2.N_2D:
        assert torch.equal(got, want), (aligned, float((got.float() - want.float()).abs().max()))
        return
    tol = 1e-5 if x.dtype == torch.float32 else 1e-2
    scale = max(float(want.float().abs().max()), 1e-6)
    err = float((got.float() - want.float()).abs().max())
    assert err <= tol * scale, (aligned, err, scale)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("which", ["fwd", "adj"])
@pytest.mark.parametrize("case", list(CASES))
def test_kernel_emulation_matches_plain(case, which, dtype):
    """Every main-path call and its adjoint through the emulated kernels,
    from an aligned and a misaligned input: the separable calls to the bit;
    the 2-D passes float32 to 1e-5 of scale (another summation order), bf16
    to 1e-2 (both round once from a float32 sum of the same bf16 taps)."""
    shape, f, kw = CASES[case]
    xs, *args = forward_and_adjoint(shape, f, kw)[which == "adj"]
    x = torch.from_numpy(np.random.RandomState(5).randn(*xs).astype(np.float32)).to(dtype)
    for aligned in (True, False):
        assert_emulation_matches_plain(x, args, aligned)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("which", ["fwd", "adj"])
@pytest.mark.parametrize("filt", ["asym", "rank2", "asym_outer"])
def test_kernel_emulation_2d_sum_matches_plain(filt, which, dtype):
    """D's pre-filter and its adjoint with an asymmetric 4x4 filter (the 2-D
    sum, or rows then columns for an asymmetric outer product), aligned and
    not, odd and even rows, and a plane count that the grid does not divide
    (the walk's last step is partial)."""
    f = torch.from_numpy(np.ascontiguousarray(RANK1_FILTERS[filt][0]))
    kw = dict(padding=2)
    for shape in ((3, 5, 10, 9), (1, 7, 33, 20)):
        xs, *args = forward_and_adjoint(shape, f, kw)[which == "adj"]
        assert args[0].ndim == 2
        x = torch.from_numpy(np.random.RandomState(8).randn(*xs).astype(np.float32)).to(dtype)
        for aligned in (True, False):
            assert_emulation_matches_plain(x, args, aligned)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 2, 3, 300), (3, 5, 6, 6), (2, 3, 9, 64)])
def test_kernel_emulation_stores_odd_rows_in_pairs(shape, dtype):
    """D's pre-filter gives rows of odd length (r + 1): the emulated stores
    pair across runs (a row of 75 runs that wraps from one warp to the next
    and across lanes at [1, 2, 3, 300]; small planes stacked in a tile at
    [3, 5, 6, 6]) and equal the plain version, as
    test_kernel_emulation_matches_plain's tolerances."""
    args = call_args(FIR4, CASES["d_downconv"][2])
    x = torch.from_numpy(np.random.RandomState(7).randn(*shape).astype(np.float32)).to(dtype)
    p, = passes(*args)
    _, plan, _ = k2.pass_launch(p, x.shape, x.dtype, 0)
    assert plan.out_w % 2 == 1 and plan.mode != k2.GUARDED
    got, want = emulate_call(x, args), upfirdn2d_k2_plain(x, *args)
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    scale = float(want.float().abs().max())
    assert float((got.float() - want.float()).abs().max()) <= tol * scale


SEP_EMULATED = dict(
    {f"{name}_{label}": (shape, *CASES[name][1:])
     for name in ("aug_up", "aug_down")
     for label, shape in (("28", (2, 9, 28, 28)), ("odd", (2, 9, 27, 29)))},
    **SEP_ODD)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("which", ["fwd", "adj"])
@pytest.mark.parametrize("case", list(SEP_EMULATED))
def test_separable_emulation_equals_plain_to_the_bit(case, which, dtype):
    """The separable kernel, emulated (emulate_sep: its intermediate rounded
    to the dtype, each pass's taps summed by fused multiply-adds in tap
    order), equals the plain version's two convolutions to the bit: the
    pipe's calls and adjoints at [2, 9, 28^2] and at odd widths, a lone row
    and a lone column filter, mixed axes, phase 1 at up 2 and a 10-tap filter
    (the guarded instantiation, its axes at run time), aligned and not."""
    shape, f, kw = SEP_EMULATED[case]
    xs, *args = forward_and_adjoint(shape, f, kw)[which == "adj"]
    assert k2.call_launch(passes(*args), xs, dtype, 0)[0] >= k2.N_2D
    x = torch.from_numpy(np.random.RandomState(9).randn(*xs).astype(np.float32)).to(dtype)
    for aligned in (True, False):
        assert_emulation_matches_plain(x, args, aligned)


def test_k2_plan_sep_shapes_at_the_pipe():
    """The pipe's 12-tap 2x up at 16 x 3 in bf16, [144, 268^2] -> 536^2: two
    tiles of 272 columns across, 9 of 60 rows down, each a window of 36 rows
    of 20 chunks (21 apart), 3 blocks an SM on 132 SMs; its 2x down [144,
    524^2] -> 256^2 (down 2 on x: 2 blocks an SM) two tiles of 128 across,
    8 of 32 down, 74 window rows; each within its block's share of an SM's
    shared memory."""
    f = setup_filter(_SYM6)
    up = passes(f, (2, 2), (1, 1), (6, 5, 6, 5), False, 4.0)
    _, plan, _ = k2.call_launch(up, (16, 9, 268, 268), torch.bfloat16, 0)
    assert (plan.out_h, plan.out_w, plan.tile_h, plan.tile_w, plan.tiles_h, plan.tiles_w) == (
        536, 536, 60, 272, 9, 2)
    assert (plan.win_h, plan.cpr, plan.pitch, plan.grid, plan.wm) == (36, 20, 168, 396, 4)
    down = passes(f, (1, 1), (2, 2), (-1, -1, -1, -1), True, 1.0)
    _, plan2, _ = k2.call_launch(down, (16, 9, 524, 524), torch.bfloat16, 0)
    assert (plan2.out_h, plan2.out_w, plan2.tile_h, plan2.tile_w, plan2.tiles_h,
            plan2.tiles_w) == (256, 256, 32, 128, 8, 2)
    assert (plan2.win_h, plan2.grid) == (74, 264)
    assert plan.smem_bytes <= k2.SM_SHARED_BYTES // 3 - 1024
    assert plan2.smem_bytes <= k2.SM_SHARED_BYTES // 2 - 1024


# ------------------------------------------------------------------- routing

def ffs256_cpu_models():
    """FFS-256's G and D (channel_base 16384, bf16 at 32^2-256^2) at a narrow
    width, on the CPU: the same blocks, resolutions and dtypes."""
    from stylegan_v_tpu_torch.models import (Discriminator, DiscriminatorConfig, Generator,
                                             GeneratorConfig)
    from stylegan_v_tpu_torch.models.config import replace
    gen = torch.Generator().manual_seed(0)
    G = Generator(replace(GeneratorConfig(), channel_base=256, channel_max=8), generator=gen)
    D = Discriminator(replace(DiscriminatorConfig(), channel_base=256, channel_max=8),
                      generator=gen)
    return G.eval(), D.eval()


class Recorder:
    """Records every upfirdn2d call (at its entry, with the kernel that
    upfirdn2d's own dispatch entered: K1's `_DownFirX2` or K2's wrapper,
    else None) and every K2 call (at upfirdn2d_k2, forward and backward,
    with k2_refusal's verdict; one launch each on a CUDA tensor), on the
    CPU."""

    def __init__(self, mp):
        self.calls, self.passes, self.k1 = [], [], []
        cr = importlib.import_module("stylegan_v_tpu_torch.ops.conv2d_resample")
        orig_call, orig_k2, orig_k1 = tup.upfirdn2d, tup.upfirdn2d_k2, tup._DownFirX2

        def call(x, f, up=1, down=1, padding=0, flip_filter=False, gain=1.0):
            n_k1, n_k2 = len(self.k1), len(self.passes)
            y = orig_call(x, f, up, down, padding, flip_filter, gain)
            route = ("K1" if len(self.k1) > n_k1 else "K2" if len(self.passes) > n_k2
                     else None)
            self.calls.append((tuple(x.shape), x.dtype, route))
            return y

        class K1:
            @staticmethod
            def apply(*args):
                self.k1.append(args[0].shape)
                return orig_k1.apply(*args)

        def k2_pass(x, f, up, down, padding, flip_filter=False, gain=1.0):
            self.passes.append((tuple(x.shape), x.dtype, k2_refusal(
                tuple(x.shape), x.dtype, x.is_contiguous(), f, up, down, padding,
                flip_filter, gain), 1))
            return orig_k2(x, f, up, down, padding, flip_filter, gain)

        mp.setattr(tup, "upfirdn2d", call)
        mp.setattr(cr, "upfirdn2d", call)
        mp.setattr(tup, "upfirdn2d_k2", k2_pass)
        mp.setattr(tup, "_DownFirX2", K1)

    def reset(self):
        self.calls.clear()
        self.passes.clear()
        self.k1.clear()

    def check(self):
        assert all(route in ("K1", "K2") for *_, route in self.calls), self.calls
        assert all(why is None for _, _, why, _ in self.passes), self.passes
        return sum(n for *_, n in self.passes)


def test_main_path_calls_take_k1_or_k2(monkeypatch):
    """G (12 K2 launches a forward at 256^2: 6 up-convs, 6 image skips), D
    (6 K2 pre-filters and 6 K1 skips a forward) and the bgc pipe (2 K2
    launches: its 12-tap 2x up and 2x down, each both passes in one),
    forward and backward, and R1's second order through D."""
    from stylegan_v_tpu_torch.training import AUGPIPE_SPECS, AugmentConfig, make_augment_pipe
    torch.manual_seed(0)
    rec = Recorder(monkeypatch)
    G, D = ffs256_cpu_models()
    g = torch.Generator().manual_seed(1)
    z = torch.randn(4, G.cfg.z_dim, generator=g)
    t = torch.tensor([[0.0, 5.0, 17.0]] * 4)
    frames = G(z, None, t, generator=g)
    assert rec.check() == 12 and {r for *_, r in rec.calls} == {"K2"}
    dtypes = {dt for _, dt, _ in rec.calls}
    assert dtypes == {torch.float32, torch.bfloat16}
    rec.reset()
    frames.square().mean().backward()
    assert rec.check() == 12 and not rec.calls            # the adjoints are K2 passes
    rec.reset()
    img = frames.detach().requires_grad_(True)
    logits = D(img, None, t)["image_logits"]
    assert rec.check() == 6
    assert sorted(r for *_, r in rec.calls) == ["K1"] * 6 + ["K2"] * 6
    rec.reset()
    grad, = torch.autograd.grad(logits.sum(), img, create_graph=True)
    assert rec.check() == 6
    rec.reset()
    grad.square().sum().backward()                          # R1's second order
    assert rec.check() == 12
    rec.reset()
    pipe = make_augment_pipe(AugmentConfig(**AUGPIPE_SPECS["bgc"], warp_upsample=2))
    x = frames.detach().reshape(4, 9, 256, 256).requires_grad_(True)
    y = pipe(g, x, 0.5)
    assert rec.check() == 2 and {r for *_, r in rec.calls} == {"K2"}
    rec.reset()
    y.square().mean().backward()
    assert rec.check() == 2


# ------------------------------------------------------------------ the wrapper

def test_a_call_on_a_cuda_tensor_is_one_launch(monkeypatch):
    """On a CUDA tensor (a CPU tensor stands in, the C entry point is
    recorded) every call is one launch: the pipe's separable 2x up and 2x
    down take the 12-tap instantiations with both passes' taps, a lone row
    filter the guarded one, G's up-conv the 2-D pass."""
    seen = []
    monkeypatch.setattr(k2, "on_cuda", lambda x, name: True)
    monkeypatch.setattr(k2, "entry_point", lambda *a: None)
    monkeypatch.setattr(k2, "_sm_count", lambda device: 132)
    monkeypatch.setattr(k2, "launch", lambda name, fn, args, device: seen.append(args))
    for name, held in (("aug_up", 12), ("aug_down", 12), ("g_upconv", 4)):
        shape, f, kw = CASES[name]
        x = torch.zeros(shape)
        before = upfirdn2d_k2.launches
        y = upfirdn2d_k2(x, *call_args(f, kw))
        assert upfirdn2d_k2.launches - before == 1 and len(seen) == 1
        _, y_ptr, taps, dtype, variant, plan = seen.pop()
        assert VARIANTS[variant][:2] == (held, held) and plan[0] == variant
        assert tuple(y.shape) == tuple(upfirdn2d_k2_plain(x, *call_args(f, kw)).shape)
        if held == 12:
            want = setup_filter(f) * 2 ** (kw.get("gain", 1) == 4)
            assert np.allclose(np.asarray(taps[:12]), want.flip(0) if name == "aug_up" else want)
    x = torch.zeros(2, 3, 9, 13)
    upfirdn2d_k2(x, torch.ones(1, 7), (2, 1), (1, 1), (3, 2, 1, -1), False, 1.0)
    _, _, taps, _, variant, plan = seen.pop()
    assert VARIANTS[variant] == k2.GUARDED_SEP and taps[0] == 1.0
    assert k2.K2PlanSep(*plan).axes()[2:] == (1, 1, 0, 2, 1, 1)          # phase 3 % 2


def test_wrapper_on_cpu_is_the_plain_version_and_launches_nothing():
    before = upfirdn2d_k2.launches
    for shape, f, kw in CASES.values():
        x = torch.from_numpy(np.random.RandomState(6).randn(*shape).astype(np.float32))
        args = call_args(f, kw)
        got = upfirdn2d_k2(x, *args)
        torch.testing.assert_close(got, upfirdn2d_k2_plain(x, *args), rtol=0, atol=0)
        torch.testing.assert_close(got, tup.upfirdn2d(x, setup_filter(f), **kw),
                                   rtol=0, atol=0)
    assert upfirdn2d_k2.launches == before


@pytest.mark.parametrize("x,f,kw,match", [
    (torch.zeros(1, 2, 8, 8, dtype=torch.float16), FIR4, dict(up=2), "bfloat16"),
    (torch.zeros(1, 2, 8, 8).transpose(2, 3), FIR4, dict(up=2), "contiguous"),
    (torch.zeros(2, 8, 8), FIR4, dict(up=2), "NCHW"),
    (torch.zeros(1, 2, 8, 8), np.ones((5, 5)), dict(), "at most 4x4"),
    (torch.zeros(1, 2, 8, 8), np.ones(17), dict(), "16 taps"),
    (torch.zeros(1, 2, 8, 8), FIR4, dict(up=3), "up and down 1 or 2"),
    (torch.zeros(1, 2, 8, 8), FIR4, dict(down=4), "up and down 1 or 2"),
    (torch.zeros(1, 2, 8, 8), FIR4, dict(up=2, down=2), "not both 2"),
    (torch.zeros(1, 2, 8, 8), FIR4, dict(up=(2, 1)), "same up and down"),
    (torch.zeros(1, 2, 8, 8), FIR4, dict(up=2, padding=(1, 1, 2, 2)), "pad parity"),
    (torch.zeros(1, 2, 3, 3), FIR4, dict(padding=-2), "empty"),
])
def test_refusal_names_what_the_kernel_does_not_take(x, f, kw, match):
    args = call_args(f, kw) if np.asarray(f).ndim == 1 and len(f) == 4 else (
        torch.as_tensor(np.asarray(f, np.float32)), *call_args(FIR4, kw)[1:])
    why = k2_refusal(tuple(x.shape), x.dtype, x.is_contiguous(), *args)
    assert why is not None and re.search(match, why), why
    assert k2_refusal((1, 2, 8, 8), torch.bfloat16, True, *call_args(FIR4, dict(up=2))) is None


def test_variants_are_the_sources():
    """VARIANTS is the source's K2_VARIANTS_2D then K2_VARIANTS_SEP, each
    plan's fields are its enum's, and the constants and run sizes the plans
    assume are the kernels'."""
    src = (Path(k2.__file__).parents[1] / "csrc" / "upfirdn2d.cu").read_text()
    body = src[src.index("#define K2_VARIANTS_2D(X)"):src.index("namespace {")]
    two_d = body[:body.index("#define K2_VARIANTS_SEP(X)")]
    found = [tuple(int(v) for v in m.split(","))
             for m in re.findall(r"X\(([\d,\s]+)\)", body)]
    assert tuple(found) == VARIANTS
    assert len(re.findall(r"X\(", two_d)) == k2.N_2D
    for enum, end, plan in (("enum Plan2DField", "kNumPlan2DFields", k2.K2Plan2D),
                            ("enum PlanSepField", "kNumPlanSepFields", k2.K2PlanSep)):
        fields = src[src.index(enum):src.index(end)]
        names = re.findall(r"k(\w+)", fields)
        assert [n.lower() for n in names] == [f.replace("_", "") for f in plan._fields]
    pattern = r"constexpr int (THREADS|STAGES|MIN_BLOCKS|RUN_C|GUARDED_TAPS) = (\d+);"
    k2d = src[src.index("namespace k2d {"):src.index("namespace ksep {")]
    ksep = src[src.index("namespace ksep {"):]
    assert {k: int(v) for k, v in re.findall(pattern, k2d)} == dict(
        THREADS=k2.THREADS, STAGES=k2.STAGES, MIN_BLOCKS=k2.MIN_BLOCKS)
    assert {k: int(v) for k, v in re.findall(pattern, ksep)} == dict(
        THREADS=k2.THREADS, RUN_C=k2.RUN_C, GUARDED_TAPS=k2.GUARDED_TAPS)
    up_or_1, other = map(int, re.search(r"constexpr int BLOCKS = DX == 1 \? (\d) : (\d);",
                                        ksep).groups())
    runs = {k: (int(a), int(b)) for k, a, b in
            re.findall(r"constexpr int (RUN_[XY]) = D == 2 \? (\d) : (\d);", src)}
    for variant in range(k2.N_2D):
        DY, DX = VARIANTS[variant][3], VARIANTS[variant][6]
        assert k2.run_2d(variant) == (runs["RUN_Y"][DY == 1], runs["RUN_X"][DX == 1])
    up2, other_r = map(int, re.search(r"constexpr int RUN_R = UX == 2 \? (\d+) : (\d+);",
                                      src).groups())
    for variant in range(k2.N_2D, len(VARIANTS)):
        assert k2.run_r(variant) == (up2 if VARIANTS[variant][5] == 2 else other_r)
        assert k2.sep_blocks(variant) == (up_or_1 if VARIANTS[variant][6] == 1 else other)
    assert VARIANTS[-1] == k2.GUARDED_SEP and VARIANTS.count(k2.GUARDED_SEP) == 1
    # the samples and rows a run reads (ksep::SEGMENT), at compile-time axes and at run time
    seg = re.search(r"constexpr int SEGMENT = U \? \(\(R - 1\) \* D \+ F - 1 - P\) / U \+ 1 : "
                    r"\(R - 1\) \* (\d) \+ F;", ksep)
    assert seg is not None
    for variant in range(k2.N_2D, len(VARIANTS)):
        FY, FX, UY, DY, PY, UX, DX, PX = VARIANTS[variant]
        most = int(seg.group(1))
        want = [((R - 1) * D + F - 1 - P) // U + 1 if U else (R - 1) * most + F
                for F, R, U, D, P in ((FX, k2.run_r(variant), UX, DX, PX),
                                      (FY, k2.RUN_C, UY, DY, PY))]
        assert k2.sep_segments(variant) == tuple(want)
        if not UX:                         # the most any axis the guarded one takes reads
            assert want == [max(((R - 1) * d + F - 1 - p) // u + 1 for u, d, p in k2.AXES)
                            for F, R in ((FX, k2.run_r(variant)), (FY, k2.RUN_C))]
    # the chunks a row-pass run loads (ksep::LOAD_CHUNKS)
    expr = re.search(r"constexpr int LOAD_CHUNKS = (sizeof\(T\) == 2 \? [^;]+);", src).group(1)
    for itemsize in (2, 4):
        py = expr.replace("sizeof(T) == 2 ?", f"{itemsize == 2} and").replace(" : ", " or ")
        for seg in range(1, 40):
            assert eval(py.replace("SEG", str(seg)).replace("/", "//")) == \
                k2.load_chunks(seg, itemsize)



@pytest.mark.parametrize("name", sorted(n for d, n in
                                        importlib.import_module(
                                            "stylegan_v_tpu_torch.tools.k2_variants").VARIANTS
                                        if d == "new"))
def test_k2_variants_edits_apply_to_the_source(name):
    """Every variant tools/k2_variants.py builds of this design edits the
    kernel's source where the edit's text stands, once, and the calls it
    times take K2 in one launch each."""
    kv = importlib.import_module("stylegan_v_tpu_torch.tools.k2_variants")
    src = kv.SOURCE.read_text()
    edits, mode, kinds = kv.VARIANTS[("new", name)]
    assert all(src.count(old) == 1 for old, _ in edits)
    for which in kinds:
        for _, shape, args in kv.calls(which):
            ps = passes(*args)
            assert k2_refusal(shape, torch.bfloat16, True, *args) is None
            assert k2.call_launch(ps, shape, torch.bfloat16, 0)[0] == (
                k2.pass_variant(ps[0]) if which == "2d" else k2.sep_variant(*k2.sep_passes(ps)))
    assert len(list(kv.main_path_calls())) == 36


# ------------------------------------------------------------ the export route

def test_export_traces_the_aten_route_and_equals_the_direct_forward(monkeypatch):
    from stylegan_v_tpu_torch import export_model as texport
    from stylegan_v_tpu_torch.models import Generator
    from test_torch_models import port_cfg, small_gen_cfg
    entered = []
    orig = tup.upfirdn2d_k2
    monkeypatch.setattr(tup, "upfirdn2d_k2", lambda *a, **k: entered.append(1) or orig(*a, **k))
    G = Generator(port_cfg(small_gen_cfg()), generator=torch.Generator().manual_seed(3)).eval()
    exported, served = texport.build_export(G, 2, 3, 1.0)
    assert not entered and not k2.aten_route_active()
    texport.check_portable(exported)
    targets = {str(n.target) for n in exported.graph.nodes if n.op == "call_function"}
    assert any("convolution" in t for t in targets)
    inputs = texport.selftest_inputs(G.cfg, 2, 3, "cpu")
    with torch.no_grad():
        got = exported.module()(*inputs)
        want = served(*inputs)
    assert entered                                    # the direct forward runs K2's wrapper
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert texport.FIR_ROUTE == "aten"
