"""K2, the port's hand-written upfirdn2d kernel (csrc/upfirdn2d.cu), on the CPU.

  * Its plain version (`upfirdn2d_k2_plain`, what `upfirdn2d` runs on a CPU
    tensor) against stylegan_v_tpu/ops/upfirdn2d.py:upfirdn2d at the exact
    parameters of every main-path call: G's up=2 conv and image skip, D's
    pre-filter of its 3x3 down=2 conv, the augment's 12-tap 2x up and 2x
    down (a crop). Value, vjp and second order (tests/test_torch_grads.py's
    check_op): float32, values and first order to 1e-4 of scale, second
    order to 1e-3.
  * The launch plan (`k2_plan`) of every pass of those calls and of their
    adjoints, at the FFS-256 step's shapes (16 videos x 3 frames), bf16 and
    float32, aligned or not: every output exactly once, every tap of every
    output read from the window cell that holds its source sample, and
    every read inside the window and the thread's registers.
  * An emulation of the kernel in numpy (the window copy and each thread's
    polyphase loops, as csrc/upfirdn2d.cu indexes them) against the plain
    version at small shapes, including the adjoints: float32 to 1e-5 of
    scale (another summation order); bf16 to 1e-2 (both round once from a
    float32 sum of the same bf16 taps).
  * Routing: every upfirdn2d call and every K2 pass that a reduced-width
    FFS-256 G, D and bgc pipe make in a forward and a backward, recorded by
    hooks, takes K1 or K2 on a CUDA tensor; the counts a G and a D forward
    make (chip_smoke.py's launch counts build on them).
  * The wrapper on a CPU tensor is the plain version and launches nothing;
    what the kernel does not take is refused; VARIANTS equals the source's
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
from stylegan_v_tpu_torch.ops.upfirdn2d_kernel import (VARIANTS, k2_plan, k2_refusal, passes,
                                                       pass_out_hw, pass_variant, upfirdn2d_k2,
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
    small = [(f"{name}_small", shape, size, f, kw) for name, (shape, f, kw) in CASES.items()
             for size in (2, 4)]
    for label, shape, size, f, kw in list(ffs256_calls()) + small:
        for which, (xs, *args) in zip(("fwd", "adj"), forward_and_adjoint(shape, f, kw)):
            H, W = xs[2:]
            for i, p in enumerate(passes(*args)):
                for aligned in (True, False):
                    yield pytest.param(p, (xs[0] * xs[1], H, W), size, aligned,
                                       id=f"{label}-{which}-pass{i}-{size}B-al{int(aligned)}")
                H, W = pass_out_hw(p, H, W)


def misaligned(itemsize):
    """A data pointer's offset past 16 bytes for an input that does not start on 16."""
    return 6 if itemsize == 2 else 4


def axis_taps(plan, axis):
    """For every output o along `axis` and every tap t < f (the filter's
    size on it): the window index of its source sample and whether it is
    one (the kernel's indexing: csrc/upfirdn2d.cu), the expected source
    coordinate, and the thread-relative register index."""
    FY, FX, UY, DY, RY, UX, DX, RX = VARIANTS[plan.variant]
    if axis == "y":
        n, F, U, D, R, f = plan.out_h, FY, UY, DY, RY, plan.fh
        tile, run, step, base, lead, pad0 = plan.tile_h, k2.RUN_Y, plan.step_y, plan.base_y, 0, None
    else:
        n, F, U, D, R, f = plan.out_w, FX, UX, DX, RX, plan.fw
        tile, run, step, base, lead = plan.tile_w, k2.RUN_X, plan.step_x, plan.base_x, plan.lead_x
    o = np.arange(n)[:, None]
    t = np.arange(f)[None, :]
    th, ol = o // tile, o % tile
    c, j = ol // run, ol % run
    num = j * D + t - R
    valid = num % U == 0
    rel = num // U                                     # register index within the thread's run
    win = lead + c * (run * D // U) + rel
    source = base + th * step + win
    return win, rel, valid, source, (n, F, U, D, R)


def check_plan_1d(plan, p, planes, H, W, itemsize, aligned):
    """A 1-D pass's plan (k2_plan): every output once, every tap from the
    window cell that holds its source sample, reads inside the window."""
    variant = plan.variant
    assert len(plan) == len(k2.K2Plan._fields)
    assert 1 <= plan.threads == plan.planes_per_tile * plan.nx * plan.ny <= k2.THREADS
    assert plan.tile_h == plan.ny * k2.RUN_Y and plan.tile_w == plan.nx * k2.RUN_X
    assert plan.tiles == -(-planes // plan.planes_per_tile) * plan.tiles_h * plan.tiles_w
    assert plan.tiles < 2 ** 31
    # every output exactly once, axis by axis
    for length, tile, run, runs, tiles in (
            (planes, plan.planes_per_tile, 1, plan.planes_per_tile,
             -(-planes // plan.planes_per_tile)),
            (plan.out_h, plan.tile_h, k2.RUN_Y, plan.ny, plan.tiles_h),
            (plan.out_w, plan.tile_w, k2.RUN_X, plan.nx, plan.tiles_w)):
        idx = (np.arange(tiles)[:, None, None] * tile + np.arange(runs)[None, :, None] * run
               + np.arange(run)[None, None, :]).ravel()
        assert np.array_equal(np.bincount(idx[idx < length], minlength=length),
                              np.ones(length, np.int64))
    # each tap's window cell holds its source sample; reads stay in the window
    FY, FX, UY, DY, RY, UX, DX, RX = VARIANTS[variant]
    for axis, win_len, src_len, u, d, pad0, seg in (
            ("y", plan.win_h, H, UY, DY, p.pad[2], ((k2.RUN_Y - 1) * DY + FY - 1 - RY) // UY + 1),
            ("x", plan.win_w, W, UX, DX, p.pad[0], ((k2.RUN_X - 1) * DX + FX - 1 - RX) // UX + 1)):
        win, rel, valid, source, _ = axis_taps(plan, axis)
        o = np.arange(win.shape[0])[:, None]
        q = o * d - pad0 + np.arange(win.shape[1])[None, :]    # the upsampled coordinate
        assert np.array_equal(valid, q % u == 0)
        assert np.array_equal(source[valid], (q // u)[valid])
        assert win[valid].min() >= 0 and win[valid].max() < win_len
        assert rel[valid].min() >= 0 and rel[valid].max() < seg
        # the thread's whole register run lies in the window too
        lead = plan.lead_x if axis == "x" else 0
        run, step = (k2.RUN_X, plan.step_x) if axis == "x" else (k2.RUN_Y, plan.step_y)
        n_runs = plan.nx if axis == "x" else plan.ny
        last = lead + (n_runs - 1) * (run * d // u) + seg - 1
        assert last < win_len
        tile = plan.tile_w if axis == "x" else plan.tile_h
        assert step * u == tile * d
    # window copies: chunks wholly inside or outside the plane, on 16 bytes
    assert plan.win_w % plan.chunk == 0 and plan.cpr == plan.win_w // plan.chunk
    assert plan.base_x % plan.chunk == 0 and plan.step_x % plan.chunk == 0
    assert 0 <= plan.lead_x < plan.chunk
    if plan.chunk > 1:
        assert aligned and W % plan.chunk == 0 and plan.chunk_bytes in (4, 8, 16)
    assert plan.chunk_bytes == plan.chunk * itemsize
    assert plan.stage_bytes >= plan.planes_per_tile * plan.win_h * plan.win_w * itemsize
    assert plan.stage_bytes <= k2.MAX_STAGE_BYTES and plan.stage_bytes % 16 == 0


def fdiv(n, md):
    """csrc/upfirdn2d.cu's FastDiv: (n m) >> s."""
    m, sh = md
    return (np.asarray(n, np.uint64) * np.uint64(m)) >> np.uint64(sh)


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
    taken = np.zeros((plan.win_h, plan.cpr), np.int64)
    for tid in range(k2.THREADS):
        if plan.cpr <= k2.THREADS:
            j0 = int(fdiv(tid, (plan.cpr_m, plan.cpr_s)))
            c0, dj, dc = tid - j0 * plan.cpr, k2.THREADS // plan.cpr, plan.cpr
            j0 = plan.win_h if j0 >= dj else j0
        else:
            j0, dj, c0, dc = 0, 1, tid, k2.THREADS
        taken[j0::dj, c0::dc] += 1
    assert (taken == 1).all()
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
    assert variant is not None
    fh, fw = p.k.shape
    if variant < k2.N_2D:
        ptr = 0 if aligned else misaligned(itemsize)
        dtype = torch.bfloat16 if itemsize == 2 else torch.float32
        mode, _ = k2.pass_mode(p.k.to(dtype).float().numpy(), fh, fw, dtype)
        plan = k2.k2_plan_2d(variant, planes, H, W, fh, fw, p.pad, itemsize, ptr, mode)
        # the main path's [1, 3, 3, 1]: rows then columns on bf16, the 2-D sum on float32
        assert plan.mode == (k2.ROWS_THEN_COLUMNS if itemsize == 2 else k2.FULL)
        assert (plan.out_h, plan.out_w) == pass_out_hw(p, H, W)
        check_plan_2d(plan, p, planes, H, W, itemsize, ptr)
    else:
        plan = k2_plan(variant, planes, H, W, fh, fw, p.pad, itemsize, aligned)
        assert (plan.out_h, plan.out_w) == pass_out_hw(p, H, W)
        check_plan_1d(plan, p, planes, H, W, itemsize, aligned)


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
        fy, fx = taps[16:20], taps[20:]
        if plan.mode == k2.ROWS_THEN_COLUMNS:
            assert np.array_equal(fy[:, None] * fx[None, :], held)
        else:
            assert not fy.any() and not fx.any()


# ------------------------------------------------- an emulation of the kernel

def emulate_1d(x: np.ndarray, plan, taps: np.ndarray) -> np.ndarray:
    """csrc/upfirdn2d.cu's 1-D kernel (namespace k1d) in numpy over every
    block and thread at once: the window copy, then each thread's loops over
    window rows, run rows, run columns and register columns, in float32."""
    FY, FX, UY, DY, RY, UX, DX, RX = VARIANTS[plan.variant]
    planes, H, W = x.shape
    t = np.arange(plan.tiles)
    tw, rest = t % plan.tiles_w, t // plan.tiles_w
    th, tp = rest % plan.tiles_h, rest // plan.tiles_h
    plane0 = tp * plan.planes_per_tile
    row0, col0 = th * plan.step_y + plan.base_y, tw * plan.step_x + plan.base_x
    P = plan.planes_per_tile
    pl = plane0[:, None, None, None] + np.arange(P)[None, :, None, None]
    iy = row0[:, None, None, None] + np.arange(plan.win_h)[None, None, :, None]
    ix = col0[:, None, None, None] + np.arange(plan.win_w)[None, None, None, :]
    inside = (pl < planes) & (iy >= 0) & (iy < H) & (ix >= 0) & (ix < W)
    window = np.where(inside, x[np.clip(pl, 0, planes - 1), np.clip(iy, 0, H - 1),
                                np.clip(ix, 0, W - 1)], np.float32(0))
    k = np.arange(plan.threads)
    cx, cy, cp = k % plan.nx, k // plan.nx % plan.ny, k // (plan.nx * plan.ny)
    SEGY = ((k2.RUN_Y - 1) * DY + FY - 1 - RY) // UY + 1
    SEGX = ((k2.RUN_X - 1) * DX + FX - 1 - RX) // UX + 1
    acc = np.zeros((k2.RUN_Y, k2.RUN_X, plan.tiles, plan.threads), np.float32)
    tiles = np.arange(plan.tiles)[:, None]
    for sy in range(SEGY):
        r = cy * (k2.RUN_Y * DY // UY) + sy
        v = [window[tiles, cp, r, plan.lead_x + cx * (k2.RUN_X * DX // UX) + sx]
             for sx in range(SEGX)]
        for jy in range(k2.RUN_Y):
            ty = sy * UY - jy * DY + RY
            if not 0 <= ty < min(FY, plan.fh):
                continue
            for jx in range(k2.RUN_X):
                for sx in range(SEGX):
                    tx = sx * UX - jx * DX + RX
                    if 0 <= tx < min(FX, plan.fw):
                        acc[jy, jx] += np.float32(taps[ty, tx]) * v[sx]
    return store_1d(acc, plan, planes, plane0, th, tw, cx, cy, cp, k)


def store_1d(acc, plan, planes, plane0, th, tw, cx, cy, cp, k):
    """The 1-D kernel's stores in numpy: two outputs a store at an even
    element offset; in a row that starts on an odd offset (odd out_w), a
    run's second column with the next lane's first, and a column alone at a
    tile's or warp's edge or the row's end. Checks that every output is
    written once and every pair lies on an even offset."""
    out = np.zeros(planes * plan.out_h * plan.out_w, np.float32)
    written = np.zeros(out.shape, np.int64)
    plane = plane0[:, None] + cp[None, :]
    oy0 = th[:, None] * plan.tile_h + cy * k2.RUN_Y
    ox = tw[:, None] * plan.tile_w + cx * k2.RUN_X
    lane = k % 32
    valid = (plane < planes) & (oy0 < plan.out_h) & (ox < plan.out_w)
    second = ox + 1 < plan.out_w
    left_pairs = (cx > 0) & (lane > 0)
    right_pairs = (cx + 1 < plan.nx) & (lane < 31) & (ox + 2 < plan.out_w)
    pairs = []

    def put(m, off, v):
        out[off[m]] = v[m]
        np.add.at(written, off[m], 1)

    for jy in range(k2.RUN_Y):
        a0, a1 = acc[jy, 0], acc[jy, 1]
        nxt = np.roll(a0, -1, axis=1)                 # the next lane's first column
        m = valid & (oy0 + jy < plan.out_h)
        row = (plane * plan.out_h + oy0 + jy) * plan.out_w
        o = np.where(m, row + ox, 0)
        even, odd = m & (row % 2 == 0), m & (row % 2 == 1)
        put(even & second, o, a0)
        put(even & second, o + 1, a1)
        put(even & ~second, o, a0)
        put(odd & ~left_pairs, o, a0)
        put(odd & right_pairs, o + 1, a1)
        put(odd & right_pairs, o + 2, nxt)
        put(odd & ~right_pairs & second, o + 1, a1)
        pairs += [o[even & second], o[odd & right_pairs] + 1]
    assert (written == 1).all()
    assert all((p % 2 == 0).all() for p in pairs)
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
                fy, fx = taps[16:20], taps[20:]
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


def emulate_pass(x: torch.Tensor, p, aligned=True) -> torch.Tensor:
    N, C, H, W = x.shape
    fh, fw = p.k.shape
    variant = pass_variant(p)
    xs = x.float().reshape(N * C, H, W).numpy()
    if variant < k2.N_2D:
        ptr = 0 if aligned else misaligned(x.element_size())
        _, plan, taps = k2.pass_launch(p, x.shape, x.dtype, ptr)
        y = emulate_2d(xs, plan, taps, x.element_size())
    else:
        plan = k2_plan(variant, N * C, H, W, fh, fw, p.pad, x.element_size(), aligned)
        y = emulate_1d(xs, plan, p.k.to(x.dtype).float().numpy())
    return torch.from_numpy(y).reshape(N, C, plan.out_h, plan.out_w).to(x.dtype)


def assert_emulation_matches_plain(x, args, aligned):
    want = upfirdn2d_k2_plain(x, *args)
    got = x
    for p in passes(*args):
        got = emulate_pass(got, p, aligned)
    assert got.shape == want.shape and got.dtype == want.dtype
    tol = 1e-5 if x.dtype == torch.float32 else 1e-2
    scale = max(float(want.float().abs().max()), 1e-6)
    err = float((got.float() - want.float()).abs().max())
    assert err <= tol * scale, (aligned, err, scale)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("which", ["fwd", "adj"])
@pytest.mark.parametrize("case", list(CASES))
def test_kernel_emulation_matches_plain(case, which, dtype):
    """Every main-path call and its adjoint through the emulated kernels,
    from an aligned and a misaligned input: float32 to 1e-5 of scale
    (another summation order), bf16 to 1e-2 (both round once from a
    float32 sum of the same bf16 taps)."""
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
    got, want = emulate_pass(x, p), upfirdn2d_k2_plain(x, *args)
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    scale = float(want.float().abs().max())
    assert float((got.float() - want.float()).abs().max()) <= tol * scale


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
    else None) and every K2 pass (at upfirdn2d_k2, forward and backward,
    with k2_refusal's verdict), on the CPU."""

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
                flip_filter, gain), len(passes(f, up, down, padding, flip_filter, gain))))
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
    """G (12 K2 passes a forward at 256^2: 6 up-convs, 6 image skips), D (6
    K2 pre-filters and 6 K1 skips a forward) and the bgc pipe (4 K2 passes),
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
    assert rec.check() == 4 and {r for *_, r in rec.calls} == {"K2"}
    rec.reset()
    y.square().mean().backward()
    assert rec.check() == 4


# ------------------------------------------------------------------ the wrapper

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
    """VARIANTS is the source's K2_VARIANTS_2D then K2_VARIANTS_1D, and each
    plan's fields are its enum's."""
    src = (Path(k2.__file__).parents[1] / "csrc" / "upfirdn2d.cu").read_text()
    body = src[src.index("#define K2_VARIANTS_2D(X)"):src.index("namespace {")]
    two_d = body[:body.index("#define K2_VARIANTS_1D(X)")]
    found = [tuple(int(v) for v in m.split(","))
             for m in re.findall(r"X\(([\d,\s]+)\)", body)]
    assert tuple(found) == VARIANTS
    assert len(re.findall(r"X\(", two_d)) == k2.N_2D
    for enum, end, plan in (("enum Plan2DField", "kNumPlan2DFields", k2.K2Plan2D),
                            ("enum PlanField", "kNumPlanFields", k2.K2Plan)):
        fields = src[src.index(enum):src.index(end)]
        names = re.findall(r"k(\w+)", fields)
        assert [n.lower() for n in names] == [f.replace("_", "") for f in plan._fields]
    consts = dict(re.findall(r"constexpr int (THREADS|STAGES|MIN_BLOCKS) = (\d+);",
                             src[src.index("namespace k2d"):src.index("namespace k1d")]))
    assert {k: int(v) for k, v in consts.items()} == dict(
        THREADS=k2.THREADS, STAGES=k2.STAGES, MIN_BLOCKS=k2.MIN_BLOCKS)
    runs = {k: (int(a), int(b)) for k, a, b in
            re.findall(r"constexpr int (RUN_[XY]) = D == 2 \? (\d) : (\d);", src)}
    for variant in range(k2.N_2D):
        DY, DX = VARIANTS[variant][3], VARIANTS[variant][6]
        assert k2.run_2d(variant) == (runs["RUN_Y"][DY == 1], runs["RUN_X"][DX == 1])


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
