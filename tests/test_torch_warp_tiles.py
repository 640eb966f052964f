"""The tile plan of the port's K4 (csrc/affine_warp.cu), on CPU.

K4 gives each block a tile of output pixels of one image. The block stages
the tile's input box, every channel (or chunks of channels, double
buffered), in shared memory, and reads each tap from there; a tap outside
the box is read from device memory (a guard that should never fire), and a
tile whose box does not fit the budget samples straight from device memory
(the direct path). `grid_sample._warp_tile_boxes` computes the boxes and the
paths as the kernel does. These tests hold it to the float32 geometry of
`_sample_taps`, which the kernels and plain versions share, exhaustively
over every tile:

  * every clipped tap of every pixel of a staged tile (inside the image, in
    zeros mode) lies in the tile's box, so the guard never fires;
  * a tile whose whole raw range lies in [-0.5, 0) (after the mirror, or on
    either axis) keeps pixel 1, its second tap, in the box;
  * the staged channels never exceed the shared-memory budget;
  * an emulation of the kernel's staged gather, which copies each box as the
    kernel does (rows from the 16-byte chunk left of the box, an odd number
    of chunks a row) and reads each tap from that copy, equals
    `affine_grid_sample_plain` to the bit, in float32 and in bfloat16;
  * the constants of the plan are the kernel source's.

The maps: the seven sets of tests/test_torch_warp_footprint.py, maps that
put a whole tile on a border, and at the ADA step's grid (536^2 -> 524^2)
the 16 maps that the port's bgc pipe draws there at p = 1. Two tile shapes:
the kernel's, and 16 x 16.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from stylegan_v_tpu_torch.ops import grid_sample as tgs
from stylegan_v_tpu_torch.training import augment as taug
from test_torch_warp_footprint import GRIDS, SETS, g_sets

STEP_GRID = (536, 536, 524, 524)
TILES = [(tgs.K4_TILE_W, tgs.K4_TILE_H), (16, 16)]


class _Recorded(Exception):
    pass


def bgc_step_maps(n=16, seed=12):
    """The G_inv that the port's bgc pipe (warp_upsample=2) hands the warp for
    n images of 256^2 at p = 1; the pipe stops at the warp."""
    calls, warp = [], taug.affine_grid_sample

    def recorded(x, G_inv, out_h, out_w, mode="reflect"):
        calls.append((tuple(x.shape[2:]), out_h, out_w, G_inv.detach().clone()))
        raise _Recorded

    pipe = taug.make_augment_pipe(taug.AugmentConfig(**taug.AUGPIPE_SPECS["bgc"],
                                                     warp_upsample=2))
    images = torch.zeros(n, 1, 256, 256)
    taug.affine_grid_sample = recorded
    try:
        with torch.no_grad(), pytest.raises(_Recorded):
            pipe(torch.Generator().manual_seed(seed), images, torch.ones(()))
    finally:
        taug.affine_grid_sample = warp
    (hw, out_h, out_w, G), = calls
    assert hw + (out_h, out_w) == STEP_GRID
    return G


def border_maps(H, W):
    """Maps that put every sample of the grid at one raw position: px in
    [-0.5, 0) directly, and after the mirror (raw -0.8); py likewise; and
    the right and bottom borders (W - 0.7, H - 0.7)."""
    def xin(p, size):           # the normalised coordinate of raw position p
        return (2.0 * p + 1.0) / size - 1.0

    rows = [((-0.25, W), (3.3, H)), ((-0.8, W), (2.6, H)), ((4.2, W), (-0.3, H)),
            ((2.1, W), (-0.9, H)), ((W - 0.7, W), (H - 0.7, H)), ((-0.1, W), (-0.45, H))]
    G = np.tile(np.eye(3, dtype=np.float32), (len(rows), 1, 1))
    for i, ((px, w), (py, h)) in enumerate(rows):
        G[i, 0, :] = [0.0, 0.0, xin(px, w)]
        G[i, 1, :] = [0.0, 0.0, xin(py, h)]
    return torch.from_numpy(G)


_MAPS = {}


def maps(name, grid):
    if (name, grid) not in _MAPS:
        if name == "bgc_step":
            G = bgc_step_maps()
        elif name == "border":
            G = border_maps(*grid[:2])
        else:
            G = torch.from_numpy(g_sets(name))
        _MAPS[name, grid] = G
    return _MAPS[name, grid]


CASES = ([(s, g) for s in SETS + ["border"] for g in GRIDS]
         + [("bgc_step", STEP_GRID), ("border", STEP_GRID), ("extreme", STEP_GRID)])


def tile_of(out_h, out_w, tile):
    """[out_h, out_w] index maps of each pixel's tile row and column."""
    tw, th = tile
    return (np.arange(out_h)[:, None] // th).repeat(out_w, 1), \
        (np.arange(out_w)[None, :] // tw).repeat(out_h, 0)


@pytest.mark.parametrize("tile", TILES, ids=lambda t: "{}x{}".format(*t))
@pytest.mark.parametrize("mode", ["reflect", "zeros"])
@pytest.mark.parametrize("gset,grid", CASES, ids=lambda c: c if isinstance(c, str)
                         else "{}x{}->{}x{}".format(*c))
def test_every_tap_of_a_staged_tile_lies_in_its_box(gset, grid, mode, tile):
    H, W, out_h, out_w = grid
    G = maps(gset, grid)
    plan = tgs._warp_tile_boxes(G, H, W, out_h, out_w, mode, tile)
    x0, x1, y0, y1, _, _, mask = (t.numpy() if t is not None else None
                                  for t in tgs._sample_taps(G, H, W, out_h, out_w, mode))
    ty, tx = tile_of(out_h, out_w, tile)
    for n in range(len(G)):
        box = plan.box[n][ty, tx]                                   # [out_h, out_w, 4]
        assert (box[..., 0] >= 0).all() and (box[..., 1] < W).all()
        assert (box[..., 2] >= 0).all() and (box[..., 3] < H).all()
        assert (box[..., 0] <= box[..., 1]).all() and (box[..., 2] <= box[..., 3]).all()
        load = plan.channels[n][ty, tx] > 0
        if mask is not None:
            load &= mask[n]
        inside = ((x0[n] >= box[..., 0]) & (x1[n] <= box[..., 1])
                  & (y0[n] >= box[..., 2]) & (y1[n] <= box[..., 3]))
        bad = np.argwhere(load & ~inside)
        assert bad.size == 0, (n, bad[:5].tolist(), box[tuple(bad[0])].tolist())
    if gset == "border":
        # the whole grid at one position in [-0.5, 0), on x, y or both: the
        # box starts at pixel 0 and keeps pixel 1, the second tap
        for n, axes in enumerate(["x", "x", "y", "y", "", "xy"]):
            for axis, (b0, b1) in (("x", (0, 1)), ("y", (2, 3))):
                if axis in axes:
                    assert (plan.box[n][..., b0] == 0).all(), (n, axis)
                    assert (plan.box[n][..., b1] >= 1).all(), (n, axis)


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("tile", TILES, ids=lambda t: "{}x{}".format(*t))
@pytest.mark.parametrize("mode", ["reflect", "zeros"])
@pytest.mark.parametrize("gset,grid", [("bgc_step", STEP_GRID), ("extreme", STEP_GRID),
                                       ("aniso", STEP_GRID), ("zoom_in", STEP_GRID)],
                         ids=lambda c: c if isinstance(c, str) else "step")
def test_staged_channels_fit_the_budget(gset, grid, mode, tile, itemsize):
    """A staged tile's channels (all of them, or two buffers of a chunk) fit
    the budget; a tile takes the direct path only if one channel does not
    fit twice."""
    H, W, out_h, out_w = grid
    C = 9
    plan = tgs._warp_tile_boxes(maps(gset, grid), H, W, out_h, out_w, mode, tile, C, itemsize)
    vec = 16 // itemsize
    for box, cg in zip(plan.box.reshape(-1, 4), plan.channels.reshape(-1)):
        bx0, bx1, by0, by1 = box
        ax0 = bx0 - bx0 % vec
        chunks = (bx1 - ax0) // vec + 1
        pitch = (chunks | 1) * vec
        assert ax0 + chunks * vec <= -(-W // vec) * vec and pitch % (2 * vec) == vec
        plane = (by1 - by0 + 1) * pitch * itemsize
        if cg == 0:
            assert 2 * plane > tgs.K4_SMEM
        else:
            assert 1 <= cg <= C and (cg if cg == C else 2 * cg) * plane <= tgs.K4_SMEM
            assert cg == C or C * plane > tgs.K4_SMEM


def test_bgc_draws_stage_almost_every_tile():
    """Under the pipe's own bgc draws at the step's grid, in bf16, nearly
    every tile is staged with all nine channels at once."""
    G = maps("bgc_step", STEP_GRID)
    plan = tgs._warp_tile_boxes(G, *STEP_GRID)
    assert (plan.channels > 0).mean() > 0.95, (plan.channels > 0).mean()
    zoom = tgs._warp_tile_boxes(g_sets("zoom_in"), *STEP_GRID)
    assert (zoom.channels == 9).all()


def staged_gather(x, G, out_h, out_w, mode, tile, plan):
    """K4 as its kernel computes, tile by tile: a staged tile copies its box
    as the kernel does (rows from the 16-byte chunk left of bx0, an odd
    number of chunks a row; columns past the image are never read) and reads
    each tap from that copy, or from x where a tap falls outside the box; a
    direct tile reads x. float32 sums in the kernel's order, one cast."""
    N, C, H, W = x.shape
    vec = 16 // x.element_size()
    xf = x.float()
    x0, x1, y0, y1, wx, wy, mask = tgs._sample_taps(G, H, W, out_h, out_w, mode)
    out = torch.zeros(N, C, out_h, out_w)
    tw, th = tile
    for n in range(N):
        for ty in range(plan.box.shape[1]):
            for tx in range(plan.box.shape[2]):
                rows = slice(ty * th, min((ty + 1) * th, out_h))
                cols = slice(tx * tw, min((tx + 1) * tw, out_w))
                tx0, tx1, ty0, ty1 = (t[n, rows, cols] for t in (x0, x1, y0, y1))
                bx0, bx1, by0, by1 = plan.box[n, ty, tx].tolist()
                if plan.channels[n, ty, tx] > 0:
                    ax0 = bx0 - bx0 % vec
                    pitch = (((bx1 - ax0) // vec + 1) | 1) * vec
                    copy = torch.full((C, by1 - by0 + 1, pitch), float("nan"))
                    width = min(pitch, W - ax0)
                    copy[:, :, :width] = xf[n, :, by0:by1 + 1, ax0:ax0 + width]
                    flat = copy.reshape(C, -1)
                    inbox = (tx0 >= bx0) & (tx1 <= bx1) & (ty0 >= by0) & (ty1 <= by1)
                    taps = []
                    for yy, xx in ((ty0, tx0), (ty0, tx1), (ty1, tx0), (ty1, tx1)):
                        s = ((yy - by0) * pitch + (xx - ax0)).clamp(0, flat.shape[1] - 1)
                        staged = flat[:, s]
                        direct = xf[n][:, yy, xx]
                        taps.append(torch.where(inbox, staged, direct))
                else:
                    taps = [xf[n][:, yy, xx] for yy, xx in ((ty0, tx0), (ty0, tx1), (ty1, tx0),
                                                            (ty1, tx1))]
                fx, fy = wx[n, rows, cols], wy[n, rows, cols]
                omx, omy = 1 - fx, 1 - fy
                top = taps[0] * omx + taps[1] * fx
                bot = taps[2] * omx + taps[3] * fx
                v = top * omy + bot * fy
                if mask is not None:
                    v = torch.where(mask[n, rows, cols], v, torch.zeros(()))
                out[n, :, rows, cols] = v
    return out.to(x.dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tile", TILES, ids=lambda t: "{}x{}".format(*t))
@pytest.mark.parametrize("mode", ["reflect", "zeros"])
@pytest.mark.parametrize("gset,grid", CASES, ids=lambda c: c if isinstance(c, str)
                         else "{}x{}->{}x{}".format(*c))
def test_staged_gather_emulation_is_the_plain_version_to_the_bit(gset, grid, mode, tile,
                                                                  dtype):
    H, W, out_h, out_w = grid
    G = maps(gset, grid)
    C = 2 if grid == STEP_GRID else 3
    if grid == STEP_GRID:
        G = G[:4] if gset == "bgc_step" else G[:2]
    x = torch.from_numpy(np.random.RandomState(6).randn(len(G), C, H, W).astype(np.float32))
    x = x.to(dtype)
    itemsize = x.element_size()
    plan = tgs._warp_tile_boxes(G, H, W, out_h, out_w, mode, tile, C, itemsize)
    got = staged_gather(x, G, out_h, out_w, mode, tile, plan)
    want = tgs.affine_grid_sample_plain(x, G, out_h, out_w, mode)
    assert torch.equal(got, want), (got.float() - want.float()).abs().max()


def test_tile_constants_are_the_kernels():
    src = (Path(tgs.__file__).resolve().parents[1] / "csrc" / "affine_warp.cu").read_text()
    consts = {k: eval(v, {}) for k, v in
              re.findall(r"constexpr int (\w+) = ([\d *]+);", src)}
    assert consts["TILE_W"] == tgs.K4_TILE_W
    assert consts["THREAD_ROWS"] * consts["ROWS"] == tgs.K4_TILE_H
    assert consts["SMEM_BYTES"] == tgs.K4_SMEM
