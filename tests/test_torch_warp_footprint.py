"""The footprint of the port's K4-bwd gather (csrc/affine_warp_bwd.cu), on CPU.

K4-bwd gives each input pixel to one thread, which visits the output pixels
that `grid_sample._warp_footprint` enumerates (the kernel's enumeration, in
Python) and adds the weight of every tap that lands on its pixel. These
tests hold the enumeration to the float32 geometry of `_sample_taps`, which
K4's kernels and plain versions share:

  * coverage: every tap of every output pixel (inside the image, in zeros
    mode) lies in the footprint of the tap's pixel, and no footprint visits
    an output pixel twice;
  * a gather emulation that sums, in float32 and in the kernel's order, along
    the footprints equals `affine_grid_sample_bwd_plain` within float32
    rounding (TOL, relative to the gradient's scale);
  * the constants of the enumeration are the kernel source's.

The maps: the sets of tests/test_torch_augment.py (a shift onto the x0
clip, an extreme zoom-out past the border, a generic affine), a 4x zoom-in
at 30 degrees, per-axis scales 4 and 1/4 (the ADA tails), a singular linear
part (the whole-grid scan), and a batch drawn by the port's bgc pipe at
p = 1.
"""
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from stylegan_v_tpu_torch.ops import grid_sample as tgs
from stylegan_v_tpu_torch.training import augment as taug
from test_torch_augment import g_inv_set

TOL = 1e-5
GRIDS = [(9, 9, 8, 11), (18, 20, 11, 13)]   # H, W, out_h, out_w
SETS = ["shift", "extreme", "random", "zoom_in", "aniso", "singular", "bgc"]


def _affine(rows):
    G = np.tile(np.eye(3, dtype=np.float32), (len(rows), 1, 1))
    G[:, :2] = np.asarray(rows, dtype=np.float32)
    return G


def _rot(deg):
    t = math.radians(deg)
    return np.array([[math.cos(t), -math.sin(t)], [math.sin(t), math.cos(t)]])


def _bgc_batch(n=6, seed=11):
    """G_inv of the port's bgc pipe (warp_upsample=2) at p = 1, as it calls the warp."""
    calls, warp = [], taug.affine_grid_sample

    def recorded(x, G_inv, out_h, out_w, mode="reflect"):
        calls.append(G_inv.detach().clone())
        return warp(x, G_inv, out_h, out_w, mode)

    pipe = taug.make_augment_pipe(taug.AugmentConfig(**taug.AUGPIPE_SPECS["bgc"],
                                                     warp_upsample=2))
    images = torch.rand(n, 3, 16, 16, generator=torch.Generator().manual_seed(seed)) * 2 - 1
    taug.affine_grid_sample = recorded
    try:
        with torch.no_grad():
            pipe(torch.Generator().manual_seed(seed), images, torch.ones(()))
    finally:
        taug.affine_grid_sample = warp
    assert len(calls) == 1
    return calls[0].numpy()


def g_sets(name):
    """[N, 3, 3] float32 inverse maps of the set `name` (module docstring)."""
    if name in ("shift", "extreme", "random"):
        return g_inv_set(name)
    if name == "zoom_in":
        lin = 0.25 * _rot(30)
        return _affine([np.c_[lin, [0.1, -0.2]], np.c_[lin.T, [-0.7, 0.6]]])
    if name == "aniso":
        return _affine([[[4, 0, 0.3], [0, 0.25, -0.1]],
                        np.c_[_rot(20) @ np.diag([0.25, 4]), [-0.4, 0.9]]])
    if name == "singular":
        return _affine([[[1, 2, 0.1], [0.5, 1, -0.2]], [[0, 0, 0.3], [0, 0, -0.4]]])
    return _bgc_batch()


_CASES = {}


def case(gset, grid, mode):
    """(G, footprints, taps) of one case, computed once."""
    key = (gset, grid, mode)
    if key not in _CASES:
        H, W, out_h, out_w = grid
        G = torch.from_numpy(g_sets(gset))
        x0, x1, y0, y1, wx, wy, mask = tgs._sample_taps(G, H, W, out_h, out_w, mode)
        taps = [(y * W + x).reshape(len(G), -1).numpy()
                for y, x in ((y0, x0), (y0, x1), (y1, x0), (y1, x1))]
        inside = (mask.reshape(len(G), -1).numpy() if mask is not None
                  else np.ones_like(taps[0], dtype=bool))
        weights = (wx.reshape(len(G), -1).numpy(), wy.reshape(len(G), -1).numpy())
        _CASES[key] = (G, tgs._warp_footprint(G, H, W, out_h, out_w, mode), taps, inside,
                       weights)
    return _CASES[key]


@pytest.mark.parametrize("mode", ["reflect", "zeros"])
@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: "{}x{}->{}x{}".format(*g))
@pytest.mark.parametrize("gset", SETS)
def test_footprint_covers_every_tap_once(gset, grid, mode):
    H, W, out_h, out_w = grid
    G, footprints, taps, inside, _ = case(gset, grid, mode)
    assert len(footprints) == len(G)
    for n, image in enumerate(footprints):
        assert len(image) == H * W
        for visits in image:
            assert len(np.unique(visits)) == len(visits), "an output pixel visited twice"
            assert visits.size == 0 or (visits.min() >= 0 and visits.max() < out_h * out_w)
        members = [set(v.tolist()) for v in image]
        for t in taps:
            for o in np.flatnonzero(inside[n]):
                assert o in members[t[n, o]], (n, divmod(o, out_w), divmod(t[n, o], W))


@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: "{}x{}->{}x{}".format(*g))
@pytest.mark.parametrize("gset", SETS)
def test_footprint_scans_only_an_unbounded_map(gset, grid):
    """Every map but the singular one takes the enumeration, whose footprints
    are much smaller than the grid; the singular one scans the whole grid."""
    H, W, out_h, out_w = grid
    _, footprints, _, _, _ = case(gset, grid, "reflect")
    for image in footprints:
        sizes = np.array([len(v) for v in image])
        if gset == "singular":
            assert (sizes == out_h * out_w).all()
        else:
            assert sizes.mean() < out_h * out_w / 4


def gather(dy, G, footprints, taps, inside, weights, H, W):
    """K4-bwd as its kernel sums: for each input pixel, along its footprint, in
    float32, the taps on the pixel in the order o00, o01, o10, o11, each
    product as (dy (1-wy)) (1-wx) etc."""
    N, C = dy.shape[:2]
    d = dy.reshape(N, C, -1)
    wx, wy = weights
    dx = np.zeros((N, C, H * W), dtype=np.float32)
    one = np.float32(1)
    for n in range(N):
        t = np.stack([tap[n] for tap in taps], axis=1)                 # [P, 4]
        for me, visits in enumerate(footprints[n]):
            hit = (t[visits] == me) & inside[n, visits, None]
            acc = np.zeros(C, dtype=np.float32)
            for i, k in zip(*np.nonzero(hit)):                          # visit order, then tap
                o = visits[i]
                fy = wy[n, o] if k >= 2 else one - wy[n, o]
                fx = wx[n, o] if k % 2 else one - wx[n, o]
                acc = acc + (d[n, :, o] * fy) * fx
            dx[n, :, me] = acc
    return dx.reshape(N, C, H, W)


@pytest.mark.parametrize("mode", ["reflect", "zeros"])
@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: "{}x{}->{}x{}".format(*g))
@pytest.mark.parametrize("gset", SETS)
def test_gather_along_the_footprint_is_the_plain_adjoint(gset, grid, mode):
    H, W, out_h, out_w = grid
    G, footprints, taps, inside, weights = case(gset, grid, mode)
    dy = np.random.RandomState(5).randn(len(G), 3, out_h, out_w).astype(np.float32)
    got = gather(dy, G, footprints, taps, inside, weights, H, W)
    want = tgs.affine_grid_sample_bwd_plain(torch.from_numpy(dy), G, H, W, mode).numpy()
    scale = max(np.abs(want).max(), 1.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * scale)


def test_footprint_constants_are_the_kernels():
    src = (Path(tgs.__file__).resolve().parents[1] / "csrc" / "affine_warp_bwd.cu").read_text()
    consts = dict(re.findall(r"constexpr \w+ (\w+) = ([^;]+);", src))
    assert float(consts["MAX_PERIODS"]) == tgs.MAX_PERIODS
    assert int(consts["MAX_INTERVALS"]) == tgs.MAX_INTERVALS
    assert float(consts["SINGULAR"]) == tgs.SINGULAR
    assert float.fromhex(consts["MAX_COORD"]) == tgs.MAX_COORD
    assert int(consts["CHUNK"]) == tgs.BWD_CHUNK
    assert (int(consts["QX"]), int(consts["QY"])) == (tgs.BWD_QX, tgs.BWD_QY)
