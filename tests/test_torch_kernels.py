"""The hand-written kernels of the PyTorch port: the downfirdn2d_x2 kernel
(K1) and its adjoint (K1-bwd), the bilinear affine warp (K4) and its
adjoint (K4-bwd).

On CPU: K1's plain version against the JAX package's Pallas kernel in
interpret mode (the same shapes as tests/test_pallas_kernels.py plus an
asymmetric filter), and the wrappers' input checks (K4's plain version is
held to the JAX package in tests/test_torch_augment.py). float32 holds to
1e-5; bf16 to 1e-2, since both sides round once from a float32 sum.

Tests marked `cuda` need an NVIDIA GPU and nvcc; they skip elsewhere. One
of them also loads a reference .pkl and runs the generate CLI on the card.
On such a machine, which need not have jax:
    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py -q
"""
import numpy as np
import pytest
import torch

from stylegan_v_tpu_torch.ops import (affine_grid_sample, affine_grid_sample_bwd_plain,
                                      affine_grid_sample_plain, affine_warp, affine_warp_bwd,
                                      downfirdn2d_x2, downfirdn2d_x2_bwd,
                                      downfirdn2d_x2_bwd_plain, downfirdn2d_x2_plain,
                                      downsample2d, fir_kernels, grid_sample, setup_filter,
                                      upfirdn2d)

SYM = np.outer([1, 3, 3, 1], [1, 3, 3, 1]).astype(np.float32) / 64
ASYM = (np.arange(16, dtype=np.float32).reshape(4, 4) - 5.0) / 40
TOLS = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


def assert_close(got: torch.Tensor, want: torch.Tensor, dtype):
    assert got.shape == want.shape and got.dtype == want.dtype == dtype
    tol = TOLS[dtype]
    torch.testing.assert_close(got.float().cpu(), want.float().cpu(), rtol=tol, atol=tol)


@pytest.mark.parametrize("shape", [(2, 16, 16, 8), (1, 32, 64, 16), (3, 8, 8, 4)])
@pytest.mark.parametrize("filt", ["sym", "asym"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_matches_pallas_interpret(shape, filt, dtype):
    import jax.numpy as jnp   # here, not at the top: the `cuda` tests run without jax
    from stylegan_v_tpu.ops.pallas_kernels import downfirdn2d_x2 as pallas_downfirdn2d_x2

    f = SYM if filt == "sym" else ASYM
    x = torch.from_numpy(np.random.RandomState(0).randn(*shape).astype(np.float32)).to(dtype)
    jx = jnp.asarray(x.float().numpy()).astype(jnp.bfloat16 if dtype == torch.bfloat16
                                                else jnp.float32)
    want = pallas_downfirdn2d_x2(jx, f, interpret=True)
    want = torch.tensor(np.asarray(want.astype(jnp.float32))).to(dtype)
    got = downfirdn2d_x2_plain(x.permute(0, 3, 1, 2).contiguous(), f)
    assert_close(got.permute(0, 2, 3, 1), want, dtype)


def test_wrapper_on_cpu_is_the_plain_version_and_launches_nothing():
    x = torch.randn(2, 3, 8, 6, generator=torch.Generator().manual_seed(1))
    before = downfirdn2d_x2.launches
    got = downfirdn2d_x2(x, SYM)
    assert downfirdn2d_x2.launches == before
    torch.testing.assert_close(got, downfirdn2d_x2_plain(x, SYM), rtol=0, atol=0)
    torch.testing.assert_close(got, downsample2d(x, setup_filter([1, 3, 3, 1])),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("shape,f,match", [
    ((2, 3, 7, 8), SYM, "even"),
    ((2, 3, 8), SYM, "NCHW"),
    ((2, 3, 8, 8), np.ones((3, 3), np.float32), "4x4"),
])
def test_wrapper_rejects_what_the_kernel_does_not_take(shape, f, match):
    with pytest.raises(ValueError, match=match):
        downfirdn2d_x2(torch.zeros(shape), f)


def test_bwd_wrapper_on_cpu_is_the_plain_version_and_launches_nothing():
    dy = torch.randn(2, 3, 4, 3, generator=torch.Generator().manual_seed(2))
    before = downfirdn2d_x2_bwd.launches
    got = downfirdn2d_x2_bwd(dy, ASYM)
    assert downfirdn2d_x2_bwd.launches == before and got.shape == (2, 3, 8, 6)
    torch.testing.assert_close(got, downfirdn2d_x2_bwd_plain(dy, ASYM), rtol=0, atol=0)
    with pytest.raises(ValueError, match="NCHW"):
        downfirdn2d_x2_bwd(torch.zeros(2, 3, 4), ASYM)


# ------------------------------------------------- K1 and K1-bwd tile plans

# K1's inputs: D's six resnet skips at 16 videos x 3 frames and at 2 x 3, and
# edge cases: H = W = 2, W = 2 with a tall H, Wo (136) not a multiple of the
# tile, one plane, more than 65,535 planes.
K1_SHAPES = [(48, 64, 256, 256), (48, 128, 128, 128), (48, 256, 64, 64), (48, 512, 32, 32),
             (16, 768, 16, 16), (16, 512, 8, 8),
             (6, 64, 256, 256), (6, 128, 128, 128), (6, 256, 64, 64), (6, 512, 32, 32),
             (2, 768, 16, 16), (2, 512, 8, 8),
             (1, 1, 2, 2), (2, 3, 2, 2), (1, 2, 1024, 2), (1, 3, 20, 272), (1, 1, 64, 64),
             (1, 70000, 4, 4)]


def plan_cases():
    """(kind, source shape, itemsize, vec) for K1 on x and K1-bwd on dy = K1's output."""
    for n, c, h, w in K1_SHAPES:
        for kind, (sh, sw) in (("down", (h, w)), ("up", (h // 2, w // 2))):
            for itemsize in (2, 4):
                small_w = sw // 2 if kind == "down" else sw   # K1's output, K1-bwd's input
                for vec in (False, True) if small_w % (16 // itemsize) == 0 else (False,):
                    yield pytest.param(kind, (n * c, sh, sw), itemsize, vec,
                                       id=f"{kind}-{n}x{c}x{sh}x{sw}-{itemsize}B-vec{int(vec)}")


def thread_reads(plan, kind):
    """Per axis, the source offsets (rows, columns) that the thread at run
    (cy, cx) reads from the window, relative to the window's origin, as the
    kernels read them (csrc/downfirdn2d_x2*.cu, fir_tile.cuh:load_row)."""
    cy, cx = np.arange(plan.ny)[:, None], np.arange(plan.nx)[:, None]
    if kind == "down":          # six rows from 4cy; columns from 2 run_w cx + pad - 1
        rows = 4 * cy + np.arange(6)
        first, n, chunk = 2 * plan.run_w * cx + plan.pad - 1, 2 * plan.run_w + 2, plan.run_w
    else:                       # four rows from 2cy; columns from run_w cx + pad - 1
        rows = 2 * cy + np.arange(4)
        first, n, chunk = plan.run_w * cx + plan.pad - 1, plan.run_w + 2, plan.run_w
    if plan.vec:                # whole vectors of `chunk` elements from first - (chunk - 1)
        start = first - (chunk - 1)
        count = -(-(n + chunk - 1) // chunk) * chunk
        cols = start + np.arange(count)
    else:
        cols = first + np.arange(n)
    return rows, cols, first + np.arange(n)


@pytest.mark.parametrize("kind,shape,itemsize,vec", list(plan_cases()))
def test_fir_plan_covers_every_output_once_and_reads_inside_its_window(kind, shape, itemsize,
                                                                       vec):
    planes, sh, sw = shape
    plan = fir_kernels.fir_plan(kind, planes, sh, sw, itemsize, vec, resident=4 * 132)
    assert len(plan) == len(fir_kernels.FirPlan._fields)
    assert plan.grid_h == (sh // 2 if kind == "down" else sh)
    assert plan.grid_w == (sw // 2 if kind == "down" else sw)
    assert 1 <= plan.threads == plan.planes_per_tile * plan.nx * plan.ny <= fir_kernels.THREADS
    assert plan.tile_h == plan.ny * plan.run_h and plan.tile_w == plan.nx * plan.run_w
    assert plan.tiles == plan.tiles_p * plan.tiles_h * plan.tiles_w
    assert plan.grid == min(plan.tiles, 4 * 132)
    # every output (K1-bwd: every dy cell, i.e. every dx quad) exactly once, axis by axis
    for length, tile, run, runs, tiles in (
            (planes, plan.planes_per_tile, 1, plan.planes_per_tile, plan.tiles_p),
            (plan.grid_h, plan.tile_h, plan.run_h, plan.ny, plan.tiles_h),
            (plan.grid_w, plan.tile_w, plan.run_w, plan.nx, plan.tiles_w)):
        idx = (np.arange(tiles)[:, None, None] * tile + np.arange(runs)[None, :, None] * run
               + np.arange(run)[None, None, :]).ravel()
        assert np.array_equal(np.bincount(idx[idx < length], minlength=length),
                              np.ones(length, np.int64))
    # the taps of every output lie in what its thread reads, and that in the window
    rows, cols, needed = thread_reads(plan, kind)
    assert rows.min() >= 0 and rows.max() < plan.win_h
    assert cols.min() >= 0 and cols.max() < plan.win_w
    assert np.isin(needed, cols).all()
    s = plan.scale
    # window origin of tile (., th, tw) is (s h0 - 1, s w0 - pad); thread (cy, cx)'s
    # outputs o need source rows s o - 1 .. (down: 2o + 2, up: o + 1)
    for o_first, origin, run, reads, pad in ((2 * np.arange(plan.ny), 1, plan.run_h, rows, 1),
                                             (plan.run_w * np.arange(plan.nx), plan.pad,
                                              plan.run_w, needed, plan.pad)):
        o = o_first[:, None] + np.arange(run)                       # relative to the tile
        lo, hi = s * o - 1 + origin, s * o + (2 if kind == "down" else 1) + origin
        assert (lo.min(axis=1) >= reads.min(axis=1)).all()
        assert (hi.max(axis=1) <= reads.max(axis=1)).all()
    # vector copies: every chunk wholly inside or outside the plane, rows on 16 bytes
    assert plan.win_w % plan.chunk == 0 and plan.cpr == plan.win_w // plan.chunk
    assert plan.stage_bytes % 16 == 0
    assert plan.row_stride >= plan.win_w
    assert plan.stage_bytes >= plan.planes_per_tile * plan.win_h * plan.row_stride * itemsize
    assert 2 * plan.stage_bytes <= 227 * 1024
    if vec:
        assert plan.chunk == plan.pad == 16 // itemsize
        assert sw % plan.chunk == 0 and (s * plan.tile_w) % plan.chunk == 0
        assert (plan.row_stride * itemsize) % 16 == 0
        if kind == "down":   # swizzled rows (fir_tile.cuh:swizzle) pair up their chunks
            slots = plan.row_stride // plan.chunk
            assert slots % 2 == 0 and slots - plan.cpr in (0, 1)
            c = np.arange(slots)
            assert sorted(c ^ ((c >> 3) & 1)) == list(c)
    else:
        assert plan.chunk == plan.pad == 1 and plan.row_stride == plan.win_w
    # the divisions of the copy loop (fir_tile.cuh:copy_window)
    for d, magic, shift, n in ((plan.cpr, plan.cpr_magic, plan.cpr_shift,
                                plan.planes_per_tile * plan.win_h * plan.cpr),
                               (plan.win_h, plan.winh_magic, plan.winh_shift,
                                plan.planes_per_tile * plan.win_h)):
        i = np.unique(np.r_[np.arange(min(n, 4096)), n - 1 - np.arange(min(n, 64))])
        i = i.astype(object)
        assert all(((k * magic >> 32) + k) >> shift == k // d for k in i)


def test_fast_div_magic_divides_up_to_2_31():
    rng = np.random.RandomState(4)
    for d in list(range(1, 300)) + [int(k) for k in rng.randint(300, 2**31 - 1, 50)]:
        magic, shift = fir_kernels.fast_div_magic(d)
        assert 0 < magic < 2**32
        for n in [0, 1, d - 1, d, d + 1, 2**31 - 1] + [int(k) for k in rng.randint(0, 2**31, 50)]:
            if n >= 0:
                assert ((n * magic >> 32) + n) >> shift == n // d, (d, n)


def test_fir_plan_packs_small_planes_and_tiles_large_ones():
    """The D skip shapes at 16 x 3: large planes take 128-thread tiles of one
    plane, planes with at most 16 outputs a row are packed several a tile."""
    big = fir_kernels.fir_plan("down", 48 * 64, 256, 256, 2, True, resident=528)
    assert (big.planes_per_tile, big.tile_h, big.tile_w, big.threads) == (1, 16, 128, 128)
    for kind, shape, itemsize, per_tile in (("down", (48 * 512, 32, 32), 2, 8),
                                            ("down", (16 * 768, 16, 16), 4, 16),
                                            ("down", (16 * 512, 8, 8), 4, 64),
                                            ("up", (16 * 512, 4, 4), 4, 32)):
        plan = fir_kernels.fir_plan(kind, *shape, itemsize, True, resident=528)
        assert plan.planes_per_tile == per_tile and plan.threads == fir_kernels.THREADS
    with pytest.raises(ValueError, match="kind"):
        fir_kernels.fir_plan("side", 1, 4, 4, 4, False, resident=1)


def warp_inputs(device, dtype=torch.float32, seed=3):
    """An image [3, 5, 18, 20] and inverse maps: identity, an extreme map (a
    quarter scale, 45 degrees, past the border: the mirror and the clipped
    x0 = -1 taps) and a generic affine."""
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(3, 5, 18, 20, generator=g, device=device).to(dtype)
    G = torch.eye(3).repeat(3, 1, 1)
    c = 4 * np.cos(np.pi / 4)
    G[1] = torch.tensor([[c, -c, 1.7], [c, c, -2.3], [0, 0, 1]])
    G[2, :2] += torch.tensor([[0.3, -0.2, 0.1], [0.25, 0.1, -0.4]])
    return x, G.to(device)


@pytest.mark.parametrize("mode", ["reflect", "zeros"])
def test_warp_wrappers_on_cpu_are_the_plain_versions_and_launch_nothing(mode):
    x, G = warp_inputs("cpu")
    before = (affine_warp.launches, affine_warp_bwd.launches)
    y = affine_warp(x, G, 11, 13, mode)
    torch.testing.assert_close(y, affine_grid_sample_plain(x, G, 11, 13, mode), rtol=0, atol=0)
    dy = torch.randn_like(y)
    dx = affine_warp_bwd(dy, G, 18, 20, mode)
    torch.testing.assert_close(dx, affine_grid_sample_bwd_plain(dy, G, 18, 20, mode),
                               rtol=0, atol=0)
    # the adjoint identity <K4 x, dy> = <x, K4-bwd dy>
    lhs, rhs = float((y.double() * dy.double()).sum()), float((x.double() * dx.double()).sum())
    assert abs(lhs - rhs) <= 1e-5 * max(abs(lhs), 1.0), (lhs, rhs)
    assert (affine_warp.launches, affine_warp_bwd.launches) == before


@pytest.mark.parametrize("args,match", [
    (((2, 3, 8), 2), "NCHW"),
    (((2, 3, 8, 8), 3), r"\[2, 3, 3\]"),
])
def test_warp_wrapper_rejects_what_the_kernel_does_not_take(args, match):
    shape, n = args
    with pytest.raises(ValueError, match=match):
        affine_warp(torch.zeros(shape), torch.eye(3).repeat(n, 1, 1), 8, 8)
    with pytest.raises(ValueError, match="mode"):
        affine_warp(torch.zeros(2, 3, 8, 8), torch.eye(3).repeat(2, 1, 1), 8, 8, "border")


# ------------------------------------------------------------ on the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("filt", ["sym", "asym"])
def test_kernel_matches_plain_on_card(cuda, dtype, filt):
    f = SYM if filt == "sym" else ASYM
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(3, 5, 18, 34, generator=g, device=cuda).to(dtype)
    before = downfirdn2d_x2.launches
    got = downfirdn2d_x2(x, f)
    torch.cuda.synchronize()
    assert downfirdn2d_x2.launches == before + 1
    assert_close(got, downfirdn2d_x2_plain(x, f), dtype)


@pytest.mark.cuda
def test_upfirdn2d_sends_only_the_k1_case_to_the_kernel(cuda):
    f = setup_filter([1, 3, 3, 1])
    x = torch.randn(2, 4, 16, 16, device=cuda)
    before = downfirdn2d_x2.launches
    got = upfirdn2d(x, f, down=2, padding=1)
    assert downfirdn2d_x2.launches == before + 1
    torch.testing.assert_close(got, downfirdn2d_x2_plain(x, f), rtol=1e-5, atol=1e-5)
    upfirdn2d(x, f, down=2, padding=2)
    upfirdn2d(x, f, up=2, padding=1)
    upfirdn2d(x[:, :, :15, :15], f, down=2, padding=1)
    assert downfirdn2d_x2.launches == before + 1


@pytest.mark.cuda
def test_kernel_raises_on_cuda_input_it_does_not_take(cuda):
    x = torch.randn(2, 4, 16, 16, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        downfirdn2d_x2(x.transpose(2, 3), SYM)
    with pytest.raises(ValueError, match="bfloat16"):
        downfirdn2d_x2(x.half(), SYM)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("filt", ["sym", "asym"])
def test_bwd_kernel_matches_plain_on_card(cuda, dtype, filt):
    f = SYM if filt == "sym" else ASYM
    g = torch.Generator(device=cuda).manual_seed(1)
    dy = torch.randn(3, 5, 9, 17, generator=g, device=cuda).to(dtype)
    before = downfirdn2d_x2_bwd.launches
    got = downfirdn2d_x2_bwd(dy, f)
    torch.cuda.synchronize()
    assert downfirdn2d_x2_bwd.launches == before + 1
    assert_close(got, downfirdn2d_x2_bwd_plain(dy, f), dtype)


EDGE_SHAPES = [(1, 1, 2, 2), (2, 3, 2, 2), (1, 2, 1024, 2), (1, 3, 20, 272), (1, 1, 64, 64),
               (1, 70000, 4, 4), (2, 512, 8, 8), (2, 5, 18, 36)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", EDGE_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("filt", ["sym", "asym"])
def test_k1_and_k1_bwd_match_plain_at_edge_shapes(cuda, shape, dtype, filt):
    """Both kernels at the tile plan's edge cases (whole-vector rows or not,
    packed planes, partial tiles, more than 65,535 planes), and from a
    misaligned view, which takes the element-wise copies."""
    f = SYM if filt == "sym" else ASYM
    g = torch.Generator(device=cuda).manual_seed(2)
    n, c, h, w = shape
    x = torch.randn(shape, generator=g, device=cuda).to(dtype)
    dy = torch.randn(n, c, h // 2, w // 2, generator=g, device=cuda).to(dtype)
    k1, k1b = downfirdn2d_x2.launches, downfirdn2d_x2_bwd.launches
    assert_close(downfirdn2d_x2(x, f), downfirdn2d_x2_plain(x, f), dtype)
    assert_close(downfirdn2d_x2_bwd(dy, f), downfirdn2d_x2_bwd_plain(dy, f), dtype)
    torch.cuda.synchronize()
    assert (downfirdn2d_x2.launches - k1, downfirdn2d_x2_bwd.launches - k1b) == (1, 1)
    xm = torch.empty(x.numel() + 1, device=cuda, dtype=dtype)[1:].view(shape)
    xm.copy_(x)
    dym = torch.empty(dy.numel() + 1, device=cuda, dtype=dtype)[1:].view(dy.shape)
    dym.copy_(dy)
    assert_close(downfirdn2d_x2(xm, f), downfirdn2d_x2_plain(x, f), dtype)
    assert_close(downfirdn2d_x2_bwd(dym, f), downfirdn2d_x2_bwd_plain(dy, f), dtype)


@pytest.mark.cuda
def test_grads_through_k1_launch_k1_bwd_then_k1(cuda):
    """First order launches K1-bwd once; the second order launches K1 again."""
    x = torch.randn(2, 4, 16, 16, device=cuda, requires_grad=True)
    f = setup_filter([1, 3, 3, 1])
    k1, k1b = downfirdn2d_x2.launches, downfirdn2d_x2_bwd.launches
    y = upfirdn2d(x, f, down=2, padding=1)
    dx, = torch.autograd.grad(y.square().sum(), x, create_graph=True)
    assert (downfirdn2d_x2.launches - k1, downfirdn2d_x2_bwd.launches - k1b) == (1, 1)
    # d/dx of sum(dx^2) with dx = 2 * K1bwd(K1(x)): K1 and K1-bwd once more each
    gx, = torch.autograd.grad(dx.square().sum(), x)
    torch.cuda.synchronize()
    assert (downfirdn2d_x2.launches - k1, downfirdn2d_x2_bwd.launches - k1b) == (2, 2)
    want = 8 * downfirdn2d_x2_bwd_plain(downfirdn2d_x2_plain(
        downfirdn2d_x2_bwd_plain(downfirdn2d_x2_plain(x.detach(), f), f), f), f)
    torch.testing.assert_close(gx, want, rtol=1e-4, atol=1e-5)
    # a non-contiguous incoming gradient is made contiguous before the launch
    dy = torch.randn(2, 4, 8, 8, device=cuda).transpose(2, 3)
    gx, = torch.autograd.grad(fir_kernels._DownFirX2.apply(x, f), x, dy)
    torch.testing.assert_close(gx, downfirdn2d_x2_bwd_plain(dy.contiguous(), f),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["reflect", "zeros"])
def test_warp_kernels_match_plain_on_card(cuda, dtype, mode):
    x, G = warp_inputs(cuda, dtype)
    k4, k4b = affine_warp.launches, affine_warp_bwd.launches
    y = affine_warp(x, G, 11, 13, mode)
    dy = torch.randn(3, 5, 11, 13, device=cuda).to(dtype)
    dx = affine_warp_bwd(dy, G, 18, 20, mode)
    torch.cuda.synchronize()
    assert (affine_warp.launches - k4, affine_warp_bwd.launches - k4b) == (1, 1)
    assert_close(y, affine_grid_sample_plain(x, G, 11, 13, mode), dtype)
    assert_close(dx, affine_grid_sample_bwd_plain(dy, G, 18, 20, mode), dtype)


@pytest.mark.cuda
def test_warp_kernels_raise_on_cuda_input_they_do_not_take(cuda):
    x, G = warp_inputs(cuda)
    with pytest.raises(ValueError, match="contiguous"):
        affine_warp(x.transpose(2, 3), G, 8, 8)
    with pytest.raises(ValueError, match="bfloat16"):
        affine_warp(x.half(), G, 8, 8)
    with pytest.raises(ValueError, match="G_inv"):
        affine_warp(x, G.double(), 8, 8)


@pytest.mark.cuda
def test_grads_through_k4_launch_k4_bwd_then_k4(cuda):
    """First order launches K4-bwd once; the second order launches K4 again."""
    x, G = warp_inputs(cuda)
    x.requires_grad_(True)
    k4, k4b = affine_warp.launches, affine_warp_bwd.launches
    y = affine_grid_sample(x, G, 11, 13)
    dx, = torch.autograd.grad(y.square().sum(), x, create_graph=True)
    assert (affine_warp.launches - k4, affine_warp_bwd.launches - k4b) == (1, 1)
    # d/dx of sum(dx^2) with dx = 2 K4bwd(K4(x)): K4 and K4-bwd once more each
    gx, = torch.autograd.grad(dx.square().sum(), x)
    torch.cuda.synchronize()
    assert (affine_warp.launches - k4, affine_warp_bwd.launches - k4b) == (2, 2)
    P, PT = affine_grid_sample_plain, affine_grid_sample_bwd_plain
    want = 8 * PT(P(PT(P(x.detach(), G, 11, 13), G, 18, 20), G, 11, 13), G, 18, 20)
    torch.testing.assert_close(gx, want, rtol=1e-4, atol=1e-4)
    # a non-contiguous incoming gradient is made contiguous before the launch
    dy = torch.randn(3, 5, 13, 11, device=cuda).transpose(2, 3)
    gx, = torch.autograd.grad(grid_sample._AffineWarp.apply(x, G, 11, 13, "reflect"), x, dy)
    torch.testing.assert_close(gx, PT(dy.contiguous(), G, 18, 20), rtol=1e-5, atol=1e-5)


def k4_bwd_maps(name):
    """[3, 3, 3] inverse maps past warp_inputs': a 4x zoom-in at 30 degrees,
    per-axis scales 4 and 1/4 (the ADA tails), and singular linear parts,
    which K4-bwd's gather takes by scanning the whole output grid."""
    c, s = np.cos(np.pi / 6) / 4, np.sin(np.pi / 6) / 4
    maps = {"zoom_in": [[[c, -s, 0.1], [s, c, -0.2]], [[c, s, -0.7], [-s, c, 0.6]],
                        [[0.25, 0, 0], [0, 0.25, 0]]],
            "aniso": [[[4, 0, 0.3], [0, 0.25, -0.1]], [[0.25, 0, -0.2], [0, 4, 0.5]],
                      [[0.24, -1.37, -0.4], [0.09, 3.76, 0.9]]],
            "singular": [[[1, 2, 0.1], [0.5, 1, -0.2]], [[0, 0, 0.3], [0, 0, -0.4]],
                         [[0, 1, 0], [0, 1, 0]]]}
    G = torch.eye(3).repeat(3, 1, 1)
    G[:, :2] = torch.tensor(maps[name], dtype=torch.float32)
    return G


def _rotation(scale, degrees, tx, ty):
    c, s = scale * np.cos(np.radians(degrees)), scale * np.sin(np.radians(degrees))
    return [[c, -s, tx], [s, c, ty]]


# K4's paths at small shapes (x shape, out_h, out_w, the linear parts of two
# inverse maps): several tiles that each stage every channel; zoom-outs of
# about 2x that stage 11 channels in double-buffered chunks; zoom-outs of
# about 4x whose boxes do not fit one channel twice (the direct path). Every
# width is a whole number of 16-byte chunks in both dtypes, so an aligned x
# takes the cp.async copy and a view one element in takes the element copy.
K4_PATHS = {
    "multi_tile": ((2, 5, 70, 96), 60, 80,
                   [_rotation(1.1, 20, 0.1, -0.05), [[0.9, 0.2, 0.0], [-0.1, 1.05, 0.2]]]),
    "chunked": ((2, 11, 96, 96), 64, 72,
                [_rotation(1.6, 30, 0.2, -0.1), _rotation(1.6, -25, -0.3, 0.15)]),
    "direct": ((2, 3, 128, 136), 40, 72,
               [_rotation(4, 45, 0.3, -0.2), _rotation(4, -40, -0.5, 0.4)]),
}


def k4_path_case(name):
    shape, out_h, out_w, maps = K4_PATHS[name]
    G = torch.eye(3).repeat(2, 1, 1)
    G[:, :2] = torch.tensor(maps, dtype=torch.float32)
    return shape, out_h, out_w, G


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["reflect", "zeros"])
@pytest.mark.parametrize("name", list(K4_PATHS))
def test_k4_path_cases_take_the_path_they_name(name, mode, dtype):
    """The plan (as the kernel computes it) sends the case's tiles down its
    path: all staged at once, some in chunks, some direct."""
    (_, C, H, W), out_h, out_w, G = k4_path_case(name)
    ch = grid_sample._warp_tile_boxes(G, H, W, out_h, out_w, mode, channels=C,
                                      itemsize=dtype.itemsize).channels
    assert ch.size > 2
    taken = {"multi_tile": (ch == C).all(), "chunked": ((ch > 0) & (ch < C)).any(),
             "direct": (ch == 0).any()}
    assert taken[name]


@pytest.mark.cuda
@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["reflect", "zeros"])
@pytest.mark.parametrize("name", list(K4_PATHS))
def test_k4_paths_equal_plain_to_the_bit_on_card(cuda, name, mode, dtype, aligned):
    shape, out_h, out_w, G = k4_path_case(name)
    G = G.to(cuda)
    x = torch.randn(shape, generator=torch.Generator(device=cuda).manual_seed(5),
                    device=cuda).to(dtype)
    if not aligned:
        x = torch.empty(x.numel() + 1, device=cuda, dtype=dtype)[1:].view(shape).copy_(x)
    k4 = affine_warp.launches
    y = affine_warp(x, G, out_h, out_w, mode)
    torch.cuda.synchronize()
    assert affine_warp.launches - k4 == 1
    assert torch.equal(y, affine_grid_sample_plain(x, G, out_h, out_w, mode))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["reflect", "zeros"])
@pytest.mark.parametrize("maps", ["zoom_in", "aniso", "singular"])
def test_k4_bwd_matches_plain_and_repeats_to_the_bit_on_card(cuda, maps, mode, dtype):
    G = k4_bwd_maps(maps).to(cuda)
    dy = torch.randn(3, 11, 11, 13, generator=torch.Generator(device=cuda).manual_seed(4),
                     device=cuda).to(dtype)
    dx = affine_warp_bwd(dy, G, 18, 20, mode)
    assert dx.dtype == dtype
    assert_close(dx, affine_grid_sample_bwd_plain(dy, G, 18, 20, mode), dtype)
    assert torch.equal(dx, affine_warp_bwd(dy, G, 18, 20, mode))


# ------------------------------------------ a reference .pkl and generate on the card

@pytest.mark.cuda
def test_reference_pkl_loads_and_generates_on_card(cuda, tmp_path):
    """io/legacy.py's import and `python -m stylegan_v_tpu_torch.generate` on
    the card, against the CPU (they launch none of the kernels above)."""
    from stylegan_v_tpu_torch import generate
    from stylegan_v_tpu_torch.models import Generator, GeneratorConfig
    from stylegan_v_tpu_torch.tools.ref_pickle import write_reference_pickle

    cfg = GeneratorConfig(w_dim=64, z_dim=64, img_resolution=32, channel_base=1024,
                          channel_max=64, num_bf16_res=0, mapping_layers=2)
    G = Generator(cfg, generator=torch.Generator().manual_seed(51))
    pkl = write_reference_pickle(str(tmp_path / "g.pkl"), G=G, G_ema=G)
    loaded = generate.load_any_checkpoint(pkl, cuda)
    for k, v in G.state_dict().items():
        assert torch.equal(loaded.state_dict()[k].cpu(), v), k
    argv = ["--network", pkl, "--num-videos", "4", "--video-len", "6", "--moco-decomposition"]
    launches = [k.launches for k in (downfirdn2d_x2, downfirdn2d_x2_bwd, affine_warp,
                                     affine_warp_bwd)]
    got = generate.main(argv + ["-o", str(tmp_path / "card"), "--device", "cuda"])
    want = generate.main(argv + ["-o", str(tmp_path / "cpu"), "--device", "cpu"])
    assert got.shape == want.shape == (4, 6, 32, 32, 3)
    assert float(np.abs(got - want).max()) <= 1e-3
    assert launches == [k.launches for k in (downfirdn2d_x2, downfirdn2d_x2_bwd, affine_warp,
                                             affine_warp_bwd)]
