"""Hand-written Hopper kernels for the FIR resampling paths.

The PyTorch counterpart of stylegan_v_tpu/ops/pallas_kernels.py.

`downfirdn2d_x2(x, f)` (K1): fused 2x FIR downsample of an NCHW tensor with a
4x4 filter and padding 1 on each side, equal to `downsample2d(x, f)` for a
4-tap `setup_filter`. It is the upfirdn2d case of every resnet skip of the
Discriminator.

`downfirdn2d_x2_bwd(dy, f)` (K1-bwd): its adjoint, a 2x FIR upsample of
[N, C, H/2, W/2] to [N, C, H, W] with the same filter and gain 1. The JAX
package has no kernel for it: jax.grad derives it.

On a CUDA tensor each launches its CUDA kernel in csrc/ (see the note there)
or raises; on a CPU tensor it runs its plain PyTorch version (`*_plain`).

`_DownFirX2` and `_UpFirX2` are the pair of autograd Functions that make K1
differentiable to any order: K1's backward is K1-bwd and K1-bwd's backward
is K1. The filter is a host constant and takes no gradient.

Each kernel is built at first use by `cuda_build` (nvcc for sm_90a, ctypes).
Its launch geometry is `fir_plan`, computed here so that the CPU tests can
check that the tiles cover every output exactly once.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from .cuda_build import DTYPE_CODES, check_launch, entry_point, launch, on_cuda

_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int,
             ctypes.POINTER(ctypes.c_int64), ctypes.c_void_p)
_OCCUPANCY_ARGTYPES = (ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.POINTER(ctypes.c_int))
THREADS = 128          # threads a block aims at (at most FIR_MAX_THREADS, csrc/fir_tile.cuh)


class FirPlan(NamedTuple):
    """The launch geometry of K1 (kind "down") or K1-bwd ("up"); the field
    order is the int64 array the C entry points read (csrc/fir_tile.cuh).

    The tile grid is K1's output [planes, grid_h, grid_w] or K1-bwd's dy. A
    tile is planes_per_tile planes x tile_h x tile_w cells; tile t is
    (t // (tiles_w tiles_h), t // tiles_w % tiles_h, t % tiles_w) in
    (planes, rows, columns). Thread k of `threads` takes run_h rows x run_w
    columns at (k // (nx ny), k // nx % ny, k % nx) in runs; what falls
    outside the grid is masked. The tile reads its window, win_h x win_w
    source elements per plane from row scale*h0 - 1 and column
    scale*w0 - pad, in `chunk`-element copies (cpr a row), each row
    row_stride elements apart in shared memory (K1 with vec swizzles the
    chunks of a row and holds an even number of them); the magic and
    shift pairs divide by cpr and win_h (`fast_div_magic`). `grid` blocks
    walk over the tiles, each holding two stages of stage_bytes."""
    planes: int
    src_h: int
    src_w: int
    grid_h: int
    grid_w: int
    vec: int
    scale: int
    run_h: int
    run_w: int
    planes_per_tile: int
    tile_h: int
    tile_w: int
    nx: int
    ny: int
    threads: int
    tiles_p: int
    tiles_h: int
    tiles_w: int
    tiles: int
    grid: int
    pad: int
    win_h: int
    win_w: int
    row_stride: int
    chunk: int
    cpr: int
    cpr_magic: int
    cpr_shift: int
    winh_magic: int
    winh_shift: int
    stage_bytes: int


def fast_div_magic(d: int) -> Tuple[int, int]:
    """(magic, shift) with n // d == ((n * magic >> 32) + n) >> shift for
    0 <= n < 2**31, as csrc/fir_tile.cuh:fast_div computes it."""
    shift = (d - 1).bit_length()
    return ((1 << 32) * ((1 << shift) - d)) // d + 1, shift


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def fir_plan(kind: str, planes: int, src_h: int, src_w: int, itemsize: int, vec: bool,
             resident: int) -> FirPlan:
    """The tile plan of K1 ("down": x [planes, src_h, src_w]) or K1-bwd ("up":
    dy [planes, src_h, src_w]) for `itemsize`-byte elements. With vec, every
    row is whole 16-byte vectors: copies and stores go 16 bytes at a time.
    `resident` is the number of blocks the card holds at once."""
    v = 16 // itemsize                       # elements in 16 bytes
    if kind == "down":                       # a thread: 2 output rows x 16 bytes
        scale, grid_h, grid_w, run_w = 2, src_h // 2, src_w // 2, v
    elif kind == "up":                       # a thread: 2 dy rows x 16/2 bytes of quads
        scale, grid_h, grid_w, run_w = 1, src_h, src_w, v // 2
    else:
        raise ValueError(f"kind is 'down' or 'up', got {kind!r}")
    run_h = 2
    tile_w = min(_ceil_div(grid_w, run_w) * run_w, 16 * run_w)
    nx = tile_w // run_w
    tile_h = min(_ceil_div(grid_h, run_h) * run_h, run_h * max(1, THREADS // nx))
    ny = tile_h // run_h
    whole = tile_h >= grid_h and tile_w >= grid_w          # pack small planes
    per_tile = max(1, min(planes, THREADS // (nx * ny))) if whole else 1
    pad, chunk = (v, v) if vec else (1, 1)
    win_h, win_w = scale * tile_h + 2, scale * tile_w + 2 * pad
    tiles_p, tiles_h = _ceil_div(planes, per_tile), _ceil_div(grid_h, tile_h)
    tiles_w = _ceil_div(grid_w, tile_w)
    tiles = tiles_p * tiles_h * tiles_w
    cpr = win_w // chunk
    row_stride = win_w + chunk * (cpr % 2) if vec and kind == "down" else win_w
    stage_bytes = _ceil_div(per_tile * win_h * row_stride * itemsize, 16) * 16
    return FirPlan(planes, src_h, src_w, grid_h, grid_w, int(vec), scale, run_h, run_w,
                   per_tile, tile_h, tile_w, nx, ny, per_tile * nx * ny, tiles_p, tiles_h,
                   tiles_w, tiles, min(tiles, resident), pad, win_h, win_w, row_stride, chunk,
                   cpr, *fast_div_magic(cpr), *fast_div_magic(win_h), stage_bytes)


_TAPS_BY_TENSOR: dict = {}


def _taps(name: str, f):
    """The 4x4 filter f, flipped, as the ctypes array the entry points take;
    for a tensor, remembered by its identity and version, so that the same
    filter costs no host work on the next launch."""
    if isinstance(f, torch.Tensor):
        hit = _TAPS_BY_TENSOR.get(id(f))
        if hit is not None and hit[0] is f and hit[1] == f._version:
            return hit[2]
    t = torch.as_tensor(f, dtype=torch.float32).detach().cpu()
    if tuple(t.shape) != (4, 4):
        raise ValueError(f"{name} needs a 4x4 filter, got {tuple(t.shape)}")
    taps = (ctypes.c_float * 16)(*_flipped_filter(t).reshape(-1).tolist())
    if isinstance(f, torch.Tensor):
        if len(_TAPS_BY_TENSOR) >= 64:
            _TAPS_BY_TENSOR.clear()
        _TAPS_BY_TENSOR[id(f)] = (f, f._version, taps)   # holds f: its id stays unique
    return taps


@functools.lru_cache(maxsize=None)
def _launch_plan(name: str, planes: int, H: int, W: int, dtype: torch.dtype, vec: bool,
                 device: int):
    """fir_plan for csrc/<name>.cu, with the grid the card holds at once, as
    the int64 array its entry point takes."""
    kind = "down" if name == "downfirdn2d_x2" else "up"
    plan = fir_plan(kind, planes, H, W, dtype.itemsize, vec, resident=1)
    blocks = ctypes.c_int(0)
    occupancy = entry_point(name, _OCCUPANCY_ARGTYPES, f"{name}_occupancy")
    with torch.cuda.device(device):
        check_launch(f"{name}_occupancy", occupancy(DTYPE_CODES[dtype], int(vec), plan.threads,
                                                    plan.stage_bytes, ctypes.byref(blocks)))
    if blocks.value < 1:
        raise RuntimeError(f"{name}: no block of {plan.threads} threads and "
                           f"{2 * plan.stage_bytes} bytes of shared memory fits an SM")
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    plan = plan._replace(grid=min(plan.tiles, blocks.value * sms))
    return (ctypes.c_int64 * len(plan))(*plan)


def _flipped_filter(f) -> torch.Tensor:
    """The 4x4 filter as float32, flipped in both axes (true convolution)."""
    f = torch.as_tensor(f, dtype=torch.float32)
    if tuple(f.shape) != (4, 4):
        raise ValueError(f"downfirdn2d_x2 needs a 4x4 filter, got {tuple(f.shape)}")
    return f.flip([0, 1])


def _check_input(x: torch.Tensor) -> None:
    if x.ndim != 4:
        raise ValueError(f"downfirdn2d_x2 needs NCHW, got shape {tuple(x.shape)}")
    if x.shape[2] % 2 or x.shape[3] % 2:
        raise ValueError(f"downfirdn2d_x2 needs even H and W, got {tuple(x.shape)}")


def _launch(wrapper, inp: torch.Tensor, out: torch.Tensor, f) -> None:
    """Launch the kernel of `wrapper` (its C entry point has the wrapper's name)
    from inp into out, over inp's N*C planes; count it."""
    name = wrapper.__name__
    if inp.dtype not in DTYPE_CODES:
        raise ValueError(f"{name} takes float32 or bfloat16, got {inp.dtype}")
    if not inp.is_contiguous():
        raise ValueError(f"{name} needs a contiguous NCHW tensor")
    if out.numel() == 0:
        return
    taps = _taps(name, f)
    N, C, H, W = inp.shape
    small_w = W if name == "downfirdn2d_x2_bwd" else W // 2   # K1's output, K1-bwd's input
    vec = small_w % (16 // inp.element_size()) == 0 and inp.data_ptr() % 16 == 0
    device = inp.device.index
    args = (inp.data_ptr(), out.data_ptr(), taps, DTYPE_CODES[inp.dtype],
            _launch_plan(name, N * C, H, W, inp.dtype, vec, device))
    launch(name, entry_point(name, _ARGTYPES), args, device)
    wrapper.launches += 1


def downfirdn2d_x2_plain(x: torch.Tensor, f) -> torch.Tensor:
    """Plain PyTorch version: pad 1, depthwise stride-2 conv with the flipped
    filter, in float32, cast back to x's dtype."""
    _check_input(x)
    fk = _flipped_filter(f).to(x.device, non_blocking=True)
    C = x.shape[1]
    y = F.conv2d(F.pad(x.float(), [1, 1, 1, 1]), fk[None, None].expand(C, 1, 4, 4),
                 stride=2, groups=C)
    return y.to(x.dtype)


def downfirdn2d_x2(x: torch.Tensor, f) -> torch.Tensor:
    """Fused FIR 2x downsample, NCHW, 4x4 filter, padding 1 on each side.

    A CPU tensor goes to `downfirdn2d_x2_plain`. A CUDA tensor (float32 or
    bfloat16, contiguous) goes to the CUDA kernel, or raises; each launch adds
    one to `downfirdn2d_x2.launches`. f is a host tensor or array; a CUDA
    filter is copied to the host first. No autograd graph: `_DownFirX2`
    carries the gradient.
    """
    _check_input(x)
    if not on_cuda(x, "downfirdn2d_x2"):
        return downfirdn2d_x2_plain(x, f)
    N, C, H, W = x.shape
    y = torch.empty((N, C, H // 2, W // 2), dtype=x.dtype, device=x.device)
    _launch(downfirdn2d_x2, x, y, f)
    return y


downfirdn2d_x2.launches = 0


def downfirdn2d_x2_bwd_plain(dy: torch.Tensor, f) -> torch.Tensor:
    """Plain PyTorch version of K1's adjoint: a depthwise stride-2 transposed
    conv with the flipped filter, in float32, cast back to dy's dtype. The
    upfirdn2d form is upfirdn2d(dy, f, up=2, padding=[2,1,2,1], flip_filter=True)."""
    if dy.ndim != 4:
        raise ValueError(f"downfirdn2d_x2_bwd needs NCHW, got shape {tuple(dy.shape)}")
    fk = _flipped_filter(f).to(dy.device, non_blocking=True)
    C = dy.shape[1]
    dx = F.conv_transpose2d(dy.float(), fk[None, None].expand(C, 1, 4, 4), stride=2,
                            padding=1, groups=C)
    return dx.to(dy.dtype)


def downfirdn2d_x2_bwd(dy: torch.Tensor, f) -> torch.Tensor:
    """The adjoint of `downfirdn2d_x2(., f)`: [N, C, Ho, Wo] -> [N, C, 2Ho, 2Wo].

    A CPU tensor goes to `downfirdn2d_x2_bwd_plain`. A CUDA tensor (float32 or
    bfloat16, contiguous) goes to the CUDA kernel, or raises; each launch adds
    one to `downfirdn2d_x2_bwd.launches`.
    """
    if dy.ndim != 4:
        raise ValueError(f"downfirdn2d_x2_bwd needs NCHW, got shape {tuple(dy.shape)}")
    if not on_cuda(dy, "downfirdn2d_x2_bwd"):
        return downfirdn2d_x2_bwd_plain(dy, f)
    N, C, Ho, Wo = dy.shape
    dx = torch.empty((N, C, 2 * Ho, 2 * Wo), dtype=dy.dtype, device=dy.device)
    _launch(downfirdn2d_x2_bwd, dy, dx, f)
    return dx


downfirdn2d_x2_bwd.launches = 0


class _DownFirX2(torch.autograd.Function):
    """K1 with a gradient: forward `downfirdn2d_x2`, backward `_UpFirX2`.

    Both directions launch on the current stream, which the autograd engine
    sets to the forward's stream for the backward. An incoming gradient may
    be non-contiguous (cuDNN's need not be), so it is made contiguous first.
    """

    @staticmethod
    def forward(ctx, x: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
        ctx.f = f
        return downfirdn2d_x2(x, f)

    @staticmethod
    def backward(ctx, dy: torch.Tensor):
        return _UpFirX2.apply(dy.contiguous(), ctx.f), None


class _UpFirX2(torch.autograd.Function):
    """K1-bwd with a gradient: forward `downfirdn2d_x2_bwd`, backward `_DownFirX2`."""

    @staticmethod
    def forward(ctx, dy: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
        ctx.f = f
        return downfirdn2d_x2_bwd(dy, f)

    @staticmethod
    def backward(ctx, ddx: torch.Tensor):
        return _DownFirX2.apply(ddx.contiguous(), ctx.f), None
