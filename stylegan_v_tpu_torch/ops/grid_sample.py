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
`affine_warp_bwd(dy, G_inv, H, W, mode)` (K4-bwd) scatter-adds the output
gradient back into the image. On a CUDA tensor each launches its CUDA
kernel (csrc/affine_warp.cu, csrc/affine_warp_bwd.cu; float32 or bf16) or
raises; on a CPU tensor it runs its plain PyTorch version, which also takes
float64. Each launch adds one to the wrapper's `launches`.

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

import torch
import torch.nn.functional as F

from .cuda_build import DTYPE_CODES, check_launch, entry_point, on_cuda

MODES = {"reflect": 0, "zeros": 1}
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


def _sample_taps(G_inv: torch.Tensor, H: int, W: int, out_h: int, out_w: int, mode: str):
    """Per output pixel [N, out_h, out_w]: the clipped tap indices x0, x1, y0,
    y1 (int64), the weights wx, wy (float32) and the in-bounds mask (zeros
    mode; None in reflect mode). The geometry of csrc/affine_warp.cuh."""
    if mode not in MODES:
        raise ValueError(mode)
    G = G_inv.float()
    gy, gx = torch.meshgrid(_grid(out_h, G.device), _grid(out_w, G.device), indexing="ij")
    xin = G[:, 0, 0, None, None] * gx + G[:, 0, 1, None, None] * gy + G[:, 0, 2, None, None]
    yin = G[:, 1, 0, None, None] * gx + G[:, 1, 1, None, None] * gy + G[:, 1, 2, None, None]
    px = ((xin + 1.0) * W - 1.0) / 2.0
    py = ((yin + 1.0) * H - 1.0) / 2.0
    mask = None
    if mode == "reflect":
        px, py = _reflect_coords(px, W), _reflect_coords(py, H)
    else:
        mask = (px > -1.0) & (px < W) & (py > -1.0) & (py < H)
    x0, y0 = torch.floor(px), torch.floor(py)
    wx, wy = px - x0, py - y0
    x0i, y0i = x0.clamp(0, W - 1).long(), y0.clamp(0, H - 1).long()
    return x0i, (x0i + 1).clamp_max(W - 1), y0i, (y0i + 1).clamp_max(H - 1), wx, wy, mask


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
    """Launch the kernel of `wrapper` (its C entry point has the wrapper's name); count it."""
    name = wrapper.__name__
    if inp.dtype not in DTYPE_CODES:
        raise ValueError(f"{name} takes float32 or bfloat16, got {inp.dtype}")
    if not inp.is_contiguous():
        raise ValueError(f"{name} needs a contiguous NCHW tensor")
    if G_inv.device != inp.device or G_inv.dtype != torch.float32 or not G_inv.is_contiguous():
        raise ValueError(f"{name} needs G_inv as a contiguous float32 tensor on {inp.device}")
    N, C = inp.shape[:2]
    if N > 65535 or out_h > 65535:
        raise ValueError(f"{name} takes at most 65535 images and output rows")
    if out.numel() == 0:
        return
    fn = entry_point(name, _ARGTYPES)
    with torch.cuda.device(inp.device):
        stream = torch.cuda.current_stream(inp.device).cuda_stream
        err = fn(inp.data_ptr(), G_inv.data_ptr(), out.data_ptr(), DTYPE_CODES[inp.dtype],
                 MODES[mode], N, C, H, W, out_h, out_w, stream)
    check_launch(name, err)
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
    y = torch.empty((N, C, out_h, out_w), dtype=x.dtype, device=x.device)
    _launch(affine_warp, x, G_inv, y, mode, H, W, out_h, out_w)
    return y


affine_warp.launches = 0


def affine_warp_bwd(dy: torch.Tensor, G_inv: torch.Tensor, H: int, W: int,
                    mode: str = "reflect") -> torch.Tensor:
    """The adjoint of `affine_warp(., G_inv, out_h, out_w, mode)` for an
    H x W input: [N, C, out_h, out_w] -> [N, C, H, W] (K4-bwd). A CPU tensor
    goes to `affine_grid_sample_bwd_plain`; a CUDA tensor to the CUDA kernel,
    which sums into a float32 buffer (rounded once to bfloat16 for a bfloat16
    dy), or raises."""
    _check(dy, G_inv, mode, "affine_warp_bwd")
    if not on_cuda(dy, "affine_warp_bwd"):
        return affine_grid_sample_bwd_plain(dy, G_inv, H, W, mode)
    N, C, out_h, out_w = dy.shape
    dx = torch.zeros((N, C, H, W), dtype=torch.float32, device=dy.device)
    _launch(affine_warp_bwd, dy, G_inv, dx, mode, H, W, out_h, out_w)
    return dx.to(dy.dtype)


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
