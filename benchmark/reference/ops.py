"""The plain operations under the reference models: FIR resampling, bias and
activation, convolution with resampling, modulated convolution and the
augment pipe's bilinear warp. Plain PyTorch only: no kernel of the
benchmarked package, nothing imported from it.

A frozen copy of the benchmarked package's plain paths (its ops/ and
utils/misc.py). Every FIR pass takes its taps rounded to its input's dtype,
sums in float32 and rounds its output to that dtype, as the plain version's
conv does (bfloat16 in the top resolutions and the augment pipe, so the pipe's
12-tap filter is bfloat16 and a separable call rounds between its passes).
`upfirdn2d` also records each call in the active `fir_calls()` list: the
benchmark counts the bytes of the program's resampling from those records,
on the meta device.
"""
from __future__ import annotations

import contextlib
import math
from typing import Any, Iterator, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F


# ------------------------------------------------------------------ helpers

class EasyDict(dict):
    """dict with attribute access."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name)


def assert_shape(x: torch.Tensor, ref_shape: Sequence[Optional[int]]) -> None:
    """Assert that a tensor matches the given shape; None entries are wildcards."""
    if x.ndim != len(ref_shape):
        raise AssertionError(f"Wrong number of dimensions: got {x.ndim}, expected {len(ref_shape)}")
    for idx, (size, ref_size) in enumerate(zip(x.shape, ref_shape)):
        if ref_size is not None and int(size) != int(ref_size):
            raise AssertionError(f"Wrong size for dimension {idx}: got {size}, expected {ref_size}")


def parse_scaling(scaling) -> List[int]:
    if isinstance(scaling, int):
        scaling = [scaling, scaling]
    sx, sy = scaling
    assert sx >= 1 and sy >= 1
    return [int(sx), int(sy)]


def parse_padding(padding) -> List[int]:
    if isinstance(padding, int):
        padding = [padding, padding]
    padding = list(padding)
    if len(padding) == 2:
        px, py = padding
        padding = [px, px, py, py]
    return [int(p) for p in padding]


def normal_param(shape, generator: Optional[torch.Generator],
                 std: float = 1.0) -> torch.nn.Parameter:
    """float32 parameter ~ N(0, std^2) from `generator`; uninitialised
    without one (the benchmark fills every weight from its seed)."""
    if generator is None:
        return torch.nn.Parameter(torch.empty(shape, dtype=torch.float32))
    return torch.nn.Parameter(torch.randn(shape, generator=generator) * std)


# ------------------------------------------------------------- FIR filters

def setup_filter(f, normalize: bool = True, flip_filter: bool = False,
                 gain: float = 1.0, separable: Optional[bool] = None) -> torch.Tensor:
    """A FIR filter as a float32 CPU tensor [fh, fw], or [taps] if separable."""
    if f is None:
        f = 1
    f = torch.as_tensor(np.asarray(f, dtype=np.float32), device="cpu")
    if f.ndim == 0:
        f = f[None]
    if separable is None:
        separable = (f.ndim == 1 and f.numel() >= 8)
    if f.ndim == 1 and not separable:
        f = torch.outer(f, f)
    if normalize:
        f = f / f.sum()
    if flip_filter:
        f = f.flip(list(range(f.ndim)))
    f = f * (gain ** (f.ndim / 2))
    return f.contiguous()


def _filter_size(f) -> Tuple[int, int]:
    """(fw, fh)."""
    if f is None:
        return 1, 1
    fa = torch.as_tensor(f)
    return int(fa.shape[-1]), int(fa.shape[0])


class FirCall(NamedTuple):
    """One upfirdn2d call: its input and output shapes and dtype."""
    in_shape: Tuple[int, ...]
    out_shape: Tuple[int, ...]
    dtype: torch.dtype


_RECORDERS: List[List[FirCall]] = []


@contextlib.contextmanager
def fir_calls() -> Iterator[List[FirCall]]:
    """Inside, every upfirdn2d call (forward and every order of its
    adjoint) is appended to the list this yields."""
    calls: List[FirCall] = []
    _RECORDERS.append(calls)
    try:
        yield calls
    finally:
        _RECORDERS.remove(calls)


class _Pass(NamedTuple):
    k: torch.Tensor
    up: Tuple[int, int]
    down: Tuple[int, int]
    pad: Tuple[int, int, int, int]


def _passes(f: torch.Tensor, up, down, padding, flip_filter: bool, gain: float) -> List[_Pass]:
    f = torch.as_tensor(f, dtype=torch.float32)
    if not flip_filter:
        f = f.flip(list(range(f.ndim)))
    up, down, padding = tuple(up), tuple(down), tuple(padding)
    if f.ndim == 2:
        return [_Pass(f * gain, up, down, padding)]
    px0, px1, py0, py1 = padding
    g = float(np.sqrt(gain))
    return [_Pass((f * g)[None, :], (up[0], 1), (down[0], 1), (px0, px1, 0, 0)),
            _Pass((f * g)[:, None], (1, up[1]), (1, down[1]), (0, 0, py0, py1))]


def _depthwise_pass(x: torch.Tensor, p: _Pass) -> torch.Tensor:
    """Zero-insert, pad (negative crops), depthwise conv whose stride decimates."""
    (upx, upy), (downx, downy), (px0, px1, py0, py1) = p.up, p.down, p.pad
    N, C, H, W = x.shape
    if upx > 1 or upy > 1:
        x = x.reshape(N, C, H, 1, W, 1)
        x = F.pad(x, [0, upx - 1, 0, 0, 0, upy - 1])
        x = x.reshape(N, C, H * upy, W * upx)
    x = F.pad(x, [px0, px1, py0, py1])
    kernel = p.k.to(x.device, x.dtype)[None, None].expand(C, 1, *p.k.shape)
    return F.conv2d(x, kernel, stride=(downy, downx), groups=C)


def _upfirdn2d_plain(x: torch.Tensor, f, up, down, padding, flip_filter, gain) -> torch.Tensor:
    """Each pass as the plain version's conv takes it: the taps rounded to
    x's dtype, a float32 sum, the output rounded to x's dtype."""
    y = x
    for p in _passes(f, up, down, padding, flip_filter, gain):
        taps = p.k.to(x.dtype).float()
        y = _depthwise_pass(y.float(), p._replace(k=taps)).to(x.dtype)
    return y


def _adjoint_args(f, up, down, padding, flip_filter, gain, in_hw, out_hw):
    (upx, upy), (downx, downy), (px0, _, py0, _) = up, down, padding
    (ih, iw), (oh, ow) = in_hw, out_hw
    fw, fh = _filter_size(f)
    p = [fw - px0 - 1, iw * upx - ow * downx + px0 - upx + 1,
         fh - py0 - 1, ih * upy - oh * downy + py0 - upy + 1]
    return f, [downx, downy], [upx, upy], p, not flip_filter, gain


class _UpFirDn2d(torch.autograd.Function):
    """upfirdn2d with upfirdn2d as its gradient (the filter is a constant),
    so every order of derivative is a forward pass."""

    @staticmethod
    def forward(ctx, x, f, up, down, padding, flip_filter, gain):
        ctx.args = f, up, down, padding, flip_filter, gain
        ctx.in_hw = x.shape[2:]
        y = _upfirdn2d_plain(x, f, up, down, padding, flip_filter, gain)
        for calls in _RECORDERS:
            calls.append(FirCall(tuple(x.shape), tuple(y.shape), x.dtype))
        return y

    @staticmethod
    def backward(ctx, dy):
        dx = _UpFirDn2d.apply(dy.contiguous(),
                              *_adjoint_args(*ctx.args, ctx.in_hw, dy.shape[2:]))
        return dx, None, None, None, None, None, None


def upfirdn2d(x: torch.Tensor, f, up=1, down=1, padding=0, flip_filter: bool = False,
              gain: float = 1.0) -> torch.Tensor:
    """Upsample by zero insertion, pad, FIR-filter, downsample (NCHW)."""
    assert x.ndim == 4
    f = torch.ones(1, 1) if f is None else torch.as_tensor(f, dtype=torch.float32)
    return _UpFirDn2d.apply(x, f, parse_scaling(up), parse_scaling(down),
                            parse_padding(padding), flip_filter, gain)


def upsample2d(x: torch.Tensor, f, up=2, padding=0, flip_filter: bool = False,
               gain: float = 1.0) -> torch.Tensor:
    upx, upy = parse_scaling(up)
    px0, px1, py0, py1 = parse_padding(padding)
    fw, fh = _filter_size(f)
    p = [px0 + (fw + upx - 1) // 2, px1 + (fw - upx) // 2,
         py0 + (fh + upy - 1) // 2, py1 + (fh - upy) // 2]
    return upfirdn2d(x, f, up=up, padding=p, flip_filter=flip_filter, gain=gain * upx * upy)


def downsample2d(x: torch.Tensor, f, down=2, padding=0, flip_filter: bool = False,
                 gain: float = 1.0) -> torch.Tensor:
    downx, downy = parse_scaling(down)
    px0, px1, py0, py1 = parse_padding(padding)
    fw, fh = _filter_size(f)
    p = [px0 + (fw - downx + 1) // 2, px1 + (fw - downx) // 2,
         py0 + (fh - downy + 1) // 2, py1 + (fh - downy) // 2]
    return upfirdn2d(x, f, down=down, padding=p, flip_filter=flip_filter, gain=gain)


# ---------------------------------------------------- bias and activation

class _LeakyReLU(torch.autograd.Function):
    """F.leaky_relu's value with gradient g * where(x >= 0, 1, alpha); linear
    in g, so a second order differentiates it again, and 0 in x."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, alpha: float) -> torch.Tensor:
        ctx.save_for_backward(x)
        ctx.alpha = alpha
        return F.leaky_relu(x, alpha)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        x, = ctx.saved_tensors
        step = torch.heaviside(x.detach(), torch.ones((), dtype=x.dtype))
        return torch.ops.aten.leaky_relu_backward(g, step, ctx.alpha, False), None


def leaky_relu(x: torch.Tensor, alpha: float = 0.2) -> torch.Tensor:
    return _LeakyReLU.apply(x, float(alpha))


activation_funcs = {
    'linear': EasyDict(func=lambda x, **_: x, def_alpha=0.0, def_gain=1.0),
    'lrelu': EasyDict(func=lambda x, alpha, **_: leaky_relu(x, alpha),
                      def_alpha=0.2, def_gain=math.sqrt(2)),
}


def bias_act(x: torch.Tensor, b: Optional[torch.Tensor] = None, dim: int = 1,
             act: str = 'linear', alpha: Optional[float] = None,
             gain: Optional[float] = None, clamp: Optional[float] = None) -> torch.Tensor:
    """Bias-add, activation, gain, clamp (the clamp's gradient one half at a bound)."""
    spec = activation_funcs[act]
    alpha = float(spec.def_alpha) if alpha is None else float(alpha)
    gain = float(spec.def_gain) if gain is None else float(gain)
    if b is not None:
        shape = [1] * x.ndim
        shape[dim] = -1
        x = x + b.reshape(shape).to(x.dtype)
    x = spec.func(x, alpha=alpha)
    if gain != 1.0:
        x = x * float(torch.tensor(gain, dtype=x.dtype))
    if clamp is not None:
        bound = torch.tensor(float(clamp), dtype=x.dtype)
        x = torch.minimum(torch.maximum(x, -bound), bound)
    return x


# ------------------------------------------------------------ convolutions

def _conv2d(x: torch.Tensor, w: torch.Tensor, stride: int = 1, padding=(0, 0, 0, 0),
            groups: int = 1, flip_weight: bool = True) -> torch.Tensor:
    if not flip_weight:
        w = w.flip([2, 3])
    w = w.to(x.dtype)
    px0, px1, py0, py1 = padding
    if px0 == px1 >= 0 and py0 == py1 >= 0:
        return F.conv2d(x, w, stride=stride, padding=(py0, px0), groups=groups)
    return F.conv2d(F.pad(x, list(padding)), w, stride=stride, groups=groups)


def conv2d_resample(x: torch.Tensor, w: torch.Tensor, f=None, up: int = 1, down: int = 1,
                    padding=0, groups: int = 1, flip_weight: bool = True,
                    flip_filter: bool = False) -> torch.Tensor:
    """Conv with optional FIR up/downsampling (reference conv2d_resample.py:59-154)."""
    _, _, kh, kw = w.shape
    fw, fh = _filter_size(f)
    px0, px1, py0, py1 = parse_padding(padding)
    if up > 1:
        px0 += (fw + up - 1) // 2
        px1 += (fw - up) // 2
        py0 += (fh + up - 1) // 2
        py1 += (fh - up) // 2
    if down > 1:
        px0 += (fw - down + 1) // 2
        px1 += (fw - down) // 2
        py0 += (fh - down + 1) // 2
        py1 += (fh - down) // 2
    if kw == 1 and kh == 1 and down > 1 and up == 1:
        x = upfirdn2d(x, f, down=down, padding=[px0, px1, py0, py1], flip_filter=flip_filter)
        return _conv2d(x, w, groups=groups, flip_weight=flip_weight)
    if kw == 1 and kh == 1 and up > 1 and down == 1:
        x = _conv2d(x, w, groups=groups, flip_weight=flip_weight)
        return upfirdn2d(x, f, up=up, padding=[px0, px1, py0, py1], gain=up ** 2,
                         flip_filter=flip_filter)
    if down > 1 and up == 1:
        x = upfirdn2d(x, f, padding=[px0, px1, py0, py1], flip_filter=flip_filter)
        return _conv2d(x, w, stride=down, groups=groups, flip_weight=flip_weight)
    if up > 1:
        x = upfirdn2d(x, f, up=up, padding=[px0, px1, py0, py1], gain=up ** 2,
                      flip_filter=flip_filter)
        x = _conv2d(x, w, groups=groups, flip_weight=flip_weight)
        if down > 1:
            x = upfirdn2d(x, f, down=down, flip_filter=flip_filter)
        return x
    return _conv2d(x, w, padding=(px0, px1, py0, py1), groups=groups, flip_weight=flip_weight)


def modulated_conv2d(x: torch.Tensor, weight: torch.Tensor, styles: torch.Tensor,
                     noise: Optional[torch.Tensor] = None, up: int = 1, down: int = 1,
                     padding: int = 0, resample_filter=None, demodulate: bool = True,
                     flip_weight: bool = True) -> torch.Tensor:
    """StyleGAN2's modulated conv as activation scalings around one shared-weight conv."""
    x = x * styles.to(x.dtype)[:, :, None, None]
    x = conv2d_resample(x=x, w=weight.to(x.dtype), f=resample_filter, up=up, down=down,
                        padding=padding, flip_weight=flip_weight)
    if demodulate:
        wsum = weight.float().square().sum(dim=(2, 3))
        d = torch.rsqrt(styles.float().square() @ wsum.t() + 1e-8)
        x = x * d.to(x.dtype)[:, :, None, None]
    if noise is not None:
        x = x + noise.to(x.dtype)
    return x


# ---------------------------------------------------------- bilinear warp

def _reflect_coords(px: torch.Tensor, size: int) -> torch.Tensor:
    u = px + 0.5
    v = torch.remainder(u, 2.0 * size)
    v = size - torch.abs(size - v)
    return v - 0.5


def _grid(n: int, device) -> torch.Tensor:
    i = torch.arange(n, dtype=torch.float32, device=device)
    return (2.0 * i + 1.0) / torch.full((), float(n), device=device) - 1.0


def _sample_taps(G_inv: torch.Tensor, H: int, W: int, out_h: int, out_w: int):
    """Per output pixel: the clipped taps x0, x1, y0, y1 and the weights wx, wy
    of the mirrored bilinear sample."""
    G = G_inv.float()
    gy, gx = torch.meshgrid(_grid(out_h, G.device), _grid(out_w, G.device), indexing="ij")
    xin = G[:, 0, 0, None, None] * gx + G[:, 0, 1, None, None] * gy + G[:, 0, 2, None, None]
    yin = G[:, 1, 0, None, None] * gx + G[:, 1, 1, None, None] * gy + G[:, 1, 2, None, None]
    px = _reflect_coords(((xin + 1.0) * W - 1.0) / 2.0, W)
    py = _reflect_coords(((yin + 1.0) * H - 1.0) / 2.0, H)
    x0, y0 = torch.floor(px), torch.floor(py)
    wx, wy = px - x0, py - y0
    x0i, y0i = x0.clamp(0, W - 1).long(), y0.clamp(0, H - 1).long()
    return x0i, (x0i + 1).clamp_max(W - 1), y0i, (y0i + 1).clamp_max(H - 1), wx, wy


def _warp(x: torch.Tensor, G_inv: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Gather the four taps of every output pixel, sum in float32, round once."""
    N, C, H, W = x.shape
    x0, x1, y0, y1, wx, wy = _sample_taps(G_inv, H, W, out_h, out_w)
    xf = x.float().reshape(N, C, H * W)
    P = out_h * out_w

    def tap(yi, xi):
        return xf.gather(2, (yi * W + xi).reshape(N, 1, P).expand(N, C, P)).reshape(
            N, C, out_h, out_w)

    wx, wy = wx[:, None], wy[:, None]
    top = tap(y0, x0) * (1 - wx) + tap(y0, x1) * wx
    bot = tap(y1, x0) * (1 - wx) + tap(y1, x1) * wx
    return (top * (1 - wy) + bot * wy).to(x.dtype)


def _warp_t(dy: torch.Tensor, G_inv: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """The transpose of `_warp`: each gradient times its four weights,
    scatter-added into its taps in float32, rounded once."""
    N, C, out_h, out_w = dy.shape
    x0, x1, y0, y1, wx, wy = _sample_taps(G_inv, H, W, out_h, out_w)
    d = dy.float()
    wx, wy = wx[:, None], wy[:, None]
    dtop, dbot = d * (1 - wy), d * wy
    dx = torch.zeros(N, C, H * W, dtype=torch.float32, device=dy.device)
    P = out_h * out_w
    for yi, xi, contrib in ((y0, x0, dtop * (1 - wx)), (y0, x1, dtop * wx),
                            (y1, x0, dbot * (1 - wx)), (y1, x1, dbot * wx)):
        dx.scatter_add_(2, (yi * W + xi).reshape(N, 1, P).expand(N, C, P),
                        contrib.reshape(N, C, P))
    return dx.reshape(N, C, H, W).to(dy.dtype)


class _Warp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, G_inv, out_h, out_w):
        ctx.save_for_backward(G_inv)
        ctx.hw = x.shape[2], x.shape[3]
        return _warp(x, G_inv, out_h, out_w)

    @staticmethod
    def backward(ctx, dy):
        G_inv, = ctx.saved_tensors
        return _WarpT.apply(dy.contiguous(), G_inv, *ctx.hw), None, None, None


class _WarpT(torch.autograd.Function):
    @staticmethod
    def forward(ctx, dy, G_inv, H, W):
        ctx.save_for_backward(G_inv)
        ctx.hw = dy.shape[2], dy.shape[3]
        return _warp_t(dy, G_inv, H, W)

    @staticmethod
    def backward(ctx, ddx):
        G_inv, = ctx.saved_tensors
        return _Warp.apply(ddx.contiguous(), G_inv, *ctx.hw), None, None, None


def affine_grid_sample(x: torch.Tensor, G_inv: torch.Tensor, out_h: int, out_w: int,
                       mode: str = "reflect") -> torch.Tensor:
    """Warp x [N, C, H, W] by the inverse maps G_inv [N, 3, 3] with mirrored
    bilinear sampling, differentiable in x to any order."""
    if mode != "reflect":
        raise ValueError("the reference warps in reflect mode only")
    return _Warp.apply(x, G_inv, out_h, out_w)
