"""upfirdn2d — pad, upsample, FIR-filter, downsample a batch of NCHW images.

PyTorch counterpart of stylegan_v_tpu/ops/upfirdn2d.py. Each filter pass is
one zero-insert upsample, one pad (negative crops) and one depthwise
`F.conv2d` whose stride does the decimation.

Semantics (reference upfirdn2d.py:120-158):
  1. Upsample by inserting up-1 zeros after each pixel.
  2. Pad with zeros (negative padding crops) — relative to the upsampled image.
  3. Convolve with the FIR filter f (flip_filter=False means true convolution).
  4. Downsample by keeping every down-th pixel (starting at 0).

Every pass goes through a hand-written kernel on a CUDA tensor (and its
plain version on a CPU tensor). One case takes the kernel pair K1 / K1-bwd:
up=1, down=2, a 4x4 filter and padding [1,1,1,1], with even H and W. It runs
`fir_kernels._DownFirX2`, whose forward is K1 (`downfirdn2d_x2`) and whose
backward is K1-bwd. Every other case runs `_UpFirDn2d`, whose forward is K2
(`upfirdn2d_kernel.upfirdn2d_k2`, one launch a call) and whose
backward is upfirdn2d again with the filter flipped, up and down swapped
and the padding mirrored (reference upfirdn2d.py:187-230), i.e. K2 again,
so every order of derivative is a forward FIR pass. Left to autograd, the
second order of a depthwise conv goes through PyTorch's generic
grouped-convolution double backward, which loops over the channels: R1 at
16 videos x 3 frames took 12 s a step that way on an H100. Inside
`upfirdn2d_kernel.aten_route()` (the export's route, and only the export's)
every case runs the plain version's ATen ops instead.

Filters are host constants: `setup_filter` returns a float32 CPU tensor, and
each call copies it to the device without a stream sync.
"""
from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import torch

from ..utils.misc import parse_padding, parse_scaling
from .fir_kernels import _DownFirX2
from .upfirdn2d_kernel import aten_route_active, k2_refusal, upfirdn2d_k2, upfirdn2d_k2_plain

Filter = Union[torch.Tensor, np.ndarray, Sequence[float], None]


def setup_filter(f: Filter, normalize: bool = True, flip_filter: bool = False,
                 gain: float = 1.0, separable: Optional[bool] = None) -> torch.Tensor:
    """Prepare a FIR filter: a float32 CPU tensor [fh, fw], or [taps] if separable."""
    if f is None:
        f = 1
    f = torch.as_tensor(np.asarray(f, dtype=np.float32))
    assert f.ndim in (0, 1, 2)
    assert f.numel() > 0
    if f.ndim == 0:
        f = f[None]

    if separable is None:
        separable = (f.ndim == 1 and f.numel() >= 8)
    if f.ndim == 1 and not separable:
        f = torch.outer(f, f)
    assert f.ndim == (1 if separable else 2)

    if normalize:
        f = f / f.sum()
    if flip_filter:
        f = f.flip(list(range(f.ndim)))
    f = f * (gain ** (f.ndim / 2))
    return f.contiguous()


def _filter_size(f: Filter):
    """Return (fw, fh)."""
    if f is None:
        return 1, 1
    fa = torch.as_tensor(f)
    assert fa.ndim in (1, 2)
    return int(fa.shape[-1]), int(fa.shape[0])


def _is_k1_case(x: torch.Tensor, f: torch.Tensor, up, down, padding) -> bool:
    return (f.shape == (4, 4) and up == [1, 1] and down == [2, 2]
            and padding == [1, 1, 1, 1] and x.shape[2] % 2 == 0 and x.shape[3] % 2 == 0)


def upfirdn2d(x: torch.Tensor, f: Filter, up=1, down=1, padding=0,
              flip_filter: bool = False, gain: float = 1.0) -> torch.Tensor:
    """Pad, upsample, filter, downsample (see module docstring).

    Args:
        x:       [N, C, H, W] float tensor.
        f:       FIR filter [fh, fw] (non-separable), [taps] (separable) or None.
        up:      int or (ux, uy) upsampling factor.
        down:    int or (dx, dy) downsampling factor.
        padding: int, (px, py) or (px0, px1, py0, py1), w.r.t. the upsampled image.
        flip_filter: False = convolution, True = correlation.
        gain:    overall magnitude scaling.
    """
    assert x.ndim == 4, f"expected NCHW, got shape {tuple(x.shape)}"
    up = parse_scaling(up)
    down = parse_scaling(down)
    padding = parse_padding(padding)
    f = torch.ones(1, 1) if f is None else torch.as_tensor(f, dtype=torch.float32)
    assert f.ndim in (1, 2)

    if aten_route_active():
        return upfirdn2d_k2_plain(x, f, up, down, padding, flip_filter, gain)
    if _is_k1_case(x, f, up, down, padding):
        # The kernel flips its filter (true convolution); pre-flip to correlate.
        fk = f.flip([0, 1]) if flip_filter else f
        return _DownFirX2.apply(x, fk if gain == 1 else fk * gain)
    return _UpFirDn2d.apply(x, f, up, down, padding, flip_filter, gain)


class _UpFirDn2d(torch.autograd.Function):
    """upfirdn2d with upfirdn2d as its gradient (the filter is a constant)."""

    @staticmethod
    def forward(ctx, x, f, up, down, padding, flip_filter, gain):
        ctx.args = f, up, down, padding, flip_filter, gain
        ctx.in_hw = x.shape[2:]
        return upfirdn2d_k2(x.contiguous(), f, up, down, padding, flip_filter, gain)

    @staticmethod
    def backward(ctx, dy):
        dx = _UpFirDn2d.apply(dy.contiguous(), *adjoint_args(*ctx.args, ctx.in_hw, dy.shape[2:]))
        return dx, None, None, None, None, None, None


def adjoint_args(f, up, down, padding, flip_filter, gain, in_hw, out_hw):
    """The (f, up, down, padding, flip_filter, gain) of the upfirdn2d that is
    the adjoint of upfirdn2d(., f, up, down, padding, flip_filter, gain) from
    in_hw to out_hw: the filter flipped, up and down swapped, the padding
    mirrored (reference upfirdn2d.py:187-230)."""
    (upx, upy), (downx, downy), (px0, _, py0, _) = up, down, padding
    (ih, iw), (oh, ow) = in_hw, out_hw
    fw, fh = _filter_size(f)
    p = [fw - px0 - 1, iw * upx - ow * downx + px0 - upx + 1,
         fh - py0 - 1, ih * upy - oh * downy + py0 - upy + 1]
    return f, [downx, downy], [upx, upy], p, not flip_filter, gain


def filter2d(x: torch.Tensor, f: Filter, padding=0, flip_filter: bool = False,
             gain: float = 1.0) -> torch.Tensor:
    """Filter with shape-preserving default padding (reference upfirdn2d.py:272-304)."""
    px0, px1, py0, py1 = parse_padding(padding)
    fw, fh = _filter_size(f)
    p = [px0 + fw // 2, px1 + (fw - 1) // 2, py0 + fh // 2, py1 + (fh - 1) // 2]
    return upfirdn2d(x, f, padding=p, flip_filter=flip_filter, gain=gain)


def upsample2d(x: torch.Tensor, f: Filter, up=2, padding=0, flip_filter: bool = False,
               gain: float = 1.0) -> torch.Tensor:
    """Upsample with a FIR filter (reference upfirdn2d.py:308-343)."""
    upx, upy = parse_scaling(up)
    px0, px1, py0, py1 = parse_padding(padding)
    fw, fh = _filter_size(f)
    p = [px0 + (fw + upx - 1) // 2, px1 + (fw - upx) // 2,
         py0 + (fh + upy - 1) // 2, py1 + (fh - upy) // 2]
    return upfirdn2d(x, f, up=up, padding=p, flip_filter=flip_filter, gain=gain * upx * upy)


def downsample2d(x: torch.Tensor, f: Filter, down=2, padding=0, flip_filter: bool = False,
                 gain: float = 1.0) -> torch.Tensor:
    """Downsample with a FIR filter (reference upfirdn2d.py:347-382)."""
    downx, downy = parse_scaling(down)
    px0, px1, py0, py1 = parse_padding(padding)
    fw, fh = _filter_size(f)
    p = [px0 + (fw - downx + 1) // 2, px1 + (fw - downx) // 2,
         py0 + (fh - downy + 1) // 2, py1 + (fh - downy) // 2]
    return upfirdn2d(x, f, down=down, padding=p, flip_filter=flip_filter, gain=gain)
