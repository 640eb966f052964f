"""2-D convolution with optional FIR up/downsampling (NCHW / OIHW).

Counterpart of stylegan_v_tpu/ops/conv2d_resample.py (reference
src/torch_utils/ops/conv2d_resample.py). Padding is applied once, relative
to the UPSAMPLED image; the pipeline is
  zero-insert(up) -> FIR filter f -> pad -> conv w -> FIR filter f -> decimate(down)
with the reference's padding arithmetic (conv2d_resample.py:94-104).

`flip_weight=True` means correlation (F.conv2d's direction);
`flip_weight=False` flips the dense kernel spatially (true convolution).
Dense convolutions are `F.conv2d`.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..utils.misc import parse_padding
from .upfirdn2d import _filter_size, upfirdn2d


def _conv2d(x: torch.Tensor, w: torch.Tensor, stride: int = 1, padding=(0, 0, 0, 0),
            groups: int = 1, flip_weight: bool = True) -> torch.Tensor:
    """Dense conv, NCHW x OIHW -> NCHW. padding = (px0, px1, py0, py1); negative crops."""
    if not flip_weight:
        w = w.flip([2, 3])
    w = w.to(x.dtype)
    px0, px1, py0, py1 = padding
    if px0 == px1 >= 0 and py0 == py1 >= 0:     # symmetric: the conv pads itself
        return F.conv2d(x, w, stride=stride, padding=(py0, px0), groups=groups)
    return F.conv2d(F.pad(x, list(padding)), w, stride=stride, groups=groups)


def conv2d_resample(x: torch.Tensor, w: torch.Tensor, f=None, up: int = 1, down: int = 1,
                    padding=0, groups: int = 1, flip_weight: bool = True,
                    flip_filter: bool = False) -> torch.Tensor:
    """Conv with optional up/downsampling (reference conv2d_resample.py:59-154).

    Args:
        x:       [N, C_in, H, W].
        w:       [C_out, C_in // groups, kh, kw] (OIHW).
        f:       FIR filter from `setup_filter`, or None.
        up/down: integer resampling factors.
        padding: int / (px,py) / (px0,px1,py0,py1), w.r.t. the upsampled image.
    """
    assert x.ndim == 4 and w.ndim == 4
    _, _, kh, kw = w.shape
    fw, fh = _filter_size(f)
    px0, px1, py0, py1 = parse_padding(padding)
    assert isinstance(up, int) and isinstance(down, int) and up >= 1 and down >= 1

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

    # 1x1 conv + downsample: decimate first, convolve at low res.
    if kw == 1 and kh == 1 and down > 1 and up == 1:
        x = upfirdn2d(x, f, down=down, padding=[px0, px1, py0, py1], flip_filter=flip_filter)
        return _conv2d(x, w, groups=groups, flip_weight=flip_weight)

    # 1x1 conv + upsample: convolve at low res, then upsample.
    if kw == 1 and kh == 1 and up > 1 and down == 1:
        x = _conv2d(x, w, groups=groups, flip_weight=flip_weight)
        return upfirdn2d(x, f, up=up, padding=[px0, px1, py0, py1], gain=up ** 2,
                         flip_filter=flip_filter)

    # Downsample: FIR filter, then strided dense conv.
    if down > 1 and up == 1:
        x = upfirdn2d(x, f, padding=[px0, px1, py0, py1], flip_filter=flip_filter)
        return _conv2d(x, w, stride=down, groups=groups, flip_weight=flip_weight)

    # Upsample: zero-insert + FIR + pad, then the dense conv at high resolution.
    if up > 1:
        x = upfirdn2d(x, f, up=up, padding=[px0, px1, py0, py1], gain=up ** 2,
                      flip_filter=flip_filter)
        x = _conv2d(x, w, groups=groups, flip_weight=flip_weight)
        if down > 1:
            x = upfirdn2d(x, f, down=down, flip_filter=flip_filter)
        return x

    # Plain conv; asymmetric or negative padding goes through F.pad.
    return _conv2d(x, w, padding=(px0, px1, py0, py1), groups=groups,
                   flip_weight=flip_weight)
