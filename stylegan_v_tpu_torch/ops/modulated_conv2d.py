"""StyleGAN2 modulated convolution in the activation-scaling form.

Counterpart of stylegan_v_tpu/ops/modulated_conv2d.py. Modulation and
demodulation are per-sample diagonal scalings, so

    demod_o * conv(w * style_i, x) == demod_o * conv(w, style_i * x)

i.e. scale activations by styles, run ONE shared-weight conv, then scale by
the demodulation coefficients, computed without per-sample weights:

    dcoef[n,o] = rsqrt( sum_i styles[n,i]^2 * wsum[o,i] + 1e-8 ),
    wsum[o,i]  = sum_kh,kw w[o,i,kh,kw]^2
"""
from __future__ import annotations

from typing import Optional

import torch

from ..utils.misc import assert_shape
from .conv2d_resample import conv2d_resample


def modulated_conv2d(
    x: torch.Tensor,                      # [N, I, H, W] input activations.
    weight: torch.Tensor,                 # [O, I, kh, kw] shared conv weight (OIHW).
    styles: torch.Tensor,                 # [N, I] per-sample modulation.
    noise: Optional[torch.Tensor] = None,  # optional [N, 1, H', W']-broadcastable noise.
    up: int = 1,
    down: int = 1,
    padding: int = 0,
    resample_filter=None,                 # from upfirdn2d.setup_filter.
    demodulate: bool = True,
    flip_weight: bool = True,
) -> torch.Tensor:
    N = x.shape[0]
    out_channels, in_channels, kh, kw = weight.shape
    assert_shape(x, [N, in_channels, None, None])
    assert_shape(styles, [N, in_channels])

    x = x * styles.to(x.dtype)[:, :, None, None]
    x = conv2d_resample(x=x, w=weight.to(x.dtype), f=resample_filter, up=up, down=down,
                        padding=padding, flip_weight=flip_weight)

    if demodulate:
        wsum = weight.float().square().sum(dim=(2, 3))                        # [O, I]
        d = torch.rsqrt(styles.float().square() @ wsum.t() + 1e-8)            # [N, O]
        x = x * d.to(x.dtype)[:, :, None, None]
    if noise is not None:          # after demodulation, as the reference's fma
        x = x + noise.to(x.dtype)
    return x
