"""The detectors' bilinear resizes, on the tensor's device.

Counterpart of stylegan_v_tpu/metrics/detectors_flax/resize.py. The
reference's detector TorchScripts resize inside the module, with two
bilinear conventions, neither with antialiasing:

  * `half_pixel`: torch `F.interpolate(align_corners=False)`,
    src = (dst + 0.5) * in/out - 0.5. The I3D's 224^2 and the C3D's 112^2.
  * `asymmetric`: TF1 `resize_bilinear(align_corners=False)`,
    src = dst * in/out. The Inception's 299^2.

Each axis is a gather of the two source rows and a lerp, with the indices and
weights of `linear_resize_weights` (a copy of the JAX package's), computed
once on the host and kept on the device per (sizes, mapping, device).
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch


def linear_resize_weights(in_size: int, out_size: int, mapping: str
                          ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-output-pixel (idx0, idx1, weight-of-idx1) for 1-D linear resize."""
    dst = np.arange(out_size, dtype=np.float64)
    scale = in_size / out_size
    if mapping == "half_pixel":          # torch align_corners=False
        src = (dst + 0.5) * scale - 0.5
    elif mapping == "asymmetric":        # TF1 align_corners=False
        src = dst * scale
    else:
        raise ValueError(f"unknown mapping '{mapping}'")
    src = np.clip(src, 0.0, in_size - 1)
    i0 = np.floor(src).astype(np.int32)
    i1 = np.minimum(i0 + 1, in_size - 1).astype(np.int32)
    w1 = (src - i0).astype(np.float32)
    return i0, i1, w1


_WEIGHTS: Dict[tuple, Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = {}


def _device_weights(in_size: int, out_size: int, mapping: str, device: torch.device):
    key = (in_size, out_size, mapping, str(device))
    if key not in _WEIGHTS:
        i0, i1, w1 = linear_resize_weights(in_size, out_size, mapping)
        _WEIGHTS[key] = (torch.from_numpy(i0.astype(np.int64)).to(device),
                         torch.from_numpy(i1.astype(np.int64)).to(device),
                         torch.from_numpy(w1).to(device))
    return _WEIGHTS[key]


def _resize_axis(x: torch.Tensor, out_size: int, axis: int, mapping: str) -> torch.Tensor:
    in_size = x.shape[axis]
    if in_size == out_size:
        return x
    i0, i1, w1 = _device_weights(in_size, out_size, mapping, x.device)
    shape = [1] * x.ndim
    shape[axis] = out_size
    w1 = w1.reshape(shape)
    # torch computes w0*x0 + w1*x1 with w0 = 1 - w1, as the JAX package does
    return x.index_select(axis, i0) * (1.0 - w1) + x.index_select(axis, i1) * w1


def bilinear_resize(x: torch.Tensor, out_h: int, out_w: int, h_axis: int, w_axis: int,
                    mapping: str = "half_pixel") -> torch.Tensor:
    """Bilinear resize of two axes of a float tensor of any rank, no antialiasing
    (H first, then W, as the JAX package's)."""
    x = _resize_axis(x, out_h, h_axis, mapping)
    return _resize_axis(x, out_w, w_axis, mapping)
