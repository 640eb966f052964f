"""What the three detectors share: TF "SAME" padding, batch norm from running
stats, seeded random weights, and the batched feature function that runs a
detector on its device."""
from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...utils.misc import float32_precision


def same_pad(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """TF-style SAME padding (low, high) of one axis."""
    out = -(-size // stride)
    pad = max(0, (out - 1) * stride + kernel - size)
    return pad // 2, pad - pad // 2


def pad_same(x: torch.Tensor, kernel, stride, value: float = 0.0) -> torch.Tensor:
    """Pad the trailing len(kernel) axes of x as TF's SAME does (more at the end)."""
    pads = [same_pad(s, k, st) for s, k, st in zip(x.shape[-len(kernel):], kernel, stride)]
    flat = [p for pair in reversed(pads) for p in pair]       # F.pad: last axis first
    return F.pad(x, flat, value=value) if any(flat) else x


def batch_norm(y: torch.Tensor, bn: nn.modules.batchnorm._BatchNorm) -> torch.Tensor:
    """Inference batch norm from the running stats, whatever the module's mode."""
    return F.batch_norm(y, bn.running_mean, bn.running_var, bn.weight, bn.bias,
                        training=False, eps=bn.eps)


@torch.no_grad()
def random_init_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded random weights for a detector whose file is absent: every conv and
    linear weight normal with variance 2/fan_in (He), so that the features keep
    their scale through the ReLUs; biases 0, batch norms the identity."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Conv3d, nn.Linear)):
            fan_in = m.weight[0].numel()
            w = torch.randn(m.weight.shape, generator=generator) * math.sqrt(2.0 / fan_in)
            m.weight.copy_(w)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.modules.batchnorm._BatchNorm):
            m.reset_parameters()
    return module


def features_fn(model: nn.Module, compute: Callable[[torch.Tensor], torch.Tensor],
                batch_size: int, device: Optional[torch.device] = None) -> Callable:
    """features(x) -> np.ndarray [N, D] float32, with x a uint8 batch as numpy or
    as a tensor on any device. `compute` maps one batch, on the model's device,
    to its features. Runs in batches of `batch_size` under inference mode with
    TF32 off; `features.on_device` tells the metric loops that a batch may stay
    on the card."""
    device = torch.device(device) if device is not None else next(model.parameters()).device
    model = model.to(device).eval()

    def features(x) -> np.ndarray:
        x = torch.from_numpy(np.asarray(x)) if not isinstance(x, torch.Tensor) else x
        out = []
        with torch.inference_mode(), float32_precision(False):
            for i in range(0, len(x), batch_size):
                out.append(compute(x[i:i + batch_size].to(device)).float().cpu())
        return torch.cat(out).numpy()

    features.on_device = True
    return features
