"""I3D (Inflated Inception-V1, Kinetics-400): the FVD feature extractor.

Counterpart of stylegan_v_tpu/metrics/detectors_flax/i3d.py, in NCDHW (time is
the depth axis). The parameters carry pytorch_i3d's names
(`Conv3d_1a_7x7.conv3d.weight`, `Mixed_3b.b1a.bn.running_mean`, ...), the
names `convert_i3d_state_dict` reads, so the state_dict of the reference's
TorchScript file loads into it (`load_i3d_state_dict`). The FVD feature is
the 1024-d average-pooled pre-logits activation.

  * Every conv and max pool pads as TF's SAME does, more at the end: an
    explicit `F.pad` before each (a max pool pads with -inf).
  * Batch norm uses the running stats with eps 1e-3.
  * The head's VALID (2, 7, 7) average pool is clamped to the extent it
    finds, so an input below 224^2 still gives a mean over a non-empty
    window (at 224^2 the clamp changes nothing).
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .common import batch_norm, features_fn, pad_same
from .resize import bilinear_resize

MIXED_CHANNELS = {
    "Mixed_3b": (64, 96, 128, 16, 32, 32),
    "Mixed_3c": (128, 128, 192, 32, 96, 64),
    "Mixed_4b": (192, 96, 208, 16, 48, 64),
    "Mixed_4c": (160, 112, 224, 24, 64, 64),
    "Mixed_4d": (128, 128, 256, 24, 64, 64),
    "Mixed_4e": (112, 144, 288, 32, 64, 64),
    "Mixed_4f": (256, 160, 320, 32, 128, 128),
    "Mixed_5b": (256, 160, 320, 32, 128, 128),
    "Mixed_5c": (384, 192, 384, 48, 128, 128),
}


def _out_channels(ch: Tuple[int, ...]) -> int:
    return ch[0] + ch[2] + ch[4] + ch[5]


class Unit3D(nn.Module):
    """SAME-padded conv3d, then batch norm and ReLU (pytorch_i3d's Unit3D)."""

    def __init__(self, in_channels: int, out_channels: int, kernel=(1, 1, 1),
                 stride=(1, 1, 1), use_bn: bool = True, activation: bool = True,
                 use_bias: bool = False):
        super().__init__()
        self.kernel, self.stride, self.activation = tuple(kernel), tuple(stride), activation
        self.conv3d = nn.Conv3d(in_channels, out_channels, kernel, stride, bias=use_bias)
        self.bn = nn.BatchNorm3d(out_channels, eps=1e-3) if use_bn else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv3d(pad_same(x, self.kernel, self.stride))
        if self.bn is not None:
            y = batch_norm(y, self.bn)
        return F.relu(y) if self.activation else y


def _maxpool3d_same(x: torch.Tensor, kernel, stride) -> torch.Tensor:
    return F.max_pool3d(pad_same(x, kernel, stride, value=float("-inf")), kernel, stride)


class InceptionMixed(nn.Module):
    """An inflated GoogLeNet block: branches b0, b1a-b1b, b2a-b2b, max pool-b3b."""

    def __init__(self, in_channels: int, ch: Tuple[int, int, int, int, int, int]):
        super().__init__()
        self.b0 = Unit3D(in_channels, ch[0])
        self.b1a = Unit3D(in_channels, ch[1])
        self.b1b = Unit3D(ch[1], ch[2], kernel=(3, 3, 3))
        self.b2a = Unit3D(in_channels, ch[3])
        self.b2b = Unit3D(ch[3], ch[4], kernel=(3, 3, 3))
        self.b3b = Unit3D(in_channels, ch[5])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([self.b0(x), self.b1b(self.b1a(x)), self.b2b(self.b2a(x)),
                          self.b3b(_maxpool3d_same(x, (3, 3, 3), (1, 1, 1)))], dim=1)


class InceptionI3d(nn.Module):
    """forward(videos [N, 3, T, H, W] in [-1, 1]) -> [N, 1024] features, or the
    400-way logits with return_features=False."""

    def __init__(self, num_classes: int = 400):
        super().__init__()
        self.Conv3d_1a_7x7 = Unit3D(3, 64, (7, 7, 7), (2, 2, 2))
        self.Conv3d_2b_1x1 = Unit3D(64, 64)
        self.Conv3d_2c_3x3 = Unit3D(64, 192, (3, 3, 3))
        in_ch = 192
        for name, ch in MIXED_CHANNELS.items():
            setattr(self, name, InceptionMixed(in_ch, ch))
            in_ch = _out_channels(ch)
        self.logits = Unit3D(in_ch, num_classes, use_bn=False, activation=False,
                             use_bias=True)

    def forward(self, x: torch.Tensor, return_features: bool = True) -> torch.Tensor:
        x = self.Conv3d_1a_7x7(x)
        x = _maxpool3d_same(x, (1, 3, 3), (1, 2, 2))
        x = self.Conv3d_2b_1x1(x)
        x = self.Conv3d_2c_3x3(x)
        x = _maxpool3d_same(x, (1, 3, 3), (1, 2, 2))
        x = self.Mixed_3b(x)
        x = self.Mixed_3c(x)
        x = _maxpool3d_same(x, (3, 3, 3), (2, 2, 2))
        for name in ("Mixed_4b", "Mixed_4c", "Mixed_4d", "Mixed_4e", "Mixed_4f"):
            x = getattr(self, name)(x)
        x = _maxpool3d_same(x, (2, 2, 2), (2, 2, 2))
        x = self.Mixed_5b(x)
        x = self.Mixed_5c(x)
        # VALID (2, 7, 7) average, stride 1, clamped to the extent, then the mean
        win = (min(2, x.shape[2]), min(7, x.shape[3]), min(7, x.shape[4]))
        x = F.avg_pool3d(x, win, stride=1)
        if return_features:
            return x.mean(dim=(2, 3, 4))
        return self.logits(x).mean(dim=(2, 3, 4))


def load_i3d_state_dict(model: InceptionI3d, state_dict: Mapping[str, torch.Tensor]) -> None:
    """Load a pytorch_i3d state_dict (a TorchScript file's included) with strict
    names, after stripping any wrapper prefix before the block names, as
    `convert_i3d_state_dict` does."""
    out: Dict[str, torch.Tensor] = {}
    for raw_name, val in state_dict.items():
        name = raw_name.split(".")
        while name and not name[0].startswith(("Conv3d_", "Mixed_", "logits")):
            name = name[1:]
        if name:
            out[".".join(name)] = val
    model.load_state_dict(out)


def i3d_features_fn(model: InceptionI3d, batch_size: int = 16,
                    device: Optional[torch.device] = None, rescale: bool = True,
                    resize: bool = True, return_features: bool = True):
    """features(videos uint8 [N, T, H, W, C], numpy or a tensor) -> np [N, 1024].

    rescale, resize and return_features are the TorchScript module's own
    forward kwargs, which the reference passes for FVD: rescale maps [0, 255]
    to [-1, 1] by x*2/255-1; resize is a half-pixel bilinear resize of each
    frame to 224^2 without antialiasing."""
    def compute(v: torch.Tensor) -> torch.Tensor:
        x = v.float()
        if rescale:
            x = x * (2.0 / 255.0) - 1.0
        x = x.permute(0, 4, 1, 2, 3)                     # NTHWC -> NCTHW
        if resize:
            x = bilinear_resize(x, 224, 224, h_axis=3, w_axis=4, mapping="half_pixel")
        return model(x, return_features=return_features)

    return features_fn(model, compute, batch_size, device)
