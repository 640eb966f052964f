"""InceptionV3 (TF's 'inception-2015-12-05' FID network): the FID, KID and IS
feature extractor.

Counterpart of stylegan_v_tpu/metrics/detectors_flax/inception_v3.py, in
NCHW. The 2048-d features are the global average of the last block ('pool3');
the 1008-way head is `output`. Batch norm uses the running stats with eps
1e-3. The 3x3 average pools of the blocks divide by the taps inside the image
(`count_include_pad=False`), as the JAX package's SAME reduce-window and the
TF graph do.

The module registers its conv units in the order they run, the order
`convert_inception_state_dict` walks, and `load_inception_state_dict` loads a
file's tensors by that order and their shapes, as the JAX package's converter
does: NVIDIA's TorchScript transcription names its tensors its own way.
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Optional

import torch
import torch.nn.functional as F
from torch import nn

from .common import batch_norm, features_fn, pad_same
from .resize import bilinear_resize


class ConvBN(nn.Module):
    """conv (no bias), batch norm from running stats, ReLU; padding 'VALID' or 'SAME'."""

    def __init__(self, in_channels: int, out_channels: int, kernel=(1, 1), stride=(1, 1),
                 padding: str = "VALID"):
        super().__init__()
        self.kernel, self.stride, self.same = tuple(kernel), tuple(stride), padding == "SAME"
        self.conv = nn.Conv2d(in_channels, out_channels, kernel, stride, bias=False)
        self.bn = nn.BatchNorm2d(out_channels, eps=1e-3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.same:
            x = pad_same(x, self.kernel, self.stride)
        return F.relu(batch_norm(self.conv(x), self.bn))


def _maxpool(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, 3, 2)


def _avgpool3_same(x: torch.Tensor) -> torch.Tensor:
    return F.avg_pool2d(x, 3, 1, padding=1, count_include_pad=False)


class MixedA(nn.Module):
    """35x35 block (TF mixed, mixed_1, mixed_2)."""

    def __init__(self, ci: int, pool_ch: int):
        super().__init__()
        self.b0 = ConvBN(ci, 64)
        self.b1a = ConvBN(ci, 48)
        self.b1b = ConvBN(48, 64, (5, 5), padding="SAME")
        self.b2a = ConvBN(ci, 64)
        self.b2b = ConvBN(64, 96, (3, 3), padding="SAME")
        self.b2c = ConvBN(96, 96, (3, 3), padding="SAME")
        self.b3b = ConvBN(ci, pool_ch)

    def forward(self, x):
        return torch.cat([self.b0(x), self.b1b(self.b1a(x)), self.b2c(self.b2b(self.b2a(x))),
                          self.b3b(_avgpool3_same(x))], dim=1)


class MixedB(nn.Module):
    """17x17 reduction (TF mixed_3)."""

    def __init__(self, ci: int):
        super().__init__()
        self.b0 = ConvBN(ci, 384, (3, 3), (2, 2))
        self.b1a = ConvBN(ci, 64)
        self.b1b = ConvBN(64, 96, (3, 3), padding="SAME")
        self.b1c = ConvBN(96, 96, (3, 3), (2, 2))

    def forward(self, x):
        return torch.cat([self.b0(x), self.b1c(self.b1b(self.b1a(x))), _maxpool(x)], dim=1)


class MixedC(nn.Module):
    """17x17 factorised-7x7 block (TF mixed_4 to mixed_7)."""

    def __init__(self, ci: int, m: int):
        super().__init__()
        self.b0 = ConvBN(ci, 192)
        self.b1a = ConvBN(ci, m)
        self.b1b = ConvBN(m, m, (1, 7), padding="SAME")
        self.b1c = ConvBN(m, 192, (7, 1), padding="SAME")
        self.b2a = ConvBN(ci, m)
        self.b2b = ConvBN(m, m, (7, 1), padding="SAME")
        self.b2c = ConvBN(m, m, (1, 7), padding="SAME")
        self.b2d = ConvBN(m, m, (7, 1), padding="SAME")
        self.b2e = ConvBN(m, 192, (1, 7), padding="SAME")
        self.b3b = ConvBN(ci, 192)

    def forward(self, x):
        b2 = self.b2e(self.b2d(self.b2c(self.b2b(self.b2a(x)))))
        return torch.cat([self.b0(x), self.b1c(self.b1b(self.b1a(x))), b2,
                          self.b3b(_avgpool3_same(x))], dim=1)


class MixedD(nn.Module):
    """8x8 reduction (TF mixed_8)."""

    def __init__(self, ci: int):
        super().__init__()
        self.b0a = ConvBN(ci, 192)
        self.b0b = ConvBN(192, 320, (3, 3), (2, 2))
        self.b1a = ConvBN(ci, 192)
        self.b1b = ConvBN(192, 192, (1, 7), padding="SAME")
        self.b1c = ConvBN(192, 192, (7, 1), padding="SAME")
        self.b1d = ConvBN(192, 192, (3, 3), (2, 2))

    def forward(self, x):
        return torch.cat([self.b0b(self.b0a(x)), self.b1d(self.b1c(self.b1b(self.b1a(x)))),
                          _maxpool(x)], dim=1)


class MixedE(nn.Module):
    """8x8 expanded block (TF mixed_9, mixed_10)."""

    def __init__(self, ci: int):
        super().__init__()
        self.b0 = ConvBN(ci, 320)
        self.b1a = ConvBN(ci, 384)
        self.b1b1 = ConvBN(384, 384, (1, 3), padding="SAME")
        self.b1b2 = ConvBN(384, 384, (3, 1), padding="SAME")
        self.b2a = ConvBN(ci, 448)
        self.b2b = ConvBN(448, 384, (3, 3), padding="SAME")
        self.b2c1 = ConvBN(384, 384, (1, 3), padding="SAME")
        self.b2c2 = ConvBN(384, 384, (3, 1), padding="SAME")
        self.b3b = ConvBN(ci, 192)

    def forward(self, x):
        b1 = self.b1a(x)
        b2 = self.b2b(self.b2a(x))
        return torch.cat([self.b0(x), self.b1b1(b1), self.b1b2(b1), self.b2c1(b2),
                          self.b2c2(b2), self.b3b(_avgpool3_same(x))], dim=1)


class InceptionV3(nn.Module):
    """forward(images [N, 3, 299, 299] in [-1, 1]) -> [N, 2048] features, or the
    1008-way logits (without the bias when no_output_bias) with
    return_features=False."""

    def __init__(self, num_classes: int = 1008):
        super().__init__()
        self.conv = ConvBN(3, 32, (3, 3), (2, 2))
        self.conv_1 = ConvBN(32, 32, (3, 3))
        self.conv_2 = ConvBN(32, 64, (3, 3), padding="SAME")
        self.conv_3 = ConvBN(64, 80)
        self.conv_4 = ConvBN(80, 192, (3, 3))
        self.mixed = MixedA(192, 32)
        self.mixed_1 = MixedA(256, 64)
        self.mixed_2 = MixedA(288, 64)
        self.mixed_3 = MixedB(288)
        self.mixed_4 = MixedC(768, 128)
        self.mixed_5 = MixedC(768, 160)
        self.mixed_6 = MixedC(768, 160)
        self.mixed_7 = MixedC(768, 192)
        self.mixed_8 = MixedD(768)
        self.mixed_9 = MixedE(1280)
        self.mixed_10 = MixedE(2048)
        self.output = nn.Linear(2048, num_classes)

    def forward(self, x: torch.Tensor, return_features: bool = True,
                no_output_bias: bool = False) -> torch.Tensor:
        x = self.conv_2(self.conv_1(self.conv(x)))
        x = _maxpool(x)
        x = self.conv_4(self.conv_3(x))
        x = _maxpool(x)
        for i in range(11):
            x = getattr(self, "mixed" if i == 0 else f"mixed_{i}")(x)
        feats = x.mean(dim=(2, 3))                    # global average 'pool3'
        if return_features:
            return feats
        return F.linear(feats, self.output.weight, None if no_output_bias else self.output.bias)


def load_inception_state_dict(model: InceptionV3, tensors: Mapping[str, torch.Tensor]) -> None:
    """Load a torch InceptionV3's tensors by order and shape, as
    `convert_inception_state_dict` maps them: each 4-D weight opens a conv
    unit, the 1-D tensors of its channel count that follow are its batch norm,
    units are assigned to the module's ConvBNs in the order they run (a unit
    whose shape does not match is skipped, as an auxiliary head's), and the
    head is the 2-D tensor with a 2048 feature axis and its bias."""
    groups: List[Dict[str, torch.Tensor]] = []
    cur: Dict[str, torch.Tensor] = {}
    for name, val in tensors.items():
        leaf = name.split(".")[-1]
        if leaf == "weight" and val.ndim == 4:
            if cur:
                groups.append(cur)
            cur = {"conv.weight": val}
            continue
        if cur and val.ndim == 1 and val.shape[0] == cur["conv.weight"].shape[0]:
            key = {"weight": "bn.weight", "bias": "bn.bias", "running_mean": "bn.running_mean",
                   "running_var": "bn.running_var"}.get(leaf)
            if key is not None:
                cur[key] = val
    if cur:
        groups.append(cur)

    units = [m for m in model.modules() if isinstance(m, ConvBN)]
    gi = 0
    for unit in units:
        shape = unit.conv.weight.shape
        while gi < len(groups) and groups[gi]["conv.weight"].shape != shape:
            gi += 1
        if gi == len(groups):
            raise KeyError(f"no source tensor for a conv of shape {tuple(shape)}")
        g = groups[gi]
        gi += 1
        unit.bn.reset_parameters()          # what the source lacks stays the identity
        unit.load_state_dict(g, strict=False)

    nc = None
    for val in tensors.values():
        if val.ndim == 2 and 2048 in val.shape and tuple(val.shape) != (2048, 2048):
            w = val if val.shape[1] == 2048 else val.T
            nc = w.shape[0]
            model.output = nn.Linear(2048, nc).to(model.output.weight.device)
            with torch.no_grad():
                model.output.weight.copy_(w)
                model.output.bias.zero_()
    if nc is not None:
        for name, val in tensors.items():
            if val.ndim == 1 and val.shape == (nc,) and name.split(".")[-1] == "bias":
                with torch.no_grad():
                    model.output.bias.copy_(val)


def inception_features_fn(model: InceptionV3, batch_size: int = 64,
                          device: Optional[torch.device] = None,
                          return_features: bool = False, no_output_bias: bool = False):
    """features(images uint8 [N, H, W, C], numpy or a tensor) -> np [N, 2048]
    features, or [N, 1008] softmax probabilities with return_features=False.

    The TF graph's preprocessing on raw uint8, as the reference invokes it:
    an asymmetric (TF1) bilinear resize of the 0..255 values to 299^2 without
    antialiasing, then -128, then x 1/128."""
    def compute(v: torch.Tensor) -> torch.Tensor:
        x = bilinear_resize(v.float(), 299, 299, h_axis=1, w_axis=2, mapping="asymmetric")
        x = ((x - 128.0) * (1.0 / 128.0)).permute(0, 3, 1, 2)
        out = model(x, return_features=return_features, no_output_bias=no_output_bias)
        return out if return_features else torch.softmax(out, dim=-1)

    return features_fn(model, compute, batch_size, device)
