"""Stand-ins for the reference's detector TorchScript files, for tests and smoke runs.

    write_standin("i3d", "detectors/i3d_torchscript.pt", example, kwargs, seed=0)

The reference's `i3d_torchscript.pt`, `inception-2015-12-05.pt` and
`c3d_ucf101.pt` are not in the repository. A stand-in has what the metrics
and validate_detectors.py need of one: a scripted forward that takes the raw
uint8 batch (channels first) with the reference's keyword arguments and does
its own preprocessing, and a state_dict that the port's loaders map into the
port's modules (metrics/metric_utils.py:_port_detector).

Its network is the port's module with seeded random weights
(`random_init_`), traced (torch.jit.trace_module) at the shape that the
preprocessing gives the example batch: every batch it is called with must
preprocess to that shape, or it raises. The preprocessing is written here
with torch ops of its own, not the port's resizes: F.interpolate for the
half-pixel resizes of the I3D (224^2) and the C3D (112^2), index arithmetic
for the Inception's TF1 resize to 299^2.

`miswired=True` (the I3D only) traces a network whose Mixed_4d block runs
its b1a weights as b0 and its b0 weights as b1a (both 1x1 convolutions to
128 channels): a file whose state_dict names one conv's weight wrongly, which
the detector gate must refuse. Nothing here is a user feature: no CLI
exposes it.
"""
from __future__ import annotations

import types
import warnings
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# the TorchScript's file name for each canonical detector (metric_utils.DETECTOR_FILES)
NAMES = ("i3d", "inception", "c3d_ucf101")


def _resize_tf1(x: torch.Tensor, out: int, dim: int) -> torch.Tensor:
    """TF1 bilinear (align_corners=False, no half pixel): src = dst * in / out."""
    n = x.shape[dim]
    if n == out:
        return x
    src = (torch.arange(out, dtype=torch.float64) * (n / out)).clamp(0.0, n - 1.0)
    i0 = src.floor().long()
    i1 = (i0 + 1).clamp(max=n - 1)
    shape = [1] * x.dim()
    shape[dim] = out
    w = (src - i0.double()).float().view(shape).to(x.device)
    a = x.index_select(dim, i0.to(x.device))
    return a + (x.index_select(dim, i1.to(x.device)) - a) * w


class I3DStandin(nn.Module):
    """forward(videos uint8 [N, 3, T, H, W], rescale, resize, return_features):
    features, or the logits head on them."""

    def __init__(self, net, size: List[int]):
        super().__init__()
        self.net, self.size = net, size

    @staticmethod
    def preprocess(x: torch.Tensor, rescale: bool, resize: bool) -> torch.Tensor:
        y = x.float()
        if rescale:
            y = y * (2.0 / 255.0) - 1.0
        if resize:
            y = F.interpolate(y, size=[y.shape[2], 224, 224], mode="trilinear",
                              align_corners=False)
        return y

    def forward(self, x: torch.Tensor, rescale: bool = False, resize: bool = False,
                return_features: bool = False) -> torch.Tensor:
        y = self.preprocess(x, rescale, resize)
        if list(y.shape[1:]) != self.size:
            raise RuntimeError("the stand-in was traced at another input shape")
        feats = self.net.features(y)
        if return_features:
            return feats
        head = self.net.model.logits.conv3d           # 1x1x1: the pooled map's mean commutes
        return F.linear(feats, head.weight.flatten(1), head.bias)


class InceptionStandin(nn.Module):
    """forward(images uint8 [N, 3, H, W], return_features, no_output_bias):
    features, or softmax probabilities of the head on them."""

    def __init__(self, net, size: List[int]):
        super().__init__()
        self.net, self.size = net, size

    @staticmethod
    def preprocess(x: torch.Tensor) -> torch.Tensor:
        y = _resize_tf1(_resize_tf1(x.float(), 299, 2), 299, 3)
        return (y - 128.0) / 128.0

    def forward(self, x: torch.Tensor, return_features: bool = False,
                no_output_bias: bool = False) -> torch.Tensor:
        y = self.preprocess(x)
        if list(y.shape[1:]) != self.size:
            raise RuntimeError("the stand-in was traced at another input shape")
        feats = self.net.features(y)
        if return_features:
            return feats
        head = self.net.model.output
        logits = F.linear(feats, head.weight, None if no_output_bias else head.bias)
        return torch.softmax(logits, dim=-1)


class C3DStandin(nn.Module):
    """forward(videos uint8 [N, 3, T, H, W]) -> class probabilities, with the
    mean cube as the buffer `mean` [3, 16, 112, 112]."""

    def __init__(self, net, size: List[int], mean: torch.Tensor):
        super().__init__()
        self.net, self.size = net, size
        self.register_buffer("mean", mean.clone())

    @staticmethod
    def preprocess(x: torch.Tensor, mean: torch.Tensor) -> torch.Tensor:
        y = F.interpolate(x.float(), size=[x.shape[2], 112, 112], mode="trilinear",
                          align_corners=False)
        m = mean if y.shape[2] == mean.shape[1] else mean.mean(dim=1, keepdim=True)
        return y - m

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.preprocess(x, self.mean)
        if list(y.shape[1:]) != self.size:
            raise RuntimeError("the stand-in was traced at another input shape")
        return self.net.probs(y)


class _Methods(nn.Module):
    """The port's module under the methods a stand-in calls, for trace_module."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def features(self, x):
        return self.model(x, return_features=True)

    def probs(self, x):
        return self.model(x)


def _miswired_mixed(self, x: torch.Tensor) -> torch.Tensor:
    """InceptionMixed.forward with b0 and b1a exchanged."""
    from ..metrics.detectors.i3d import _maxpool3d_same
    return torch.cat([self.b1a(x), self.b1b(self.b0(x)), self.b2b(self.b2a(x)),
                      self.b3b(_maxpool3d_same(x, (3, 3, 3), (1, 1, 1)))], dim=1)


def port_module(name: str, seed: int) -> nn.Module:
    """The port's detector module for `name` with random_init_ weights from `seed`."""
    from ..metrics import detectors as det
    model = {"i3d": det.InceptionI3d, "inception": det.InceptionV3, "c3d_ucf101": det.C3D}[name]()
    return det.random_init_(model, torch.Generator().manual_seed(seed)).eval()


@torch.no_grad()
def write_standin(name: str, path: str, example: np.ndarray, kwargs: Dict,
                  seed: int = 0, miswired: bool = False) -> str:
    """Write the stand-in TorchScript for detector `name` to `path`: the port's
    module with weights from `seed`, traced at what `example` (uint8, channels
    last, as validate_detectors.fixture_inputs gives it) preprocesses to under
    the reference kwargs `kwargs`. Returns `path`."""
    if miswired and name != "i3d":
        raise ValueError("only the I3D stand-in can be miswired")
    model = port_module(name, seed)
    if miswired:
        model.Mixed_4d.forward = types.MethodType(_miswired_mixed, model.Mixed_4d)
    x = torch.from_numpy(np.ascontiguousarray(example[:1]))
    x = x.permute(0, 4, 1, 2, 3) if x.ndim == 5 else x.permute(0, 3, 1, 2)
    if name == "i3d":
        y = I3DStandin.preprocess(x, kwargs.get("rescale", False), kwargs.get("resize", False))
        methods = ("features",)
    elif name == "inception":
        y = InceptionStandin.preprocess(x)
        methods = ("features",)
    else:
        y = C3DStandin.preprocess(x, model.mean)
        methods = ("probs",)
    with warnings.catch_warnings():     # shapes become constants: valid at this one shape
        warnings.simplefilter("ignore", torch.jit.TracerWarning)
        net = torch.jit.trace_module(_Methods(model), {m: (y,) for m in methods},
                                     check_trace=False)
    size = list(y.shape[1:])
    wrapper = {"i3d": lambda: I3DStandin(net, size),
               "inception": lambda: InceptionStandin(net, size),
               "c3d_ucf101": lambda: C3DStandin(net, size, model.mean)}[name]()
    torch.jit.script(wrapper).save(path)
    return path
