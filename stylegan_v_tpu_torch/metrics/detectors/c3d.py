"""C3D-UCF101: the Video Inception Score (ISv) classifier.

Counterpart of stylegan_v_tpu/metrics/detectors_flax/c3d.py: the standard C3D
(8 conv3d layers, 5 max pools, fc6-fc8), NCDHW, with the torch names
`conv1a.weight` ... `fc8.bias` of the tgan2 TorchScript port the reference
scores with, returning softmax probabilities over the 101 classes.

The preprocessing subtracts a per-pixel mean cube, the buffer `mean`
[3, 16, 112, 112]. A file that carries one gives it (`load_c3d_state_dict`);
otherwise it holds the per-channel UCF-101 means everywhere, which is the
JAX package's fallback to the same numbers.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .common import features_fn
from .resize import bilinear_resize

# Per-channel RGB means of the tgan2 UCF-101 mean cube (the JAX package's
# UCF101_MEAN_RGB): the mean when a file carries no cube.
UCF101_MEAN_RGB = (101.2, 97.6, 89.6)
LAYERS = ("conv1a", "conv2a", "conv3a", "conv3b", "conv4a", "conv4b", "conv5a", "conv5b",
          "fc6", "fc7", "fc8")


class C3D(nn.Module):
    """forward(x [N, 3, 16, 112, 112], preprocessed) -> [N, num_classes] softmax
    probabilities (logits with return_probs=False)."""

    def __init__(self, num_classes: int = 101,
                 mean_rgb: Tuple[float, float, float] = UCF101_MEAN_RGB):
        super().__init__()
        chans = [(3, 64), (64, 128), (128, 256), (256, 256), (256, 512), (512, 512),
                 (512, 512), (512, 512)]
        for name, (ci, co) in zip(LAYERS[:8], chans):
            setattr(self, name, nn.Conv3d(ci, co, 3, padding=1))
        self.fc6 = nn.Linear(8192, 4096)
        self.fc7 = nn.Linear(4096, 4096)
        self.fc8 = nn.Linear(4096, num_classes)
        mean = torch.tensor(mean_rgb, dtype=torch.float32)[:, None, None, None]
        self.register_buffer("mean", mean.expand(3, 16, 112, 112).contiguous())

    def forward(self, x: torch.Tensor, return_probs: bool = True) -> torch.Tensor:
        x = F.max_pool3d(F.relu(self.conv1a(x)), (1, 2, 2), (1, 2, 2))    # T x 56 x 56
        x = F.max_pool3d(F.relu(self.conv2a(x)), 2, 2)                    # T/2 x 28 x 28
        x = F.max_pool3d(F.relu(self.conv3b(F.relu(self.conv3a(x)))), 2, 2)
        x = F.max_pool3d(F.relu(self.conv4b(F.relu(self.conv4a(x)))), 2, 2)
        x = F.relu(self.conv5b(F.relu(self.conv5a(x))))
        # pool5 pads H and W by one on both sides: 2 x 7 x 7 -> 1 x 4 x 4
        x = F.max_pool3d(x, 2, 2, padding=(0, 1, 1))
        x = F.relu(self.fc6(x.flatten(1)))                  # C, T, H, W order
        x = self.fc8(F.relu(self.fc7(x)))
        return torch.softmax(x, dim=-1) if return_probs else x


def load_c3d_state_dict(model: C3D, state_dict: Mapping[str, torch.Tensor]) -> None:
    """Load a C3D state_dict whose names may carry a wrapper prefix (as
    `model.conv1a.weight`), with the mean cube when the file registered one
    ([3, T, H, W], [1, 3, T, H, W] or [T, H, W, 3]), as
    `convert_c3d_state_dict` reads them."""
    out: Dict[str, torch.Tensor] = {}
    for name, val in state_dict.items():
        parts = name.split(".")
        if "mean" in parts[-1].lower() and val.squeeze().ndim == 4:
            cube = val.squeeze()
            if cube.shape[-1] == 3 and cube.shape[0] != 3:
                cube = cube.permute(3, 0, 1, 2)
            model.mean = cube.to(model.mean.device, torch.float32).contiguous()
        elif len(parts) >= 2 and parts[-2] in LAYERS and parts[-1] in ("weight", "bias"):
            out[".".join(parts[-2:])] = val
    missing = set(LAYERS) - {k.split(".")[0] for k in out}
    if missing:
        raise KeyError(f"C3D state_dict: missing layers {sorted(missing)}")
    model.load_state_dict(out, strict=False)


def c3d_features_fn(model: C3D, batch_size: int = 16, device: Optional[torch.device] = None):
    """features(videos uint8 [N, T, H, W, C], numpy or a tensor) -> np [N, 101]
    class probabilities.

    The tgan2 preprocessing: each frame resized to 112^2 by a half-pixel
    bilinear resize of the raw 0..255 values without antialiasing, then the
    mean cube subtracted; for T != 16 its mean over time (Video-IS always
    scores 16-frame clips)."""
    def compute(v: torch.Tensor) -> torch.Tensor:
        x = bilinear_resize(v.float(), 112, 112, h_axis=2, w_axis=3, mapping="half_pixel")
        x = x.permute(0, 4, 1, 2, 3)                     # NTHWC -> NCTHW
        mean = model.mean if x.shape[2] == model.mean.shape[1] else \
            model.mean.mean(dim=1, keepdim=True)
        return model(x - mean)

    return features_fn(model, compute, batch_size, device)
