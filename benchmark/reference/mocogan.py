"""The MoCoGAN discriminator, plain: a per-frame image D and the Conv3d /
BatchNorm3d video D over [B, C, T, H, W] (reference src/training/mocogan.py).

A frozen copy of the benchmarked package's models/mocogan.py for one
process: the batch norms take the statistics of their own input. Conv3d
weights OIDHW, no bias, in the input's dtype; the video D adds
noise_sigma * N(0, 1) from a draw source to every conv's input.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .config import DiscriminatorConfig
from .discriminator import Discriminator as ImageDiscriminator

Triple = Tuple[int, int, int]


def _randn(noise, shape, device) -> torch.Tensor:
    """One N(0, 1) draw of `shape` from a draw source or a torch.Generator."""
    if isinstance(noise, torch.Generator):
        return torch.randn(shape, generator=noise, device=noise.device).to(device)
    if noise is None or not hasattr(noise, "randn"):
        raise ValueError("the MoCoGAN video discriminator needs a noise source (randn) "
                         "or a torch.Generator")
    return noise.randn(shape).to(device)


class _Conv3d(nn.Module):
    """Bias-free 3-D conv, weight OIDHW ~ N(0, 0.02) (the reference's weights_init)."""

    def __init__(self, in_channels: int, out_channels: int, kernel: Triple, stride: Triple,
                 padding: Triple, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.stride, self.padding = stride, padding
        shape = (out_channels, in_channels, *kernel)
        w = (torch.randn(shape, generator=generator) * 0.02 if generator is not None
             else torch.empty(shape))
        self.weight = nn.Parameter(w)

    def out_shape(self, x: torch.Tensor) -> Tuple[int, int, int]:
        """The (T, H, W) of forward(x); 0 or less where an axis collapses
        (which F.conv3d refuses and lax.conv_general_dilated returns empty)."""
        k = self.weight.shape[2:]
        return tuple((n + 2 * p - kk) // s + 1 for n, kk, p, s in
                     zip(x.shape[2:], k, self.padding, self.stride))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv3d(x, self.weight.to(x.dtype), stride=self.stride, padding=self.padding)


class _BatchNorm3d(nn.Module):
    """Batch-statistics normalisation (biased variance, eps 1e-5) with affine
    parameters; no running buffers."""

    def __init__(self, features: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        gamma = (1 + 0.02 * torch.randn(features, generator=generator)
                 if generator is not None else torch.empty(features))
        self.weight = nn.Parameter(gamma)
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dims = (0, 2, 3, 4)
        mean = x.mean(dim=dims, keepdim=True)
        var = x.var(dim=dims, unbiased=False, keepdim=True)
        y = (x - mean) * torch.rsqrt(var + 1e-5)
        return y * self.weight[:, None, None, None] + self.bias[:, None, None, None]


class MoCoGANVideoDiscriminator(nn.Module):
    """Conv3d ladder over [B, C, T, H, W] (reference mocogan.py:228-278);
    returns [B, T', H', W'] logits."""

    def __init__(self, n_channels: int, n_output_neurons: int = 1, use_noise: bool = True,
                 noise_sigma: float = 0.1, ndf: int = 64, image_size: int = 64,
                 num_t_paddings: int = 0, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.use_noise, self.noise_sigma = use_noise, noise_sigma
        self.num_t_paddings = ntp = num_t_paddings
        specs = [
            (n_channels, ndf, (4, 4, 4), (1, 2, 2), (2 if ntp > 0 else 0, 1, 1), False),
            (ndf, ndf * 2, (4, 4, 4), (1, 2, 2), (2 if ntp > 1 else 0, 1, 1), True),
            (ndf * 2, ndf * 4, (4, 4, 4), (1, 2, 2), (2 if ntp > 2 else 0, 1, 1), True),
            (ndf * 4, ndf * 8, (4, 4, 4), (1, 2, 2), (2 if ntp > 3 else 0, 1, 1), True),
        ]
        if image_size == 256:
            specs += [
                (ndf * 8, ndf * 8, (3, 3, 3), (1, 1, 1), (1 + (1 if ntp > 4 else 0), 1, 1), True),
                (ndf * 8, ndf * 8, (3, 3, 3), (1, 1, 1), (1 + (1 if ntp > 5 else 0), 1, 1), True),
            ]
        self.num_convs = len(specs)
        for i, (ci, co, k, s, p, bn) in enumerate(specs):
            setattr(self, f"conv{i}", _Conv3d(ci, co, k, s, p, generator))
            if bn:
                setattr(self, f"bn{i}", _BatchNorm3d(co, generator))
        self.conv_out = _Conv3d(ndf * 8, n_output_neurons, (4, 4, 4), (1, 1, 1),
                                (2 if ntp > 5 else 0, 0, 0), generator)

    def forward(self, videos: torch.Tensor, noise=None) -> torch.Tensor:
        x, frames, ntp = videos, videos.shape[2], self.num_t_paddings
        for i in range(self.num_convs):
            if self.use_noise:
                x = x + self.noise_sigma * _randn(noise, x.shape, x.device).to(x.dtype)
            conv = getattr(self, f"conv{i}")
            if conv.out_shape(x)[0] <= 0:
                raise ValueError(
                    f"video discriminator conv{i} collapsed the time axis to 0 "
                    f"(input had {frames} frames, num_t_paddings="
                    f"{ntp}). Feed more frames (the reference runs MoCoGAN with "
                    f"16-frame traditional sampling) or raise "
                    f"model.discriminator.video_discr_num_t_paddings.")
            x = conv(x)
            if hasattr(self, f"bn{i}"):
                x = getattr(self, f"bn{i}")(x)
            x = F.leaky_relu(x, 0.2)
        out = self.conv_out.out_shape(x)
        if min(out) <= 0:
            raise ValueError(
                f"video discriminator produced empty logits {(x.shape[0], *out)} "
                f"(input had {frames} frames, num_t_paddings={ntp}); "
                f"raise model.discriminator.video_discr_num_t_paddings or feed "
                f"more frames per video.")
        return self.conv_out(x).squeeze(1)         # [B, out_t, out_h, out_w]


class MoCoGANDiscriminator(nn.Module):
    """Image D + video D (reference mocogan.py:16-75).

    forward(img [B*F, C, H, W], c [B, c_dim] or None, t [B, F], noise=...) ->
    {'image_logits': [B*F], 'video_logits': [B, T'*H'*W']}; `noise` feeds
    the video D's instance noise (module docstring).
    """

    def __init__(self, cfg: DiscriminatorConfig, video_discr_lr_multiplier: float = 0.1,
                 video_discr_num_t_paddings: int = 0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if cfg.img_resolution < 64:
            raise ValueError("MoCoGAN video discriminator needs >= 64x64 inputs (its fixed "
                             "Conv3d ladder collapses smaller resolutions to empty outputs; "
                             "the reference architecture has the same constraint)")
        self.cfg = cfg
        self.video_discr_lr_multiplier = video_discr_lr_multiplier
        # image branch: the per-frame SG2-D with frames_per_video=1
        img_cfg = dataclasses.replace(
            cfg, channel_base=int((1.0 if cfg.img_resolution >= 512 else 0.5) * 32768),
            mbstd_group_size=4, concat_res=-1,
            sampling=dataclasses.replace(cfg.sampling, num_frames_per_video=1))
        self.image_discr = ImageDiscriminator(img_cfg, generator=generator)
        self.video_discr = MoCoGANVideoDiscriminator(
            n_channels=cfg.img_channels, image_size=cfg.img_resolution,
            num_t_paddings=video_discr_num_t_paddings, generator=generator)

    @property
    def lr_scale_map(self) -> Dict[str, float]:
        """The optimizer's learning-rate multiplier for each top-level child
        (reference params_with_lr, mocogan.py:54-58)."""
        return {"video_discr": self.video_discr_lr_multiplier}

    def forward(self, img: torch.Tensor, c: Optional[torch.Tensor], t: torch.Tensor,
                force_fp32: bool = False, noise=None) -> Dict[str, torch.Tensor]:
        B, nf = t.shape
        image_logits = self.image_discr(
            img, c.repeat_interleave(nf, dim=0) if c is not None else None,
            t.reshape(B * nf, 1), force_fp32=force_fp32)["image_logits"]
        # [B*F, C, H, W] frame major -> [B, C, F, H, W]
        videos = img.reshape(B, nf, *img.shape[1:]).transpose(1, 2)
        video_logits = self.video_discr(videos, noise)
        return {"image_logits": image_logits, "video_logits": video_logits.reshape(B, -1)}
