"""Sparse-frame video discriminator.

Counterpart of stylegan_v_tpu/models/discriminator.py (reference
src/training/networks.py:406-673), NCHW: a StyleGAN2 discriminator with
  1. time-delta conditioning: TemporalDifferenceEncoder embeddings are
     projected into cmap for a projection-discriminator dot product;
  2. sparse-frame fusion: frames are processed independently down to
     `concat_res`, then concatenated on the channel axis
     ([B*F,C,H,W] -> [B,F*C,H,W], channel index f*C + c).

The resnet skip of every block is a 1x1 down=2 conv, whose FIR downsample
runs the downfirdn2d_x2 kernel (K1) on CUDA tensors, and its adjoint kernel
(K1-bwd) in every backward through it.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
from torch import nn

from .ops import downsample2d, setup_filter
from .ops import assert_shape
from .config import DiscriminatorConfig
from .layers import Conv2dLayer, FullyConnectedLayer, MappingNetwork, TemporalDifferenceEncoder


class DiscriminatorBlock(nn.Module):
    """Two convs + resnet skip, downsampling by 2 (reference networks.py:406-488).

    Freeze-D: the block's layers are numbered from `first_layer_idx` in the
    order fromrgb?, conv0, conv1, skip? (stylegan_v_tpu/models/discriminator.py:50-56);
    a layer whose number is below `freeze_layers` is built with trainable=False.
    """

    def __init__(self, in_channels: int, tmp_channels: int, out_channels: int,
                 resolution: int, img_channels: int, first_layer_idx: int = 0,
                 architecture: str = "resnet", activation: str = "lrelu",
                 resample_filter=(1, 3, 3, 1), conv_clamp: Optional[float] = None,
                 use_bf16: bool = False, freeze_layers: int = 0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.in_channels = in_channels
        self.resolution = resolution
        self.img_channels = img_channels
        self.architecture = architecture
        self.use_bf16 = use_bf16
        self.resample_filter = setup_filter(resample_filter)
        self.has_fromrgb = in_channels == 0 or architecture == "skip"
        self.num_layers = int(self.has_fromrgb) + 2 + int(architecture == "resnet")
        idx = iter(range(first_layer_idx, first_layer_idx + self.num_layers))

        def conv(*args, **kwargs):
            return Conv2dLayer(*args, trainable=next(idx) >= freeze_layers,
                               generator=generator, **kwargs)

        conv_kwargs = dict(activation=activation, conv_clamp=conv_clamp)
        if self.has_fromrgb:
            self.fromrgb = conv(img_channels, tmp_channels, kernel_size=1, **conv_kwargs)
        conv0_in = in_channels if in_channels > 0 else tmp_channels
        self.conv0 = conv(conv0_in, tmp_channels, kernel_size=3, **conv_kwargs)
        self.conv1 = conv(tmp_channels, out_channels, kernel_size=3, down=2,
                          resample_filter=resample_filter, **conv_kwargs)
        if architecture == "resnet":
            self.skip = conv(conv0_in, out_channels, kernel_size=1, bias=False, down=2,
                             resample_filter=resample_filter)

    def forward(self, x: Optional[torch.Tensor], img: Optional[torch.Tensor],
                force_fp32: bool = False):
        dtype = torch.bfloat16 if (self.use_bf16 and not force_fp32) else torch.float32
        if x is not None:
            assert_shape(x, [None, self.in_channels, self.resolution, self.resolution])
            x = x.to(dtype)

        if self.has_fromrgb:
            assert_shape(img, [None, self.img_channels, self.resolution, self.resolution])
            img = img.to(dtype)
            y = self.fromrgb(img)
            x = x + y if x is not None else y
            img = (downsample2d(img, self.resample_filter)
                   if self.architecture == "skip" else None)

        if self.architecture == "resnet":
            y = self.skip(x, gain=math.sqrt(0.5))
            x = self.conv0(x)
            x = self.conv1(x, gain=math.sqrt(0.5))
            x = y + x
        else:
            x = self.conv0(x)
            x = self.conv1(x)
        assert x.dtype == dtype
        return x, img


class MinibatchStdLayer(nn.Module):
    """Appends cross-sample stddev channels (reference networks.py:492-514).

    Groups are STRIDED across the batch (group g = samples {g*n+i}), as the
    reference's view gives them.
    """

    def __init__(self, group_size: Optional[int], num_channels: int = 1):
        super().__init__()
        self.group_size = group_size
        self.num_channels = num_channels

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        N, C, H, W = x.shape
        G = min(self.group_size, N) if self.group_size is not None else N
        F = self.num_channels
        c = C // F
        y = x.reshape(G, -1, F, c, H, W)
        y = y - y.mean(dim=0)
        y = y.square().mean(dim=0)
        y = (y + 1e-8).sqrt()
        y = y.mean(dim=(2, 3, 4))                   # [n, F]
        y = y.reshape(-1, F, 1, 1).repeat(G, 1, H, W)
        return torch.cat([x, y.to(x.dtype)], dim=1)


class DiscriminatorEpilogue(nn.Module):
    """mbstd + conv + fc + projection head (reference networks.py:518-576)."""

    def __init__(self, in_channels: int, cmap_dim: int, resolution: int, img_channels: int,
                 architecture: str = "resnet", mbstd_group_size: Optional[int] = 4,
                 mbstd_num_channels: int = 1, activation: str = "lrelu",
                 conv_clamp: Optional[float] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.in_channels = in_channels
        self.cmap_dim = cmap_dim
        self.resolution = resolution
        self.architecture = architecture
        if architecture == "skip":
            self.fromrgb = Conv2dLayer(img_channels, in_channels, kernel_size=1,
                                       activation=activation, generator=generator)
        self.mbstd = (MinibatchStdLayer(mbstd_group_size, mbstd_num_channels)
                      if mbstd_num_channels > 0 else None)
        self.conv = Conv2dLayer(in_channels + mbstd_num_channels, in_channels, kernel_size=3,
                                activation=activation, conv_clamp=conv_clamp,
                                generator=generator)
        # NCHW flatten: fc input features in the reference's C*H*W order.
        self.fc = FullyConnectedLayer(in_channels * resolution ** 2, in_channels,
                                      activation=activation, generator=generator)
        self.out = FullyConnectedLayer(in_channels, 1 if cmap_dim == 0 else cmap_dim,
                                       generator=generator)

    def forward(self, x: torch.Tensor, img: Optional[torch.Tensor],
                cmap: Optional[torch.Tensor]) -> torch.Tensor:
        assert_shape(x, [None, self.in_channels, self.resolution, self.resolution])
        x = x.float()
        if self.architecture == "skip":
            x = x + self.fromrgb(img.float())
        if self.mbstd is not None:
            x = self.mbstd(x)
        x = self.conv(x)
        x = self.fc(x.flatten(1))
        x = self.out(x)
        if self.cmap_dim > 0:
            assert_shape(cmap, [None, self.cmap_dim])
            x = (x * cmap).sum(dim=1, keepdim=True) / math.sqrt(self.cmap_dim)
        return x


class Discriminator(nn.Module):
    """Sparse-frame video discriminator (reference networks.py:580-673).

    forward(img [B*F,C,H,W], c [B,c_dim] or None, t [B,F]) -> {'image_logits': [B]}
    """

    def __init__(self, cfg: DiscriminatorConfig, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        nf = cfg.sampling.num_frames_per_video
        log2res = int(math.log2(cfg.img_resolution))
        self.block_resolutions = [2 ** i for i in range(log2res, 2, -1)]
        self.has_time_encoder = nf > 1
        chans = {res: min(cfg.channel_base // res, cfg.channel_max)
                 for res in self.block_resolutions + [4]}
        cmap_dim = cfg.cmap_dim if cfg.cmap_dim is not None else chans[4]
        if cfg.c_dim == 0 and not self.has_time_encoder:
            cmap_dim = 0

        total_c_dim = cfg.c_dim
        if self.has_time_encoder:
            self.time_encoder = TemporalDifferenceEncoder(cfg.sampling, generator=generator)
            total_c_dim += self.time_encoder.get_dim()

        bf16_resolution = max(2 ** (log2res + 1 - cfg.num_bf16_res), 8)
        cur_layer_idx = 0
        for res in self.block_resolutions:
            in_ch = chans[res] if res < cfg.img_resolution else 0
            out_ch = chans[res // 2]
            if res // 2 == cfg.concat_res:
                out_ch = out_ch // cfg.num_frames_div_factor
            if res == cfg.concat_res:
                in_ch = (in_ch // cfg.num_frames_div_factor) * nf
            block = DiscriminatorBlock(
                in_ch, chans[res], out_ch, resolution=res, img_channels=cfg.img_channels,
                first_layer_idx=cur_layer_idx, architecture=cfg.architecture,
                resample_filter=cfg.resample_filter, conv_clamp=cfg.conv_clamp,
                use_bf16=(res >= bf16_resolution), freeze_layers=cfg.freeze_layers,
                generator=generator)
            setattr(self, f"b{res}", block)
            cur_layer_idx += block.num_layers

        if total_c_dim > 0 and cmap_dim > 0:
            self.mapping = MappingNetwork(z_dim=0, c_dim=total_c_dim, w_dim=cmap_dim,
                                          num_ws=None, num_layers=cfg.mapping_layers,
                                          w_avg_beta=None, generator=generator)
        self.b4 = DiscriminatorEpilogue(
            chans[4], cmap_dim=cmap_dim, resolution=4, img_channels=cfg.img_channels,
            architecture=cfg.architecture, mbstd_group_size=cfg.mbstd_group_size,
            mbstd_num_channels=cfg.mbstd_num_channels, conv_clamp=cfg.conv_clamp,
            generator=generator)

    def forward(self, img: torch.Tensor, c: Optional[torch.Tensor], t: torch.Tensor,
                force_fp32: bool = False) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        nf = cfg.sampling.num_frames_per_video
        assert t.ndim == 2, f"expected [B, F], got {tuple(t.shape)}"
        assert img.shape[0] == t.shape[0] * t.shape[1], \
            f"frame count mismatch: {tuple(img.shape)} vs {tuple(t.shape)}"

        if self.has_time_encoder:
            t_embs = self.time_encoder(t.reshape(-1, nf))
            c = (torch.cat([c, t_embs], dim=1) if c is not None and cfg.c_dim > 0
                 else t_embs)
            if cfg.dummy_c:
                c = c * 0.0

        x = None
        for res in self.block_resolutions:
            if res == cfg.concat_res:
                # frame fusion: [B*F, C, H, W] -> [B, F*C, H, W], channel f*C + c
                x = x.reshape(x.shape[0] // nf, nf * x.shape[1], *x.shape[2:])
            x, img = getattr(self, f"b{res}")(x, img, force_fp32=force_fp32)

        cmap = self.mapping(None, c) if hasattr(self, "mapping") else None
        x = self.b4(x, img, cmap)
        return {"image_logits": x.squeeze(1)}
