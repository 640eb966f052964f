"""MoCoGAN baseline discriminator (reference src/training/mocogan.py).

Counterpart of stylegan_v_tpu/models/mocogan.py, NCDHW: a per-frame
StyleGAN2 image discriminator (one frame per "video", no frame fusion) plus
a Conv3d/BatchNorm3d video discriminator over [B, C, T, H, W] (reference
MoCoGANVideoDiscriminator, mocogan.py:228-278). It returns both
image_logits and video_logits; the loss adds a softplus term for each
(reference loss.py:91-96, 130-134, 156-159).

  * Conv3d weights are OIDHW, drawn N(0, 0.02), without bias; they run in
    the input's dtype (float32 here).
  * BatchNorm3d normalises with the batch's statistics (biased variance,
    eps 1e-5) and keeps no running buffers, as the JAX module: the
    reference consults its buffers only in eval mode, which training never
    enters. Over W ranks (`batch_statistics_over`, which the train step
    enters) the statistics are the global batch's, as the JAX module's are
    under GSPMD: sums all-reduced with their gradient
    (parallel/distributed.py:all_reduce_sum).
  * The video discriminator adds `noise_sigma * N(0, 1)` to every conv's
    input. The JAX module draws it with make_rng("noise"); here it comes
    from `noise`, a draw source (an object with randn(shape)) or a
    torch.Generator, so a caller (a test) can replay the JAX draws. Each
    draw has the port's shape [B, C, T, H, W].
  * The video branch's 0.1 learning-rate multiplier (reference
    mocogan.py:54-58) is `lr_scale_map`, which the train step turns into an
    Adam parameter group.

Parameter names are the JAX module's: image_discr.<the Discriminator's>,
video_discr.conv{i}.weight, video_discr.bn{i}.weight/bias,
video_discr.conv_out.weight.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Iterator, List, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.distributed import World, all_reduce_sum
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
    """Batch-statistics normalisation with affine parameters (gamma ~ N(1, 0.02),
    beta = 0, the reference's weights_init); no running buffers.

    `world` (set by `batch_statistics_over`, None outside it): over W > 1
    ranks, each holding n = B*T*H*W of the global W*n elements a channel,
    the mean is all_reduce_sum(x.sum) / (W*n) and the biased variance a
    second pass around it, all_reduce_sum(((x - mean)^2).sum) / (W*n), as
    jnp.var computes it: two [C]-sized all_reduces a call, and two more in
    the backward."""

    world: Optional[World] = None

    def __init__(self, features: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        gamma = (1 + 0.02 * torch.randn(features, generator=generator)
                 if generator is not None else torch.empty(features))
        self.weight = nn.Parameter(gamma)
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        world, dims = self.world, (0, 2, 3, 4)
        if world is None or world.size == 1:
            mean = x.mean(dim=dims, keepdim=True)
            var = x.var(dim=dims, unbiased=False, keepdim=True)
        else:
            count = world.size * (x.numel() // x.shape[1])
            mean = all_reduce_sum(x.sum(dim=dims, keepdim=True), world) / count
            var = all_reduce_sum((x - mean).square().sum(dim=dims, keepdim=True), world) / count
        y = (x - mean) * torch.rsqrt(var + 1e-5)
        return y * self.weight[:, None, None, None] + self.bias[:, None, None, None]


@contextlib.contextmanager
def batch_statistics_over(module: nn.Module, world: World) -> Iterator[None]:
    """Inside, every BatchNorm3d of `module` takes its statistics over the
    ranks of `world` (its own rows for one rank); outside, over its input.
    Also a decorator: the train step runs inside it."""
    norms = [m for m in module.modules() if isinstance(m, _BatchNorm3d)]
    saved = [m.world for m in norms]
    for m in norms:
        m.world = world
    try:
        yield
    finally:
        for m, w in zip(norms, saved):
            m.world = w


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


def _instance_norm_3d(x: torch.Tensor) -> torch.Tensor:
    """Affine-free InstanceNorm3d: per sample and channel over (T, H, W)
    (torch nn.InstanceNorm3d defaults: affine=False)."""
    mean = x.mean(dim=(2, 3, 4), keepdim=True)
    var = x.var(dim=(2, 3, 4), unbiased=False, keepdim=True)
    return (x - mean) * torch.rsqrt(var + 1e-5)


class SubVideoDiscriminator(nn.Module):
    """Single-scale 3-D patch discriminator (reference mocogan.py:166-224,
    pix2pixHD lineage): a k=4 s=2 conv ladder with instance norm, a stride-1
    block and a 1-channel patch head. Returns the intermediate features
    when get_intermediate_feat (for feature-matching losses), else the
    patch logits."""

    def __init__(self, num_input_channels: int, ndf: int = 64, n_layers: int = 3,
                 get_intermediate_feat: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.n_layers = n_layers
        self.get_intermediate_feat = get_intermediate_feat
        nf = ndf
        self.conv0 = _Conv3d(num_input_channels, nf, (4, 4, 4), (2, 2, 2), (2, 2, 2), generator)
        for n in range(1, n_layers):
            nf_prev, nf = nf, min(nf * 2, 512)
            setattr(self, f"conv{n}", _Conv3d(nf_prev, nf, (4, 4, 4), (2, 2, 2), (2, 2, 2),
                                              generator))
        nf_prev, nf = nf, min(nf * 2, 512)
        setattr(self, f"conv{n_layers}", _Conv3d(nf_prev, nf, (4, 4, 4), (1, 1, 1), (2, 2, 2),
                                                 generator))
        self.head = _Conv3d(nf, 1, (4, 4, 4), (1, 1, 1), (2, 2, 2), generator)

    def forward(self, x: torch.Tensor) -> Union[torch.Tensor, List[torch.Tensor]]:
        x = F.leaky_relu(self.conv0(x), 0.2)
        feats = [x]
        for n in range(1, self.n_layers + 1):
            x = F.leaky_relu(_instance_norm_3d(getattr(self, f"conv{n}")(x)), 0.2)
            feats.append(x)
        x = self.head(x)
        feats.append(x)
        return feats if self.get_intermediate_feat else x


class VideoDiscriminator(nn.Module):
    """Multiscale 3-D patch discriminator (reference mocogan.py:100-162):
    num_sub_discrs SubVideoDiscriminators on progressively avg-pooled
    videos [B, C, T, H, W]; returns a list (one per scale, finest-pool first)
    of feature lists (or single logits when not get_intermediate_feat).
    Kept for parity with the reference, where it is likewise unused by the
    training path (MoCoGANDiscriminator uses MoCoGANVideoDiscriminator)."""

    def __init__(self, num_input_channels: int, ndf: int = 64, n_layers: int = 3,
                 n_frames_per_sample: int = 16, num_sub_discrs: int = 2,
                 get_intermediate_feat: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        ndf_max = 64
        self.num_sub_discrs = num_sub_discrs
        self.t_stride = 2 if n_frames_per_sample > 16 else 1
        # the reference indexes sub-Ds coarsest-width-first (scale i gets
        # ndf * 2^(num-1-i)) and runs them in reverse; net effect: the
        # UNPOOLED input meets the NARROWEST sub-D
        for block_idx in range(num_sub_discrs):
            i = num_sub_discrs - 1 - block_idx
            setattr(self, f"scale{i}", SubVideoDiscriminator(
                num_input_channels, ndf=min(ndf_max, ndf * (2 ** (num_sub_discrs - 1 - i))),
                n_layers=n_layers, get_intermediate_feat=get_intermediate_feat,
                generator=generator))

    def forward(self, x: torch.Tensor) -> list:
        results = []
        for block_idx in range(self.num_sub_discrs):
            i = self.num_sub_discrs - 1 - block_idx
            results.append(getattr(self, f"scale{i}")(x))
            if block_idx != self.num_sub_discrs - 1:
                x = F.avg_pool3d(x, 3, stride=(self.t_stride, 2, 2), padding=1,
                                 count_include_pad=False)
        return results


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
