"""StyleGAN-V generator: style-modulated synthesis ladder conditioned on
continuous timestamps through the motion mapping network.

Counterpart of stylegan_v_tpu/models/generator.py (reference
src/training/networks.py:90-401). NCHW activations and OIHW weights; the
highest `num_bf16_res` resolutions compute in bf16, the image skip stays in
float32. Modulated convs use the activation-scaling form of
ops/modulated_conv2d.py.

Random draws (motion_z when it is not given, per-layer noise in 'random'
mode) come from the `generator` argument of `forward`: a torch.Generator, or
for the per-layer noise also a draw source with randn(shape) (over several
ranks, parallel/distributed.py:RowsDraws, which draws the global batch's
noise and keeps the rank's rows, as the JAX step draws it).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from .ops import bias_act, modulated_conv2d, setup_filter, upsample2d
from .ops import activation_funcs
from .ops import assert_shape, normal_param
from .config import GeneratorConfig
from .layers import Conv2dLayer, FullyConnectedLayer, GenInput, MappingNetwork
from .motion import MotionMappingNetwork, compute_motion_v_dim


def draw_noise(source, shape, device) -> torch.Tensor:
    """Standard normal noise of `shape` on `device`, from a torch.Generator or
    from a draw source (an object whose randn(shape) returns a tensor)."""
    if isinstance(source, torch.Generator):
        return torch.randn(shape, generator=source, device=device)
    return source.randn(shape).to(device)


class SynthesisLayer(nn.Module):
    """modconv + optional noise + bias_act (reference networks.py:91-144).

    Computes in the dtype of its input.
    """

    def __init__(self, in_channels: int, out_channels: int, w_dim: int, resolution: int,
                 kernel_size: int = 3, up: int = 1, activation: str = "lrelu",
                 resample_filter=(1, 3, 3, 1), conv_clamp: Optional[float] = None,
                 use_noise: bool = True, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.in_channels = in_channels
        self.resolution = resolution
        self.up = up
        self.activation = activation
        self.conv_clamp = conv_clamp
        self.use_noise = use_noise
        self.padding = kernel_size // 2
        self.resample_filter = setup_filter(resample_filter) if up > 1 else None
        self.affine = FullyConnectedLayer(w_dim, in_channels, bias_init=1, generator=generator)
        self.weight = normal_param([out_channels, in_channels, kernel_size, kernel_size],
                                   generator)
        self.bias = nn.Parameter(torch.zeros([out_channels]))
        if use_noise:
            self.noise_strength = nn.Parameter(torch.zeros([]))
            self.register_buffer("noise_const", normal_param([resolution, resolution],
                                                             generator).data)

    def forward(self, x: torch.Tensor, w: torch.Tensor, noise_mode: str = "random",
                gain: float = 1.0, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        assert noise_mode in ("random", "const", "none")
        in_res = self.resolution // self.up
        assert_shape(x, [None, self.in_channels, in_res, in_res])
        styles = self.affine(w)

        noise = None
        if self.use_noise and noise_mode == "random":
            if generator is None:
                raise ValueError("noise_mode='random' needs a torch.Generator or a draw source")
            noise = draw_noise(generator, [x.shape[0], 1, self.resolution, self.resolution],
                               x.device) * self.noise_strength
        elif self.use_noise and noise_mode == "const":
            noise = self.noise_const[None, None] * self.noise_strength

        x = modulated_conv2d(x=x, weight=self.weight, styles=styles, noise=noise, up=self.up,
                             padding=self.padding, resample_filter=self.resample_filter,
                             flip_weight=(self.up == 1))
        act_gain = activation_funcs[self.activation].def_gain * gain
        act_clamp = self.conv_clamp * gain if self.conv_clamp is not None else None
        return bias_act(x, self.bias.to(x.dtype), act=self.activation, gain=act_gain,
                        clamp=act_clamp)


class ToRGBLayer(nn.Module):
    """Demodulation-free 1x1 modconv to image channels (reference networks.py:148-163)."""

    def __init__(self, in_channels: int, out_channels: int, w_dim: int, kernel_size: int = 1,
                 conv_clamp: Optional[float] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv_clamp = conv_clamp
        self.weight_gain = 1.0 / math.sqrt(in_channels * kernel_size ** 2)
        self.affine = FullyConnectedLayer(w_dim, in_channels, bias_init=1, generator=generator)
        self.weight = normal_param([out_channels, in_channels, kernel_size, kernel_size],
                                   generator)
        self.bias = nn.Parameter(torch.zeros([out_channels]))

    def forward(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        styles = self.affine(w) * self.weight_gain
        x = modulated_conv2d(x=x, weight=self.weight, styles=styles, demodulate=False)
        return bias_act(x, self.bias.to(x.dtype), clamp=self.conv_clamp)


class SynthesisBlock(nn.Module):
    """One resolution rung: (conv0-up), conv1, torgb + skip accumulation
    (reference networks.py:168-266)."""

    def __init__(self, in_channels: int, out_channels: int, w_dim: int, motion_v_dim: int,
                 resolution: int, img_channels: int, is_last: bool,
                 architecture: str = "skip", resample_filter=(1, 3, 3, 1),
                 conv_clamp: Optional[float] = None, use_bf16: bool = False,
                 use_noise: bool = True, input_type: str = "temporal",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.in_channels = in_channels
        self.w_dim = w_dim
        self.resolution = resolution
        self.img_channels = img_channels
        self.architecture = architecture
        self.use_bf16 = use_bf16
        self.resample_filter = setup_filter(resample_filter)
        self.num_conv = 1 if in_channels == 0 else 2
        self.num_torgb = 1 if (is_last or architecture == "skip") else 0
        layer_kwargs = dict(w_dim=w_dim, resolution=resolution,
                            resample_filter=resample_filter, conv_clamp=conv_clamp,
                            use_noise=use_noise, generator=generator)

        if in_channels == 0:
            self.input = GenInput(out_channels, input_type=input_type,
                                  motion_v_dim=motion_v_dim, generator=generator)
            self.conv1 = SynthesisLayer(self.input.total_dim, out_channels, **layer_kwargs)
        else:
            if architecture == "resnet":
                self.skip = Conv2dLayer(in_channels, out_channels, kernel_size=1, bias=False,
                                        up=2, resample_filter=resample_filter,
                                        generator=generator)
            self.conv0 = SynthesisLayer(in_channels, out_channels, up=2, **layer_kwargs)
            self.conv1 = SynthesisLayer(out_channels, out_channels, **layer_kwargs)
        if self.num_torgb:
            self.torgb = ToRGBLayer(out_channels, img_channels, w_dim=w_dim,
                                    conv_clamp=conv_clamp, generator=generator)

    def forward(self, x: Optional[torch.Tensor], img: Optional[torch.Tensor],
                ws: torch.Tensor, motion_v: Optional[torch.Tensor] = None,
                force_fp32: bool = False, noise_mode: str = "random",
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        assert_shape(ws, [None, self.num_conv + self.num_torgb, self.w_dim])
        dtype = torch.bfloat16 if (self.use_bf16 and not force_fp32) else torch.float32
        noise_kwargs = dict(noise_mode=noise_mode, generator=generator)

        if self.in_channels == 0:
            x = self.input(ws.shape[0], motion_v=motion_v, dtype=dtype)
            x = self.conv1(x, ws[:, 0], **noise_kwargs)
        else:
            assert_shape(x, [None, self.in_channels, self.resolution // 2,
                             self.resolution // 2])
            x = x.to(dtype)
            if self.architecture == "resnet":
                y = self.skip(x, gain=math.sqrt(0.5))
                x = self.conv0(x, ws[:, 0], **noise_kwargs)
                x = self.conv1(x, ws[:, 1], gain=math.sqrt(0.5), **noise_kwargs)
                x = y + x
            else:
                x = self.conv0(x, ws[:, 0], **noise_kwargs)
                x = self.conv1(x, ws[:, 1], **noise_kwargs)

        if img is not None:
            assert_shape(img, [None, self.img_channels, self.resolution // 2,
                               self.resolution // 2])
            img = upsample2d(img, self.resample_filter)

        if self.num_torgb:
            y = self.torgb(x, ws[:, self.num_conv]).float()
            img = img + y if img is not None else y

        assert x.dtype == dtype
        assert img is None or img.dtype == torch.float32
        return x, img


def channels_dict(cfg) -> Dict[int, int]:
    resolutions = [2 ** i for i in range(2, int(math.log2(cfg.img_resolution)) + 1)]
    return {res: min(cfg.channel_base // res, cfg.channel_max) for res in resolutions}


def compute_num_ws(cfg: GeneratorConfig) -> int:
    """Number of per-layer w vectors (reference networks.py:301-321)."""
    n = 0
    chans = channels_dict(cfg)
    for res in [2 ** i for i in range(2, int(math.log2(cfg.img_resolution)) + 1)]:
        in_ch = chans[res // 2] if res > 4 else 0
        n += 1 if in_ch == 0 else 2
        if res == cfg.img_resolution:
            n += 1  # final torgb
    return n


class SynthesisNetwork(nn.Module):
    """Resolution ladder 4 -> img_resolution, owning the motion encoder
    (reference networks.py:271-366)."""

    def __init__(self, cfg: GeneratorConfig, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        self.block_resolutions = [2 ** i for i in range(2, int(math.log2(cfg.img_resolution)) + 1)]
        self.motion_v_dim = compute_motion_v_dim(cfg)
        self.num_ws = compute_num_ws(cfg)
        # w widened when motion codes are concatenated onto w (reference networks.py:310)
        self.w_dim_eff = cfg.w_dim + (self.motion_v_dim
                                      if cfg.time_enc.cond_type == "concat_w" else 0)
        if cfg.has_motion:
            self.motion_encoder = MotionMappingNetwork(cfg, generator=generator)

        chans = channels_dict(cfg)
        log2res = int(math.log2(cfg.img_resolution))
        bf16_resolution = max(2 ** (log2res + 1 - cfg.num_bf16_res), 8)
        for res in self.block_resolutions:
            setattr(self, f"b{res}", SynthesisBlock(
                in_channels=chans[res // 2] if res > 4 else 0, out_channels=chans[res],
                w_dim=self.w_dim_eff, motion_v_dim=self.motion_v_dim, resolution=res,
                img_channels=cfg.img_channels, is_last=(res == cfg.img_resolution),
                architecture=cfg.architecture, resample_filter=cfg.resample_filter,
                conv_clamp=cfg.conv_clamp, use_bf16=(res >= bf16_resolution),
                use_noise=cfg.use_noise, input_type=cfg.input_type, generator=generator))

    def forward(self, ws: torch.Tensor, t: torch.Tensor, c: Optional[torch.Tensor] = None,
                motion_z: Optional[torch.Tensor] = None,
                motion_v: Optional[torch.Tensor] = None, force_fp32: bool = False,
                noise_mode: str = "random",
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        cfg = self.cfg
        assert t.ndim == 2, f"expected [B, F] timestamps, got {tuple(t.shape)}"
        assert_shape(ws, [t.shape[0], self.num_ws, cfg.w_dim])
        num_frames = t.shape[1]
        ws = ws.repeat_interleave(num_frames, dim=0)

        if not cfg.has_motion:
            motion_v = None
        else:
            if motion_v is None:
                motion_v = self.motion_encoder(c, t, motion_z=motion_z,
                                               generator=generator)["motion_v"]
            if cfg.time_enc.cond_type == "concat_w":
                mv = motion_v[:, None, :].expand(-1, self.num_ws, -1)
                ws = torch.cat([ws, mv], dim=2)
            elif cfg.time_enc.cond_type == "sum_w":
                ws = ws + motion_v[:, None, :]

        ws = ws.float()
        # motion_v feeds only the first block under concat_const
        # (reference networks.py:362-363 nulls it for later blocks).
        mv = motion_v if cfg.time_enc.cond_type == "concat_const" else None
        x = img = None
        w_idx = 0
        for res in self.block_resolutions:
            block = getattr(self, f"b{res}")
            block_ws = ws[:, w_idx:w_idx + block.num_conv + block.num_torgb]
            x, img = block(x, img, block_ws, motion_v=mv, force_fp32=force_fp32,
                           noise_mode=noise_mode, generator=generator)
            w_idx += block.num_conv
        return img


class Generator(nn.Module):
    """mapping + synthesis (reference networks.py:371-401).

    forward(z, c, t) -> [B*F, C, H, W] images in float32.
    """

    def __init__(self, cfg: GeneratorConfig, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        self.num_ws = compute_num_ws(cfg)
        self.mapping = MappingNetwork(
            z_dim=cfg.z_dim, c_dim=cfg.c_dim, w_dim=cfg.w_dim, num_ws=self.num_ws,
            num_layers=cfg.mapping_layers, lr_multiplier=cfg.mapping_lr_multiplier,
            w_avg_beta=cfg.w_avg_beta, generator=generator)
        self.synthesis = SynthesisNetwork(cfg, generator=generator)

    def forward(self, z: torch.Tensor, c: Optional[torch.Tensor], t: torch.Tensor,
                truncation_psi: float = 1.0, truncation_cutoff: Optional[int] = None,
                update_w_avg: bool = False, motion_z: Optional[torch.Tensor] = None,
                noise_mode: str = "random", force_fp32: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        assert len(z) == len(t), f"batch mismatch: {tuple(z.shape)} vs {tuple(t.shape)}"
        ws = self.mapping(z, c, truncation_psi=truncation_psi,
                          truncation_cutoff=truncation_cutoff, update_w_avg=update_w_avg)
        return self.synthesis(ws, t=t, c=c, motion_z=motion_z, noise_mode=noise_mode,
                              force_fp32=force_fp32, generator=generator)
