"""Core layers: equalized-LR layers, mapping network, generator input, and the
discriminator-side time-difference encoder.

Counterpart of stylegan_v_tpu/models/layers.py (reference
src/training/layers.py). Parameters are stored at "unit" scale and rescaled
at call time (equalized learning rate). Images are NCHW, conv weights OIHW,
FC weights [out, in], 1-D conv weights [out, in, k]. `w_avg` is a buffer,
updated in place when `update_w_avg=True`.

Every constructor takes `generator`, the torch.Generator its weights are
drawn from (None leaves them uninitialised, to be loaded from a state_dict).
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .ops import activation_funcs, bias_act, conv2d_resample, leaky_relu, setup_filter
from .ops import assert_shape, normal_param
from .config import SamplingConfig


def normalize_2nd_moment(x: torch.Tensor, dim: int = 1, eps: float = 1e-8) -> torch.Tensor:
    """x * rsqrt(mean(x^2)) (reference layers.py:16-18)."""
    return x * torch.rsqrt(x.square().mean(dim=dim, keepdim=True) + eps)


class FullyConnectedLayer(nn.Module):
    """Equalized-LR linear layer (reference layers.py:109-138).

    weight [out, in] stored at scale N(0, 1/lr_multiplier); effective weight
    = weight * lr_multiplier / sqrt(in); bias scaled by lr_multiplier.
    Computes in float32.
    """

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 activation: str = "linear", lr_multiplier: float = 1.0,
                 bias_init: float = 0.0, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.activation = activation
        self.lr_multiplier = lr_multiplier
        self.weight_gain = lr_multiplier / math.sqrt(in_features)
        self.weight = normal_param([out_features, in_features], generator,
                                   std=1.0 / lr_multiplier)
        self.bias = (nn.Parameter(torch.full([out_features], float(bias_init)))
                     if bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.linear(x.float(), self.weight * self.weight_gain)
        b = self.bias
        if b is not None and self.lr_multiplier != 1.0:
            b = b * self.lr_multiplier
        return bias_act(x, b, act=self.activation)


class Conv2dLayer(nn.Module):
    """Equalized-LR conv with optional FIR up/downsampling (reference layers.py:143-197).

    Computes in the dtype of its input. `trainable=False` (Freeze-D) detaches
    weight and bias in forward, so their gradient is zero, as the JAX
    package's stop_gradient gives it (stylegan_v_tpu/models/layers.py:86-88).
    """

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 bias: bool = True, activation: str = "linear", up: int = 1, down: int = 1,
                 resample_filter=(1, 3, 3, 1), conv_clamp: Optional[float] = None,
                 lr_multiplier: float = 1.0, trainable: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.trainable = trainable
        self.activation = activation
        self.up = up
        self.down = down
        self.conv_clamp = conv_clamp
        self.lr_multiplier = lr_multiplier
        self.padding = kernel_size // 2
        self.weight_gain = 1.0 / math.sqrt(in_channels * kernel_size ** 2)
        self.resample_filter = (setup_filter(resample_filter)
                                if (up > 1 or down > 1) else None)
        self.weight = normal_param([out_channels, in_channels, kernel_size, kernel_size],
                                   generator)
        self.bias = nn.Parameter(torch.zeros([out_channels])) if bias else None

    def forward(self, x: torch.Tensor, gain: float = 1.0) -> torch.Tensor:
        w, b = self.weight, self.bias
        if not self.trainable:
            w = w.detach()
            b = b.detach() if b is not None else None
        w = w * (self.weight_gain * self.lr_multiplier)
        b = b * self.lr_multiplier if b is not None else None
        x = conv2d_resample(x, w, f=self.resample_filter, up=self.up,
                            down=self.down, padding=self.padding,
                            flip_weight=(self.up == 1))
        act_gain = activation_funcs[self.activation].def_gain * gain
        act_clamp = self.conv_clamp * gain if self.conv_clamp is not None else None
        return bias_act(x, b.to(x.dtype) if b is not None else None,
                        act=self.activation, gain=act_gain, clamp=act_clamp)


class MappingNetwork(nn.Module):
    """z/c -> w mapping with 2nd-moment normalization, w_avg tracking,
    broadcast and truncation (reference layers.py:23-104)."""

    def __init__(self, z_dim: int, c_dim: int, w_dim: int, num_ws: Optional[int],
                 num_layers: int = 8, embed_features: Optional[int] = None,
                 layer_features: Optional[int] = None, activation: str = "lrelu",
                 lr_multiplier: float = 0.01, w_avg_beta: Optional[float] = 0.995,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.z_dim, self.c_dim, self.w_dim = z_dim, c_dim, w_dim
        self.num_ws = num_ws
        self.num_layers = num_layers
        self.w_avg_beta = w_avg_beta
        embed_features = embed_features if embed_features is not None else w_dim
        if c_dim == 0:
            embed_features = 0
        layer_features = layer_features if layer_features is not None else w_dim
        features = [z_dim + embed_features] + [layer_features] * (num_layers - 1) + [w_dim]

        if c_dim > 0:
            self.embed = FullyConnectedLayer(c_dim, embed_features, generator=generator)
        for idx in range(num_layers):
            setattr(self, f"fc{idx}", FullyConnectedLayer(
                features[idx], features[idx + 1], activation=activation,
                lr_multiplier=lr_multiplier, generator=generator))
        if num_ws is not None and w_avg_beta is not None:
            self.register_buffer("w_avg", torch.zeros([w_dim]))

    def forward(self, z: Optional[torch.Tensor], c: Optional[torch.Tensor],
                truncation_psi: float = 1.0, truncation_cutoff: Optional[int] = None,
                update_w_avg: bool = False, batch_mean=None) -> torch.Tensor:
        """w for z and c. With update_w_avg, w_avg moves toward the batch's mean
        w; `batch_mean`, when given, takes that mean over this rank's rows to
        the global batch's (parallel/distributed.py:World.mean_over_ranks)."""
        x = None
        if self.z_dim > 0:
            assert_shape(z, [None, self.z_dim])
            x = normalize_2nd_moment(z.float())
        if self.c_dim > 0:
            assert_shape(c, [None, self.c_dim])
            y = normalize_2nd_moment(self.embed(c.float()))
            x = torch.cat([x, y], dim=1) if x is not None else y

        for idx in range(self.num_layers):
            x = getattr(self, f"fc{idx}")(x)

        if update_w_avg and self.num_ws is not None and self.w_avg_beta is not None:
            # w_avg <- lerp(mean(x), w_avg, beta) (reference layers.py:87-89)
            mean = x.detach().mean(dim=0)
            if batch_mean is not None:
                mean = batch_mean(mean)
            self.w_avg.copy_(mean.lerp(self.w_avg, self.w_avg_beta))

        if self.num_ws is not None:
            x = x[:, None, :].repeat(1, self.num_ws, 1)

        if truncation_psi != 1:
            assert self.w_avg_beta is not None
            if self.num_ws is None or truncation_cutoff is None:
                x = self.w_avg.lerp(x, truncation_psi)
            else:
                x = torch.cat([self.w_avg.lerp(x[:, :truncation_cutoff], truncation_psi),
                               x[:, truncation_cutoff:]], dim=1)
        return x


class EqLRConv1d(nn.Module):
    """Equalized-LR 1-D conv over [N, C, L] (reference layers.py:332-373)."""

    def __init__(self, in_features: int, out_features: int, kernel_size: int,
                 padding: int = 0, stride: int = 1, activation: str = "linear",
                 lr_multiplier: float = 1.0, bias: bool = True, bias_init: float = 0.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        assert activation in ("linear", "lrelu")
        self.activation = activation
        self.padding = padding
        self.stride = stride
        self.lr_multiplier = lr_multiplier
        self.weight_gain = lr_multiplier / math.sqrt(in_features * kernel_size)
        self.weight = normal_param([out_features, in_features, kernel_size], generator,
                                   std=1.0 / lr_multiplier)
        self.bias = (nn.Parameter(torch.full([out_features], float(bias_init)))
                     if bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        assert x.ndim == 3, f"expected [N, C, L], got {tuple(x.shape)}"
        y = F.conv1d(x, self.weight * self.weight_gain, stride=self.stride,
                     padding=self.padding)
        if self.bias is not None:
            y = y + (self.bias * self.lr_multiplier)[None, :, None]
        if self.activation == "lrelu":
            # plain torch-style leaky_relu: NO sqrt(2) gain (reference layers.py:370),
            # with jax.nn.leaky_relu's gradient at 0
            y = leaky_relu(y, 0.2)
        return y


class GenInput(nn.Module):
    """First-block input: learned const, or const ⊕ motion code
    (reference layers.py:202-251)."""

    def __init__(self, channel_dim: int, input_type: str = "temporal",
                 motion_v_dim: int = 0, generator: Optional[torch.Generator] = None):
        super().__init__()
        if input_type not in ("const", "temporal"):
            raise NotImplementedError(f"Unknown input type: {input_type}")
        self.channel_dim = channel_dim
        self.input_type = input_type
        self.motion_v_dim = motion_v_dim
        self.const = normal_param([channel_dim, 4, 4], generator)

    @property
    def total_dim(self) -> int:
        if self.input_type == "const":
            return self.channel_dim
        return self.channel_dim + self.motion_v_dim

    def forward(self, batch_size: int, motion_v: Optional[torch.Tensor] = None,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
        if self.input_type == "const":
            return self.const[None].expand(batch_size, -1, -1, -1).to(dtype)
        assert motion_v is not None, "temporal input requires motion_v"
        n = motion_v.shape[0]
        c = self.const[None].expand(n, -1, -1, -1)
        mv = motion_v[:, :, None, None].expand(n, self.motion_v_dim, 4, 4)
        return torch.cat([c, mv], dim=1).to(dtype)


def construct_log_spaced_freqs(max_num_frames: int, skip_small_t_freqs: int = 0) -> np.ndarray:
    """Log-spaced Fourier coefficients (reference layers.py:439-446). Host numpy."""
    time_resolution = 2 ** np.ceil(np.log2(max_num_frames))
    num_fourier_feats = int(np.ceil(np.log2(time_resolution)))
    powers = 2.0 ** np.arange(num_fourier_feats)
    powers = powers[:len(powers) - skip_small_t_freqs]
    return (powers[None, :] * np.pi / time_resolution).astype(np.float32)


class FixedTimeEncoder(nn.Module):
    """sin/cos of log-spaced frequencies of t (reference layers.py:302-327)."""

    def __init__(self, max_num_frames: int, skip_small_t_freqs: int = 0):
        super().__init__()
        coefs = construct_log_spaced_freqs(max_num_frames, skip_small_t_freqs)
        self.register_buffer("fourier_coefs", torch.from_numpy(coefs), persistent=False)

    def get_dim(self) -> int:
        return self.fourier_coefs.shape[1] * 2

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        assert t.ndim == 2, f"expected [N, F], got {tuple(t.shape)}"
        raw = self.fourier_coefs * t.reshape(-1).float()[:, None]   # [N*F, num_feats]
        return torch.cat([raw.sin(), raw.cos()], dim=1)


class TemporalDifferenceEncoder(nn.Module):
    """Embeds frame-time DELTAS: learned embedding + fixed Fourier features of
    pairwise differences (reference layers.py:255-297)."""

    def __init__(self, sampling: SamplingConfig, d: int = 256, skip_small_t_freqs: int = 0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.sampling = sampling
        self.d = d
        if sampling.num_frames_per_video > 1:
            self.const_embed = nn.Embedding.from_pretrained(
                normal_param([sampling.max_num_frames, d], generator).data, freeze=False)
            self.time_encoder = FixedTimeEncoder(sampling.max_num_frames, skip_small_t_freqs)

    def get_dim(self) -> int:
        nf = self.sampling.num_frames_per_video
        if nf == 1:
            return 1
        fdim = self.time_encoder.get_dim()
        if self.sampling.type == "uniform":
            return self.d + fdim
        return (self.d + fdim) * (nf - 1)

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        nf = self.sampling.num_frames_per_video
        assert_shape(t, [None, nf])
        batch_size = t.shape[0]
        if nf == 1:
            return torch.zeros([batch_size, 1], device=t.device)
        if self.sampling.type == "uniform":
            t_diffs = (t[:, 1] - t[:, 0]).reshape(-1)            # [N]
            num_diffs = 1
        else:
            t_diffs = (t[:, 1:] - t[:, :-1]).reshape(-1)          # [N*(F-1)]
            num_diffs = nf - 1
        # float -> round (half to even, as jnp.round) -> int (reference layers.py:291-292)
        const_embs = self.const_embed(torch.round(t_diffs.float()).long())
        fourier_embs = self.time_encoder(t_diffs[:, None])
        out = torch.cat([const_embs, fourier_embs], dim=1)
        return out.reshape(batch_size, num_diffs * out.shape[1])
