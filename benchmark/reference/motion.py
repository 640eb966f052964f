"""Motion mapping network + acyclic sine time encoder.

Counterpart of stylegan_v_tpu/models/motion.py (reference
src/training/motion.py), with both trajectory strategies: `conv` (a
padding-free Conv1d stack) and `autoregressive` (a one-layer `nn.LSTM`
named `rnn`, the reference's own module and state_dict names; cuDNN's on
the card).

The trajectory length is `MotionMappingNetwork.required_traj_len(cfg, max_t)`.
`motion_z` [B, L, z_dim] comes in as an argument, or is drawn from an
explicit torch.Generator; nothing draws from the global RNG.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from .ops import assert_shape
from .config import GeneratorConfig
from .layers import EqLRConv1d, FullyConnectedLayer, MappingNetwork


def construct_linspaced_frequencies(num_freqs: int, min_period_len: float,
                                    max_period_len: float) -> np.ndarray:
    """Log-linspaced base frequencies, descending period order
    (reference motion.py:218-222). Host numpy."""
    freqs = 2 * np.pi / (2 ** np.linspace(np.log2(min_period_len),
                                          np.log2(max_period_len), num_freqs))
    return freqs[::-1].copy().astype(np.float32)[None, :]   # [1, num_freqs]


def compute_motion_v_dim(cfg: GeneratorConfig) -> int:
    """Output dim of the motion encoder."""
    if cfg.motion.v_dim <= 0:
        return 0
    if cfg.motion.fourier:
        return cfg.time_enc.dim * 2     # AlignedTimeEncoder: sin+cos per freq
    return cfg.motion.v_dim


class AlignedTimeEncoder(nn.Module):
    """Acyclic sine embeddings aligned with the piecewise-linear motion codes
    (reference motion.py:161-214).

    embedding(t) = sincos(freq * period(u_l) * t + phase(u_l) * phase_scale)
                 - lerp(sincos(...t_left...), sincos(...t_right...))
                 + lerp(aligners(u_l), aligners(u_r))
    """

    def __init__(self, cfg: GeneratorConfig, latent_dim: int = 512,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        te = cfg.time_enc
        freqs = construct_linspaced_frequencies(te.dim, te.min_period_len, te.max_period_len)
        period_lens = 2 * np.pi / freqs
        phase_scales = (te.max_period_len / period_lens).astype(np.float32)
        self.register_buffer("freqs", torch.from_numpy(freqs), persistent=False)
        self.register_buffer("phase_scales", torch.from_numpy(phase_scales), persistent=False)
        nfeat = freqs.shape[1]
        # Bias-free predictors prevent motion mode collapse (motion.py:173-180).
        self.periods_predictor = FullyConnectedLayer(latent_dim, nfeat, bias=False,
                                                     generator=generator)
        self.phase_predictor = FullyConnectedLayer(latent_dim, nfeat, bias=False,
                                                   generator=generator)
        self.aligners_predictor = FullyConnectedLayer(latent_dim, nfeat * 2, bias=False,
                                                      generator=generator)

    def get_dim(self) -> int:
        return self.freqs.shape[1] * 2

    def forward(self, t: torch.Tensor, motion_u_left: torch.Tensor,
                motion_u_right: torch.Tensor, interp_weights: torch.Tensor,
                t_left: torch.Tensor, t_right: torch.Tensor) -> torch.Tensor:
        batch_size, num_frames, u_dim = motion_u_left.shape
        assert_shape(t, [batch_size, num_frames])
        u_l = motion_u_left.reshape(batch_size * num_frames, u_dim)
        u_r = motion_u_right.reshape(batch_size * num_frames, u_dim)

        periods = torch.tanh(self.periods_predictor(u_l)) + 1.0
        phases = self.phase_predictor(u_l)
        aligners_left = self.aligners_predictor(u_l)
        aligners_right = self.aligners_predictor(u_r)

        def pos_emb(tv):
            raw = (self.freqs * periods * tv.reshape(-1).float()[:, None]
                   + phases * self.phase_scales)
            return torch.cat([raw.sin(), raw.cos()], dim=1)

        w = interp_weights.reshape(-1, 1)
        aligners_remove = pos_emb(t_left) * (1 - w) + pos_emb(t_right) * w
        aligners_add = aligners_left * (1 - w) + aligners_right * w
        return pos_emb(t) - aligners_remove + aligners_add


def _lstm(input_size: int, hidden_size: int,
          generator: Optional[torch.Generator]) -> nn.LSTM:
    """A one-layer unidirectional nn.LSTM (reference motion.py:44-48) whose
    weights and biases are drawn from `generator`, uniform in +-1/sqrt(H) as
    nn.LSTM's own init draws them from the global RNG (None leaves them
    uninitialised, to be loaded). Built on the meta device first, so that
    its constructor draws nothing."""
    rnn = nn.LSTM(input_size, hidden_size, batch_first=True, device="meta")
    rnn = rnn.to_empty(device="cpu")
    if generator is not None:
        bound = 1.0 / math.sqrt(hidden_size)
        with torch.no_grad():
            for p in rnn.parameters():
                p.copy_(torch.rand(p.shape, generator=generator) * (2 * bound) - bound)
    return rnn


class MotionMappingNetwork(nn.Module):
    """Continuous-time motion code generator (reference motion.py:19-156)."""

    def __init__(self, cfg: GeneratorConfig, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        m = cfg.motion
        if m.gen_strategy == "autoregressive":
            self.rnn = _lstm(m.z_dim + cfg.c_dim, m.z_dim, generator)
        elif m.gen_strategy == "conv":
            # padding-free stack => valid for unbounded t (motion.py:51-59)
            self.conv = nn.Sequential(
                EqLRConv1d(m.z_dim + cfg.c_dim, m.z_dim, m.kernel_size, activation="lrelu",
                           lr_multiplier=0.01, generator=generator),
                EqLRConv1d(m.z_dim, m.v_dim, m.kernel_size, activation="lrelu",
                           lr_multiplier=0.01, generator=generator))
        else:
            raise NotImplementedError(f"Unknown gen strategy: {m.gen_strategy}")
        if m.fourier:
            self.time_encoder = AlignedTimeEncoder(cfg, latent_dim=m.v_dim, generator=generator)
        else:
            self.mapping = MappingNetwork(
                z_dim=m.z_dim, c_dim=cfg.c_dim, w_dim=m.v_dim, num_ws=None, num_layers=2,
                activation="lrelu", w_avg_beta=None, lr_multiplier=0.01, generator=generator)

    @staticmethod
    def required_traj_len(cfg: GeneratorConfig, max_t: Optional[float] = None) -> int:
        """Trajectory length incl. conv margin (reference motion.py:63-66 + :80)."""
        m = cfg.motion
        mt = max(cfg.sampling.max_num_frames - 1, max_t if max_t is not None else 0)
        base = int(math.ceil(mt / m.motion_z_distance)) + 2
        extra = (m.kernel_size - 1) * 2 if m.gen_strategy == "conv" else 0
        return base + extra

    def get_dim(self) -> int:
        return compute_motion_v_dim(self.cfg)

    def sample_motion_z(self, batch_size: int, generator: torch.Generator,
                        max_t: Optional[float] = None) -> torch.Tensor:
        """A full motion noise trajectory [B, L, z_dim] on the generator's device."""
        L = self.required_traj_len(self.cfg, max_t)
        return torch.randn([batch_size, L, self.cfg.motion.z_dim], generator=generator,
                           device=generator.device)

    def _generate_motion_u(self, c: Optional[torch.Tensor], t: torch.Tensor,
                           motion_z: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Trajectory synthesis + neighbour gather + lerp (motion.py:68-127)."""
        m = self.cfg.motion
        batch_size, num_frames = t.shape
        input_trajs = motion_z[:batch_size, :, :m.z_dim].float()
        if self.cfg.c_dim > 0:
            assert c is not None
            c_rep = c[:, None, :].expand(batch_size, input_trajs.shape[1], c.shape[1])
            input_trajs = torch.cat([input_trajs, c_rep.float()], dim=2)

        if self.cfg.motion.gen_strategy == "autoregressive":
            # JAX's cell holds one bias per gate, bias_ih_l0 + bias_hh_l0 here: only
            # bias_ih_l0 trains (Adam on both would move their sum twice as far)
            trajs, _ = torch.func.functional_call(
                self.rnn, {"bias_hh_l0": self.rnn.bias_hh_l0.detach()}, (input_trajs,))
        else:
            trajs = self.conv(input_trajs.transpose(1, 2)).transpose(1, 2)  # [B, L', D]

        t = t.float()
        dist = float(m.motion_z_distance)
        left_idx = torch.floor(t / dist).long()[:, :, None].expand(-1, -1, trajs.shape[2])
        u_left = torch.gather(trajs, 1, left_idx)                         # [B, F, D]
        u_right = torch.gather(trajs, 1, left_idx + 1)

        t_mod = torch.remainder(t, dist)                                   # floored, as jnp.mod
        t_left = t - t_mod
        t_right = t_left + dist
        interp_weights = (t_mod / dist)[:, :, None]
        motion_u = u_left * (1 - interp_weights) + u_right * interp_weights
        return dict(motion_u_left=u_left, motion_u_right=u_right, t_left=t_left,
                    t_right=t_right, interp_weights=interp_weights,
                    motion_u=motion_u.reshape(batch_size * num_frames, -1))

    def forward(self, c: Optional[torch.Tensor], t: torch.Tensor,
                motion_z: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        assert t.ndim == 2, f"expected [B, F] timestamps, got {tuple(t.shape)}"
        if motion_z is None:
            if generator is None:
                raise ValueError("pass motion_z, or a torch.Generator to draw it from")
            motion_z = self.sample_motion_z(t.shape[0], generator)
        info = self._generate_motion_u(c, t, motion_z)

        if self.cfg.motion.fourier:
            motion_v = self.time_encoder(
                t=t.float(), motion_u_left=info["motion_u_left"],
                motion_u_right=info["motion_u_right"], t_left=info["t_left"],
                t_right=info["t_right"], interp_weights=info["interp_weights"])
        else:
            c_rep = c.repeat_interleave(t.shape[1], dim=0) if self.cfg.c_dim > 0 else None
            motion_v = self.mapping(info["motion_u"], c_rep)
        return dict(motion_v=motion_v, motion_z=motion_z)
