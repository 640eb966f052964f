"""Typed, frozen (hashable) model configuration.

A copy of stylegan_v_tpu/models/config.py: that module is pure Python, but
importing it runs stylegan_v_tpu/models/__init__.py and so loads jax and flax.
tests/test_torch_bridge.py holds the two copies equal field for field.

Defaults mirror configs/model/stylegan-v.yaml and configs/sampling/*.yaml.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class SamplingConfig:
    """Frame sampling policy (reference configs/sampling/{base,random,uniform}.yaml)."""
    type: str = "random"                       # 'random' | 'uniform'
    num_frames_per_video: int = 3
    max_num_frames: int = 1024
    fps: float = 25.0
    # random sampler (configs/sampling/random.yaml)
    total_dists: Optional[Tuple[int, ...]] = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048)
    max_dist: int = 32
    # uniform sampler (configs/sampling/uniform.yaml)
    dists_between_frames: Optional[Tuple[int, ...]] = None
    max_dist_between_frames: Optional[int] = None


@dataclass(frozen=True)
class MotionConfig:
    """Motion-trajectory lattice (reference configs/model/stylegan-v.yaml:12-27)."""
    z_dim: int = 512
    v_dim: int = 512
    motion_z_distance: int = 16                 # = time_enc.min_period_len by default
    gen_strategy: str = "conv"                  # 'conv' | 'autoregressive'
    kernel_size: int = 11
    use_fractional_t: bool = True
    fourier: bool = True


@dataclass(frozen=True)
class TimeEncConfig:
    """Acyclic sine positional embedding (reference configs/model/stylegan-v.yaml:30-46)."""
    cond_type: str = "concat_const"             # 'concat_const' | 'concat_w' | 'sum_w'
    dim: int = 256
    min_period_len: int = 16
    max_period_len: int = 1024
    # Declared in the reference config but never read by reference code
    # (SURVEY.md §5.6); kept for config-surface parity.
    phase_dropout_std: float = 1.0


@dataclass(frozen=True)
class GeneratorConfig:
    w_dim: int = 512
    z_dim: int = 512
    c_dim: int = 0
    img_resolution: int = 256
    img_channels: int = 3
    channel_base: int = 32768
    channel_max: int = 512
    num_bf16_res: int = 4                       # reference num_fp16_res; run in bf16
    conv_clamp: Optional[float] = 256.0
    use_noise: bool = False                     # StyleGAN-V default (stylegan-v.yaml:6)
    input_type: str = "temporal"                # 'const' | 'temporal'
    architecture: str = "skip"                  # 'orig' | 'skip' | 'resnet'
    mapping_layers: int = 2                     # reference auto-cfg uses map=2 (train.py:139-145)
    mapping_lr_multiplier: float = 0.01
    w_avg_beta: float = 0.995
    resample_filter: Tuple[int, ...] = (1, 3, 3, 1)
    motion: MotionConfig = field(default_factory=MotionConfig)
    time_enc: TimeEncConfig = field(default_factory=TimeEncConfig)
    sampling: SamplingConfig = field(default_factory=SamplingConfig)

    @property
    def has_motion(self) -> bool:
        return self.motion.v_dim > 0


@dataclass(frozen=True)
class DiscriminatorConfig:
    c_dim: int = 0
    img_resolution: int = 256
    img_channels: int = 3
    channel_base: int = 32768
    channel_max: int = 512
    num_bf16_res: int = 4
    conv_clamp: Optional[float] = 256.0
    architecture: str = "resnet"
    cmap_dim: Optional[int] = None
    mbstd_group_size: Optional[int] = 4
    mbstd_num_channels: int = 1
    mapping_layers: int = 8                     # cmap MappingNetwork depth (reference default)
    concat_res: int = 16                        # frame-fusion resolution (stylegan-v.yaml:49)
    num_frames_div_factor: int = 2              # channel divisor around concat (stylegan-v.yaml:50)
    dummy_c: bool = False
    freeze_layers: int = 0                      # Freeze-D (reference train.py:319-324)
    resample_filter: Tuple[int, ...] = (1, 3, 3, 1)
    sampling: SamplingConfig = field(default_factory=SamplingConfig)


def replace(cfg, **kwargs):
    """dataclasses.replace that tunnels dotted keys: replace(cfg, **{'motion.z_dim': 8})."""
    direct = {k: v for k, v in kwargs.items() if "." not in k}
    nested = {}
    for k, v in kwargs.items():
        if "." in k:
            head, rest = k.split(".", 1)
            nested.setdefault(head, {})[rest] = v
    for head, sub in nested.items():
        direct[head] = replace(getattr(cfg, head), **sub)
    return dataclasses.replace(cfg, **direct)
