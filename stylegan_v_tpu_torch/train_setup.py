"""Config tree -> typed training setup (reference src/train.py:54-351
`process_hyperparams` re-expressed over the typed dataclass configs).

Covers: cfg_specs presets incl. 'auto' heuristics (train.py:138-161), G/D
config assembly with bf16 setup (num_fp16_res=4 + conv_clamp=256 analog,
train.py:170-174), optimizer/loss kwargs, ADA modes (train.py:241-277),
Freeze-D, subset/mirror/cond handling.

A copy of stylegan_v_tpu/train_setup.py onto the port's config classes
(tests/test_torch_loop.py holds the two equal field by field), plus the
original's `allow_tf32` training option (off by default), which the port's
step takes (training/train_step.py:make_train_step).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional

from .models.config import (
    DiscriminatorConfig, GeneratorConfig, MotionConfig, SamplingConfig, TimeEncConfig,
)
from .training.augment import AUGPIPE_SPECS, AugmentConfig
from .training.loss import LossConfig
from .training.train_step import OptimizerConfig, TrainingConfig
from .utils.misc import EasyDict


class UserError(Exception):
    pass


# Base presets (reference train.py:138-145).
CFG_SPECS = {
    "auto":      dict(ref_gpus=-1, kimg=25000, mb=-1, mbstd=-1, fmaps=-1,
                      lrate=-1, r1_gamma=-1, ema=-1, ramp=0.05, map=2),
    "stylegan2": dict(ref_gpus=8, kimg=25000, mb=32, mbstd=4, fmaps=1,
                      lrate=0.002, r1_gamma=10, ema=10, ramp=None, map=8),
    "paper256":  dict(ref_gpus=8, kimg=25000, mb=64, mbstd=8, fmaps=0.5,
                      lrate=0.0025, r1_gamma=1, ema=20, ramp=None, map=8),
    "paper512":  dict(ref_gpus=8, kimg=25000, mb=64, mbstd=8, fmaps=1,
                      lrate=0.0025, r1_gamma=0.5, ema=20, ramp=None, map=8),
    "paper1024": dict(ref_gpus=8, kimg=25000, mb=32, mbstd=4, fmaps=1,
                      lrate=0.002, r1_gamma=2, ema=10, ramp=None, map=8),
    "cifar":     dict(ref_gpus=2, kimg=100000, mb=64, mbstd=32, fmaps=1,
                      lrate=0.0025, r1_gamma=0.01, ema=500, ramp=0.05, map=2),
}


@dataclass
class TrainSetup:
    """Everything the training loop needs, fully typed."""
    run_dir: str
    desc: str
    gen_cfg: GeneratorConfig
    disc_cfg: DiscriminatorConfig
    loss_cfg: LossConfig
    train_cfg: TrainingConfig
    opt_g: OptimizerConfig
    opt_d: OptimizerConfig
    augment_cfg: Optional[AugmentConfig]
    augment_p: float
    dataset_kwargs: Dict[str, Any]
    sampling_cfg: SamplingConfig
    use_fractional_t: bool
    total_kimg: float                        # the quality demo runs fractions of a kimg
    kimg_per_tick: float
    snap_ticks: int
    metrics: List[str]
    seed: int
    num_chips: int
    resume: Optional[str]
    freeze_layers: int
    num_workers: int
    disc_source: str = "networks"            # 'networks' | 'mocogan'
    video_discr_lr_multiplier: float = 0.1
    video_discr_num_t_paddings: int = 0
    allow_tf32: bool = False                 # TF32 in the step's float32 convs and matmuls
    # extra kwargs forwarded to metric_main.calc_metric for in-training
    # metrics (e.g. max_real_override/num_gen_override for demo-scale FVD);
    # the port also reads them from training.metric_kwargs
    metric_kwargs: Optional[Dict[str, Any]] = None


def _sampling_from_cfg(s: Dict) -> SamplingConfig:
    return SamplingConfig(
        type=s.get("type", "random"),
        num_frames_per_video=int(s.get("num_frames_per_video", 3)),
        max_num_frames=int(s.get("max_num_frames", 1024)),
        fps=float(s.get("fps", 25)),
        total_dists=tuple(s["total_dists"]) if s.get("total_dists") else None,
        max_dist=s.get("max_dist", 32),
        dists_between_frames=(tuple(s["dists_between_frames"])
                              if s.get("dists_between_frames") else None),
        max_dist_between_frames=s.get("max_dist_between_frames"),
    )


def setup_training(cfg: EasyDict, dataset_resolution: int, dataset_c_dim: int,
                   run_dir: Optional[str] = None) -> TrainSetup:
    """Resolve the frozen experiment config into a TrainSetup."""
    t = cfg.training
    gen = cfg.model.generator
    disc = cfg.model.discriminator
    lk = cfg.model.loss_kwargs
    desc_parts = [cfg.dataset.name, cfg.model.get("name", "stylegan2"), t.cfg]

    num_chips = int(t.get("gpus", 1))
    res = dataset_resolution

    if t.cfg not in CFG_SPECS:
        raise UserError(f"Unknown training.cfg preset: {t.cfg}")
    spec = EasyDict(CFG_SPECS[t.cfg])
    if t.cfg == "auto":
        spec.ref_gpus = num_chips
        if t.get("batch_size"):
            spec.mb = int(t.batch_size)
        else:
            spec.mb = max(min(num_chips * min(4096 // res, 32), 64), num_chips)
        spec.mbstd = min(spec.mb // num_chips, disc.get("mbstd_group_size", 4))
        spec.fmaps = 1 if res >= 512 else 0.5
        spec.lrate = 0.002 if res >= 1024 else 0.0025
        spec.r1_gamma = 0.0002 * (res ** 2) / spec.mb
        spec.ema = spec.mb * 10 / 32
    elif t.get("batch_size"):
        spec.mb = int(t.batch_size)
    if t.get("kimg"):
        spec.kimg = int(t.kimg)
    if spec.mb % num_chips != 0:
        raise UserError("batch_size must be divisible by the number of chips")

    sampling = _sampling_from_cfg(dict(gen.get("sampling", cfg.get("sampling", {}))))
    mcfg = gen.get("motion", {}) or {}
    tecfg = gen.get("time_enc", {}) or {}
    use_labels = bool(t.get("cond", False))
    c_dim = dataset_c_dim if use_labels else 0
    if use_labels and dataset_c_dim == 0:
        raise UserError("cond=true requires labels in the dataset")

    bf16_res = 0 if (t.get("fp32") or gen.get("fp32")) else 4
    conv_clamp = None if (t.get("fp32") or gen.get("fp32")) else 256.0

    gen_cfg = GeneratorConfig(
        w_dim=int(gen.get("w_dim", 512)),
        z_dim=int(gen.get("z_dim", gen.get("w_dim", 512))),
        c_dim=c_dim,
        img_resolution=res,
        img_channels=3,
        channel_base=int(gen.get("fmaps", spec.fmaps) * 32768),
        channel_max=int(gen.get("channel_max", 512)),
        num_bf16_res=bf16_res,
        conv_clamp=conv_clamp,
        use_noise=bool(gen.get("use_noise", False)),
        input_type=gen.get("input", {}).get("type", "temporal"),
        architecture=gen.get("architecture", "skip"),
        mapping_layers=int(gen.get("mapping_net_n_layers", spec.map)),
        motion=MotionConfig(
            z_dim=int(mcfg.get("z_dim", 512)),
            v_dim=int(mcfg.get("v_dim", 512)),
            motion_z_distance=int(mcfg.get("motion_z_distance", 16)),
            gen_strategy=mcfg.get("gen_strategy", "conv"),
            kernel_size=int(mcfg.get("kernel_size", 11)),
            use_fractional_t=bool(mcfg.get("use_fractional_t", True)),
            fourier=bool(mcfg.get("fourier", True)),
        ),
        time_enc=TimeEncConfig(
            cond_type=tecfg.get("cond_type", "concat_const"),
            dim=int(tecfg.get("dim", 256)),
            min_period_len=int(tecfg.get("min_period_len", 16)),
            max_period_len=int(tecfg.get("max_period_len", 1024)),
        ),
        sampling=sampling,
    )

    disc_bf16 = 0 if (t.get("fp32") or disc.get("fp32")) else 4
    disc_cfg = DiscriminatorConfig(
        c_dim=c_dim,
        img_resolution=res,
        img_channels=3,
        channel_base=int(disc.get("fmaps", spec.fmaps) * 32768),
        channel_max=int(disc.get("channel_max", 512)),
        num_bf16_res=disc_bf16,
        conv_clamp=None if disc_bf16 == 0 else 256.0,
        architecture=disc.get("architecture", "resnet"),
        mbstd_group_size=int(spec.mbstd) if spec.mbstd and spec.mbstd > 0 else None,
        concat_res=int(disc.get("concat_res", 16)),
        num_frames_div_factor=int(disc.get("num_frames_div_factor", 2)),
        dummy_c=bool(disc.get("dummy_c", False)),
        freeze_layers=int(t.get("freezed", 0)),
        mapping_layers=2,
        sampling=sampling,
    )

    loss_cfg = LossConfig(
        r1_gamma=float(lk.get("r1_gamma", spec.r1_gamma)),
        style_mixing_prob=float(lk.get("style_mixing_prob", 0.9)),
        pl_weight=float(lk.get("pl_weight", 2.0)),
        video_consistent_aug=bool(lk.get("video_consistent_aug", False)),
    )

    # ADA (reference train.py:241-277)
    aug_mode = t.get("aug", "ada")
    augment_cfg = None
    augment_p = 0.0
    ada_target = None
    if aug_mode == "ada":
        ada_target = float(t.get("target", 0.6))
    elif aug_mode == "fixed":
        if t.get("p") is None:
            raise UserError("aug=fixed requires training.p")
        augment_p = float(t.p)
    elif aug_mode != "noaug":
        raise UserError(f"Unknown aug mode: {aug_mode}")
    if aug_mode != "noaug":
        pipe = t.get("augpipe", "bgc")
        if pipe not in AUGPIPE_SPECS:
            raise UserError(f"Unknown augpipe: {pipe}")
        augment_cfg = AugmentConfig(**AUGPIPE_SPECS[pipe])

    # reference batch_gpu semantics: microbatch per accumulation round
    # (train.py:229-235); defaults to whole batch when unset.
    batch_chip = t.get("batch_gpu")
    # Transfer-learning resume from a pretrained pkl: make ADA react faster
    # and disable EMA rampup (reference train.py:315-317). Non-pkl resume
    # paths are full-state orbax resumes and keep their schedules.
    resume = t.get("resume")
    transfer_resume = bool(resume) and str(resume).endswith(".pkl")
    train_cfg = TrainingConfig(
        batch_size=int(spec.mb),
        batch_chip=int(batch_chip) if batch_chip else None,
        ema_kimg=float(spec.ema),
        ema_rampup=None if transfer_resume else spec.ramp,
        ada_kimg=100.0 if transfer_resume else 500.0,
        G_reg_interval=4 if loss_cfg.pl_weight > 0 else None,
        D_reg_interval=16 if loss_cfg.r1_gamma > 0 else None,
        ada_target=ada_target,
        zero1=bool(t.get("zero1", False)),
    )

    opt = cfg.model.get("optim", {}) or {}
    g_opt = opt.get("generator", {}) or {}
    d_opt = opt.get("discriminator", {}) or {}
    g_betas = g_opt.get("betas", [0, 0.99])
    d_betas = d_opt.get("betas", [0, 0.99])
    opt_g = OptimizerConfig(lr=float(g_opt.get("lr", spec.lrate)),
                            beta1=float(g_betas[0]), beta2=float(g_betas[1]))
    opt_d = OptimizerConfig(lr=float(d_opt.get("lr", spec.lrate)),
                            beta1=float(d_betas[0]), beta2=float(d_betas[1]))

    dataset_kwargs = dict(
        path=t.get("data", cfg.dataset.path),
        sampling=sampling,
        max_num_frames=int(cfg.dataset.get("max_num_frames", 1024)),
        use_labels=use_labels,
        xflip=bool(t.get("mirror", False)),
        max_size=t.get("subset"),
        random_seed=int(t.get("seed", 0)),
    )

    return TrainSetup(
        run_dir=run_dir or t.get("outdir", "runs/exp"),
        desc="-".join(str(p) for p in desc_parts),
        gen_cfg=gen_cfg, disc_cfg=disc_cfg, loss_cfg=loss_cfg,
        train_cfg=train_cfg, opt_g=opt_g, opt_d=opt_d,
        augment_cfg=augment_cfg, augment_p=augment_p,
        dataset_kwargs=dataset_kwargs, sampling_cfg=sampling,
        use_fractional_t=bool(mcfg.get("use_fractional_t", True)),
        total_kimg=int(spec.kimg),
        kimg_per_tick=float(t.get("kimg_per_tick", 5)),
        snap_ticks=int(t.get("snap", 50)),
        metrics=list(t.get("metrics", [])),
        seed=int(t.get("seed", 0)),
        num_chips=num_chips,
        resume=resume,
        freeze_layers=int(t.get("freezed", 0)),
        num_workers=int(t.get("num_workers", 3)),
        disc_source=disc.get("source", "networks"),
        video_discr_lr_multiplier=float(disc.get("video_discr_lr_multiplier", 0.1)),
        video_discr_num_t_paddings=int(disc.get("video_discr_num_t_paddings", 0)),
        allow_tf32=bool(t.get("allow_tf32", False)),
        metric_kwargs=(dict(t["metric_kwargs"]) if t.get("metric_kwargs") else None),
    )
