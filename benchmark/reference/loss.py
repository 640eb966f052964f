"""Phased non-saturating StyleGAN2 video-GAN loss.

Counterpart of stylegan_v_tpu/training/loss.py (reference
src/training/loss.py, StyleGAN2Loss). Each phase runs the modules held by
`GANLoss` on explicit inputs and returns its loss with an autograd graph
(plus stats, detached); R1 and the path-length penalty differentiate through
`torch.autograd.grad(..., create_graph=True)`.

Phases (reference loss.py:74-173):
  * Gmain - softplus(-D(G(z,t)))
  * Gpl   - path-length reg on a pl_batch_shrink-smaller batch
  * Dgen  - softplus(D(G(z,t))), G frozen
  * Dreal - softplus(-D(real))
  * Dr1   - R1 gradient penalty, averaged per video

Every random draw is an argument: `motion_z` (the motion trajectories),
`pl_noise` (Gpl's image-space noise, unscaled N(0, 1)), `mix` (style
mixing: the cutoff and the second z), `aug_draws` (the ADA pipe's draw
source or a torch.Generator, training/augment.py) and `d_noise` (the
MoCoGAN video D's instance noise, a draw source or a torch.Generator,
models/mocogan.py). The train step makes them, from a torch.Generator or
from the caller. Per-layer noise, when the generator config has it, is
drawn inside synthesis from `generator`.

With the MoCoGAN discriminator, D also returns `video_logits`, and every
phase that runs D adds their softplus term to its loss (reference
loss.py:91-96, 130-134, 156-159). R1 stays on the image logits alone, as the
JAX package's `sum_logits_and_out` differentiates them only.

Over several ranks, `batch_mean` takes a rank's mean of a batch quantity to
the global batch's (parallel/distributed.py:World.mean_over_ranks): the
mapping's w_avg moves toward the global mean of w, and Gpl's pl_mean toward
the global mean path length, as in the JAX step over its global batch.

With an augment pipe, every D input goes through it first, at `augment_p`
(a float32 device tensor), as the JAX package's run_D does: with
video_consistent_aug the frames of a video are fused on the channel axis,
frame major, so they share one transform (reference loss.py:56-67).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .discriminator import Discriminator
from .generator import Generator

Stats = Dict[str, torch.Tensor]
Mix = Optional[Tuple[torch.Tensor, torch.Tensor]]      # (cutoff, z2)


@dataclass(frozen=True)
class LossConfig:
    """Mirrors reference loss_kwargs (configs/model/{base,stylegan-v}.yaml)."""
    r1_gamma: float = 10.0
    style_mixing_prob: float = 0.0       # stylegan-v default (stylegan-v.yaml:53)
    pl_weight: float = 0.0               # stylegan-v default (stylegan-v.yaml:54)
    pl_batch_shrink: int = 2
    pl_decay: float = 0.01
    video_consistent_aug: bool = True    # same ADA transform for all frames of a video


def _score_stats(logits: torch.Tensor, kind: str) -> Stats:
    logits = logits.detach()
    return {f"Loss/scores/{kind}": logits.mean(), f"Loss/signs/{kind}": logits.sign().mean()}


class GANLoss:
    """Bundles G, D and the loss config into the phase losses.

    augment_fn: Optional[(draws, img [N, C, H, W], p) -> img], the ADA pipe
    (training/augment.py:make_augment_pipe). batch_mean: None on one rank,
    else the mean over the ranks of a per-rank mean (module docstring).
    """

    def __init__(self, G: Generator, D: Discriminator, cfg: LossConfig,
                 augment_fn=None, batch_mean: Optional[Callable] = None):
        self.G = G
        self.D = D
        self.cfg = cfg
        self.augment_fn = augment_fn
        self.batch_mean = batch_mean
        self.num_frames = G.cfg.sampling.num_frames_per_video

    # ---------------- submodule runners ----------------

    def run_mapping(self, z: torch.Tensor, c: Optional[torch.Tensor], update_w_avg: bool,
                    mix: Mix = None) -> torch.Tensor:
        """mapping + optional style mixing (reference loss.py:44-51).

        mix = (cutoff, z2): layers at or past `cutoff` take their w from z2;
        cutoff == num_ws mixes nothing. Needed when style_mixing_prob > 0.
        """
        ws = self.G.mapping(z, c, update_w_avg=update_w_avg, batch_mean=self.batch_mean)
        if self.cfg.style_mixing_prob > 0:
            cutoff, z2 = mix
            ws2 = self.G.mapping(z2, c, update_w_avg=False)
            mask = torch.arange(ws.shape[1], device=ws.device)[None, :, None] < cutoff
            ws = torch.where(mask, ws, ws2)
        return ws

    def run_synthesis(self, ws: torch.Tensor, t: torch.Tensor, c: Optional[torch.Tensor],
                      motion_z: torch.Tensor,
                      generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.G.synthesis(ws, t=t, c=c, motion_z=motion_z, generator=generator)

    def augment(self, img: torch.Tensor, aug_draws, augment_p) -> torch.Tensor:
        """Video-consistent ADA (reference loss.py:56-67) on [B*F, C, H, W]."""
        f = self.num_frames
        if self.cfg.video_consistent_aug and f > 1:
            nf, ch, h, w = img.shape
            # [B*F, C, H, W] -> [B, F*C, H, W]: all frames share one transform
            v = self.augment_fn(aug_draws, img.reshape(nf // f, f * ch, h, w), augment_p)
            return v.reshape(nf, ch, h, w)
        return self.augment_fn(aug_draws, img, augment_p)

    def run_D(self, img: torch.Tensor, c: Optional[torch.Tensor], t: torch.Tensor,
              aug_draws=None, augment_p=None, d_noise=None) -> Dict[str, torch.Tensor]:
        if self.augment_fn is not None:
            img = self.augment(img, aug_draws, augment_p)
        if d_noise is None:
            return self.D(img, c, t)
        return self.D(img, c, t, noise=d_noise)

    # ---------------- phase losses ----------------

    def gmain(self, z, c, t, motion_z, mix: Mix = None,
              generator: Optional[torch.Generator] = None, aug_draws=None,
              augment_p=None, d_noise=None) -> Tuple[torch.Tensor, Stats]:
        """softplus(-D(G)) + the in-place w_avg update (reference loss.py:84-99)."""
        ws = self.run_mapping(z, c, update_w_avg=True, mix=mix)
        img = self.run_synthesis(ws, t, c, motion_z, generator)
        out = self.run_D(img, c, t, aug_draws, augment_p, d_noise)
        logits = out["image_logits"]
        loss = F.softplus(-logits).mean()
        stats = {**_score_stats(logits, "fake"), "Loss/G/loss": loss.detach()}
        if "video_logits" in out:          # MoCoGAN (reference loss.py:91-96)
            loss_video = F.softplus(-out["video_logits"]).mean()
            stats["Loss/scores/fake_video"] = out["video_logits"].detach().mean()
            stats["Loss/G/loss_video"] = loss_video.detach()
            loss = loss + loss_video
        return loss, stats

    def gpl(self, z, c, t, motion_z, pl_noise, pl_mean: torch.Tensor, mix: Mix = None,
            generator: Optional[torch.Generator] = None
            ) -> Tuple[torch.Tensor, torch.Tensor, Stats]:
        """Path-length regularization (reference loss.py:101-117).

        Runs on the first len(z) // pl_batch_shrink samples; motion_z, pl_noise
        and mix are already that size. Returns (loss, new pl_mean, stats).
        """
        bsz = z.shape[0] // self.cfg.pl_batch_shrink
        z, t = z[:bsz], t[:bsz]
        c = c[:bsz] if c is not None else None
        ws = self.run_mapping(z, c, update_w_avg=False, mix=mix)
        img = self.run_synthesis(ws, t, c, motion_z, generator)
        pl_noise = pl_noise / math.sqrt(img.shape[2] * img.shape[3])
        pl_grads, = torch.autograd.grad((img * pl_noise).sum(), ws, create_graph=True)
        pl_lengths = pl_grads.square().sum(dim=2).mean(dim=1).sqrt()
        mean_length = pl_lengths.detach().mean()
        if self.batch_mean is not None:
            mean_length = self.batch_mean(mean_length)
        new_pl_mean = pl_mean + self.cfg.pl_decay * (mean_length - pl_mean)
        pl_penalty = (pl_lengths - new_pl_mean).square()
        loss = pl_penalty.mean() * self.cfg.pl_weight
        stats = {"Loss/pl_penalty": pl_penalty.detach().mean(), "Loss/G/reg": loss.detach()}
        return loss, new_pl_mean, stats

    def dgen(self, z, c, t, motion_z, mix: Mix = None,
             generator: Optional[torch.Generator] = None, aug_draws=None,
             augment_p=None, d_noise=None) -> Tuple[torch.Tensor, Stats]:
        """softplus(D(G)), G frozen (reference loss.py:119-137)."""
        with torch.no_grad():
            ws = self.run_mapping(z, c, update_w_avg=False, mix=mix)
            img = self.run_synthesis(ws, t, c, motion_z, generator)
        out = self.run_D(img, c, t, aug_draws, augment_p, d_noise)
        logits = out["image_logits"]
        loss, stats = F.softplus(logits).mean(), _score_stats(logits, "fake")
        if "video_logits" in out:          # reference loss.py:130-134
            loss = loss + F.softplus(out["video_logits"]).mean()
            stats["Loss/scores/fake_video"] = out["video_logits"].detach().mean()
        return loss, stats

    def dreal_dr1(self, real_img: torch.Tensor, c, t, do_main: bool, do_r1: bool,
                  r1_gamma: float, aug_draws=None, augment_p=None,
                  d_noise=None) -> Tuple[torch.Tensor, Stats]:
        """Dreal + R1 sharing ONE D forward (reference loss.py:139-173): R1 takes
        the gradient of that forward's image logits, which Dreal reuses, with
        respect to the real frames before the augment."""
        if do_r1:
            real_img = real_img.detach().requires_grad_(True)
        out = self.run_D(real_img, c, t, aug_draws, augment_p, d_noise)
        logits = out["image_logits"]
        stats = _score_stats(logits, "real")
        loss = torch.zeros((), device=logits.device)
        if do_main:
            loss_real = F.softplus(-logits).mean()
            stats["Loss/D/loss_real"] = loss_real.detach()
            loss = loss + loss_real
            if "video_logits" in out:      # reference loss.py:156-159
                loss = loss + F.softplus(-out["video_logits"]).mean()
                stats["Loss/scores/real_video"] = out["video_logits"].detach().mean()
        if do_r1:
            r1_grads, = torch.autograd.grad(logits.sum(), real_img, create_graph=True)
            r1_per_frame = r1_grads.square().sum(dim=(1, 2, 3))              # [B*F]
            frames_per_logit = real_img.shape[0] // logits.shape[0]
            r1_per_video = r1_per_frame.reshape(-1, frames_per_logit).mean(dim=1)
            loss_r1 = r1_per_video.mean() * (r1_gamma / 2)
            stats["Loss/r1_penalty"] = r1_per_frame.detach().mean()
            stats["Loss/D/reg"] = loss_r1.detach()
            loss = loss + loss_r1
        return loss, stats
