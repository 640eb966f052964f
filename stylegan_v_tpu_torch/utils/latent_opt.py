"""The latent optimiser that the project and clip_edit CLIs share: a cosine
ramp lr schedule and Adam whose per-step lr scales the update."""
from __future__ import annotations

import math

import torch


def get_lr(t: float, initial_lr: float, rampdown: float = 0.25,
           rampup: float = 0.05) -> float:
    """Cosine ramp schedule (reference clip_edit.py:44-49)."""
    lr_ramp = min(1.0, (1.0 - t) / rampdown)
    lr_ramp = 0.5 - 0.5 * math.cos(lr_ramp * math.pi)
    lr_ramp = lr_ramp * min(1.0, t / rampup)
    return initial_lr * lr_ramp


def make_adam(params) -> torch.optim.Adam:
    """Adam for a schedule that scales the update, not the gradient (Adam's
    direction is invariant to the gradient's scale; reference
    project.py:131-134): set_lr before each step. It equals
    optax.chain(scale_by_adam(), scale(-1)) times the lr, eps 1e-8 on both."""
    return torch.optim.Adam(params, lr=0.0, betas=(0.9, 0.999), eps=1e-8)


def set_lr(opt: torch.optim.Optimizer, lr: float) -> None:
    for group in opt.param_groups:
        group["lr"] = lr
