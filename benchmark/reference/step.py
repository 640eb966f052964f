"""One training step of the video GAN, plain and on one process: Gmain,
Dmain (Dgen + Dreal), Dr1 on the steps that ask for it, Adam with the lazy
regularisation's scaled rates and betas, the NaN scrub, G_ema and the ADA
controller (reference training_loop.py:350-410, loss.py:74-173).

It follows the benchmarked package's training/train_step.py for one rank
with the path-length penalty off (pl_weight 0, as every configuration of the
benchmark has it). `draws` is the dict the program's step takes:
{"Gmain": {"z", "motion_z", "augment": [source], "d_noise": [source]},
 "Dgen": likewise, "Dreal" and "Dr1": {"augment", "d_noise"}}, one round.
"""
from __future__ import annotations

import copy
from typing import Dict, List, Optional

import torch

from .augment import AugmentConfig, make_augment_pipe
from .loss import GANLoss, LossConfig


def _param_groups(module: torch.nn.Module, lr: float, lr_scales: Dict[str, float]) -> List[Dict]:
    groups: List[Dict] = []
    for name, p in module.named_parameters():
        group_lr = lr * lr_scales.get(name.split(".")[0], 1.0)
        if not groups or groups[-1]["lr"] != group_lr:
            groups.append({"params": [], "lr": group_lr})
        groups[-1]["params"].append(p)
    return groups


def _adam(module, opt: Dict, interval: Optional[int], lr_scales: Dict[str, float]):
    ratio = 1.0 if interval is None else interval / (interval + 1)
    return torch.optim.Adam(_param_groups(module, opt["lr"] * ratio, lr_scales),
                            lr=opt["lr"] * ratio,
                            betas=(opt["beta1"] ** ratio, opt["beta2"] ** ratio), eps=opt["eps"])


class Trainer:
    """G, D, G_ema, both optimizers and the device scalars of one run."""

    def __init__(self, G, D, loss_cfg: Dict, train_cfg: Dict, opt_g: Dict, opt_d: Dict,
                 augment_cfg: Optional[Dict], augment_p: float):
        if loss_cfg["pl_weight"] > 0 or loss_cfg["style_mixing_prob"] > 0:
            raise ValueError("the reference step has no path-length penalty or style mixing")
        if train_cfg["batch_chip"] not in (None, train_cfg["batch_size"]):
            raise ValueError("the reference step runs one round a step")
        self.G, self.D, self.tcfg = G, D, train_cfg
        self.G_ema = copy.deepcopy(G).eval().requires_grad_(False)
        pipe = make_augment_pipe(AugmentConfig(**augment_cfg)) if augment_cfg else None
        self.loss = GANLoss(G, D, LossConfig(**loss_cfg), augment_fn=pipe)
        self.loss_cfg = self.loss.cfg
        lr_scales = getattr(D, "lr_scale_map", {})
        self.opt_G = _adam(G, opt_g, train_cfg["G_reg_interval"], {})
        self.opt_D = _adam(D, opt_d, train_cfg["D_reg_interval"], lr_scales)
        dev = next(G.parameters()).device
        self.augment_p = torch.tensor(augment_p, dtype=torch.float32, device=dev)
        self.ada_sign_acc = torch.zeros((), device=dev)
        self.step_index = 0
        self.cur_nimg = 0
        self.video_noise = hasattr(D, "video_discr")
        self.has_pipe = pipe is not None

    def _minimise(self, params, loss: torch.Tensor, opt) -> None:
        for p in params:
            p.grad = None
        loss.backward(inputs=params)
        clip = self.tcfg["grad_clip_value"]
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            p.grad.nan_to_num_(nan=0.0, posinf=clip, neginf=-clip)
        opt.step()

    def step(self, batch: Dict[str, torch.Tensor], draws: Dict, do_dr1: bool) -> Dict:
        G, D, loss = self.G, self.D, self.loss
        real_img = batch["real_img"].float() / 127.5 - 1.0                  # [B, F, C, H, W]
        real_t = batch["real_t"].float()
        gen_t = batch["gen_t"].float()

        def aug(name):
            out = {}
            if self.has_pipe:
                out.update(aug_draws=draws[name]["augment"][0], augment_p=self.augment_p)
            if self.video_noise:
                out["d_noise"] = draws[name]["d_noise"][0]
            return out

        def gen(name, p):
            return dict(z=draws[name]["z"], c=None, t=gen_t[:, p],
                        motion_z=draws[name]["motion_z"], mix=None)

        stats = {}
        l, s = loss.gmain(**gen("Gmain", 0), **aug("Gmain"))
        stats.update(s)
        self._minimise(list(G.parameters()), l, self.opt_G)

        l1, s1 = loss.dgen(**gen("Dgen", 2), **aug("Dgen"))
        l2, s2 = loss.dreal_dr1(real_img.flatten(0, 1), None, real_t, do_main=True, do_r1=False,
                                r1_gamma=self.loss_cfg.r1_gamma, **aug("Dreal"))
        stats.update(s1)
        stats.update(s2)
        stats["Loss/D/loss"] = l1.detach() + s2["Loss/D/loss_real"]
        self._minimise(list(D.parameters()), l1 + l2, self.opt_D)

        if do_dr1:
            gain = float(self.tcfg["D_reg_interval"] or 1)
            l, s = loss.dreal_dr1(real_img.flatten(0, 1), None, real_t, do_main=False,
                                  do_r1=True, r1_gamma=self.loss_cfg.r1_gamma, **aug("Dr1"))
            stats.update(s)
            self._minimise(list(D.parameters()), l * gain, self.opt_D)

        with torch.no_grad():
            ema_nimg = self.tcfg["ema_kimg"] * 1000.0
            if self.tcfg["ema_rampup"] is not None:
                ema_nimg = min(ema_nimg, self.cur_nimg * self.tcfg["ema_rampup"])
            beta = 0.5 ** (self.tcfg["batch_size"] / max(ema_nimg, 1e-8))
            for p, e in zip(G.parameters(), self.G_ema.parameters()):
                e.copy_(p.lerp(e, beta))
            for b, e in zip(G.buffers(), self.G_ema.buffers()):
                e.copy_(b)
            self.ada_sign_acc = self.ada_sign_acc + stats["Loss/signs/real"]
            target, interval = self.tcfg["ada_target"], self.tcfg["ada_interval"]
            if target is not None and (self.step_index + 1) % interval == 0:
                adjust = torch.sign(self.ada_sign_acc / interval - target) \
                    * (self.tcfg["batch_size"] * interval) / (self.tcfg["ada_kimg"] * 1000.0)
                self.augment_p = (self.augment_p + adjust).clamp_min(0.0)
                self.ada_sign_acc = torch.zeros_like(self.ada_sign_acc)
        self.step_index += 1
        self.cur_nimg += self.tcfg["batch_size"] * gen_t.shape[2]
        return stats
