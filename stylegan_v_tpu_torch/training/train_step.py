"""The training step: all phases of one iteration.

Counterpart of stylegan_v_tpu/training/train_step.py (reference
training_loop.py:350-410). The JAX package compiles one pure function
(state, batch, rng) -> (state', stats); the port runs the same phases
eagerly and updates the state IN PLACE (modules, optimizers and the device
scalars), returning it with the stats.

Lazy regularization (reference training_loop.py:238-252): main and reg phases
share one Adam per network whose lr and betas are pre-scaled by
mb_ratio = interval/(interval+1); reg losses are scaled by their interval.
The caller chooses `do_gpl` and `do_dr1` (stylegan_v_tpu/training/loop.py:257-258).

Random draws. The JAX step draws z, the motion trajectories, Gpl's noise,
the style-mixing cutoffs and the ADA pipe's transforms inside. The port
takes them as `draws`, or makes them from an explicit torch.Generator
(`sample_draws`):

    draws = {"Gmain": {"z": [B, z_dim], "motion_z": [B, L, mz],
                       "mix_cutoff": [R] int, "mix_z": [B, z_dim],
                       "augment": [R draw sources]},
             "Gpl":   {"z": [B, z_dim], "motion_z": [R*b, L, mz],
                       "pl_noise": [R*b*F, C, H, W],
                       "mix_cutoff": [R] int, "mix_z": [R*b, z_dim]},
             "Dgen":  like "Gmain",
             "Dreal": {"augment": [R draw sources]},
             "Dr1":   {"augment": [R draw sources]}}

with R accumulation rounds, b = (B/R) // pl_batch_shrink, the mix_*
entries only when style_mixing_prob > 0, and the "augment" entries (and
"Dreal", "Dr1") only with an augment pipe. Round r takes the r-th of R
equal slices of every tensor entry and the r-th draw source, which feeds
that round's D call of the phase (training/augment.py: an object with
rand(shape) and randn(shape), or a torch.Generator). "Gpl" is read only
when do_gpl, "Dr1" only when do_dr1. Every D call augments at the state's
`augment_p`, a device tensor the step never reads on the host.

Batch (torch tensors, [B, ...] global shapes; moved to the modules' device):
  real_img: [B, F, C, H, W] uint8, normalised on the device
  real_c:   [B, c_dim] float32 (c_dim may be 0)
  real_t:   [B, F] float32
  gen_c:    [B, 3, c_dim]: per-phase label draws (Gmain, Gpl, Dmain)
  gen_t:    [B, 3, F]: per-phase timestamp draws
"""
from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import torch

from ..models import Discriminator, Generator
from ..utils.misc import float32_precision
from .augment import GeneratorDraws
from .loss import GANLoss, LossConfig, Stats

Draws = Dict[str, Dict[str, object]]     # tensors, and lists of augment draw sources


@dataclass(frozen=True)
class OptimizerConfig:
    """Adam hyperparameters (reference train.py cfg_specs)."""
    lr: float = 0.002
    beta1: float = 0.0
    beta2: float = 0.99
    eps: float = 1e-8


@dataclass(frozen=True)
class TrainingConfig:
    batch_size: int = 64                  # videos per step
    # microbatch size (videos) per accumulation round; None = whole batch
    # (the reference's batch_gpu, training_loop.py:363-378).
    batch_chip: Optional[int] = None
    ema_kimg: float = 10.0
    ema_rampup: Optional[float] = None
    G_reg_interval: Optional[int] = 4
    D_reg_interval: Optional[int] = 16
    ada_target: Optional[float] = None    # None = fixed p
    ada_interval: int = 4
    ada_kimg: float = 500.0
    grad_clip_value: float = 1e5          # nan_to_num posinf bound (misc.py:46-56)
    zero1: bool = False                   # ZeRO-1: not ported yet (ROADMAP P8)


@dataclass
class TrainState:
    """G, D and G_ema hold the parameters and buffers (w_avg); the scalars
    pl_mean, augment_p and ada_sign_acc are float32 tensors on their device,
    so the step never waits on them; step and cur_nimg (in FRAMES,
    training_loop.py:403) are host ints."""
    step: int
    cur_nimg: int
    G: Generator
    D: Discriminator
    G_ema: Generator
    opt_G: torch.optim.Adam
    opt_D: torch.optim.Adam
    pl_mean: torch.Tensor
    augment_p: torch.Tensor
    ada_sign_acc: torch.Tensor


def _mb_ratio(interval: Optional[int]) -> float:
    return 1.0 if interval is None else interval / (interval + 1)


def _adam(params, cfg: OptimizerConfig, ratio: float) -> torch.optim.Adam:
    return torch.optim.Adam(params, lr=cfg.lr * ratio,
                            betas=(cfg.beta1 ** ratio, cfg.beta2 ** ratio), eps=cfg.eps)


def scrub_grads(params: List[torch.Tensor], clip: float = 1e5) -> None:
    """NaN/Inf gradient scrub before every optimizer step, in place
    (reference training_loop.py:383-385)."""
    for p in params:
        p.grad.nan_to_num_(nan=0.0, posinf=clip, neginf=-clip)


def init_train_state(G: Generator, D: Discriminator, opt_g_cfg: OptimizerConfig,
                     opt_d_cfg: OptimizerConfig, tcfg: TrainingConfig,
                     augment_p: float = 0.0) -> TrainState:
    """State around G and D as they are (weights drawn or loaded), on their device.

    G_ema starts as a copy of G. Adam's moments start at zero, as optax's do.
    """
    device = next(G.parameters()).device
    return TrainState(
        step=0, cur_nimg=0, G=G, D=D,
        G_ema=copy.deepcopy(G).eval().requires_grad_(False),
        opt_G=_adam(G.parameters(), opt_g_cfg, _mb_ratio(tcfg.G_reg_interval)),
        opt_D=_adam(D.parameters(), opt_d_cfg, _mb_ratio(tcfg.D_reg_interval)),
        pl_mean=torch.zeros((), device=device),
        augment_p=torch.tensor(augment_p, dtype=torch.float32, device=device),
        ada_sign_acc=torch.zeros((), device=device))


def sample_draws(G: Generator, loss_cfg: LossConfig, batch_size: int, rounds: int,
                 generator: torch.Generator, do_gpl: bool, augment: bool = False,
                 do_dr1: bool = False) -> Draws:
    """Every random draw of one step (module docstring), on the generator's
    device. The augment pipe draws from `generator` itself, when it runs."""
    cfg = G.cfg
    dev = generator.device
    num_ws = G.num_ws
    motion = G.synthesis.motion_encoder

    def normal(*shape):
        return torch.randn(shape, generator=generator, device=dev)

    def phase(n: int, pl: bool) -> Dict[str, torch.Tensor]:
        # n samples in all, n // rounds a round
        d = {"z": normal(batch_size, cfg.z_dim), "motion_z": motion.sample_motion_z(n, generator)}
        if pl:
            res, F = cfg.img_resolution, cfg.sampling.num_frames_per_video
            d["pl_noise"] = normal(n * F, cfg.img_channels, res, res)
        if loss_cfg.style_mixing_prob > 0:
            cut = torch.randint(1, num_ws, (rounds,), generator=generator, device=dev)
            mixed = torch.rand(rounds, generator=generator, device=dev) < loss_cfg.style_mixing_prob
            d["mix_cutoff"] = torch.where(mixed, cut, torch.full_like(cut, num_ws))
            d["mix_z"] = normal(n, cfg.z_dim)
        return d

    draws = {"Gmain": phase(batch_size, False), "Dgen": phase(batch_size, False)}
    if do_gpl:
        draws["Gpl"] = phase(rounds * (batch_size // rounds // loss_cfg.pl_batch_shrink), True)
    if augment:
        sources = [GeneratorDraws(generator)] * rounds
        for name in ("Gmain", "Dgen", "Dreal") + (("Dr1",) if do_dr1 else ()):
            draws.setdefault(name, {})["augment"] = sources
    return draws


def _accumulate(params: List[torch.Tensor], rounds: int,
                run_round: Callable[[int], Tuple[torch.Tensor, Stats]]) -> Stats:
    """Gradient accumulation over microbatch rounds (train_step.py:208-234):
    the gradients (into .grad, zero where a parameter got none) and the
    stats are averaged over the rounds."""
    for p in params:
        p.grad = None
    total: Stats = {}
    for r in range(rounds):
        loss, stats = run_round(r)
        loss.backward(inputs=params)
        for k, v in stats.items():
            total[k] = total[k] + v if k in total else v
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        elif rounds > 1:
            p.grad.div_(rounds)
    return {k: v / rounds for k, v in total.items()}


def make_train_step(G: Generator, D: Discriminator, loss_cfg: LossConfig,
                    tcfg: TrainingConfig, augment_fn=None, d_lr_scales=None,
                    state_sharding=None, mesh=None, allow_tf32: bool = False):
    """Returns train_step(state, batch, generator=None, do_gpl=False,
    do_dr1=False, draws=None) -> (state, stats) for a state around G and D.

    `draws` (module docstring) replaces every random draw of the step; without
    it they come from `generator`, a torch.Generator on the modules' device.
    `augment_fn` is the ADA pipe (training/augment.py:make_augment_pipe) or
    None. The step runs its float32 convolutions and matmuls without TF32
    unless `allow_tf32` (the original's training option, off by default),
    and gives the caller's settings back when it returns or raises.
    """
    if d_lr_scales:
        raise NotImplementedError("per-subtree D learning rates (MoCoGAN) are not "
                                  "ported yet (ROADMAP P9)")
    if state_sharding is not None or mesh is not None or tcfg.zero1:
        raise NotImplementedError("sharded training (mesh, state sharding, ZeRO-1) is "
                                  "not ported yet (ROADMAP P8)")
    loss = GANLoss(G, D, loss_cfg, augment_fn=augment_fn)
    params_G, params_D = list(G.parameters()), list(D.parameters())
    num_frames = G.cfg.sampling.num_frames_per_video
    c_dim = G.cfg.c_dim
    device = params_G[0].device

    def rounds_of(B: int) -> int:
        if tcfg.batch_chip is None or tcfg.batch_chip >= B:
            return 1
        assert B % tcfg.batch_chip == 0, \
            f"batch {B} not divisible by batch_chip {tcfg.batch_chip}"
        return B // tcfg.batch_chip

    @float32_precision(allow_tf32)
    def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
                   generator: Optional[torch.Generator] = None, do_gpl: bool = False,
                   do_dr1: bool = False, draws: Optional[Draws] = None):
        assert state.G is G and state.D is D, "the state is not around this step's G and D"
        B = batch["real_t"].shape[0]
        rounds = rounds_of(B)
        if draws is None:
            if generator is None:
                raise ValueError("train_step needs a torch.Generator or explicit draws")
            draws = sample_draws(G, loss_cfg, B, rounds, generator, do_gpl,
                                 augment=augment_fn is not None, do_dr1=do_dr1)
        batch = {k: v.to(device, non_blocking=True) for k, v in batch.items()}
        real_img = batch["real_img"].float() / 127.5 - 1.0           # [B, F, C, H, W]
        real_c = batch["real_c"] if c_dim > 0 else None
        real_t = batch["real_t"].float()
        gen_c = batch["gen_c"] if c_dim > 0 else None
        gen_t = batch["gen_t"].float()

        def rows(x: Optional[torch.Tensor], r: int) -> Optional[torch.Tensor]:
            """Round r's slice of x (one of `rounds` equal slices)."""
            if x is None:
                return None
            n = x.shape[0] // rounds
            return x[r * n:(r + 1) * n].to(device, non_blocking=True)

        def aug_inputs(name: str, r: int):
            """Round r's augment draws and p for a phase that runs D."""
            if augment_fn is None:
                return {}
            return dict(aug_draws=draws[name]["augment"][r], augment_p=state.augment_p)

        def phase_inputs(name: str, p: int, r: int):
            d = draws[name]
            mix = None
            if loss_cfg.style_mixing_prob > 0:
                mix = (rows(d["mix_cutoff"], r)[0], rows(d["mix_z"], r))
            c = rows(gen_c[:, p], r) if gen_c is not None else None
            return dict(z=rows(d["z"], r), c=c, t=rows(gen_t[:, p], r),
                        motion_z=rows(d["motion_z"], r), mix=mix, generator=generator)

        stats: Stats = {}

        # ---- Gmain (the w_avg buffer updates in place, round by round) ----
        stats.update(_accumulate(params_G, rounds,
                                 lambda r: loss.gmain(**phase_inputs("Gmain", 0, r),
                                                      **aug_inputs("Gmain", r))))
        scrub_grads(params_G, tcfg.grad_clip_value)
        state.opt_G.step()

        # ---- Gpl (lazy, gain = interval) ----------------------------------
        if do_gpl:
            gain = float(tcfg.G_reg_interval or 1)
            pl_mean = state.pl_mean

            def gpl_round(r: int):
                nonlocal pl_mean
                l, pl_mean, s = loss.gpl(pl_noise=rows(draws["Gpl"]["pl_noise"], r),
                                         pl_mean=pl_mean, **phase_inputs("Gpl", 1, r))
                return l * gain, s

            stats.update(_accumulate(params_G, rounds, gpl_round))
            state.pl_mean = pl_mean.detach()
            scrub_grads(params_G, tcfg.grad_clip_value)
            state.opt_G.step()

        # ---- Dmain (Dgen + Dreal in one optimizer step) --------------------
        def dmain_round(r: int):
            l1, s1 = loss.dgen(**phase_inputs("Dgen", 2, r), **aug_inputs("Dgen", r))
            ri = rows(real_img, r).flatten(0, 1)                          # [b*F, C, H, W]
            l2, s2 = loss.dreal_dr1(ri, rows(real_c, r), rows(real_t, r), do_main=True,
                                    do_r1=False, r1_gamma=loss_cfg.r1_gamma,
                                    **aug_inputs("Dreal", r))
            s1.update(s2)
            s1["Loss/D/loss"] = l1.detach() + s2["Loss/D/loss_real"]
            return l1 + l2, s1

        stats.update(_accumulate(params_D, rounds, dmain_round))
        scrub_grads(params_D, tcfg.grad_clip_value)
        state.opt_D.step()

        # ---- Dr1 (lazy, gain = interval) ----------------------------------
        if do_dr1:
            gain = float(tcfg.D_reg_interval or 1)

            def dr1_round(r: int):
                ri = rows(real_img, r).flatten(0, 1)
                l, s = loss.dreal_dr1(ri, rows(real_c, r), rows(real_t, r), do_main=False,
                                      do_r1=True, r1_gamma=loss_cfg.r1_gamma,
                                      **aug_inputs("Dr1", r))
                return l * gain, s

            stats.update(_accumulate(params_D, rounds, dr1_round))
            scrub_grads(params_D, tcfg.grad_clip_value)
            state.opt_D.step()

        with torch.no_grad():
            # ---- G_ema (reference training_loop.py:391-400) ----------------
            ema_nimg = tcfg.ema_kimg * 1000.0
            if tcfg.ema_rampup is not None:
                ema_nimg = min(ema_nimg, state.cur_nimg * tcfg.ema_rampup)
            ema_beta = 0.5 ** (tcfg.batch_size / max(ema_nimg, 1e-8))
            for p, e in zip(params_G, state.G_ema.parameters()):
                e.copy_(p.lerp(e, ema_beta))
            for b, e in zip(G.buffers(), state.G_ema.buffers()):
                e.copy_(b)

            # ---- ADA controller (reference training_loop.py:406-410) -------
            state.ada_sign_acc = state.ada_sign_acc + stats["Loss/signs/real"]
            if tcfg.ada_target is not None and (state.step + 1) % tcfg.ada_interval == 0:
                adjust = torch.sign(state.ada_sign_acc / tcfg.ada_interval - tcfg.ada_target) \
                    * (tcfg.batch_size * tcfg.ada_interval) / (tcfg.ada_kimg * 1000.0)
                state.augment_p = (state.augment_p + adjust).clamp_min(0.0)
                state.ada_sign_acc = torch.zeros_like(state.ada_sign_acc)
        stats["Progress/augment_p"] = state.augment_p

        state.step += 1
        state.cur_nimg += tcfg.batch_size * num_frames
        return state, stats

    return train_step
