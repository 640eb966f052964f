"""The training step: all phases of one iteration.

Counterpart of stylegan_v_tpu/training/train_step.py (reference
training_loop.py:350-410). The JAX package compiles one pure function
(state, batch, rng) -> (state', stats); the port runs the same phases
eagerly and updates the state IN PLACE (modules, optimizers and the device
scalars), returning it with the stats.

Lazy regularization (reference training_loop.py:238-252): main and reg phases
share one Adam per network whose lr and betas are pre-scaled by
mb_ratio = interval/(interval+1); reg losses are scaled by their interval.
`d_lr_scales` (MoCoGAN's {'video_discr': 0.1}, models/mocogan.py:
lr_scale_map) gives D's Adam one parameter group per top-level child it
names, at lr * mb_ratio * scale, as the JAX package's optax.multi_transform
does (stylegan_v_tpu/training/train_step.py:86-110).
The caller chooses `do_gpl` and `do_dr1` (stylegan_v_tpu/training/loop.py:257-258).

Random draws. The JAX step draws z, the motion trajectories, Gpl's noise,
the style-mixing cutoffs and the ADA pipe's transforms inside. The port
takes them as `draws`, or makes them from an explicit torch.Generator
(`sample_draws`):

    draws = {"Gmain": {"z": [B, z_dim], "motion_z": [B, L, mz],
                       "mix_cutoff": [R] int, "mix_z": [B, z_dim],
                       "augment": [R draw sources], "d_noise": [R draw sources]},
             "Gpl":   {"z": [B, z_dim], "motion_z": [R*b, L, mz],
                       "pl_noise": [R*b*F, C, H, W],
                       "mix_cutoff": [R] int, "mix_z": [R*b, z_dim]},
             "Dgen":  like "Gmain",
             "Dreal": {"augment": [R draw sources], "d_noise": [R draw sources]},
             "Dr1":   {"augment": [R draw sources], "d_noise": [R draw sources]}}

with R accumulation rounds, b = (B/R) // pl_batch_shrink, the mix_*
entries only when style_mixing_prob > 0, the "augment" entries only with an
augment pipe and the "d_noise" entries (the video D's instance noise) only
with the MoCoGAN D; "Dreal" and "Dr1" only with either. Round r takes the
r-th of R equal slices of every tensor entry and the r-th draw source, which
feeds that round's D call of the phase (training/augment.py: an object with
rand(shape) and randn(shape), or a torch.Generator). "Gpl" is read only
when do_gpl, "Dr1" only when do_dr1. Every D call augments at the state's
`augment_p`, a device tensor the step never reads on the host.

Over W ranks (one process each, `world`), every rank runs the step on its
rows of the global batch (parallel/distributed.py:row_plan): per round of
N = B/R videos, rank r holds rows rank_rows(N, G, W, r), which keep D's
minibatch-std groups (G videos, strided) the global batch's, so D's forward
issues no collective. `draws` are the step's GLOBAL draws, the same on every
rank (or made from `generator`, seeded alike on every rank); each rank keeps
its rows of them, so a run's draws do not depend on W. Per-layer noise in
'random' mode is drawn inside synthesis from `generator`: over W ranks every
layer draws the noise of the round's global frames and keeps the rank's
(RowsDraws), as the JAX step draws it over its global batch. What the JAX step
reduces over its global batch, the port all-reduces: each phase's gradients
(one flat buffer per network, averaged after the rounds and before the
scrub, as in JAX), the mapping's w_avg (the mean of each round's w), Gpl's
pl_mean (the mean path length) and the step's stats, once, before the ADA
controller reads Loss/signs/real. Every phase's loss is a mean over equally
many rows on every rank, so the mean over the ranks is the global batch's.
With one rank nothing is reduced. The MoCoGAN D's image D keeps its
minibatch-std groups of 4 frames whole (mbstd_group counts them in videos),
its video D's noise is the rank's rows of the global draw, and the video
D's batch norms take the global batch's statistics inside the step
(models/mocogan.py:batch_statistics_over): two all_reduces a norm in each D
forward and two in its backward, which carry each rank's loss gradient to
every rank's rows, so the flat gradient mean is the global loss's gradient.
Every rank runs the same D calls and backwards in the same order, so they
issue the same collectives: a Dr1 phase runs the video D's forward (its
all_reduces) but R1 differentiates the image logits alone, so no backward
reaches them, on any rank.

Batch (torch tensors, [B, ...]: the global batch, or with W ranks this
rank's B/W rows of it; moved to the modules' device):
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

from ..models import Discriminator, Generator, MoCoGANDiscriminator
from ..models.mocogan import batch_statistics_over
from ..parallel.distributed import (RowsDraws, World, all_reduce_mean_, frame_rows, mbstd_group,
                                    rank_draws, row_plan, world as current_world)
from ..parallel.zero import make_adam
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
    # ZeRO-1: Adam's moments partitioned over the ranks (parallel/zero.py)
    zero1: bool = False


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
    opt_G: torch.optim.Optimizer          # Adam, or ZeRO-1 over Adam
    opt_D: torch.optim.Optimizer
    pl_mean: torch.Tensor
    augment_p: torch.Tensor
    ada_sign_acc: torch.Tensor


def _mb_ratio(interval: Optional[int]) -> float:
    return 1.0 if interval is None else interval / (interval + 1)


def param_groups(module: torch.nn.Module, lr: float,
                 lr_scales: Optional[Dict[str, float]] = None) -> List[Dict]:
    """`module`'s parameters as Adam parameter groups, in `module.parameters()`
    order: a top-level child named in `lr_scales` at lr * its scale, the rest
    at lr (optax.multi_transform's labels; one group without scales)."""
    groups: List[Dict] = []
    for name, p in module.named_parameters():
        group_lr = lr * (lr_scales or {}).get(name.split(".")[0], 1.0)
        if not groups or groups[-1]["lr"] != group_lr:
            groups.append({"params": [], "lr": group_lr})
        groups[-1]["params"].append(p)
    return groups


def _adam(module: torch.nn.Module, cfg: OptimizerConfig, ratio: float, world: World,
          zero1: bool = False, lr_scales: Optional[Dict[str, float]] = None
          ) -> torch.optim.Optimizer:
    return make_adam(param_groups(module, cfg.lr * ratio, lr_scales), lr=cfg.lr * ratio,
                     betas=(cfg.beta1 ** ratio, cfg.beta2 ** ratio), eps=cfg.eps, world=world,
                     zero1=zero1)


def scrub_grads(params: List[torch.Tensor], clip: float = 1e5) -> None:
    """NaN/Inf gradient scrub before every optimizer step, in place
    (reference training_loop.py:383-385)."""
    for p in params:
        p.grad.nan_to_num_(nan=0.0, posinf=clip, neginf=-clip)


def init_train_state(G: Generator, D: torch.nn.Module, opt_g_cfg: OptimizerConfig,
                     opt_d_cfg: OptimizerConfig, tcfg: TrainingConfig,
                     augment_p: float = 0.0, world: Optional[World] = None,
                     d_lr_scales: Optional[Dict[str, float]] = None) -> TrainState:
    """State around G and D as they are (weights drawn or loaded), on their device.

    G_ema starts as a copy of G. Adam's moments start at zero, as optax's do;
    with tcfg.zero1 and more than one rank in `world` (the default process
    group's when None) they are partitioned over the ranks. `d_lr_scales`
    (D's own `lr_scale_map` when None, as MoCoGAN's D carries; {} for none)
    gives D's Adam a parameter group per scaled child (`param_groups`).
    """
    world = current_world() if world is None else world
    device = next(G.parameters()).device
    if d_lr_scales is None:
        d_lr_scales = getattr(D, "lr_scale_map", None)
    return TrainState(
        step=0, cur_nimg=0, G=G, D=D,
        G_ema=copy.deepcopy(G).eval().requires_grad_(False),
        opt_G=_adam(G, opt_g_cfg, _mb_ratio(tcfg.G_reg_interval), world, tcfg.zero1),
        opt_D=_adam(D, opt_d_cfg, _mb_ratio(tcfg.D_reg_interval), world, tcfg.zero1,
                    d_lr_scales),
        pl_mean=torch.zeros((), device=device),
        augment_p=torch.tensor(augment_p, dtype=torch.float32, device=device),
        ada_sign_acc=torch.zeros((), device=device))


def sample_draws(G: Generator, loss_cfg: LossConfig, batch_size: int, rounds: int,
                 generator: torch.Generator, do_gpl: bool, augment: bool = False,
                 do_dr1: bool = False, d_noise: bool = False) -> Draws:
    """Every random draw of one step (module docstring), on the generator's
    device. The augment pipe and the video D's noise (`d_noise`) draw from
    `generator` itself, when they run."""
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
    sources = [GeneratorDraws(generator)] * rounds
    for key in ("augment",) * augment + ("d_noise",) * d_noise:
        for name in ("Gmain", "Dgen", "Dreal") + (("Dr1",) if do_dr1 else ()):
            draws.setdefault(name, {})[key] = sources
    return draws


def _accumulate(params: List[torch.Tensor], rounds: int,
                run_round: Callable[[int], Tuple[torch.Tensor, Stats]],
                world: World = World()) -> Stats:
    """Gradient accumulation over microbatch rounds (train_step.py:208-234):
    the gradients (into .grad, zero where a parameter got none) and the
    stats are averaged over the rounds; then the gradients over the ranks,
    through one flat buffer. The stats stay this rank's."""
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
    all_reduce_mean_([p.grad for p in params], world)
    return {k: v / rounds for k, v in total.items()}


def make_train_step(G: Generator, D: Discriminator, loss_cfg: LossConfig,
                    tcfg: TrainingConfig, augment_fn=None, d_lr_scales=None,
                    world: Optional[World] = None, allow_tf32: bool = False):
    """Returns train_step(state, batch, generator=None, do_gpl=False,
    do_dr1=False, draws=None) -> (state, stats) for a state around G and D.

    `draws` (module docstring) replaces every random draw of the step; without
    it they come from `generator`, a torch.Generator on the modules' device.
    `augment_fn` is the ADA pipe (training/augment.py:make_augment_pipe) or
    None. `d_lr_scales` is taken for the JAX package's signature only: D's
    learning rates are the groups of the state's opt_D (init_train_state).
    `world` is this process's place among the ranks (the default
    process group's when None; the module docstring says what W ranks
    compute): the batch is then this rank's rows. The step runs its float32
    convolutions and matmuls without TF32 unless `allow_tf32` (the
    original's training option, off by default), and gives the caller's
    settings back when it returns or raises.
    """
    world = current_world() if world is None else world
    W = world.size
    video_noise = isinstance(D, MoCoGANDiscriminator)
    loss = GANLoss(G, D, loss_cfg, augment_fn=augment_fn,
                   batch_mean=world.mean_over_ranks if W > 1 else None)
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

    if W > 1:      # a round whose rows do not split over the ranks raises here
        mbstd_group(D, tcfg.batch_size // rounds_of(tcfg.batch_size), W)

    @float32_precision(allow_tf32)
    @batch_statistics_over(D, world)
    def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
                   generator: Optional[torch.Generator] = None, do_gpl: bool = False,
                   do_dr1: bool = False, draws: Optional[Draws] = None):
        assert state.G is G and state.D is D, "the state is not around this step's G and D"
        B = batch["real_t"].shape[0] * W                              # global videos
        rounds = rounds_of(B)
        if draws is None:
            if generator is None:
                raise ValueError("train_step needs a torch.Generator or explicit draws")
            draws = sample_draws(G, loss_cfg, B, rounds, generator, do_gpl,
                                 augment=augment_fn is not None, do_dr1=do_dr1,
                                 d_noise=video_noise)
        noise = {}               # each phase's source of synthesis's per-layer noise
        if W > 1:
            N = B // rounds
            plan = row_plan(B, rounds, mbstd_group(D, N, W), W, world.rank,
                            loss_cfg.pl_batch_shrink if do_gpl else None)
            draws = rank_draws(draws, plan, num_frames)
            if generator is not None:
                source = GeneratorDraws(generator)
                noise = {name: RowsDraws(source, frame_rows(plan.rows, num_frames),
                                         N * num_frames) for name in ("Gmain", "Dgen")}
                if do_gpl:        # Gpl's rows: the rank's share of a round's first b videos
                    k = len(plan.rows) // loss_cfg.pl_batch_shrink
                    b = N // loss_cfg.pl_batch_shrink
                    noise["Gpl"] = RowsDraws(source, frame_rows(plan.rows[:k], num_frames),
                                             b * num_frames)
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
            """Round r's augment draws and p, and video D noise, for a phase that runs D."""
            out = {}
            if augment_fn is not None:
                out.update(aug_draws=draws[name]["augment"][r], augment_p=state.augment_p)
            if video_noise:
                out["d_noise"] = draws[name]["d_noise"][r]
            return out

        def phase_inputs(name: str, p: int, r: int):
            d = draws[name]
            mix = None
            if loss_cfg.style_mixing_prob > 0:
                mix = (rows(d["mix_cutoff"], r)[0], rows(d["mix_z"], r))
            c = rows(gen_c[:, p], r) if gen_c is not None else None
            return dict(z=rows(d["z"], r), c=c, t=rows(gen_t[:, p], r),
                        motion_z=rows(d["motion_z"], r), mix=mix,
                        generator=noise.get(name, generator))

        stats: Stats = {}

        # ---- Gmain (the w_avg buffer updates in place, round by round) ----
        stats.update(_accumulate(params_G, rounds,
                                 lambda r: loss.gmain(**phase_inputs("Gmain", 0, r),
                                                      **aug_inputs("Gmain", r)), world))
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

            stats.update(_accumulate(params_G, rounds, gpl_round, world))
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

        stats.update(_accumulate(params_D, rounds, dmain_round, world))
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

            stats.update(_accumulate(params_D, rounds, dr1_round, world))
            scrub_grads(params_D, tcfg.grad_clip_value)
            state.opt_D.step()

        with torch.no_grad():
            # ---- the stats over the ranks, before the ADA controller reads them
            if W > 1:
                names = sorted(stats)
                flat = torch.stack([stats[k].detach().float().reshape(()) for k in names])
                all_reduce_mean_([flat], world)
                stats = dict(zip(names, flat.unbind()))

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
