"""Long-running training-stability soak of the port at the FFS-256 shape.

    python -m stylegan_v_tpu_torch.soak_train --rounds 125

The counterpart of scripts/soak_train.py (the JAX package's), with its flags
and defaults plus `--seed` and `--device` (default cuda:0; no card raises,
`--device cpu` runs on the CPU). It builds the FFS-256 G and D
(channel_base=16384, bf16 in the top four resolutions), the step of
training/train_step.py:make_train_step at 16 videos x 3 frames with the bgc
ADA pipe (warp_upsample=2), r1_gamma = 0.0002 * res^2 / B, pl_weight 0, Adam
lr 0.0025 and the ADA controller at target 0.6, and runs rounds of
(r1_every - 1) main steps and one lazy-R1 step on one fixed seeded uint8
batch staged on the device, with the ADA p fed back from step to step.

Every step's watched stats are folded on the device into one finiteness
flag a stat; the flags, the R1 step's stats and augment_p come back to the
host once a round, and the first non-finite value raises, naming the round
and the stats. 125 rounds of 16 are 2000 steps. frames/s counts the model
build, as the JAX script's "incl. compile" does.

The JAX script seeds its step keys from the clock; the port draws every
step's randomness from one torch.Generator seeded with --seed, so a failure
reproduces. The models are drawn from seed 0 and the batch from
np.random.RandomState(0), as the JAX script's.
"""
from __future__ import annotations

import argparse
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

# D's score means and signs and the live ADA p tell whether the adversarial
# equilibrium is healthy (signs drifting to +-1 with p pinned at 0 or its
# limit: collapse); a NaN anywhere is a numeric failure.
WATCH = ("Loss/scores/fake", "Loss/scores/real", "Loss/signs/real", "Loss/G/loss",
         "Loss/r1_penalty")


def build_models(res: int, device: torch.device, channel_base: int = 16384):
    """The FFS-256 G and D at `res` (the JAX script's configs), drawn from seed 0."""
    from .models import Discriminator, DiscriminatorConfig, Generator, GeneratorConfig
    from .models.config import replace

    gen = torch.Generator().manual_seed(0)
    G = Generator(replace(GeneratorConfig(), img_resolution=res, channel_base=channel_base),
                  generator=gen)
    D = Discriminator(replace(DiscriminatorConfig(), img_resolution=res,
                              channel_base=channel_base), generator=gen)
    return G.to(device), D.to(device)


def make_batch(B: int, F: int, res: int, device: torch.device) -> Dict[str, torch.Tensor]:
    """The JAX script's fixed batch from np.random.RandomState(0), in the
    port's layout (frames [B, F, 3, res, res] uint8), on `device`."""
    rng = np.random.RandomState(0)
    t = np.sort(rng.randint(0, 128, size=(B, F)).astype(np.float32), axis=1)
    t += np.arange(F)[None] * 0.1
    batch = {
        "real_img": rng.randint(0, 255, (B, F, res, res, 3)).astype(np.uint8)
                       .transpose(0, 1, 4, 2, 3),
        "real_c": np.zeros((B, 0), np.float32),
        "real_t": t,
        "gen_c": np.zeros((B, 3, 0), np.float32),
        "gen_t": np.stack([t, t + 1, t + 2], axis=1),
    }
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in batch.items()}


def soak(G, D, batch: Dict[str, torch.Tensor], rounds: int, r1_every: int = 16,
         warp_upsample: int = 2, seed: int = 0, t_start: Optional[float] = None,
         log: Callable[[str], None] = print) -> Dict:
    """`rounds` rounds of (r1_every - 1) main steps and one R1 step of the
    soak's step on G and D; raises AssertionError at the first round whose
    watched stats or augment_p are not finite. Returns the last round's
    stats, the final p and frames/s since `t_start` (now when None)."""
    from .training import (AUGPIPE_SPECS, AugmentConfig, LossConfig, OptimizerConfig,
                           TrainingConfig, init_train_state, make_augment_pipe,
                           make_train_step)

    t_start = time.time() if t_start is None else t_start
    device = next(G.parameters()).device
    B, F = batch["real_t"].shape
    res = batch["real_img"].shape[-1]
    tcfg = TrainingConfig(batch_size=B, ada_target=0.6)
    lcfg = LossConfig(r1_gamma=0.0002 * res ** 2 / B, pl_weight=0.0, video_consistent_aug=True)
    opt = OptimizerConfig(0.0025)
    aug = make_augment_pipe(AugmentConfig(**AUGPIPE_SPECS["bgc"], warp_upsample=warp_upsample))
    state = init_train_state(G, D, opt, opt, tcfg)
    step = make_train_step(G, D, lcfg, tcfg, augment_fn=aug)
    generator = torch.Generator(device=device).manual_seed(seed)

    stats: Dict[str, float] = {}
    for r in range(rounds):
        finite: Dict[str, torch.Tensor] = {}
        for i in range(r1_every):
            state, step_stats = step(state, batch, generator=generator,
                                     do_dr1=i == r1_every - 1)
            for k in WATCH:
                if k in step_stats:
                    ok = torch.isfinite(step_stats[k]).all()
                    finite[k] = ok if k not in finite else finite[k] & ok
        flags = dict(zip(finite, torch.stack(list(finite.values())).tolist()))  # one sync
        stats = {k: float(step_stats[k]) for k in WATCH if k in step_stats}
        p = float(state.augment_p)
        bad = [k for k, ok in flags.items() if not ok] + ([] if np.isfinite(p) else ["augment_p"])
        assert not bad, f"non-finite at round {r}: {bad}"
        if r % 10 == 0 or r == rounds - 1:
            steps_done = (r + 1) * r1_every
            fps = steps_done * B * F / (time.time() - t_start)
            line = "  ".join(f"{k.split('/')[-1]}={v:+.3f}" for k, v in stats.items())
            log(f"round {r:4d} (step {steps_done:5d}): p={p:.4f}  {line}  "
                f"[{fps:.1f} f/s incl. build]")
    steps = rounds * r1_every
    fps = steps * B * F / (time.time() - t_start)
    p = float(state.augment_p)
    log(f"SOAK PASS: {steps} steps, zero non-finite stats, final ADA p={p:.4f}, "
        f"{fps:.1f} frames/s sustained (incl. build)")
    return {"steps": steps, "augment_p": p, "frames_per_s": fps, "stats": stats, "state": state}


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--resolution", type=int, default=256)
    ap.add_argument("--rounds", type=int, default=125)
    ap.add_argument("--r1-every", type=int, default=16)
    ap.add_argument("--warp-upsample", type=int, default=2, choices=[1, 2])
    ap.add_argument("--seed", type=int, default=0, help="the step's torch.Generator seed")
    ap.add_argument("--device", default="cuda:0", help="cuda:0 (the default), cuda:N or cpu")
    return ap.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> Dict:
    """The CLI; returns soak()'s summary."""
    from .training.loop import resolve_device

    args = parse_args(argv)
    device = resolve_device(args.device)
    t_start = time.time()
    G, D = build_models(args.resolution, device)
    F = G.cfg.sampling.num_frames_per_video
    print(f"initializing ({args.resolution}^2, batch {args.batch}x{F}, "
          f"warp_upsample={args.warp_upsample}, seed {args.seed}) on {device}...", flush=True)
    batch = make_batch(args.batch, F, args.resolution, device)
    return soak(G, D, batch, args.rounds, args.r1_every, args.warp_upsample, args.seed,
                t_start=t_start, log=lambda s: print(s, flush=True))


if __name__ == "__main__":
    main()
