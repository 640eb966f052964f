"""Adversarial-dynamics probe of the port at demo scale: score telemetry a step.

    python -m stylegan_v_tpu_torch.diag_dynamics --data data/moving64.zip --steps 200
    python -m stylegan_v_tpu_torch.diag_dynamics --data data/moving64.zip --freeze-d

The counterpart of scripts/diag_dynamics.py (the JAX package's), with its
flags and defaults plus `--device` (default cuda:0; no card raises,
`--device cpu` runs on the CPU). It runs the port's real training step
(training/train_step.py:make_train_step; lazy R1 every 16th step, no Gpl) on
the moving-pattern dataset (scripts/make_moving_dataset.py) through the zip
loader, and prints D(real) and D(fake) logits every --log-every steps:

  --freeze-d   sets D's Adam lr to 0: if G cannot push the D(fake) logits up
               against a FROZEN random-init D, the G gradient path is
               broken; if it can, a divergence is an equilibrium problem
               (D memorising small data), not a bug.
  (default)    a normal adversarial run, with gamma, lr and augment to
               bisect which ingredient restores the equilibrium.

The models are drawn from a torch.Generator seeded with --seed, the step's
randomness from another on the device seeded alike, and the loader from
--seed, so a run repeats.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional, Tuple

import torch


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--data", default="data/moving64.zip")
    ap.add_argument("--res", type=int, default=64)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--channel-base", type=int, default=8192)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--lr", type=float, default=0.0025)
    ap.add_argument("--d-lr", type=float, default=None,
                    help="override D lr (default: same as --lr)")
    ap.add_argument("--gamma", type=float, default=0.0512)
    ap.add_argument("--augment-p", type=float, default=0.0,
                    help="fixed ADA p (no controller in this probe)")
    ap.add_argument("--augpipe", default="bgc")
    ap.add_argument("--freeze-d", action="store_true")
    ap.add_argument("--dataset-frames", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda:0", help="cuda:0 (the default), cuda:N or cpu")
    return ap.parse_args(argv)


def build(args: argparse.Namespace, device: torch.device):
    """(state, step, dataset, sampling, d_lr): the probe's models, state and
    step, as the JAX script builds them."""
    import dataclasses

    from .data import VideoFramesFolderDataset
    from .models import Discriminator, Generator
    from .models.config import DiscriminatorConfig, GeneratorConfig, SamplingConfig
    from .training import (AUGPIPE_SPECS, AugmentConfig, LossConfig, OptimizerConfig,
                           TrainingConfig, init_train_state, make_augment_pipe,
                           make_train_step)

    res, B = args.res, args.batch
    sampling = SamplingConfig(num_frames_per_video=3, max_num_frames=args.dataset_frames)
    gen_cfg = dataclasses.replace(GeneratorConfig(), img_resolution=res,
                                  channel_base=args.channel_base, sampling=sampling)
    disc_cfg = dataclasses.replace(DiscriminatorConfig(), img_resolution=res,
                                   channel_base=args.channel_base, sampling=sampling)
    gen = torch.Generator().manual_seed(args.seed)
    G = Generator(gen_cfg, generator=gen).to(device)
    D = Discriminator(disc_cfg, generator=gen).to(device)

    loss_cfg = LossConfig(r1_gamma=args.gamma, pl_weight=0.0, video_consistent_aug=True)
    tcfg = TrainingConfig(batch_size=B, ema_kimg=2.0, ada_target=None)
    d_lr = 0.0 if args.freeze_d else (args.d_lr if args.d_lr is not None else args.lr)
    state = init_train_state(G, D, OptimizerConfig(lr=args.lr), OptimizerConfig(lr=d_lr),
                             tcfg, augment_p=args.augment_p)
    augment_fn = (make_augment_pipe(AugmentConfig(**AUGPIPE_SPECS[args.augpipe]))
                  if args.augpipe != "none" and args.augment_p > 0 else None)
    step = make_train_step(G, D, loss_cfg, tcfg, augment_fn=augment_fn)
    dataset = VideoFramesFolderDataset(path=args.data, sampling=sampling,
                                       max_num_frames=args.dataset_frames)
    return state, step, dataset, sampling, d_lr


def main(argv: Optional[List[str]] = None) -> Tuple[List[Tuple[int, Dict[str, float]]], object]:
    """The CLI; returns the logged (step, stats) rows and the final state."""
    from .data import DeviceLoader, TrainingDataLoader
    from .training.loop import resolve_device

    args = parse_args(argv)
    device = resolve_device(args.device)
    state, step_fn, dataset, sampling, d_lr = build(args, device)
    loader = TrainingDataLoader(dataset, batch_size=args.batch, gen_sampling=sampling,
                                use_fractional_t=True, seed=args.seed, num_workers=2)
    batches = DeviceLoader(loader, device)
    generator = torch.Generator(device=device).manual_seed(args.seed)

    mode = "FROZEN-D (G sanity)" if args.freeze_d else "adversarial"
    print(f"mode={mode} lr={args.lr} d_lr={d_lr} gamma={args.gamma} "
          f"p={args.augment_p} pipe={args.augpipe} videos={len(dataset)} device={device}",
          flush=True)
    t0 = time.time()
    hist = []
    try:
        for step in range(args.steps):
            state, stats = step_fn(state, next(batches), generator=generator,
                                   do_gpl=False, do_dr1=(step % 16 == 0))
            if step % args.log_every == 0 or step == args.steps - 1:
                s = {k: float(v) for k, v in stats.items()}
                hist.append((step, s))
                print(f"step {step:4d}  Dreal {s['Loss/scores/real']:+7.3f}  "
                      f"Dfake {s['Loss/scores/fake']:+7.3f}  "
                      f"Gloss {s['Loss/G/loss']:6.3f}  "
                      f"r1 {s.get('Loss/r1_penalty', float('nan')):8.5f}  "
                      f"({time.time() - t0:5.1f}s)", flush=True)
    finally:
        batches.close()

    first, last = hist[0][1], hist[-1][1]
    d_fake = last["Loss/scores/fake"] - first["Loss/scores/fake"]
    print(f"\nD(fake) logit delta over run: {d_fake:+.3f} "
          f"({'G CAN push logits up' if d_fake > 0.5 else 'G made no progress'})", flush=True)
    return hist, state


if __name__ == "__main__":
    main()
