"""Project target video frames into the generator's (w+, motion_z) latent
space (reference src/scripts/project.py:34-223).

    python -m stylegan_v_tpu_torch.project --network x.pkl --target-dir frames/ \\
        -o out/ [--num-steps 1000] [--detector-dir detectors/] [--device cpu]

The counterpart of scripts/project.py (the JAX package's), with its flags plus
`--device` (default cuda; no card raises, `--device cpu` runs on the CPU).
The first --num-frames images of --target-dir in name order, resized to the
generator's resolution (Pillow LANCZOS), are the target: one video of F
frames at t = 0..F-1. The w init is the mean of 1000 mapping samples; the
motion_z init the best of --motion-init-trials draws by the loss; then w+ and
motion_z are optimised jointly with Adam under the reference's lr ramp
up/down and an annealed w noise, with synthesis at noise_mode="none".

Objective: with the reference's TorchScript `vgg16.pt` (the NVIDIA
stylegan2-ada metrics file) in --detector-dir, $SGV_DETECTOR_DIR or
./detectors, the LPIPS distance of the reference (project.py:77-88,139),
run in torch on G's device; without it, the multi-scale pixel + pyramid loss
of the JAX script, whose 2x downsamples are the K1 case of upfirdn2d (K1
forward, K1-bwd in the backward, on the card).

Every random draw (the mapping samples, the motion trials, the w noise) comes
from a torch.Generator on G's device seeded from --seed, or from the draw
source `project` is given. Writes projected.mp4 and projected_latents.npz
(w [1, num_ws, w_dim], motion_z [1, L, motion z_dim]).
"""
from __future__ import annotations

import argparse
import math
import os
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .ops import downsample2d, setup_filter
from .utils.latent_opt import get_lr, make_adam, set_lr

PYRAMID_FILTER = [1, 3, 3, 1]
PYRAMID_LEVELS = 3
W_AVG_SAMPLES = 1000


def find_vgg16(detector_dir: Optional[str] = None) -> Optional[str]:
    cands = [detector_dir, os.environ.get("SGV_DETECTOR_DIR"),
             os.path.join(os.getcwd(), "detectors")]
    for d in cands:
        if d and os.path.isfile(os.path.join(d, "vgg16.pt")):
            return os.path.join(d, "vgg16.pt")
    return None


def make_lpips_features(vgg_path: str, device) -> Callable[[torch.Tensor], torch.Tensor]:
    """The LPIPS feature fn of a TorchScript vgg16.pt on `device`: [N, C, H, W]
    in [-1, 1] -> [N, D], differentiable in its input. Preprocessing as the
    reference's project.py:84-87,136-139: scale to [0, 255], area-downsample
    above 256."""
    model = torch.jit.load(vgg_path, map_location=device).eval()
    for p in model.parameters():
        p.requires_grad_(False)

    def features(x: torch.Tensor) -> torch.Tensor:
        img = (x + 1.0) * (255.0 / 2.0)
        if img.shape[2] > 256:
            img = F.interpolate(img, size=(256, 256), mode="area")
        return model(img, resize_images=False, return_lpips=True)
    return features


def pyramid(x: torch.Tensor) -> List[torch.Tensor]:
    """x and its PYRAMID_LEVELS 2x downsamples by the [1, 3, 3, 1] filter."""
    f = setup_filter(PYRAMID_FILTER)
    levels = [x]
    for _ in range(PYRAMID_LEVELS):
        levels.append(downsample2d(levels[-1], f))
    return levels


def multiscale_loss(a: torch.Tensor, b) -> torch.Tensor:
    """Pixel + pyramid distance in [-1, 1] space, the stand-in for VGG16-LPIPS
    (scripts/project.py:multiscale_loss): the mean squared difference at each
    level of `pyramid`. `b` is the target [N, C, H, W] or its pyramid."""
    b_levels = b if isinstance(b, (list, tuple)) else pyramid(b)
    loss = None
    for x, y in zip(pyramid(a), b_levels):
        term = torch.mean(torch.square(x - y))
        loss = term if loss is None else loss + term
    return loss


def init_w_avg(G, draws, num_samples: int = W_AVG_SAMPLES) -> torch.Tensor:
    """The w init of the reference's project.py:60-72: the mean w of
    num_samples mapping samples, tiled to [1, num_ws, w_dim]."""
    z = draws.randn((num_samples, G.cfg.z_dim))
    with torch.no_grad():
        w_avg = G.mapping(z, None)[:, 0].mean(dim=0)
    return w_avg[None, None].repeat(1, G.num_ws, 1)


def motion_init_search(loss_fn, w: torch.Tensor, draws, shape, trials: int):
    """The best of `trials` motion_z draws of `shape` by loss_fn(w, motion_z)
    (reference project.py:181-223); returns (motion_z, its loss)."""
    best_mz, best_l = None, math.inf
    for _ in range(trials):
        mz = draws.randn(shape)
        with torch.no_grad():
            loss = float(loss_fn(w, mz))
        if loss < best_l:
            best_mz, best_l = mz, loss
    return best_mz, best_l


def projection_loss(G, target: torch.Tensor, lpips=None):
    """loss_fn(w, motion_z) of the projection: G's frames at t = 0..F-1 with
    noise_mode="none" against `target` [F, C, H, W], by the LPIPS feature fn
    `lpips` (the summed squared feature distance) or, without it, by
    multiscale_loss against the target's pyramid, computed here once."""
    t = torch.arange(target.shape[0], dtype=torch.float32, device=target.device)[None]

    def synth(w, motion_z):
        return G.synthesis(w, t=t, motion_z=motion_z, noise_mode="none")

    if lpips is not None:
        with torch.no_grad():
            target_features = lpips(target)

        def loss_fn(w, motion_z):
            return torch.sum(torch.square(lpips(synth(w, motion_z)) - target_features))
        return loss_fn
    target_levels = pyramid(target)

    def loss_fn(w, motion_z):
        return multiscale_loss(synth(w, motion_z), target_levels)
    return loss_fn


def project(G, target: torch.Tensor, num_steps: int = 1000, lr: float = 0.1,
            lr_rampup: float = 0.05, lr_rampdown: float = 0.25, w_noise_scale: float = 0.05,
            motion_init_trials: int = 8, lpips=None, draws=None, seed: int = 0,
            log: Callable[[str], None] = print) -> Dict:
    """Project `target` ([F, C, H, W] in [-1, 1], on G's device) into (w+,
    motion_z). `lpips`: a feature fn (make_lpips_features) for the LPIPS
    objective, else the multi-scale loss, whose target pyramid is computed
    once. `draws`: a source whose randn(shape) gives standard normals on the
    target's device (default: a torch.Generator there seeded from `seed`).

    Returns w [1, num_ws, w_dim], motion_z [1, L, z_dim], the search's best
    loss (`init_loss`), each step's loss (`losses`) and the optimisation's
    host seconds, which end on a synchronising read of the losses."""
    from .models.motion import MotionMappingNetwork
    from .training.augment import GeneratorDraws

    device = target.device
    cfg = G.cfg
    if draws is None:
        draws = GeneratorDraws(torch.Generator(device=device).manual_seed(seed))
    G.train()   # only cuDNN's LSTM backward reads the mode: no layer of G acts on it
    num_frames = target.shape[0]
    loss_fn = projection_loss(G, target, lpips)
    w0 = init_w_avg(G, draws)
    L = MotionMappingNetwork.required_traj_len(cfg, float(num_frames))
    mz0, init_loss = motion_init_search(loss_fn, w0, draws, (1, L, cfg.motion.z_dim),
                                        motion_init_trials)
    log(f"motion init search: best of {motion_init_trials} -> {init_loss:.4f}")

    w = w0.clone().requires_grad_(True)
    mz = mz0.clone().requires_grad_(True)
    opt = make_adam([w, mz])
    losses = []
    t0 = time.perf_counter()
    for step in range(num_steps):
        frac = step / num_steps
        step_lr = get_lr(frac, lr, lr_rampdown, lr_rampup)
        set_lr(opt, step_lr)
        w_noise = w_noise_scale * max(0.0, 1.0 - frac / 0.75) ** 2
        loss = loss_fn(w + w_noise * draws.randn(w.shape), mz)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        losses.append(loss.detach())
        if step % 100 == 0 or step == num_steps - 1:
            log(f"step {step:5d}  loss {float(losses[-1]):.5f}  lr {step_lr:.4f}")
    losses = torch.stack(losses).tolist() if losses else []
    seconds = time.perf_counter() - t0
    return dict(w=w.detach(), motion_z=mz.detach(), init_loss=init_loss, losses=losses,
                seconds=seconds)


def load_target(target_dir: str, num_frames: int, res: int) -> torch.Tensor:
    """The first num_frames images of target_dir in name order, LANCZOS-resized
    to res: [F, C, H, W] float32 in [-1, 1] on the CPU."""
    import PIL.Image
    frames = sorted(os.listdir(target_dir))[:num_frames]
    target = np.stack([
        np.asarray(PIL.Image.open(os.path.join(target_dir, f)).resize((res, res),
                                                                       PIL.Image.LANCZOS),
                   dtype=np.float32) for f in frames]) / 127.5 - 1.0
    return torch.from_numpy(target).permute(0, 3, 1, 2).contiguous()


def main(argv: Optional[List[str]] = None) -> Dict:
    """The CLI; returns `project`'s result."""
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--network", required=True, help="a snapshot (.pt) or a reference .pkl")
    ap.add_argument("--target-dir", required=True,
                    help="directory of target frames (000000.jpg ...)")
    ap.add_argument("--output-dir", "-o", required=True)
    ap.add_argument("--num-steps", type=int, default=1000)
    ap.add_argument("--num-frames", type=int, default=8)
    ap.add_argument("--lr", type=float, default=0.1)
    ap.add_argument("--lr-rampup", type=float, default=0.05)
    ap.add_argument("--lr-rampdown", type=float, default=0.25)
    ap.add_argument("--w-noise-scale", type=float, default=0.05)
    ap.add_argument("--motion-init-trials", type=int, default=8)
    ap.add_argument("--detector-dir", default=None,
                    help="directory containing vgg16.pt (LPIPS); falls back "
                         "to SGV_DETECTOR_DIR / ./detectors")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (the default), cuda:N or cpu")
    args = ap.parse_args(argv)

    from .generate import load_any_checkpoint
    from .training.loop import resolve_device
    from .training.video_io import save_video_frames_as_mp4
    from .utils.misc import float32_precision

    device = resolve_device(args.device)
    G = load_any_checkpoint(args.network, device)
    target = load_target(args.target_dir, args.num_frames, G.cfg.img_resolution).to(device)

    vgg_path = find_vgg16(args.detector_dir)
    if vgg_path:
        print(f"Using VGG16-LPIPS perceptual loss ({vgg_path})")
    else:
        print("vgg16.pt not found: using multi-scale pixel/Laplacian loss "
              "(see --detector-dir)")
    with float32_precision(False):          # float32 convolutions and matmuls, as in JAX
        lpips = make_lpips_features(vgg_path, device) if vgg_path else None
        result = project(G, target, num_steps=args.num_steps, lr=args.lr,
                         lr_rampup=args.lr_rampup, lr_rampdown=args.lr_rampdown,
                         w_noise_scale=args.w_noise_scale,
                         motion_init_trials=args.motion_init_trials, lpips=lpips,
                         seed=args.seed)
        t = torch.arange(target.shape[0], dtype=torch.float32, device=device)[None]
        with torch.no_grad():
            final = G.synthesis(result["w"], t=t, motion_z=result["motion_z"],
                                noise_mode="none")
    final = (final * 0.5 + 0.5).clamp(0, 1).permute(0, 2, 3, 1).cpu().numpy()

    os.makedirs(args.output_dir, exist_ok=True)
    save_video_frames_as_mp4(final, 25.0, os.path.join(args.output_dir, "projected.mp4"))
    np.savez(os.path.join(args.output_dir, "projected_latents.npz"),
             w=result["w"].cpu().numpy(), motion_z=result["motion_z"].cpu().numpy())
    print(f"Wrote projected.mp4 + projected_latents.npz to {args.output_dir}")
    return result


if __name__ == "__main__":
    main()
