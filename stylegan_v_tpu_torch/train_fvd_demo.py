"""End-to-end quality demo of the port: FVD falling over training on procedural data.

    python -m stylegan_v_tpu_torch.train_fvd_demo --outdir runs/fvd_demo_torch \\
        --total-kimg 500 --kimg-per-tick 8 --snap-ticks 2 --gamma 1.0 \\
        --augment-p 0.2 --ada-kimg 50 --ada-target 0.6 --workers 3

The counterpart of scripts/train_fvd_demo.py (the JAX package's), with its
flags and defaults plus `--device` (default cuda; no card raises, `--device
cpu` runs on the CPU). It trains the G and D of the port at 64^2 on the
moving-pattern dataset (scripts/make_moving_dataset.py, written from --seed
when --data is missing) through the whole pipeline: zip -> loader ->
training loop (ADA, lazy R1, EMA) -> fvd2048_16f after every snapshot, and
prints the FVD series.

The FVD's I3D has fixed random weights (`register_random_i3d`): a
random-feature Frechet distance, not comparable to Kinetics-I3D FVD, but a
witness of convergence through the same metric stack. Its weights follow
the JAX demo's distribution (flax's lecun_normal: a normal truncated at two
standard deviations, variance 1/fan_in; zero biases; identity batch norms),
so the port's FVD values lie on the JAX run's scale, though they are
another draw of it.
"""
from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import math
import os
import sys
import threading
import traceback
from typing import List, Optional, Tuple

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FVD_FRAMES = 16                       # fvd2048_16f's clip length
METRIC = "fvd2048_16f"
# the standard deviation of a unit normal truncated to [-2, 2]: flax divides
# the target standard deviation by it, so the truncated draw keeps its variance
TRUNC_STD = 0.87962566103423978


def load_maker():
    """scripts/make_moving_dataset.py, loaded by path (numpy and Pillow only)."""
    spec = importlib.util.spec_from_file_location(
        "make_moving_dataset", os.path.join(REPO, "scripts", "make_moving_dataset.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@torch.no_grad()
def lecun_normal_(module: torch.nn.Module, generator: torch.Generator) -> torch.nn.Module:
    """flax's lecun_normal on every Conv3d weight of `module` (the I3D's): a
    unit normal truncated to [-2, 2] (inverse CDF in float64 from
    `generator`'s uniforms), scaled by sqrt(1 / fan_in) / TRUNC_STD; biases
    0, batch norms the identity. fan_in is a filter's size, kd * kh * kw *
    in channels."""
    lo, hi = math.erf(-2 / math.sqrt(2)), math.erf(2 / math.sqrt(2))
    for m in module.modules():
        if isinstance(m, torch.nn.Conv3d):
            u = torch.rand(m.weight.shape, generator=generator, dtype=torch.float64)
            x = math.sqrt(2) * torch.erfinv(lo + (hi - lo) * u)
            std = math.sqrt(1.0 / m.weight[0].numel()) / TRUNC_STD
            m.weight.copy_(x.clamp(-2.0, 2.0) * std)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
            m.reset_parameters()
    return module


def random_i3d(seed: int):
    """The demo's I3D, drawn on the CPU from `seed`, so that every device gets
    the same weights."""
    from .metrics.detectors import InceptionI3d
    model = lecun_normal_(InceptionI3d(), torch.Generator().manual_seed(seed))
    return model.eval().requires_grad_(False)


def i3d_cache_tag(seed: int, num_frames: int, res: int, resize224: bool) -> str:
    """The dataset-stats cache tag of the demo's I3D. It names the port's draw
    ("torch-"), so that a shared cache never hands the port the real-data
    statistics of the JAX demo's detector, another draw under the same seed."""
    return f"torch-rand-i3d-s{seed}-f{num_frames}-r{res}-{'224' if resize224 else 'native'}"


def register_random_i3d(seed: int, num_frames: int, res: int, resize224: bool,
                        device) -> None:
    """Override the metrics' 'i3d' detector with `random_i3d(seed)` on `device`.
    resize224=False runs the (fully convolutional) I3D at the dataset's
    resolution, about 12x cheaper at 64^2 and as valid for a random-feature
    distance."""
    from .metrics import metric_utils
    from .metrics.detectors import i3d_features_fn
    model = random_i3d(seed).to(device)

    def make_features(rescale: bool = True, resize: bool = True, return_features: bool = True,
                      batch_size: int = 16, **_):
        return i3d_features_fn(model, batch_size=batch_size, device=device, rescale=rescale,
                               resize=resize and resize224, return_features=return_features)

    metric_utils.register_detector("i3d", make_features,
                                   cache_tag=i3d_cache_tag(seed, num_frames, res, resize224))


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--outdir", default="runs/fvd_demo")
    ap.add_argument("--data", default="data/moving64.zip")
    ap.add_argument("--videos", type=int, default=512)
    ap.add_argument("--dataset-frames", type=int, default=32)
    ap.add_argument("--res", type=int, default=64)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--channel-base", type=int, default=8192)
    ap.add_argument("--total-kimg", type=float, default=100)
    ap.add_argument("--kimg-per-tick", type=float, default=8.0)
    ap.add_argument("--snap-ticks", type=int, default=1)
    ap.add_argument("--fvd-items", type=int, default=256,
                    help="max_real/num_gen override for the demo-scale FVD")
    ap.add_argument("--resize224", action="store_true",
                    help="run I3D at its native 224^2 input (slower)")
    ap.add_argument("--augpipe", default="bgc",
                    help="ADA augment pipe spec name (training/augment.py AUGPIPE_SPECS) or "
                         "'none'; 'blit' keeps ADA live without the geometric warp")
    ap.add_argument("--lr", type=float, default=0.0025)
    ap.add_argument("--gamma", type=float, default=1.0,
                    help="R1 gamma; 0 for the 0.0002*res^2/B heuristic (reference train.py "
                         "cfg_specs), which lets D run away on this 512-video set")
    ap.add_argument("--ada-target", type=float, default=0.6)
    ap.add_argument("--ada-kimg", type=float, default=50.0,
                    help="ADA ramp speed: kimg for p to move one unit (the reference's 500 is "
                         "tuned for 25000-kimg runs)")
    ap.add_argument("--augment-p", type=float, default=0.2, help="initial ADA p")
    ap.add_argument("--detector-seed", type=int, default=17)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--resume", default=None,
                    help="'latest' resumes the newest snapshot in --outdir")
    ap.add_argument("--device", default="cuda", help="cuda (the default), cuda:N or cpu")
    return ap.parse_args(argv)


def build_setup(args: argparse.Namespace):
    """The demo's TrainSetup, as the JAX demo builds it (scripts/train_fvd_demo.py)."""
    from .models.config import DiscriminatorConfig, GeneratorConfig, SamplingConfig
    from .train_setup import TrainSetup
    from .training.augment import AUGPIPE_SPECS, AugmentConfig
    from .training.loss import LossConfig
    from .training.train_step import OptimizerConfig, TrainingConfig

    res, B = args.res, args.batch
    sampling = SamplingConfig(num_frames_per_video=3, max_num_frames=args.dataset_frames)
    gen_cfg = dataclasses.replace(GeneratorConfig(), img_resolution=res,
                                  channel_base=args.channel_base, sampling=sampling)
    disc_cfg = dataclasses.replace(DiscriminatorConfig(), img_resolution=res,
                                   channel_base=args.channel_base, sampling=sampling)
    no_aug = args.augpipe == "none"
    return TrainSetup(
        run_dir=args.outdir, desc="fvd-demo-moving64",
        gen_cfg=gen_cfg, disc_cfg=disc_cfg,
        loss_cfg=LossConfig(r1_gamma=args.gamma if args.gamma > 0 else 0.0002 * res ** 2 / B,
                            pl_weight=0.0, video_consistent_aug=True),
        train_cfg=TrainingConfig(batch_size=B, ema_kimg=2.0, ada_kimg=args.ada_kimg,
                                 ada_target=None if no_aug else args.ada_target),
        opt_g=OptimizerConfig(lr=args.lr), opt_d=OptimizerConfig(lr=args.lr),
        augment_cfg=None if no_aug else AugmentConfig(**AUGPIPE_SPECS[args.augpipe]),
        augment_p=0.0 if no_aug else args.augment_p,
        dataset_kwargs=dict(path=args.data, sampling=sampling,
                            max_num_frames=args.dataset_frames),
        sampling_cfg=sampling, use_fractional_t=True,
        total_kimg=args.total_kimg, kimg_per_tick=args.kimg_per_tick,
        snap_ticks=args.snap_ticks, metrics=[METRIC],
        seed=args.seed, num_chips=1, resume=args.resume, freeze_layers=0,
        num_workers=args.workers,
        metric_kwargs=dict(max_real_override=args.fvd_items, num_gen_override=args.fvd_items))


def fvd_series(path: str) -> List[Tuple[int, float]]:
    """(snapshot_nimg, FVD) of each row of a metric jsonl, in file order."""
    if not os.path.exists(path):
        return []
    with open(path) as f:
        rows = [json.loads(line) for line in f]
    return [(r.get("snapshot_nimg", -1), r["results"][METRIC]) for r in rows]


class StallWatchdog:
    """Every `interval` seconds, every thread's Python stack to stderr, to tell
    a long silent phase from a hang after the fact. A Python thread reads the
    stacks under the interpreter lock (sys._current_frames). It stands in for
    the JAX demo's faulthandler.dump_traceback_later, whose C thread walks the
    running threads' frames without the lock: its third dump crashed a
    500-kimg run of this demo on the card with a segmentation fault, halfway
    through the main thread's stack."""

    def __init__(self, interval: float = 600.0):
        self.interval, self.stop = interval, threading.Event()
        self.thread = threading.Thread(target=self._run, name="stall-watchdog", daemon=True)

    def _run(self) -> None:
        while not self.stop.wait(self.interval):
            names = {t.ident: t.name for t in threading.enumerate()}
            out = [f"Stall watchdog: every thread's stack after {self.interval:g} s"]
            for ident, frame in sys._current_frames().items():
                if ident != threading.get_ident():
                    out.append(f"Thread {names.get(ident, ident)} (most recent call last):")
                    out.extend(line.rstrip("\n") for line in traceback.format_stack(frame))
            print("\n".join(out), file=sys.stderr, flush=True)

    def __enter__(self):
        self.thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop.set()
        self.thread.join()


def main(argv: Optional[List[str]] = None) -> List[Tuple[int, float]]:
    """The CLI; returns the FVD series of --outdir's metric jsonl."""
    from .training.loop import resolve_device, training_loop

    args = parse_args(argv)
    device = resolve_device(args.device)
    with StallWatchdog():
        if not os.path.exists(args.data):
            load_maker().write_dataset(args.data, args.videos, args.dataset_frames, args.res,
                                       seed=args.seed)
            print(f"dataset -> {args.data}", flush=True)
        register_random_i3d(args.detector_seed, FVD_FRAMES, args.res, args.resize224, device)
        training_loop(build_setup(args), device=device)

    series = fvd_series(os.path.join(args.outdir, f"metric-{METRIC}.jsonl"))
    if series:
        print("\nFVD (random-feature I3D) over training:")
        for nimg, fvd in series:
            print(f"  nimg {nimg:>9}: {fvd:10.6g}")
    if len(series) >= 2:
        first, last = series[0][1], series[-1][1]
        print(f"first -> last: {first:.6g} -> {last:.6g} "
              f"({'DECREASED' if last < first else 'did not decrease'})")
    return series


if __name__ == "__main__":
    main()
