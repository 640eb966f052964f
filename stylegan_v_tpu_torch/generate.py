"""Video sampling CLI of the port (reference src/scripts/generate.py).

    python -m stylegan_v_tpu_torch.generate --networks-dir runs/exp -o out/ \\
        --num-videos 9 --video-len 64 --as-grids
    python -m stylegan_v_tpu_torch.generate --network x.pkl -o out/ --device cpu

The counterpart of scripts/generate.py (the JAX package's), with its flags
plus `--device` (default cuda; no card raises, `--device cpu` runs on the
CPU). It samples videos from a checkpoint: a port snapshot
(`network-snapshot-<kimg>.pt`, its G_ema; `--networks-dir` picks the one
with the lowest value in metric-fvd2048_16f.jsonl, else the latest) or a
reference `.pkl` (io/legacy.py, its config from the pickle's init kwargs).
z, c, the timestamps and --moco-decomposition's trajectories are drawn with
numpy from `--seed` exactly as the JAX script draws them, so both write the
same videos from the same weights. Outputs: one mp4 a video, a grid mp4
(--as-grids, --moco-decomposition), or frame folders (--save-as-frames).

--frame-shards F synthesises the [videos, frames] grid over W ranks, a
(W/F data x F frame) grid (parallel/sharded_eval.py), each rank its block,
and rank 0 writes: under torchrun it joins the W ranks torchrun started,
else it spawns F ranks.
Rank r runs on cuda:<local rank> over nccl, or, with --device cuda:N, every
rank on that card over gloo (nccl refuses two ranks on one device), or on
the CPU over gloo.
"""
from __future__ import annotations

import argparse
import json
import os
from typing import List, Optional

import numpy as np


def pick_best_checkpoint(networks_dir: str, metric: str = "fvd2048_16f") -> Optional[str]:
    """argmin over metric-<name>.jsonl (reference generate.py:63-75), else the
    latest snapshot in the directory."""
    from .io.checkpoint import find_latest_snapshot
    jsonl = os.path.join(networks_dir, f"metric-{metric}.jsonl")
    if os.path.exists(jsonl):
        best, best_v = None, float("inf")
        with open(jsonl) as f:
            for line in f:
                rec = json.loads(line)
                v = list(rec.get("results", {}).values())
                if v and v[0] < best_v:
                    best_v = v[0]
                    best = rec.get("snapshot")
        if best:
            # the loop names a snapshot by its stem, calc_metrics by its file
            return os.path.join(networks_dir, best if best.endswith((".pt", ".pkl"))
                                else best + ".pt")
    return find_latest_snapshot(networks_dir)


def load_any_checkpoint(path: str, device):
    """The G_ema of a port snapshot (.pt) or of a reference .pkl (its G_ema,
    else its G), on `device`, in eval mode without gradients."""
    from .io.checkpoint import load_snapshot, meta_decode
    from .io.legacy import (StubModule, flatten_module_state, infer_generator_config,
                            load_network_pkl, load_port_state, port_state)
    from .models import Generator

    if path.endswith(".pkl"):
        data = load_network_pkl(path)
        stub = data.get("G_ema") or data.get("G")
        if not isinstance(stub, StubModule):
            raise ValueError(f"{path} holds no torch-era generator (a TF-era pickle has no "
                             "video generator config: resume training from it instead)")
        G = Generator(infer_generator_config(stub))
        load_port_state(G, port_state(flatten_module_state(stub)), require_all=True)
        print(f"  imported reference pkl: {G.cfg.img_resolution}^2, w_dim {G.cfg.w_dim}")
    else:
        payload, meta = load_snapshot(path)
        G = Generator(meta_decode(meta["configs"]["G"]))
        G.load_state_dict(payload["G_ema"])
    return G.to(device).eval().requires_grad_(False)


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--networks-dir", help="run dir with snapshots + metric jsonls")
    ap.add_argument("--network", help="explicit checkpoint path (.pt or .pkl)")
    ap.add_argument("--output-dir", "-o", required=True)
    ap.add_argument("--num-videos", type=int, default=9)
    ap.add_argument("--video-len", type=int, default=16)
    ap.add_argument("--fps", type=float, default=25.0)
    ap.add_argument("--slowmo", type=float, default=1.0,
                    help="fractional-t slow-motion factor (reference generate.py:113)")
    ap.add_argument("--time-offset", type=float, default=0.0)
    ap.add_argument("--truncation-psi", type=float, default=0.9)
    ap.add_argument("--noise-mode", default="const", choices=["const", "random", "none"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--class-idx", type=int, default=None,
                    help="class label for conditional models (omit = random)")
    ap.add_argument("--as-grids", action="store_true",
                    help="one grid mp4 instead of per-video mp4s")
    ap.add_argument("--save-as-frames", action="store_true")
    ap.add_argument("--moco-decomposition", action="store_true",
                    help="3x3 panel: same motion across rows, same content "
                         "across columns (reference generate.py:115-123)")
    ap.add_argument("--batch-size-num-frames", type=int, default=100)
    ap.add_argument("--frame-shards", type=int, default=1,
                    help="split the frame axis over a (data x frame) grid of ranks for "
                         "long clips: num-videos must divide the data axis and video-len "
                         "the frame axis")
    ap.add_argument("--device", default="cuda", help="cuda (the default), cuda:N or cpu")
    return ap.parse_args(argv)


def draw_inputs(args, cfg):
    """z, c, ts and motion_z from np.random.RandomState(seed), in the JAX
    script's order: motion_z is --moco-decomposition's, or with --frame-shards
    every video's own (all ranks synthesise one trajectory), else None
    (generate_videos draws it)."""
    from .models.motion import MotionMappingNetwork
    n = args.num_videos
    rng = np.random.RandomState(args.seed)
    z = rng.randn(n, cfg.z_dim).astype(np.float32)
    ts = (args.time_offset
          + np.tile(np.arange(args.video_len, dtype=np.float32)[None], (n, 1)) / args.slowmo)
    c = None
    if cfg.c_dim > 0:
        idx = (np.full(n, args.class_idx) if args.class_idx is not None
               else rng.randint(cfg.c_dim, size=n))
        c = np.eye(cfg.c_dim, dtype=np.float32)[idx]
    motion_z = None
    if args.moco_decomposition and cfg.has_motion:
        k = int(np.sqrt(n))
        if k * k != n:
            raise ValueError("--moco-decomposition requires a square num-videos")
        L = MotionMappingNetwork.required_traj_len(cfg, float(ts.max()))
        row_motion = rng.randn(k, L, cfg.motion.z_dim).astype(np.float32)
        motion_z = np.repeat(row_motion, k, axis=0)       # same motion per row
        z = np.tile(z[:k], (k, 1))                        # same content per col
    elif args.frame_shards > 1 and cfg.has_motion:
        L = MotionMappingNetwork.required_traj_len(cfg, float(ts.max()))
        motion_z = rng.randn(n, L, cfg.motion.z_dim).astype(np.float32)
    return z, c, ts, motion_z


def run(args, device, world=None) -> Optional[np.ndarray]:
    """Load, synthesise and (rank 0) write; returns the videos [N, T, H, W, C]
    in [0, 1] on rank 0, None on the others."""
    from .parallel.distributed import World
    from .training.video_io import (generate_videos, save_video_frames_as_frames_parallel,
                                    save_video_frames_as_mp4, videos_as_grids)
    from .utils.misc import float32_precision
    world = World() if world is None else world
    log = print if world.is_chief else (lambda *_: None)

    path = args.network or pick_best_checkpoint(args.networks_dir)
    if not path:
        raise FileNotFoundError(f"no checkpoint found in {args.networks_dir}")
    log(f"Loading {path}")
    G = load_any_checkpoint(path, device)
    cfg = G.cfg
    z, c, ts, motion_z = draw_inputs(args, cfg)
    n = args.num_videos

    log(f"Generating {n} videos x {args.video_len} frames...")
    with float32_precision(False):          # float32 convolutions and matmuls, as in JAX
        if args.frame_shards > 1:
            from .parallel.sharded_eval import sharded_generate_frames
            frames = sharded_generate_frames(G, z, c, ts, motion_z, args.frame_shards,
                                             noise_mode=args.noise_mode,
                                             truncation_psi=args.truncation_psi, world=world)
            videos = None if frames is None else np.clip(frames.numpy() * 0.5 + 0.5, 0.0, 1.0)
        else:
            videos = generate_videos(G, z, c, ts, motion_z=motion_z,
                                     noise_mode=args.noise_mode,
                                     truncation_psi=args.truncation_psi,
                                     batch_size_num_frames=args.batch_size_num_frames,
                                     seed=args.seed)
    if not world.is_chief:
        return None

    os.makedirs(args.output_dir, exist_ok=True)
    if args.as_grids or args.moco_decomposition:
        out = os.path.join(args.output_dir, "grid.mp4")
        save_video_frames_as_mp4(videos_as_grids(videos), args.fps, out)
        print(f"Wrote {out}")
    elif args.save_as_frames:
        for i in range(n):
            save_video_frames_as_frames_parallel(
                videos[i], os.path.join(args.output_dir, f"video{i:04d}"))
        print(f"Wrote {n} frame folders to {args.output_dir}")
    else:
        for i in range(n):
            save_video_frames_as_mp4(videos[i], args.fps,
                                     os.path.join(args.output_dir, f"video{i:04d}.mp4"))
        print(f"Wrote {n} mp4s to {args.output_dir}")
    return videos


def _rank(rank: int, world_size: int, init_method: str, argv: List[str],
          local_rank: Optional[int] = None) -> Optional[np.ndarray]:
    """One rank of --frame-shards: join the process group, run, leave."""
    import torch

    from .parallel.distributed import destroy_distributed, init_distributed
    from .training.loop import resolve_device

    args = parse_args(argv)
    dev = resolve_device(args.device)
    backend = "gloo" if dev.index is not None else None     # all ranks on one named card
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", rank if local_rank is None else local_rank)
    if dev.type == "cpu" and "OMP_NUM_THREADS" not in os.environ:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world_size))
    world = init_distributed(backend, rank, world_size, init_method, dev)
    try:
        return run(args, dev, world)
    finally:
        destroy_distributed()


def main(argv: Optional[List[str]] = None) -> Optional[np.ndarray]:
    """The CLI; returns rank 0's videos [N, T, H, W, C] in [0, 1] (None when
    it spawned the ranks, or on another rank)."""
    import sys

    from .parallel.distributed import launch
    from .training.loop import resolve_device

    argv = list(sys.argv[1:] if argv is None else argv)
    args = parse_args(argv)
    device = resolve_device(args.device)
    if args.frame_shards <= 1:
        return run(args, device)
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:          # under torchrun
        return _rank(int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]), "env://", argv,
                     int(os.environ.get("LOCAL_RANK", 0)))
    launch(_rank, args.frame_shards, args=(argv,))
    return None


if __name__ == "__main__":
    main()
