"""Generator throughput harness of the port (reference
src/scripts/profile_model.py:45-100): a warm-up, then timed syntheses per
batch size; prints s/iter, frames/s and peak device memory.

    python -m stylegan_v_tpu_torch.profile_model --resolution 256 --batch-sizes 4,8,16,32
    python -m stylegan_v_tpu_torch.profile_model --network runs/exp/network-snapshot-000100.pt

The counterpart of scripts/profile_model.py (the JAX package's), with its
flags plus `--device` (default cuda; no card raises). `--network` is a port
snapshot or a reference .pkl (generate.py:load_any_checkpoint); without it G
is a fresh draw at --resolution. On the card each batch size's --iters
syntheses (noise_mode="const") are timed with CUDA events and its peak
memory is torch.cuda.max_memory_allocated, reset per batch size; on the CPU
the host clock times them and there is no memory column. `--trace-dir`
writes a torch.profiler trace of the timed calls (trace.json, for
chrome://tracing or Perfetto).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import time
from typing import Dict, List, Optional

import torch


def profile_for_batch_size(G, videos: int, frames: int, iters: int = 10) -> Dict[str, float]:
    """Seconds per synthesis of `videos` clips of `frames` frames and frames/s,
    after one warm-up call. z comes from a generator seeded with the clock's
    seconds, as the JAX harness seeds its key, the motion trajectories from
    one seeded 0."""
    device = next(G.parameters()).device
    gen = torch.Generator(device=device).manual_seed(int(time.time()) & 0x7FFFFFFF)
    motion = torch.Generator(device=device).manual_seed(0)
    t = torch.arange(frames, dtype=torch.float32, device=device)[None].repeat(videos, 1)
    zs = torch.randn(iters + 1, videos, G.cfg.z_dim, generator=gen, device=device)
    with torch.no_grad():
        G(zs[0], None, t, noise_mode="const", generator=motion)          # warm-up
        if device.type == "cuda":
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            for z in zs[1:]:
                G(z, None, t, noise_mode="const", generator=motion)
            end.record()
            end.synchronize()
            elapsed = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            for z in zs[1:]:
                G(z, None, t, noise_mode="const", generator=motion)
            elapsed = time.perf_counter() - t0
    return dict(sec_per_iter=elapsed / iters, frames_per_sec=iters * videos * frames / elapsed)


def profile(G, batch_sizes: List[int], frames: int, iters: int,
            trace_dir: Optional[str] = None) -> List[Dict[str, float]]:
    """profile_for_batch_size for each batch size, one printed row each; returns
    the rows (peak_gib only on the card)."""
    from .utils.misc import float32_precision
    device = next(G.parameters()).device
    cuda = device.type == "cuda"
    print(f"device: {torch.cuda.get_device_name(device) if cuda else 'cpu'}  "
        f"resolution: {G.cfg.img_resolution}")
    print(f"{'videos':>8} {'frames':>7} {'s/iter':>9} {'frames/sec':>12}"
        + (f" {'peak-mem':>10}" if cuda else ""))
    prof = (torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]
                                   + ([torch.profiler.ProfilerActivity.CUDA] if cuda else []))
            if trace_dir else contextlib.nullcontext())
    rows = []
    with prof, float32_precision(False):
        for bs in batch_sizes:
            if cuda:
                torch.cuda.reset_peak_memory_stats(device)
            r = dict(videos=bs, frames=frames, **profile_for_batch_size(G, bs, frames, iters))
            line = (f"{bs:>8} {frames:>7} {r['sec_per_iter']:>9.3f} "
                    f"{r['frames_per_sec']:>12.1f}")
            if cuda:
                r["peak_gib"] = torch.cuda.max_memory_allocated(device) / 2 ** 30
                line += f" {r['peak_gib']:>9.2f}G"
            print(line)
            rows.append(r)
    if trace_dir:
        os.makedirs(trace_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
        print(f"trace written to {trace_dir}")
    return rows


def main(argv: Optional[List[str]] = None) -> List[Dict[str, float]]:
    """The CLI; returns one row a batch size."""
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--network", default=None,
                    help="a port snapshot (.pt) or a reference .pkl (default: a fresh draw)")
    ap.add_argument("--resolution", type=int, default=256)
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--batch-sizes", default="4,8,16,32")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--trace-dir", default=None, help="write a torch.profiler trace there")
    ap.add_argument("--device", default="cuda", help="cuda (the default), cuda:N or cpu")
    args = ap.parse_args(argv)

    from .training.loop import resolve_device
    device = resolve_device(args.device)
    if args.network:
        from .generate import load_any_checkpoint
        G = load_any_checkpoint(args.network, device)
    else:
        from .models import Generator, GeneratorConfig
        cfg = dataclasses.replace(GeneratorConfig(), img_resolution=args.resolution)
        G = Generator(cfg, generator=torch.Generator().manual_seed(0))
        G = G.to(device).eval().requires_grad_(False)
    return profile(G, [int(b) for b in args.batch_sizes.split(",")], args.frames, args.iters,
                   args.trace_dir)


if __name__ == "__main__":
    main()
