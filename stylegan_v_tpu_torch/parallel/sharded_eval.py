"""Frame-sharded video synthesis over the ranks of a process group.

The port's counterpart of stylegan_v_tpu/parallel/sharded_eval.py:
sharded_generate_frames. Frames are independent given the videos' w and
motion trajectories, so W ranks form a (data x frame) grid: rank
r = d * frame_shards + f synthesises the block of videos d and timestamps f
of the [V, T] grid, with every video's whole motion trajectory (`motion_z`,
the same on every rank), and rank 0 gathers the blocks and prints the
gather's time. No collective runs
while the frames are made. Per-layer noise in 'random' mode is the global
[V*T] grid's draw from a generator seeded with 1 (the JAX function's noise
key), of which each rank keeps its frames, so the frames do not depend on
the grid.

The JAX package's `sharded_map_batched` has no counterpart: the port's
metrics split their items over the ranks themselves (metrics/metric_utils.py).
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..training.augment import GeneratorDraws
from .distributed import RowsDraws, World, world as current_world


def frame_grid(V: int, T: int, frame_shards: int, world: World):
    """(data, videos a rank, frames a rank, d, f) of `world`'s rank in the
    (data x frame) grid; raises where V or T does not split evenly."""
    if frame_shards < 1 or world.size % frame_shards != 0:
        raise ValueError(f"{world.size} ranks do not divide into {frame_shards} frame shards")
    data = world.size // frame_shards
    if V % data != 0 or T % frame_shards != 0:
        raise ValueError(f"videos {V} / frames {T} must divide the {data}x{frame_shards} "
                         f"(data x frame) grid")
    d, f = divmod(world.rank, frame_shards)
    return data, V // data, T // frame_shards, d, f


def sharded_generate_frames(G, z, c, ts, motion_z, frame_shards: int,
                            noise_mode: str = "const", truncation_psi: float = 1.0,
                            world: Optional[World] = None) -> Optional[torch.Tensor]:
    """Synthesize the frames of every (video, timestamp) pair over the ranks.

    Args:
        G: the port's Generator, the same weights on every rank, on this
           rank's device; z [V, z_dim], c [V, c_dim] or None, ts [V, T],
           motion_z [V, L, mz] or None (numpy arrays or tensors, the same on
           every rank); frame_shards: the grid's frame axis; `world` the
           default process group's when None.
    Returns, on rank 0, float32 frames in [-1, 1] on the CPU, [V, T, H, W, C]
    (the layout of the JAX function and of the CLI's writers); None on the
    other ranks.
    """
    world = current_world() if world is None else world
    device = next(G.parameters()).device

    def tensor(x):
        return None if x is None else torch.as_tensor(x, dtype=torch.float32, device=device)

    if motion_z is None and G.cfg.has_motion:
        raise ValueError("pass motion_z: every rank must synthesise the same trajectories")
    z, c, ts, motion_z = tensor(z), tensor(c), tensor(ts), tensor(motion_z)
    V, T = ts.shape
    data, nv, nt, d, f = frame_grid(V, T, frame_shards, world)
    vids, frames = slice(d * nv, (d + 1) * nv), slice(f * nt, (f + 1) * nt)
    rows = (np.arange(V)[vids, None] * T + np.arange(T)[None, frames]).reshape(-1)
    noise = RowsDraws(GeneratorDraws(torch.Generator(device=device).manual_seed(1)), rows,
                      V * T)
    with torch.no_grad():
        img = G(z[vids], None if c is None else c[vids], ts[vids, frames],
                truncation_psi=truncation_psi,
                motion_z=None if motion_z is None else motion_z[vids],
                noise_mode=noise_mode, generator=noise)           # [nv*nt, C, H, W]
    block = img.float().reshape(nv, nt, *img.shape[1:]).permute(0, 1, 3, 4, 2).contiguous()
    if world.size == 1:
        return block.cpu()
    if world.backend == "gloo":
        block = block.cpu()
    elif block.is_cuda:
        torch.cuda.synchronize(device)             # the synthesis is not the gather's time
    t0 = time.perf_counter()
    blocks = [torch.empty_like(block) for _ in range(world.size)]
    dist.all_gather(blocks, block)
    if not world.is_chief:
        return None
    out = torch.empty((V, T) + tuple(block.shape[2:]))
    for r, b in enumerate(blocks):
        rd, rf = divmod(r, frame_shards)
        out[rd * nv:(rd + 1) * nv, rf * nt:(rf + 1) * nt] = b.cpu()
    print(f"Gathered {V} x {T} frames from {world.size} ranks in "
          f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
    return out
