"""Video generation + media IO helpers.

Behavioral parity with reference src/training/logging.py: a video of ANY
length is synthesized chunk-wise against ONE shared motion_z trajectory so
chunks stay temporally coherent (logging.py:37-65); timestamps may be
fractional (slow-mo). Output media: mp4 (cv2), JPEG/PNG frame folders,
image grids.

The port's counterpart of stylegan_v_tpu/training/video_io.py: generate_videos
runs the port's Generator; the media helpers are copies, each importing
Pillow or cv2 at first use.
"""
from __future__ import annotations

import math
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch

from ..models.motion import MotionMappingNetwork


def generate_videos(G, z, c, ts, motion_z=None, noise_mode: str = "const",
                    truncation_psi: float = 1.0, batch_size_num_frames: int = 100,
                    seed: int = 0) -> np.ndarray:
    """Chunked video synthesis (reference logging.py:17-81) on G's device.

    Args:
        G: the port's Generator (its weights are used as they are).
        z [N, z_dim], c [N, c_dim] or None, ts [N, T] float timestamps
        (numpy arrays or tensors).
        motion_z: optional precomputed trajectories [N, L, motion_z_dim];
                  sampled once for the FULL clip when absent.
    Every draw comes from a torch.Generator on G's device seeded from `seed`
    (motion_z), `seed + 1` (the class-conditional truncation's w samples)
    or 1 (per-layer noise in noise_mode="random"), never from the global RNG.
    Returns float32 videos [N, T, H, W, C] in [0, 1].
    """
    device = next(G.parameters()).device
    cfg = G.cfg

    def tensor(x):
        return torch.as_tensor(x, dtype=torch.float32, device=device)

    def generator(s):
        return torch.Generator(device=device).manual_seed(s)

    z = tensor(z)
    ts = tensor(ts)
    N, T = ts.shape

    if motion_z is None and cfg.has_motion:
        # one trajectory for the whole clip (temporal coherence across chunks)
        L = MotionMappingNetwork.required_traj_len(cfg, float(ts.max()))
        motion_z = torch.randn((N, L, cfg.motion.z_dim), generator=generator(seed),
                               device=device)

    # All N videos are synthesized together in each call (the reference
    # loops one video at a time, logging.py:44-65). batch_size_num_frames
    # bounds TOTAL frames per call, so the per-video chunk shrinks as N
    # grows; chunk lengths are balanced to ONE size.
    frames_per_video = max(1, batch_size_num_frames // N)
    num_chunks = (T + frames_per_video - 1) // frames_per_video
    chunk = (T + num_chunks - 1) // num_chunks

    c_all = None if (c is None or cfg.c_dim == 0) else tensor(c)
    mz_all = None if motion_z is None else tensor(motion_z)

    with torch.no_grad():
        # Class-conditional truncation: truncate toward the PER-CLASS w mean
        # estimated from fresh samples, not the global moving w_avg
        # (reference logging.py:27-32,50-52).
        class_w_avg = None
        if c_all is not None and truncation_psi < 1:
            num_ws_to_average = 1000
            z_avg = torch.randn((N * num_ws_to_average, cfg.z_dim), generator=generator(seed + 1),
                                device=device)
            c_avg = c_all.repeat_interleave(num_ws_to_average, dim=0)
            w = G.mapping(z_avg, c_avg)[:, 0]
            class_w_avg = w.reshape(N, num_ws_to_average, -1).mean(dim=1)       # [N, w]

        # Pad timestamps so every chunk has the same length; padded frames
        # are synthesized with the final timestamp and sliced off.
        pad = num_chunks * chunk - T
        ts_pad = torch.cat([ts, ts[:, -1:].repeat(1, pad)], dim=1) if pad else ts

        chunks = []
        for k in range(num_chunks):
            t_chunk = ts_pad[:, k * chunk:(k + 1) * chunk]
            if class_w_avg is not None:
                ws = G.mapping(z, c_all)
                ws = truncation_psi * ws + (1 - truncation_psi) * class_w_avg[:, None]
                img = G.synthesis(ws, t=t_chunk, c=c_all, motion_z=mz_all,
                                  noise_mode=noise_mode, generator=generator(1))
            else:
                img = G(z, c_all, t_chunk, truncation_psi=truncation_psi, motion_z=mz_all,
                        noise_mode=noise_mode, generator=generator(1))
            out = (img * 0.5 + 0.5).clamp(0.0, 1.0)                  # [N*chunk, C, H, W]
            out = out.permute(0, 2, 3, 1).float().cpu().numpy()
            chunks.append(out.reshape(N, chunk, *out.shape[1:]))
    videos = np.concatenate(chunks, axis=1)[:, :T]   # [N, T, H, W, C]
    return videos


def make_grid(images: np.ndarray, nrow: Optional[int] = None,
              padding: int = 2) -> np.ndarray:
    """Tile [N, H, W, C] images into one grid image (torchvision.make_grid analog)."""
    N, H, W, C = images.shape
    nrow = nrow or int(math.ceil(math.sqrt(N)))
    ncol = (N + nrow - 1) // nrow
    grid = np.zeros((ncol * (H + padding) + padding,
                     nrow * (W + padding) + padding, C), images.dtype)
    for idx in range(N):
        r, col = divmod(idx, nrow)
        y = r * (H + padding) + padding
        x = col * (W + padding) + padding
        grid[y:y + H, x:x + W] = images[idx]
    return grid


def videos_as_grids(videos: np.ndarray, nrow: Optional[int] = None) -> np.ndarray:
    """[N, T, H, W, C] -> [T, grid_h, grid_w, C] (reference logging.py:74-78)."""
    T = videos.shape[1]
    return np.stack([make_grid(videos[:, t], nrow=nrow) for t in range(T)])


def save_video_frames_as_mp4(frames: np.ndarray, fps: float, save_path: str) -> None:
    """frames [T, H, W, C] float [0,1] or uint8 -> .mp4 (reference logging.py:97-111)."""
    import cv2
    if frames.dtype != np.uint8:
        frames = (np.clip(frames, 0, 1) * 255).astype(np.uint8)
    T, H, W, C = frames.shape
    os.makedirs(os.path.dirname(os.path.abspath(save_path)), exist_ok=True)
    writer = cv2.VideoWriter(save_path, cv2.VideoWriter_fourcc(*"mp4v"),
                             float(fps), (W, H))
    for t in range(T):
        writer.write(cv2.cvtColor(frames[t], cv2.COLOR_RGB2BGR))
    writer.release()


def save_video_frames_as_frames_parallel(frames: np.ndarray, save_dir: str,
                                         time_offset: int = 0,
                                         num_processes: int = 8) -> None:
    """frame-folder output (reference logging.py:124-140), thread-parallel."""
    import PIL.Image
    os.makedirs(save_dir, exist_ok=True)
    if frames.dtype != np.uint8:
        frames = (np.clip(frames, 0, 1) * 255).astype(np.uint8)

    def write_one(i):
        PIL.Image.fromarray(frames[i]).save(
            os.path.join(save_dir, f"{i + time_offset:06d}.jpg"), q=95)

    with ThreadPoolExecutor(max_workers=num_processes) as ex:
        list(ex.map(write_one, range(len(frames))))


def save_image_grid(images: np.ndarray, path: str, drange=(-1, 1),
                    grid_size=None) -> None:
    """uint8 grid writer (reference training_loop.py save_image_grid analog).
    images: [N, H, W, C] in drange."""
    import PIL.Image
    lo, hi = drange
    img = (np.asarray(images, np.float32) - lo) / (hi - lo)
    img = (np.clip(img, 0, 1) * 255).astype(np.uint8)
    if grid_size is not None:
        gw, gh = grid_size
        grid = make_grid(img, nrow=gw, padding=0)
    else:
        grid = make_grid(img, padding=0)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    if grid.shape[-1] == 1:
        grid = grid[:, :, 0]
    PIL.Image.fromarray(grid).save(path)
