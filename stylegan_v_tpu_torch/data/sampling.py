"""Sparse frame-sampling policies (host-side numpy).

Behavioral parity with reference src/training/layers.py:377-435: memory is
O(frames_sampled) regardless of video length; pairwise distances are
controlled so the discriminator sees a spread of time deltas.

Unlike the reference (global `random` module), every function takes an
explicit np.random RandomState/Generator for reproducible, per-worker streams.

A copy of stylegan_v_tpu/data/sampling.py on the port's SamplingConfig
(tests/test_torch_data.py holds the two equal).
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..models.config import SamplingConfig


def sample_frames(cfg: SamplingConfig, total_video_len: int,
                  use_fractional_t: bool = False,
                  rng: Optional[np.random.RandomState] = None) -> np.ndarray:
    """Dispatch by cfg.type (reference layers.py:377-383)."""
    rng = rng or np.random.RandomState()
    if cfg.type == "random":
        return random_frame_sampling(cfg, total_video_len, use_fractional_t, rng)
    if cfg.type == "uniform":
        return uniform_frame_sampling(cfg, total_video_len, use_fractional_t, rng)
    raise NotImplementedError(f"Unknown sampling type: {cfg.type}")


def random_frame_sampling(cfg: SamplingConfig, total_video_len: int,
                          use_fractional_t: bool = False,
                          rng: Optional[np.random.RandomState] = None) -> np.ndarray:
    """first + last + random interior frames of a random total span
    (reference layers.py:387-411)."""
    rng = rng or np.random.RandomState()
    nf = cfg.num_frames_per_video
    min_time_diff = nf - 1
    max_time_diff = min(total_video_len - 1,
                        cfg.max_dist if cfg.max_dist is not None else float("inf"))

    if cfg.total_dists is not None:
        time_diff_range = [d for d in cfg.total_dists if min_time_diff <= d <= max_time_diff]
    else:
        time_diff_range = list(range(min_time_diff, int(max_time_diff)))
    assert len(time_diff_range) > 0, (
        f"no valid total span for video of len {total_video_len} "
        f"(need >= {min_time_diff + 1} frames)")

    time_diff = int(time_diff_range[rng.randint(len(time_diff_range))])
    if use_fractional_t:
        offset = rng.rand() * (total_video_len - time_diff - 1)
    else:
        offset = rng.randint(0, total_video_len - time_diff)
    frames_idx = [offset]
    if nf > 1:
        frames_idx.append(offset + time_diff)
    if nf > 2:
        interior = rng.choice(np.arange(1, time_diff), size=nf - 2, replace=False)
        frames_idx.extend(offset + int(i) for i in interior)
    return np.array(sorted(frames_idx))


def uniform_frame_sampling(cfg: SamplingConfig, total_video_len: int,
                           use_fractional_t: bool = False,
                           rng: Optional[np.random.RandomState] = None) -> np.ndarray:
    """Equidistant frames with a random spacing d (reference layers.py:415-435)."""
    rng = rng or np.random.RandomState()
    nf = cfg.num_frames_per_video
    if cfg.dists_between_frames is not None:
        valid = [d for d in cfg.dists_between_frames
                 if cfg.max_dist_between_frames is None or d <= cfg.max_dist_between_frames]
        valid = [d for d in valid if (d * nf - d + 1) <= total_video_len]
        assert len(valid) > 0, f"no valid spacing for video of len {total_video_len}"
        d = int(valid[rng.randint(len(valid))])
    else:
        max_d = min(cfg.max_dist if cfg.max_dist is not None else float("inf"),
                    total_video_len // nf)
        d = int(rng.randint(1, int(max_d) + 1))

    d_total = d * nf - d + 1
    if use_fractional_t:
        offset = rng.rand() * (total_video_len - d_total)
    else:
        offset = rng.randint(0, total_video_len - d_total + 1)
    return offset + np.arange(nf) * d
