"""The one traffic generator: everything a run feeds the program, made from
the cell's seed, its traffic file (`traffic/<mix>.json`) and its
configuration file (`configs/<config>.json`).

A traffic file holds parameters only. Its "kind" names the mix module,
`lib/<kind>_cell.py`, whose loop drives the program: "train" (the training
step) or "synth" (G_ema's forward through the generator path of the
program's metrics). What one configuration fixes (videos a
chip holds, frames a video, how timestamps are drawn, the assumed video
length) is read from the configuration file's "clip" section.

Every random input comes from a seed derived from (seed, purpose, index), so
the program and the reference, given the same seed, get the same inputs in
any order they ask for them.
"""
from __future__ import annotations

import hashlib
import json
import os
from typing import Dict, List, Optional

import numpy as np
import torch

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def subseed(seed: int, *keys) -> int:
    """A 63-bit seed from (seed, keys), independent between purposes."""
    digest = hashlib.sha256(repr((int(seed),) + keys).encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def load_traffic(name: str) -> Dict:
    with open(os.path.join(BENCH_DIR, "traffic", f"{name}.json")) as f:
        return json.load(f)


class SeededDraws:
    """A draw source (rand, randn) over its own torch.Generator on `device`:
    the object the program's augment pipe and video D take their draws from."""

    def __init__(self, seed: int, device):
        self.device = torch.device(device)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

    def rand(self, shape) -> torch.Tensor:
        return torch.rand(shape, generator=self.generator, device=self.device)

    def randn(self, shape) -> torch.Tensor:
        return torch.randn(shape, generator=self.generator, device=self.device)


class MetaDraws:
    """A draw source of shapes only, for counting work on the meta device."""

    def rand(self, shape) -> torch.Tensor:
        return torch.empty(shape, device="meta")

    randn = rand


# -------------------------------------------- timestamps, as the loader draws them

def random_frame_times(nf: int, total_dists, max_dist, video_len: int, fractional: bool,
                       rng: np.random.RandomState) -> np.ndarray:
    """First and last frame of a random span, random frames between
    (the program's data/sampling.py:random_frame_sampling)."""
    max_diff = min(video_len - 1, max_dist if max_dist is not None else float("inf"))
    spans = ([d for d in total_dists if nf - 1 <= d <= max_diff] if total_dists
             else list(range(nf - 1, int(max_diff))))
    span = int(spans[rng.randint(len(spans))])
    offset = rng.rand() * (video_len - span - 1) if fractional else \
        rng.randint(0, video_len - span)
    idx = [offset]
    if nf > 1:
        idx.append(offset + span)
    if nf > 2:
        idx.extend(offset + int(i) for i in rng.choice(np.arange(1, span), size=nf - 2,
                                                      replace=False))
    return np.array(sorted(idx))


def uniform_frame_times(nf: int, max_dist, video_len: int, fractional: bool,
                        rng: np.random.RandomState) -> np.ndarray:
    """Equidistant frames with a random spacing (data/sampling.py:uniform_frame_sampling,
    without a list of spacings)."""
    max_d = min(max_dist if max_dist is not None else float("inf"), video_len // nf)
    d = int(rng.randint(1, int(max_d) + 1))
    span = d * nf - d + 1
    offset = rng.rand() * (video_len - span) if fractional else \
        rng.randint(0, video_len - span + 1)
    return offset + np.arange(nf) * d


def frame_times(sampling: Dict, video_len: int, fractional: bool,
                rng: np.random.RandomState) -> np.ndarray:
    nf = sampling["num_frames_per_video"]
    if sampling["type"] == "random":
        return random_frame_times(nf, sampling["total_dists"], sampling["max_dist"],
                                  video_len, fractional, rng)
    if sampling["type"] == "uniform":
        if sampling.get("dists_between_frames"):
            raise ValueError("a list of spacings is not drawn by this generator")
        return uniform_frame_times(nf, sampling["max_dist"], video_len, fractional, rng)
    raise ValueError(f"unknown sampling type {sampling['type']!r}")


def motion_len(gen_cfg: Dict, max_t: Optional[float] = None) -> int:
    """The motion trajectory's length (the program's
    MotionMappingNetwork.required_traj_len)."""
    m = gen_cfg["motion"]
    mt = max(gen_cfg["sampling"]["max_num_frames"] - 1, max_t if max_t is not None else 0)
    base = int(np.ceil(mt / m["motion_z_distance"])) + 2
    return base + ((m["kernel_size"] - 1) * 2 if m["gen_strategy"] == "conv" else 0)


# ------------------------------------------------------------------ training

class TrainFeed:
    """The training mix: a pool of distinct batches, cycled, and each step's
    draws. Batch i: uint8 frames [B, F, 3, R, R] on the device; the real
    clips' timestamps drawn as the dataset draws them (whole frames), the
    generated clips' as the loader draws them for each of the three phases
    (fractional where the motion code takes fractional time)."""

    def __init__(self, traffic: Dict, clip: Dict, gen_cfg: Dict, seed: int, device,
                 pipe: bool, video_noise: bool):
        self.traffic, self.clip, self.gen_cfg = traffic, clip, gen_cfg
        self.seed, self.device = seed, torch.device(device)
        self.pipe, self.video_noise = pipe, video_noise
        self.videos = clip["videos_per_chip"]
        self.frames = gen_cfg["sampling"]["num_frames_per_video"]
        self.res = gen_cfg["img_resolution"]
        self.L = motion_len(gen_cfg)
        self.pool = [self._batch(i) for i in range(traffic["pool_batches"])]

    def _batch(self, i: int) -> Dict[str, torch.Tensor]:
        B, F, R = self.videos, self.frames, self.res
        g = torch.Generator(device=self.device).manual_seed(subseed(self.seed, "frames", i))
        real = torch.randint(0, 256, (B, F, 3, R, R), generator=g, device=self.device,
                             dtype=torch.uint8)
        rng = np.random.RandomState(subseed(self.seed, "times", i) % 2 ** 32)
        sampling, vlen = self.gen_cfg["sampling"], self.clip["video_len"]
        gen_len = min(vlen, sampling["max_num_frames"])
        frac = self.gen_cfg["motion"]["use_fractional_t"]
        real_t = np.stack([frame_times(sampling, vlen, False, rng) for _ in range(B)])
        gen_t = np.stack([frame_times(sampling, gen_len, frac, rng)
                          for _ in range(B * 3)]).reshape(B, 3, F)
        to = dict(device=self.device, dtype=torch.float32)
        return {"real_img": real, "real_c": torch.zeros(B, 0, **to),
                "real_t": torch.as_tensor(real_t, **to), "gen_c": torch.zeros(B, 3, 0, **to),
                "gen_t": torch.as_tensor(gen_t, **to)}

    def batch(self, step: int) -> Dict[str, torch.Tensor]:
        return self.pool[step % len(self.pool)]

    def draws(self, step: int, do_dr1: bool) -> Dict:
        """Step `step`'s draws, as the program's train_step takes them (one round)."""
        g = torch.Generator(device=self.device).manual_seed(subseed(self.seed, "z", step))
        zd, mz = self.gen_cfg["z_dim"], self.gen_cfg["motion"]["z_dim"]
        out = {}
        for name in ("Gmain", "Dgen"):
            out[name] = {"z": torch.randn(self.videos, zd, generator=g, device=self.device),
                         "motion_z": torch.randn(self.videos, self.L, mz, generator=g,
                                                 device=self.device)}
        for name in ("Gmain", "Dgen", "Dreal") + (("Dr1",) if do_dr1 else ()):
            d = out.setdefault(name, {})
            if self.pipe:
                d["augment"] = [SeededDraws(subseed(self.seed, "augment", step, name),
                                            self.device)]
            if self.video_noise:
                d["d_noise"] = [SeededDraws(subseed(self.seed, "d_noise", step, name),
                                            self.device)]
        return out


# ------------------------------------------------------------------ synthesis

class SynthFeed:
    """The synthesis mix: batch i is `clips` fresh (z, motion_z) from the seed
    at timestamps 0 .. frames-1, as the FVD generator side draws them."""

    def __init__(self, traffic: Dict, gen_cfg: Dict, seed: int, device):
        self.clips, self.frames = traffic["clips_per_batch"], traffic["frames_per_clip"]
        self.gen_cfg, self.seed, self.device = gen_cfg, seed, torch.device(device)
        self.t = torch.arange(self.frames, dtype=torch.float32,
                              device=self.device)[None].repeat(self.clips, 1)
        self.L = motion_len(gen_cfg, float(self.frames - 1))

    def inputs(self, i: int):
        g = torch.Generator(device=self.device).manual_seed(subseed(self.seed, "clip", i))
        z = torch.randn(self.clips, self.gen_cfg["z_dim"], generator=g, device=self.device)
        mz = torch.randn(self.clips, self.L, self.gen_cfg["motion"]["z_dim"], generator=g,
                         device=self.device)
        return z, self.t, mz

    def sample(self, count: int, horizon: int) -> List[int]:
        """The batches whose frames are kept for the check: batch 0 and
        `count` more drawn from the seed among the first `horizon`."""
        rng = np.random.RandomState(subseed(self.seed, "sample") % 2 ** 32)
        return sorted({0, *rng.choice(np.arange(1, horizon), size=count, replace=False).tolist()})
