"""The "synth" mix: G_ema's forward as the FVD generator side runs it, through
the program's own client path, `metrics/metric_utils.py:
compute_feature_stats_for_generator`: fresh z and motion codes each batch,
consecutive timestamps, `Generator.forward` under inference mode with TF32
off, the frames turned into uint8 and copied to the host by the program
(`.cpu().numpy()`, fresh pageable memory each batch), then handed to a
detector. One client in a closed loop: batch i+1 is dispatched once batch
i's frames are on the host.

The harness gives that function what a metric would: a draw source that
yields the seed's z and motion codes (traffic.SynthFeed), a detector
registered under its own name that notes when each batch's frames reach it
and returns one feature a clip, and a stats class whose `is_full` ends the
loop once the window's time has passed. The dataset the function opens for
its labels is one small frame written at set-up under TMPDIR.

Each batch's time is the host clock's from the previous batch's frames
reaching the detector (or from the call) to its own; synth_frames_per_s is
every frame of the window over the window's host-clock length. The frames of
a few batches drawn from the seed (and of batch 0) are kept; after the
window the program's G is freed and the reference's G, made from the same
seed, draws them again.
"""
from __future__ import annotations

import os
import shutil
import tempfile
import time
from typing import Callable, Dict

import numpy as np
import torch

from .traffic import SynthFeed, subseed
from .weights import init_from_seed

CHIPS = (1,)
KEPT_BATCHES = 4          # drawn from the seed among the first SAMPLE_HORIZON
SAMPLE_HORIZON = 100
TRACED_BATCHES = 16
DETECTOR = "benchmark_window"


def to_uint8(img: torch.Tensor) -> torch.Tensor:
    """[N, C, H, W] in [-1, 1] -> [N, H, W, C] uint8, as the metric path quantises."""
    img = torch.clamp((img * 0.5 + 0.5) * 255.0 + 0.5, 0, 255).to(torch.uint8)
    return img.permute(0, 2, 3, 1)


class FeedDraws:
    """The draw source the program's generator path takes: its calls alternate
    z [B, z_dim] and motion_z [B, L, z_dim] a batch; both are the feed's for
    that batch, from the batch's own seed."""

    def __init__(self, feed: SynthFeed, first: int):
        self.feed, self.calls, self.first = feed, 0, first
        self.pending = None

    def randn(self, shape) -> torch.Tensor:
        i, part = self.first + self.calls // 2, self.calls % 2
        self.calls += 1
        if part == 0:
            z, _, mz = self.feed.inputs(i)
            self.pending = mz
            out = z
        else:
            out = self.pending
        if tuple(out.shape) != tuple(shape):
            raise RuntimeError(f"the program asked for {tuple(shape)}, the feed has "
                               f"{tuple(out.shape)}")
        return out


def _window_stats(until: Callable[[], bool]):
    from stylegan_v_tpu_torch.metrics.metric_utils import FeatureStats

    class WindowStats(FeatureStats):
        """Full once `until()` says so; keeps nothing of the features."""

        def is_full(self) -> bool:
            return until()
    return WindowStats


def _write_dataset(root: str) -> str:
    """One video of one 8 x 8 frame: what the generator path opens for labels
    (the configuration has none)."""
    import PIL.Image
    d = os.path.join(root, "frames", "video0")
    os.makedirs(d)
    PIL.Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(os.path.join(d, "000000.png"))
    return os.path.join(root, "frames")


class Program:
    def __init__(self, setup, plain: Dict, cell: Dict, seed: int, device: torch.device):
        from stylegan_v_tpu_torch.metrics.metric_utils import MetricOptions, register_detector
        from stylegan_v_tpu_torch.models import Generator
        G = Generator(setup.gen_cfg).to(device)
        init_from_seed([G], subseed(seed, "weights"))
        self.G = G.eval().requires_grad_(False)
        self.feed = SynthFeed(cell["traffic"], plain["gen_cfg"], seed, device)
        self.frames_per_batch = self.feed.clips * self.feed.frames
        self.warmup = cell["traffic"]["warmup_batches"]
        self.tmp = tempfile.mkdtemp(prefix="benchmark_synth_")
        self.opts = MetricOptions(G=self.model(), device=device,
                                  dataset_kwargs={"path": _write_dataset(self.tmp)})
        register_detector(DETECTOR, lambda **kw: self._detector)
        self.index = 0              # batches done, over every call
        self.keep = set()
        self.kept: Dict[int, torch.Tensor] = {}
        self.arrivals = []          # host clock when each batch's frames arrived

    def model(self):
        """What the program's path calls as G (the faults wrap it)."""
        return self.G

    def _detector(self, x):
        self.arrivals.append(time.perf_counter())
        if self.index in self.keep:
            self.kept[self.index] = torch.from_numpy(x).reshape(-1, *x.shape[-3:])
        self.index += 1
        return np.zeros((x.shape[0], 1), np.float32)

    def batches(self, until: Callable[[], bool]) -> float:
        """Run the program's generator path from batch `self.index` until
        `until()`; returns the host clock when the call began."""
        from stylegan_v_tpu_torch.metrics.metric_utils import compute_feature_stats_for_generator
        t0 = time.perf_counter()
        compute_feature_stats_for_generator(
            self.opts, DETECTOR, {}, batch_size=self.frames_per_batch,
            num_video_frames=self.feed.frames, temporal_detector=True, max_items=None,
            noise_mode="const", feature_stats_cls=_window_stats(until),
            draws=FeedDraws(self.feed, self.index))
        return t0

    def count(self, n: int) -> None:
        stop = self.index + n
        self.batches(lambda: self.index >= stop)

    def close(self) -> None:
        shutil.rmtree(self.tmp, ignore_errors=True)


def _batch_ms(t0: float, arrivals) -> list:
    return [1e3 * (b - a) for a, b in zip([t0] + arrivals[:-1], arrivals)]


def checked_output(prog: Program, card, log) -> Dict:
    """The kept batches without a timed window."""
    prog.keep = set(prog.feed.sample(KEPT_BATCHES, SAMPLE_HORIZON))
    prog.count(max(prog.keep) + 1)
    prog.close()
    return {"kept": prog.kept}


def run_program(prog: Program, card, seconds: float, trace: bool, log) -> Dict:
    warmup = prog.warmup
    prog.count(warmup)
    card.sync()
    setup_peak = card.peak_bytes()
    prog.keep = {warmup + i for i in prog.feed.sample(KEPT_BATCHES, SAMPLE_HORIZON)}
    prog.arrivals = []
    card.reset_peak()
    first = prog.index
    deadline = time.perf_counter() + seconds
    t0 = prog.batches(lambda: time.perf_counter() >= deadline)
    card.sync()
    window_s = time.perf_counter() - t0
    batches = prog.index - first
    out = {"window_t0": t0, "window_s": window_s, "batches": batches, "attempted": batches,
           "frames": batches * prog.frames_per_batch,
           "batch_ms": _batch_ms(t0, prog.arrivals), "kept": dict(prog.kept),
           "setup_peak": setup_peak, "window_peak": card.peak_bytes(), "failed": 0}
    ms = sorted(out["batch_ms"])
    q = {p: ms[min(len(ms) - 1, int(p / 100 * len(ms)))] for p in (50, 90, 95, 97.5, 99)}
    log(f"window: {batches} batches in {window_s:.3f} s; kept {sorted(prog.kept)}; batch ms "
        + ", ".join(f"p{p} {v:.2f}" for p, v in q.items()) + f", max {ms[-1]:.2f}")
    if trace:
        from .trace import traced
        prog.keep = set()
        out["trace"] = traced(lambda: prog.count(TRACED_BATCHES), card.sync)
        out["traced_units"] = TRACED_BATCHES
    prog.close()
    return out


def run_reference(plain: Dict, cell: Dict, seed: int, device: torch.device, kept: Dict,
                  allow_tf32: bool = False):
    """The reference's frames for each kept batch: [(program's, reference's)]."""
    from ..reference import build_models
    G, _ = build_models(plain, device)
    init_from_seed([G], subseed(seed, "weights"))
    G = G.eval().requires_grad_(False)
    feed = SynthFeed(cell["traffic"], plain["gen_cfg"], seed, device)
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = cudnn.allow_tf32, matmul.allow_tf32
    pairs = []
    try:
        cudnn.allow_tf32 = matmul.allow_tf32 = allow_tf32
        with torch.no_grad():
            for i in sorted(kept):
                z, t, mz = feed.inputs(i)
                pairs.append((kept[i], to_uint8(G(z, None, t, motion_z=mz,
                                                  noise_mode="const")).cpu()))
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved
    return pairs


def check(plain: Dict, cell: Dict, seed: int, device: torch.device, out: Dict,
          control: bool = False) -> Dict[str, Dict]:
    """frames_mean_gap over the kept batches; with `control`, the reference
    with TF32 allowed in the program's place."""
    from .checks import frames_numbers
    pairs = run_reference(plain, cell, seed, device, out["kept"])
    if control:
        ctl = run_reference(plain, cell, seed, device, out["kept"], allow_tf32=True)
        pairs = [(c[1], r[1]) for c, r in zip(ctl, pairs)]
    return frames_numbers(pairs)


def work(plain: Dict, cell: Dict, out: Dict) -> Dict[str, float]:
    from ..count import work as W
    w = W.synth_work(plain, cell["traffic"]["clips_per_batch"], cell["traffic"]["frames_per_clip"])
    return dict(w, window_flops=out["batches"] * w["batch_flops"],
                traced_fir_bytes=out.get("traced_units", 0) * w["batch_fir_bytes"])


# ------------------------------------------------ faults, for the checks' own tests

class _SwapClips(torch.nn.Module):
    """G, but its first clip's frames are the second clip's."""

    def __init__(self, G, frames: int):
        super().__init__()
        self.inner, self.frames, self.cfg = G, frames, G.cfg

    def forward(self, *args, **kwargs):
        img = self.inner(*args, **kwargs)
        f = self.frames
        return torch.cat([img[f:2 * f], img[f:]])


class AlteredProgram(Program):
    """Synthesis hands one clip the frames of another, where they are made."""

    def model(self):
        return _SwapClips(self.G, self.feed.frames)


FAULTS = {"altered": AlteredProgram}
