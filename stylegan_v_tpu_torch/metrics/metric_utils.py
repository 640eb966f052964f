"""Metric infrastructure: feature statistics, the detector registry, feature
extraction for a dataset and for a generator, and the dataset-stats cache.

Counterpart of stylegan_v_tpu/metrics/metric_utils.py (reference
src/metrics/metric_utils.py):
  * `FeatureStats` accumulates the raw mean and covariance in float64 on the
    host (a copy, `merge` and `replica_max_items` included);
    `merge_across_processes` merges the ranks' partial stats;
  * dataset feature stats are cached on disk under a hash of every argument
    (`_cache_tag`, a copy), in ~/.cache/stylegan_v_tpu_torch/metric-stats
    unless `cache_dir` says otherwise;
  * generator stats draw fresh z and motion codes, labels from the dataset
    and CONSECUTIVE timestamps t = range(0, F*subsample, subsample), and
    quantise the frames to uint8 as the data path does. G_ema and the
    detector both run on the card with no host round trip between them: only
    each batch's features reach the host.

Detectors, looked up by name: one registered with `register_detector`; the
stub (SGV_STUB_DETECTORS=1); else the reference's file from `detector_dir`,
$SGV_DETECTOR_DIR or ./detectors. For the three canonical names the file's
state_dict loads into the port's module, which runs on the device; any
other file runs as TorchScript on the device. A metric runs on
`MetricOptions.device`, cuda:0 when None: without a card it raises, and
nothing falls back to the CPU.

Replicas (stylegan_v_tpu/metrics/metric_utils.py:464-590): with
`num_replicas` R, replica r reads the dataset items r, r+R, ... and makes
its share of the generated items (`replica_max_items`) from seeds
seed + r (labels) and seed*1000 + r (z and motion codes). When R equals the
number of processes in the default process group, each process is one
replica: the partial stats are merged across processes (gathered on the
host), every process returns the full stats, and only replica 0 writes the
dataset-stats cache. In one process, R > 1 gives replica r's partial stats,
cached under a key of their own.
"""
from __future__ import annotations

import hashlib
import os
import pickle
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch


def _vlog(msg: str) -> None:
    """Opt-in stage telemetry (SGV_METRIC_VERBOSE=1): stderr, timestamped, flushed."""
    if os.environ.get("SGV_METRIC_VERBOSE"):
        import sys
        import time as _time
        print(f"[metric {_time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr, flush=True)


@dataclass
class MetricOptions:
    """Mirrors reference MetricOptions (metric_utils.py:23-36); `G` is the port's
    Generator (G_ema) on `device`, which replaces the JAX package's
    G_variables and mesh."""
    G: Any = None                      # models.Generator
    dataset_kwargs: Dict = field(default_factory=dict)
    gen_dataset_kwargs: Optional[Dict] = None
    generator_as_dataset: bool = False
    num_replicas: int = 1
    replica: int = 0
    rank: int = 0
    cache: bool = True
    cache_dir: Optional[str] = None
    detector_dir: Optional[str] = None
    verbose: bool = False
    progress: Optional[Callable] = None
    # overrides of a metric's item counts (None = the metric's default)
    max_real_override: Optional[int] = None
    num_gen_override: Optional[int] = None
    device: Any = None                 # torch.device; cuda:0 when None


def metric_device(opts: MetricOptions) -> torch.device:
    """The device a metric runs on: opts.device, or cuda:0 when None; "cuda"
    names the current card. A CUDA device that is not there raises; nothing
    falls back to the CPU."""
    device = torch.device("cuda", 0) if opts.device is None else torch.device(opts.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: metrics run on the card; pass device='cpu' "
                           "to run them on the CPU")
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def _multi_process(opts: MetricOptions) -> bool:
    """True when each process of the default process group is one replica."""
    from ..parallel.distributed import world
    n = world().size
    return n > 1 and opts.num_replicas == n


class FeatureStats:
    """float64 moment accumulator (reference metric_utils.py:63-139)."""

    def __init__(self, capture_all: bool = False, capture_mean_cov: bool = False,
                 max_items: Optional[int] = None):
        self.capture_all = capture_all
        self.capture_mean_cov = capture_mean_cov
        self.max_items = max_items
        self.num_items = 0
        self.num_features = None
        self.all_features = None
        self.raw_mean = None
        self.raw_cov = None

    def set_num_features(self, num_features: int):
        if self.num_features is not None:
            assert num_features == self.num_features
        else:
            self.num_features = num_features
            self.all_features = []
            self.raw_mean = np.zeros([num_features], dtype=np.float64)
            self.raw_cov = np.zeros([num_features, num_features], dtype=np.float64)

    def is_full(self) -> bool:
        return self.max_items is not None and self.num_items >= self.max_items

    def append(self, x) -> None:
        x = np.asarray(x, dtype=np.float32)
        assert x.ndim == 2
        if self.max_items is not None and self.num_items + x.shape[0] > self.max_items:
            if self.num_items >= self.max_items:
                return
            x = x[:self.max_items - self.num_items]
        self.set_num_features(x.shape[1])
        self.num_items += x.shape[0]
        if self.capture_all:
            self.all_features.append(x)
        if self.capture_mean_cov:
            x64 = x.astype(np.float64)
            self.raw_mean += x64.sum(axis=0)
            self.raw_cov += x64.T @ x64

    def get_all(self) -> np.ndarray:
        assert self.capture_all
        return np.concatenate(self.all_features, axis=0)

    def get_mean_cov(self):
        assert self.capture_mean_cov
        mean = self.raw_mean / self.num_items
        cov = self.raw_cov / self.num_items - np.outer(mean, mean)
        return mean, cov

    def save(self, pkl_file: str) -> None:
        # atomic temp-file + os.replace (reference metric_utils.py:250-254): a
        # crash mid-write never leaves a truncated pkl for later runs
        import uuid
        os.makedirs(os.path.dirname(os.path.abspath(pkl_file)), exist_ok=True)
        temp_file = pkl_file + "." + uuid.uuid4().hex
        with open(temp_file, "wb") as f:
            pickle.dump(self.__dict__, f)
        os.replace(temp_file, pkl_file)

    @staticmethod
    def load(pkl_file: str) -> "FeatureStats":
        with open(pkl_file, "rb") as f:
            s = pickle.load(f)
        obj = FeatureStats(capture_all=s["capture_all"], max_items=s["max_items"])
        obj.__dict__.update(s)
        return obj

    # Replica merging: each replica accumulates its strided subset
    # (truncated with replica_max_items, which reproduces the global cutoff);
    # moments add, captured features interleave round-robin in dataset order.

    @staticmethod
    def replica_max_items(total: int, num_replicas: int, replica: int) -> int:
        """How many strided items replica owns under the global truncation:
        replica r's i-th item sits at global interleaved position i*R + r,
        kept iff i*R + r < total."""
        return len(range(replica, total, num_replicas))

    @staticmethod
    def merge(stats_list) -> "FeatureStats":
        """Merge per-replica stats (replica order = list order)."""
        assert len(stats_list) > 0
        base = stats_list[0]
        out = FeatureStats(capture_all=base.capture_all,
                           capture_mean_cov=base.capture_mean_cov,
                           max_items=sum(s.num_items for s in stats_list))
        out.set_num_features(base.num_features)
        out.num_items = sum(s.num_items for s in stats_list)
        if base.capture_mean_cov:
            for s in stats_list:
                out.raw_mean += s.raw_mean
                out.raw_cov += s.raw_cov
        if base.capture_all:
            # round-robin interleave (replica r's item i -> position i*R+r,
            # skipping exhausted replicas): lexsort by (i, r)
            nf = base.num_features or 0
            feats = [s.get_all() if s.num_items else
                     np.zeros((0, nf), np.float32) for s in stats_list]
            key_i = np.concatenate([np.arange(len(f)) for f in feats])
            key_r = np.concatenate([np.full(len(f), r)
                                    for r, f in enumerate(feats)])
            if key_i.size:
                order = np.lexsort((key_r, key_i))
                out.all_features = [np.concatenate(feats, axis=0)[order]]
            else:
                out.all_features = []
        return out

    def merge_across_processes(self) -> "FeatureStats":
        """Gather every process's partial stats (as host objects: float64
        moments travel losslessly) and merge them in process order, so every
        process returns the same full stats (the JAX package's
        merge_across_processes, one all_gather_object here). A process whose
        share is empty takes the feature count from the others."""
        from ..parallel.distributed import world
        w = world()
        if w.size == 1:
            return self
        parts = [None] * w.size
        torch.distributed.all_gather_object(parts, {
            "num_items": self.num_items, "num_features": self.num_features,
            "raw_mean": self.raw_mean, "raw_cov": self.raw_cov,
            "all_features": self.get_all() if self.capture_all and self.num_items else None})
        nf = max((p["num_features"] or -1) for p in parts)
        if nf < 0:
            return self                      # no process appended anything
        stats = []
        for p in parts:
            s = FeatureStats(capture_all=self.capture_all,
                             capture_mean_cov=self.capture_mean_cov)
            s.set_num_features(nf)
            s.num_items = p["num_items"]
            if self.capture_mean_cov and p["raw_mean"] is not None:
                s.raw_mean, s.raw_cov = p["raw_mean"], p["raw_cov"]
            if self.capture_all:
                s.all_features = ([p["all_features"]] if p["all_features"] is not None
                                  else [])
            stats.append(s)
        return FeatureStats.merge(stats)


# ----------------------------- detector registry -----------------------------

# canonical filenames of the reference detectors
DETECTOR_FILES = {
    "inception": "inception-2015-12-05.pt",
    "i3d": "i3d_torchscript.pt",
    "c3d_ucf101": "c3d_ucf101.pt",
}

_custom_detectors: Dict[str, Callable] = {}
_custom_detector_tags: Dict[str, str] = {}


def register_detector(name: str, builder: Callable,
                      cache_tag: Optional[str] = None) -> None:
    """Override detector `name` with a custom builder, called with the metric's
    detector kwargs.

    cache_tag identifies THIS builder's feature space in the dataset-stats
    cache key. Two different custom detectors registered under the same
    name (e.g. random-weight I3Ds under different seeds) MUST pass distinct
    tags, or the second run silently reuses the first one's cached real
    stats and the resulting distance compares features from two different
    projections. Omitting it keeps the legacy shared 'custom' namespace.
    """
    _custom_detectors[name] = builder
    if cache_tag is not None:
        _custom_detector_tags[name] = cache_tag
    else:
        _custom_detector_tags.pop(name, None)


def _detector_search_dirs(opts: MetricOptions):
    dirs = []
    if opts.detector_dir:
        dirs.append(opts.detector_dir)
    if os.environ.get("SGV_DETECTOR_DIR"):
        dirs.append(os.environ["SGV_DETECTOR_DIR"])
    dirs.append(os.path.join(os.getcwd(), "detectors"))
    return dirs


def _stub_detector(name: str, **detector_kwargs) -> Callable:
    """Deterministic cheap features (the 'stub' backend): spatially pooled
    pixel statistics. Enabled via SGV_STUB_DETECTORS=1 — lets the full metric
    stack (caching, Frechet/KID/IS math, jsonl reporting) run end-to-end
    without any detector weight files. NOT comparable to real detector
    scores."""
    def features(x: np.ndarray) -> np.ndarray:
        x = np.asarray(x, np.float64) / 255.0
        if x.ndim == 5:                          # video [N, T, H, W, C]
            return np.concatenate(
                [x.mean(axis=(1, 2, 3)), x.std(axis=(1, 2, 3)),
                 np.diff(x.mean(axis=(2, 3, 4)), axis=1)], axis=1)
        N, H, W, C = x.shape                     # image [N, H, W, C]
        p = max(H // 4, 1)
        x = x[:, :H // p * p, :W // p * p]
        x = x.reshape(N, p, H // p, p, W // p, C).mean(axis=(2, 4))
        return x.reshape(N, -1)
    return features


def _port_detector(name: str, path: str, device: torch.device, **detector_kwargs) -> Callable:
    """The port's module for a canonical detector, with the file's state_dict."""
    from . import detectors as det
    sd = torch.jit.load(path, map_location="cpu").state_dict()
    if name == "i3d":
        model = det.InceptionI3d()
        det.load_i3d_state_dict(model, sd)
        return det.i3d_features_fn(model, device=device, **detector_kwargs)
    if name == "inception":
        model = det.InceptionV3()
        det.load_inception_state_dict(model, sd)
        return det.inception_features_fn(model, device=device, **detector_kwargs)
    model = det.C3D()
    det.load_c3d_state_dict(model, sd)
    return det.c3d_features_fn(model, device=device, **detector_kwargs)


def get_detector(name: str, opts: MetricOptions, **detector_kwargs) -> Callable:
    """Returns features_fn(images uint8 [N,H,W,C] or [N,T,H,W,C]) -> np [N, D].
    A features function with `on_device` also takes a tensor on its device."""
    if name in _custom_detectors:
        return _custom_detectors[name](**detector_kwargs)
    if os.environ.get("SGV_STUB_DETECTORS"):
        return _stub_detector(name, **detector_kwargs)
    fname = DETECTOR_FILES.get(name, name)
    for d in _detector_search_dirs(opts):
        path = os.path.join(d, fname)
        if os.path.exists(path):
            device = metric_device(opts)
            if name in DETECTOR_FILES:
                return _port_detector(name, path, device, **detector_kwargs)
            return _torchscript_detector(path, name, device, **detector_kwargs)
    raise FileNotFoundError(
        f"Detector '{name}' ({fname}) not found in {_detector_search_dirs(opts)}. "
        f"Fetch it with scripts/download_detectors.py on a machine with network "
        f"access, or set SGV_DETECTOR_DIR.")


def _torchscript_detector(path: str, name: str, device: torch.device,
                          **detector_kwargs) -> Callable:
    """Run a TorchScript detector on `device`: the raw uint8 batch goes into the
    scripted module with the caller's kwargs verbatim, as reference
    metric_utils.py:232-245 does (any rescaling or resizing happens inside
    the TorchScript)."""
    model = torch.jit.load(path, map_location=device).eval()

    def features(images) -> np.ndarray:
        x = images if isinstance(images, torch.Tensor) else torch.from_numpy(np.asarray(images))
        assert x.dtype == torch.uint8
        x = x.to(device)
        x = x.permute(0, 4, 1, 2, 3) if x.ndim == 5 else x.permute(0, 3, 1, 2)
        with torch.inference_mode():
            out = model(x.contiguous(), **detector_kwargs)
        return out.float().cpu().numpy()

    features.on_device = True
    return features


# ------------------------------ feature loops ---------------------------------

def _cache_tag(opts: MetricOptions, dataset_kwargs: Dict, detector_name: str,
               stats_kwargs: Dict, extra: Dict) -> str:
    def stable(o):
        try:
            return repr(sorted(o.items())) if isinstance(o, dict) else repr(o)
        except Exception:
            return str(o)
    args = dict(dataset_kwargs={k: stable(v) for k, v in dataset_kwargs.items()},
                detector=detector_name, stats_kwargs=stats_kwargs, extra=extra)
    md5 = hashlib.md5(repr(sorted(args.items())).encode("utf-8")).hexdigest()
    name = os.path.splitext(os.path.basename(
        str(dataset_kwargs.get("path", "ds"))))[0]
    return f"{name}-{detector_name}-{md5}"


def _iter_items_threaded(dataset, indices, num_workers: int = 8,
                         prefetch: int = 32):
    """Yield dataset[idx] for idx in indices IN ORDER, decoding up to
    `prefetch` items ahead on a thread pool (the reference hides decode in
    DataLoader workers, reference metric_utils.py:229-231). Order
    preservation keeps FeatureStats truncation and capture_all order
    identical to the serial loop."""
    if num_workers <= 1 or len(indices) <= 1:
        for idx in indices:
            yield dataset[idx]
        return
    from collections import deque
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(max_workers=num_workers) as ex:
        pending = deque()
        it = iter(indices)
        for _ in range(min(prefetch, len(indices))):
            pending.append(ex.submit(dataset.__getitem__, next(it)))
        while pending:
            item = pending.popleft().result()
            nxt = next(it, None)
            if nxt is not None:
                pending.append(ex.submit(dataset.__getitem__, nxt))
            yield item


def _detector_backend_tag(name: str) -> str:
    """Cache-key backend class: 'stub' and 'custom' features must never
    share a cache entry with the real detectors ('real' covers the port's
    modules and TorchScript)."""
    if name in _custom_detectors:
        tag = _custom_detector_tags.get(name)
        return f"custom:{tag}" if tag else "custom"
    if os.environ.get("SGV_STUB_DETECTORS"):
        return "stub"
    return "real"


def _make_dataset(dataset_kwargs: Dict, use_image_dataset: bool):
    from ..data import ImageFolderDataset, VideoFramesFolderDataset
    kwargs = dict(dataset_kwargs)
    if use_image_dataset:
        # frames-as-images adapter (reference dataset.py:469-481)
        keep = {"path", "use_labels", "xflip", "random_seed"}
        kwargs = {k: v for k, v in kwargs.items() if k in keep}
        return ImageFolderDataset(**kwargs)
    return VideoFramesFolderDataset(**kwargs)


def compute_feature_stats_for_dataset(
        opts: MetricOptions, detector_name: str, detector_kwargs: Dict,
        batch_size: int = 64, data_loader_kwargs=None, max_items=None,
        temporal_detector: bool = False, use_image_dataset: bool = False,
        feature_stats_cls=FeatureStats, **stats_kwargs) -> FeatureStats:
    """(reference metric_utils.py:189-257). With replicas, this replica's
    strided share of the items (module docstring)."""
    dataset_kwargs = dict(opts.dataset_kwargs)
    if temporal_detector:
        dataset_kwargs.pop("sampling", None)
    multi_process = _multi_process(opts)
    # one process's share of several replicas is cached under its own key;
    # merged stats are the full stats, cached under the serial key
    partial_stats = opts.num_replicas > 1 and not multi_process

    cache_file = None
    if opts.cache:
        cache_dir = opts.cache_dir or os.path.join(
            os.path.expanduser("~"), ".cache", "stylegan_v_tpu_torch", "metric-stats")
        extra = dict(max_items=max_items, temporal=temporal_detector,
                     image=use_image_dataset,
                     backend=_detector_backend_tag(detector_name),
                     # preprocessing kwargs change the features (e.g. I3D
                     # rescale/resize) — they must invalidate the cache
                     detector_kwargs=repr(sorted(detector_kwargs.items())))
        if partial_stats:
            extra.update(num_replicas=opts.num_replicas, replica=opts.replica)
        tag = _cache_tag(opts, dataset_kwargs, detector_name, stats_kwargs, extra)
        cache_file = os.path.join(cache_dir, tag + ".pkl")
        hit = os.path.isfile(cache_file)
        if multi_process:
            # every process takes process 0's decision, and all raise together
            # where the file is not visible to all of them (a lone raise would
            # leave the others waiting in the next collective)
            flags = [None] * opts.num_replicas
            torch.distributed.all_gather_object(flags, hit)
            hit = bool(flags[0])
            if hit and not all(flags):
                missing = [r for r, f in enumerate(flags) if not f]
                raise RuntimeError(f"metric stats cache hit on process 0 but {cache_file} is "
                                   f"not visible on process(es) {missing}: the cache dir "
                                   f"must be shared by all processes (cache_dir)")
        if hit:
            return feature_stats_cls.load(cache_file)

    dataset = _make_dataset(dataset_kwargs, use_image_dataset)
    num_items = len(dataset) if max_items is None else min(len(dataset), max_items)
    local_items = FeatureStats.replica_max_items(num_items, opts.num_replicas, opts.replica)
    stats = feature_stats_cls(max_items=local_items, **stats_kwargs)
    detector = get_detector(detector_name, opts, **detector_kwargs)
    # round-robin item split (reference metric_utils.py:230)
    item_subset = [(i * opts.num_replicas + opts.replica) % num_items
                   for i in range((num_items - 1) // opts.num_replicas + 1)]

    _vlog(f"real[{detector_name}]: {len(item_subset)} items, batch {batch_size}")
    batch = []
    nb = 0
    for item in _iter_items_threaded(dataset, item_subset):
        img = item["image"]
        if not temporal_detector and img.ndim == 4:
            img = img[0]              # first frame for image detectors
        batch.append(img)
        if len(batch) == batch_size:
            stats.append(detector(np.stack(batch)))
            nb += 1
            if nb in (1, 2) or nb % 16 == 0:
                _vlog(f"real batch {nb} done ({stats.num_items} items)")
            batch = []
            if stats.is_full():
                break
    if batch and not stats.is_full():
        stats.append(detector(np.stack(batch)))
    _vlog(f"real[{detector_name}]: done ({stats.num_items} items)")
    dataset.close()

    if multi_process:
        stats = stats.merge_across_processes()
    if cache_file is not None and (not multi_process or opts.replica == 0):
        stats.save(cache_file)
    return stats


def compute_feature_stats_for_generator(
        opts: MetricOptions, detector_name: str, detector_kwargs: Dict,
        batch_size: int = 16, num_video_frames: int = 16,
        subsample_factor: int = 1, temporal_detector: bool = False,
        max_items=None, noise_mode: str = "const", seed: int = 0,
        feature_stats_cls=FeatureStats, draws=None, **stats_kwargs) -> FeatureStats:
    """Fresh z + dataset labels + consecutive timestamps -> G -> uint8 ->
    detector (reference metric_utils.py:260-331).

    G runs on opts.device under inference mode with TF32 off. z and the
    motion codes come from `draws`, a draw source (an object whose
    randn(shape) returns a standard normal tensor), called per batch for z
    [B, z_dim] and then, when G has motion, for motion_z [B, L, motion.z_dim];
    by default a torch.Generator on the device seeded with seed*1000 + replica.
    Labels come from np.random.RandomState(seed + replica), as in the JAX
    package. With replicas this replica makes its share of `max_items`
    (replica_max_items), merged across processes when each is a replica. A
    detector with `on_device` takes the uint8 frames where G made them; any
    other gets them on the host."""
    from ..models.motion import MotionMappingNetwork
    from ..training.augment import GeneratorDraws
    from ..utils.misc import float32_precision

    device = metric_device(opts)
    G = opts.G
    cfg = G.cfg
    g_device = next(G.parameters()).device
    if g_device != device:
        raise ValueError(f"G is on {g_device}, the metric runs on {device}")
    dataset = _make_dataset(dict(opts.dataset_kwargs), use_image_dataset=False)

    if max_items is not None and opts.num_replicas > 1:
        max_items = FeatureStats.replica_max_items(max_items, opts.num_replicas, opts.replica)
    stats = feature_stats_cls(max_items=max_items, **stats_kwargs)
    detector = get_detector(detector_name, opts, **detector_kwargs)
    on_device = getattr(detector, "on_device", False)
    rng = np.random.RandomState(seed + opts.replica)
    if draws is None:
        draws = GeneratorDraws(torch.Generator(device).manual_seed(seed * 1000 + opts.replica))

    ts_row = np.arange(num_video_frames, dtype=np.float32) * subsample_factor
    L = (MotionMappingNetwork.required_traj_len(cfg, float(ts_row.max()))
         if cfg.has_motion else 0)
    batch_videos = max(1, batch_size // num_video_frames)
    if max_items is not None:
        # never synthesize more videos per batch than the quota needs
        batch_videos = min(batch_videos, max(int(max_items), 1))
    t = torch.from_numpy(np.tile(ts_row[None], (batch_videos, 1))).to(device)

    _vlog(f"gen[{detector_name}]: target {max_items} items, "
          f"batch {batch_videos} videos x {num_video_frames}f")
    was_training = G.training
    G.eval()
    nb = 0
    try:
        with torch.inference_mode(), float32_precision(False):
            while not stats.is_full():
                z = draws.randn((batch_videos, cfg.z_dim)).to(device, torch.float32)
                c = None
                if cfg.c_dim > 0:
                    c = np.stack([dataset.get_label(rng.randint(len(dataset)))
                                  for _ in range(batch_videos)]).astype(np.float32)
                    c = torch.from_numpy(c).to(device)
                mz = (draws.randn((batch_videos, L, cfg.motion.z_dim)).to(device, torch.float32)
                      if cfg.has_motion else None)
                img = G(z, c, t, motion_z=mz, noise_mode=noise_mode)     # [B*F, C, H, W]
                img = torch.clamp((img * 0.5 + 0.5) * 255.0 + 0.5, 0, 255).to(torch.uint8)
                img = img.permute(0, 2, 3, 1)                            # the JAX layout
                if temporal_detector:
                    img = img.reshape(batch_videos, num_video_frames, *img.shape[1:])
                stats.append(detector(img if on_device else img.cpu().numpy()))
                nb += 1
                if nb in (1, 2) or nb % 16 == 0:
                    _vlog(f"gen batch {nb} done ({stats.num_items} items)")
    finally:
        G.train(was_training)
    _vlog(f"gen[{detector_name}]: done ({stats.num_items} items)")
    dataset.close()
    if _multi_process(opts):
        stats = stats.merge_across_processes()
    return stats


def rewrite_opts_for_gen_dataset(opts: MetricOptions) -> MetricOptions:
    """Evaluate a 'fake' dataset in place of the generator
    (reference metric_utils.py:39-46)."""
    import copy
    new = copy.copy(opts)
    assert opts.gen_dataset_kwargs is not None
    new.dataset_kwargs = opts.gen_dataset_kwargs
    new.cache = False
    return new
