"""FVD over I3D (Kinetics-400) features (reference
src/metrics/frechet_video_distance.py). Counterpart of
stylegan_v_tpu/metrics/frechet_video_distance.py."""
from __future__ import annotations

import copy

from . import metric_utils
from .frechet_inception_distance import frechet_distance

NUM_FRAMES_IN_BATCH = {128: 128, 256: 128, 512: 64, 1024: 32}


def compute_fvd(opts, max_real, num_gen, num_frames: int,
                subsample_factor: int = 1, detector_name: str = "i3d") -> float:
    # the reference's kwargs (frechet_video_distance.py:23): raw uint8 goes
    # into the detector, which rescales to [-1, 1] and resizes to 224^2
    detector_kwargs = dict(rescale=True, resize=True, return_features=True)
    resolution = opts.dataset_kwargs.get("resolution") or 256
    batch_size = NUM_FRAMES_IN_BATCH.get(resolution, 128)
    if opts.max_real_override is not None:
        max_real = opts.max_real_override
    if opts.num_gen_override is not None:
        num_gen = opts.num_gen_override

    # real: consecutive-frame loading with subsampling + short-video discard
    # (reference frechet_video_distance.py:26-33)
    real_opts = copy.copy(opts)
    real_opts.dataset_kwargs = dict(opts.dataset_kwargs, load_n_consecutive=num_frames,
                                    subsample_factor=subsample_factor,
                                    discard_short_videos=True)
    mu_real, sigma_real = metric_utils.compute_feature_stats_for_dataset(
        opts=real_opts, detector_name=detector_name,
        detector_kwargs=detector_kwargs, capture_mean_cov=True,
        max_items=max_real, temporal_detector=True,
        batch_size=max(1, batch_size // num_frames)).get_mean_cov()
    metric_utils._vlog("fvd: real mean/cov ready")

    if opts.generator_as_dataset:
        gen_opts = metric_utils.rewrite_opts_for_gen_dataset(opts)
        gen_opts.dataset_kwargs = dict(gen_opts.dataset_kwargs, load_n_consecutive=num_frames,
                                       subsample_factor=subsample_factor,
                                       discard_short_videos=True)
        stats = metric_utils.compute_feature_stats_for_dataset(
            opts=gen_opts, detector_name=detector_name,
            detector_kwargs=detector_kwargs, capture_mean_cov=True,
            max_items=num_gen, temporal_detector=True,
            batch_size=max(1, batch_size // num_frames))
    else:
        stats = metric_utils.compute_feature_stats_for_generator(
            opts=opts, detector_name=detector_name,
            detector_kwargs=detector_kwargs, capture_mean_cov=True,
            max_items=num_gen, temporal_detector=True,
            num_video_frames=num_frames, subsample_factor=subsample_factor,
            batch_size=batch_size)
    mu_gen, sigma_gen = stats.get_mean_cov()
    metric_utils._vlog("fvd: gen mean/cov ready, computing frechet distance")

    if opts.rank != 0:
        return float("nan")
    fvd = frechet_distance(mu_real, sigma_real, mu_gen, sigma_gen)
    metric_utils._vlog(f"fvd: {fvd:.4f}")
    return fvd
